"""Finite-volume stencil primitives on (..., H, W) and (..., D, H, W) tensors.

Port of ``srm_tpu/ops/stencil.py``: ghost-cell padding, the 5-point (2D)
and 7-point (3D) neighbourhood of a padded field, harmonic, arithmetic and
upstream-weighted face values and the 5- and 7-point divergences. Each keeps the
reference's operation order, so the plain stencils in
``srm_tpu_torch.kernels.stencil`` round as the reference does.

Convention: i indexes the last axis (x / width), j the second-to-last
(y / height), k the third-from-last (z / depth).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F


class _EdgePad(torch.autograd.Function):
    """One ghost cell on each side of the last ``dims`` axes, repeating the
    edge cell: ``F.pad(mode="replicate")`` on the tensor flattened to
    (N, 1, *last ``dims`` axes), which pads exactly those axes.

    The backward is the VJP of a width-1 ``jnp.pad(mode="symmetric")``: it
    folds each halo into the edge cells beside it with slicing adds in a
    fixed order, axis by axis from the first padded one, the low halo then
    the high one (a corner's value thus reaches its corner cell through the
    edge it lies on). No atomics: the same bits on every run, where
    ``F.pad``'s CUDA backward adds the up to four halo values of a corner
    cell with atomics in an order that changes from run to run."""

    @staticmethod
    def forward(ctx, f, dims):
        ctx.dims = dims
        lead = f.shape[:-dims]
        out = F.pad(f.reshape((-1, 1) + tuple(f.shape[-dims:])), (1, 1) * dims,
                    mode="replicate")
        return out.reshape(tuple(lead) + tuple(out.shape[2:]))

    @staticmethod
    def backward(ctx, g):
        for ax in range(g.dim() - ctx.dims, g.dim()):
            n = g.shape[ax] - 2
            core = g.narrow(ax, 1, n).clone()
            core.narrow(ax, 0, 1).add_(g.narrow(ax, 0, 1))
            core.narrow(ax, n - 1, 1).add_(g.narrow(ax, n + 1, 1))
            g = core
        return g, None


def pad_symmetric(f: torch.Tensor) -> torch.Tensor:
    """One ghost cell on each side of the last two axes.

    A width-1 ``jnp.pad(mode="symmetric")`` repeats the edge cell, which is
    torch's ``replicate`` mode (not ``reflect``); the gradient folds the
    halo back in a fixed order (:class:`_EdgePad`)."""
    return _EdgePad.apply(f, 2)


class Neighbors(NamedTuple):
    """Centre and 4-neighbourhood of a padded (..., H+2, W+2) field."""
    ij: torch.Tensor
    i1: torch.Tensor    # i+1 (east)
    i_1: torch.Tensor   # i-1 (west)
    j1: torch.Tensor    # j+1
    j_1: torch.Tensor   # j-1


def neighbors(fp: torch.Tensor) -> Neighbors:
    return Neighbors(
        ij=fp[..., 1:-1, 1:-1],
        i1=fp[..., 1:-1, 2:],
        i_1=fp[..., 1:-1, :-2],
        j1=fp[..., 2:, 1:-1],
        j_1=fp[..., :-2, 1:-1],
    )


def harmonic_faces(k: Neighbors) -> Tuple[torch.Tensor, ...]:
    """Harmonic-mean face permeability: (kx_ih, kx_i_h, ky_jh, ky_j_h)."""
    kx_ih = 2.0 * k.i1 * k.ij / (k.i1 + k.ij)
    kx_i_h = 2.0 * k.ij * k.i_1 / (k.ij + k.i_1)
    ky_jh = 2.0 * k.j1 * k.ij / (k.j1 + k.ij)
    ky_j_h = 2.0 * k.ij * k.j_1 / (k.ij + k.j_1)
    return kx_ih, kx_i_h, ky_jh, ky_j_h


def average_faces(f: Neighbors) -> Tuple[torch.Tensor, ...]:
    """Arithmetic face averages: (f_ih, f_i_h, f_jh, f_j_h)."""
    return (0.5 * (f.i1 + f.ij), 0.5 * (f.ij + f.i_1),
            0.5 * (f.j1 + f.ij), 0.5 * (f.ij + f.j_1))


def upstream_faces(kr: Neighbors, pot: Neighbors) -> Tuple[torch.Tensor, ...]:
    """Upstream-weighted face values: (kr_ih, kr_i_h, kr_jh, kr_j_h). A face
    takes the neighbour's value where the neighbour's potential is higher
    and the centre's otherwise, ties included; a replicate pad makes every
    boundary face a tie."""
    return (torch.where(pot.i1 - pot.ij <= 0.0, kr.ij, kr.i1),
            torch.where(pot.ij - pot.i_1 <= 0.0, kr.ij, kr.i_1),
            torch.where(pot.j1 - pot.ij <= 0.0, kr.ij, kr.j1),
            torch.where(pot.ij - pot.j_1 <= 0.0, kr.ij, kr.j_1))


def five_point_divergence(a_ih, a_i_h, a_jh, a_j_h, p: Neighbors, q_over_dv, dv):
    """dv · (−a_i_h·p_{i−1} − a_j_h·p_{j−1} + Σa·p_ij − a_ih·p_{i+1}
    − a_jh·p_{j+1} + q/dv)."""
    return dv * ((-a_i_h * p.i_1) + (-a_j_h * p.j_1)
                 + ((a_i_h + a_j_h + a_ih + a_jh) * p.ij)
                 + (-a_ih * p.i1) + (-a_jh * p.j1) + q_over_dv)


# ---------------------------------------------------------------------------
# 3D (7-point), srm_tpu/ops/stencil.py:97-160
# ---------------------------------------------------------------------------
def pad_symmetric_3d(f: torch.Tensor) -> torch.Tensor:
    """One ghost cell on each side of the last three axes (edge repeat, as
    :func:`pad_symmetric`). ``replicate`` on a 4D tensor would read it as
    an unbatched (C, D, H, W) volume; :class:`_EdgePad` flattens the
    volumes to (N, 1, D, H, W) explicitly."""
    return _EdgePad.apply(f, 3)


class Neighbors3D(NamedTuple):
    """Centre and 6-neighbourhood of a padded (..., D+2, H+2, W+2) field."""
    ij: torch.Tensor
    i1: torch.Tensor
    i_1: torch.Tensor
    j1: torch.Tensor
    j_1: torch.Tensor
    k1: torch.Tensor    # k+1 (down)
    k_1: torch.Tensor   # k-1 (up)


def neighbors_3d(fp: torch.Tensor) -> Neighbors3D:
    return Neighbors3D(
        ij=fp[..., 1:-1, 1:-1, 1:-1],
        i1=fp[..., 1:-1, 1:-1, 2:],
        i_1=fp[..., 1:-1, 1:-1, :-2],
        j1=fp[..., 1:-1, 2:, 1:-1],
        j_1=fp[..., 1:-1, :-2, 1:-1],
        k1=fp[..., 2:, 1:-1, 1:-1],
        k_1=fp[..., :-2, 1:-1, 1:-1],
    )


def harmonic_faces_3d(k: Neighbors3D, kz: Neighbors3D) -> Tuple[torch.Tensor, ...]:
    """Harmonic-mean permeability at the six faces: (kx_ih, kx_i_h, ky_jh,
    ky_j_h, kz_kh, kz_k_h); the z faces use the vertical field ``kz``."""
    kx_ih = 2.0 * k.i1 * k.ij / (k.i1 + k.ij)
    kx_i_h = 2.0 * k.ij * k.i_1 / (k.ij + k.i_1)
    ky_jh = 2.0 * k.j1 * k.ij / (k.j1 + k.ij)
    ky_j_h = 2.0 * k.ij * k.j_1 / (k.ij + k.j_1)
    kz_kh = 2.0 * kz.k1 * kz.ij / (kz.k1 + kz.ij)
    kz_k_h = 2.0 * kz.ij * kz.k_1 / (kz.ij + kz.k_1)
    return kx_ih, kx_i_h, ky_jh, ky_j_h, kz_kh, kz_k_h


def upstream_faces_3d(kr: Neighbors3D, pot: Neighbors3D) -> Tuple[torch.Tensor, ...]:
    """Upstream-weighted values at the six faces: (kr_ih, kr_i_h, kr_jh,
    kr_j_h, kr_kh, kr_k_h), as :func:`upstream_faces` (ties take the
    centre's value, and only the selected branch receives the gradient)."""
    return (torch.where(pot.i1 - pot.ij <= 0.0, kr.ij, kr.i1),
            torch.where(pot.ij - pot.i_1 <= 0.0, kr.ij, kr.i_1),
            torch.where(pot.j1 - pot.ij <= 0.0, kr.ij, kr.j1),
            torch.where(pot.ij - pot.j_1 <= 0.0, kr.ij, kr.j_1),
            torch.where(pot.k1 - pot.ij <= 0.0, kr.ij, kr.k1),
            torch.where(pot.ij - pot.k_1 <= 0.0, kr.ij, kr.k_1))


def average_faces_3d(f: Neighbors3D) -> Tuple[torch.Tensor, ...]:
    """Arithmetic face averages: (f_ih, f_i_h, f_jh, f_j_h, f_kh, f_k_h)."""
    return (0.5 * (f.i1 + f.ij), 0.5 * (f.ij + f.i_1),
            0.5 * (f.j1 + f.ij), 0.5 * (f.ij + f.j_1),
            0.5 * (f.k1 + f.ij), 0.5 * (f.ij + f.k_1))


def seven_point_divergence(a_ih, a_i_h, a_jh, a_j_h, a_kh, a_k_h, p: Neighbors3D,
                           q_over_dv, dv):
    """dv · (−a_i_h·p_{i−1} − a_j_h·p_{j−1} − a_k_h·p_{k−1} + Σa·p_ijk
    − a_ih·p_{i+1} − a_jh·p_{j+1} − a_kh·p_{k+1} + q/dv)."""
    return dv * ((-a_i_h * p.i_1) + (-a_j_h * p.j_1) + (-a_k_h * p.k_1)
                 + ((a_i_h + a_j_h + a_k_h + a_ih + a_jh + a_kh) * p.ij)
                 + (-a_ih * p.i1) + (-a_jh * p.j1) + (-a_kh * p.k1) + q_over_dv)
