"""Finite-volume stencil primitives on (..., H, W) tensors.

Port of the 2D part of ``srm_tpu/ops/stencil.py``: ghost-cell padding,
the 5-point neighbourhood of a padded field, harmonic and arithmetic face
values and the 5-point divergence. Each keeps the reference's operation
order, so the plain stencil in ``srm_tpu_torch.kernels.stencil`` rounds as
the reference does.

Convention: i indexes the last axis (x / width), j the second-to-last
(y / height).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F


def pad_symmetric(f: torch.Tensor) -> torch.Tensor:
    """One ghost cell on each side of the last two axes.

    A width-1 ``jnp.pad(mode="symmetric")`` repeats the edge cell, which is
    torch's ``replicate`` mode (not ``reflect``). ``replicate`` pads the
    last two axes of a 3D or 4D tensor."""
    lead = f.shape[:-2]
    f3 = f.reshape((-1,) + tuple(f.shape[-2:]))
    out = F.pad(f3.unsqueeze(1), (1, 1, 1, 1), mode="replicate").squeeze(1)
    return out.reshape(tuple(lead) + tuple(out.shape[-2:]))


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


def five_point_divergence(a_ih, a_i_h, a_jh, a_j_h, p: Neighbors, q_over_dv, dv):
    """dv · (−a_i_h·p_{i−1} − a_j_h·p_{j−1} + Σa·p_ij − a_ih·p_{i+1}
    − a_jh·p_{j+1} + q/dv)."""
    return dv * ((-a_i_h * p.i_1) + (-a_j_h * p.j_1)
                 + ((a_i_h + a_j_h + a_ih + a_jh) * p.ij)
                 + (-a_ih * p.i1) + (-a_jh * p.j1) + q_over_dv)
