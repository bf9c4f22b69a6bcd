"""Fused stencil residuals: CUDA kernels, plain versions, gradients.

Port of the three kernels of ``srm_tpu/kernels/stencil_pallas.py``:
``dg_stencil_residual`` (kernel B1, dry gas, 2D, 5-point),
``dg3d_stencil_residual`` (kernel B2, dry gas, 3D, 7-point) and
``gc_stencil_residual`` (kernel B3, gas condensate, 2D, two phases). Each
has three pieces, as in the reference:

* a plain PyTorch version, a straight batched port of the reference's
  math and jnp twin (:func:`dg_stencil_residual_reference`, from
  ``_residual_math`` / ``_jnp_forward`` ``:57-103, 151-160``;
  :func:`dg3d_stencil_residual_reference`, from ``_residual_math_3d`` /
  ``_jnp_forward_3d`` ``:179-235, 284-292``;
  :func:`gc_stencil_residual_reference`, from ``_residual_math_gc`` /
  ``_gc_jnp_forward`` ``:352-453, 508-515``). The CPU path and the checks
  of the kernels use them.
* a CUDA kernel (``csrc/dg_stencil.cu``, ``csrc/dg3d_stencil.cu``,
  ``csrc/gc_stencil.cu``), built with ``nvcc`` for ``sm_90a`` at first use
  and called through ctypes on PyTorch's current stream. ``launches``
  counts B1's launches, ``launches_3d`` B2's and ``launches_gc`` B3's.
* a ``torch.autograd.Function`` (:class:`DGStencilResidualFn`,
  :class:`DG3DStencilResidualFn`, :class:`GCStencilResidualFn`): forward
  through the kernel (or, for tensors on the CPU, the plain version). The
  reference's ``jax.custom_vjp`` differentiates its jnp twin (``:568-571``,
  ``:313-316``, ``:529-540``); so does the backward here for CPU tensors,
  through the recomputed plain version. For CUDA tensors each has a
  backward kernel of one launch (in the same ``.cu`` files; B1's and B3's
  tiles planned by :func:`bwd_tile_plan`; ``launches_bwd``,
  ``launches_3d_bwd``, ``launches_gc_bwd``), whose plain version is an
  explicit adjoint derived by hand
  (:func:`dg_stencil_residual_backward_reference`,
  :func:`dg3d_stencil_residual_backward_reference`,
  :func:`gc_stencil_residual_backward_reference`).

:func:`dg_stencil_residual`, :func:`dg3d_stencil_residual` and
:func:`gc_stencil_residual` are the public ops, and
:func:`dg_stencil_residual_backward`, :func:`dg3d_stencil_residual_backward`
and :func:`gc_stencil_residual_backward` the backward kernels on their own.
A CUDA tensor goes to the kernel, or the call raises: there is no fallback
to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Tuple

import torch

from srm_tpu_torch.kernels.build import load_library
from srm_tpu_torch.ops.stencil import (Neighbors, average_faces, average_faces_3d,
                                       five_point_divergence, harmonic_faces, harmonic_faces_3d,
                                       neighbors, neighbors_3d, upstream_faces)

EPSILON = 1e-7

#: launches of the B1 (2D) kernel; the plain version never counts
launches = 0
#: launches of the B2 (3D) kernel; the plain version never counts
launches_3d = 0
#: launches of the B3 (gas-condensate) kernel; the plain version never counts
launches_gc = 0
#: launches of B1's, B2's and B3's backward kernels; the plain versions never count
launches_bwd = 0
launches_3d_bwd = 0
launches_gc_bwd = 0
#: the names of the launch counters above. They count calls from Python: a
#: CUDA graph that captured a launch replays it without calling the wrapper,
#: so the trainer adds each counter's move during the capture at each replay
COUNTERS = ("launches", "launches_3d", "launches_gc", "launches_bwd", "launches_3d_bwd",
            "launches_gc_bwd")


class StencilConfig(NamedTuple):
    C: float
    D: float
    dx: float
    dy: float
    dz: float
    Sgi: float
    krgo: float          # constant DG relperm at Sgi
    phi: float           # constant porosity


class GCStencilConfig(NamedTuple):
    C: float
    D: float
    dx: float
    dy: float
    dz: float
    Swmin: float
    phi: float           # constant porosity


DG_ARGS = ("p0p", "p1p", "kxp", "bgugp", "invBg0", "invBg1", "dinvBg0", "q", "qwell", "tsteps")
DG3D_ARGS = ("p0p", "p1p", "kxp", "kzp", "bgugp", "invBg0", "invBg1", "dinvBg0", "q", "qwell",
             "tsteps")

#: B3's 25 fields, in the reference's ``_GC_ARGS`` order (``:456-459``):
#: padded (B, H+2, W+2) where the name ends in "p", centred (B, H, W) else
GC_ARGS = ("p0", "p1p", "kxp", "Sg0", "Sg1", "krgo1p", "krog1p",
           "invBg0", "invBo0", "Rs0", "Rv0", "dinvBg0", "dinvBo0", "dRs0",
           "dRv0", "invBg1p", "invBo1p", "invug1p", "invuo1p", "Rs1p", "Rv1p",
           "qfg", "qdg", "qfo", "qvo")
GC_PADDED = frozenset(("p1p", "kxp", "krgo1p", "krog1p", "invBg1p", "invBo1p", "invug1p",
                       "invuo1p", "Rs1p", "Rv1p"))


def rock_compressibility(phi: float) -> float:
    """cf = 97.32e-6 / (1 + 55.8721 φ^1.428586), in double."""
    return 97.32e-6 / (1.0 + 55.8721 * phi**1.428586)


def dg_stencil_residual_reference(p0p, p1p, kxp, bgugp, invBg0, invBg1, dinvBg0, q,
                                  qwell, tsteps, cfg: StencilConfig):
    """(dom, ibc, tde, mbc) with the reference's operation order."""
    C, D = cfg.C, cfg.D
    dv = cfg.dx * cfg.dy * cfg.dz
    t1 = tsteps[:, 0].reshape(-1, 1, 1)
    t2 = tsteps[:, 1].reshape(-1, 1, 1)

    kx_ih, kx_i_h, ky_jh, ky_j_h = harmonic_faces(neighbors(kxp))
    b_ih, b_i_h, b_jh, b_j_h = average_faces(neighbors(bgugp))
    pn = neighbors(p1p)
    p_ij = pn.ij
    p0 = p0p[:, 1:-1, 1:-1]

    cf = rock_compressibility(cfg.phi)
    cr0 = cfg.phi * cf * invBg0
    cp1 = cfg.Sgi * (cfg.phi * dinvBg0 + cr0)

    inv_dxx = 1.0 / (cfg.dx * cfg.dx)
    inv_dyy = 1.0 / (cfg.dy * cfg.dy)
    a1 = C * kx_i_h * cfg.krgo * b_i_h * inv_dxx
    a2 = C * ky_j_h * cfg.krgo * b_j_h * inv_dyy
    a3 = C * kx_ih * cfg.krgo * b_ih * inv_dxx
    a4 = C * ky_jh * cfg.krgo * b_jh * inv_dyy
    a5 = (1.0 / D) * (cp1 / t1)

    p2 = (p_ij - p0) * (1.0 + t2 / torch.clamp_min(t1, 1e-12)) + p0
    tde = (dv / D) * cp1 * (
        2.0 * EPSILON / t1
        + (t2 * p0 + t1 * p2 - (t1 + t2) * p_ij) / (t1 * t2 + t2 * t2))

    divq = five_point_divergence(a3, a1, a4, a2, pn, q / dv, dv)
    acc = dv * a5 * (p_ij - p0)
    dom = divq + acc
    ibc = qwell * divq
    mbc_cell = q + dv * cfg.Sgi * cfg.phi * (invBg1 - invBg0) / (D * t1)
    return dom, ibc, tde, -mbc_cell.sum(dim=(1, 2))


def dg3d_stencil_residual_reference(p0p, p1p, kxp, kzp, bgugp, invBg0, invBg1, dinvBg0, q,
                                    qwell, tsteps, cfg: StencilConfig):
    """(dom, ibc, tde, mbc) of the 7-point residual, with the operation
    order of the reference's ``_residual_math_3d``. ``kzp`` arrives
    pre-scaled by the vertical anisotropy (kv/kh)."""
    C, D = cfg.C, cfg.D
    dv = cfg.dx * cfg.dy * cfg.dz
    t1 = tsteps[:, 0].reshape(-1, 1, 1, 1)
    t2 = tsteps[:, 1].reshape(-1, 1, 1, 1)

    kx_ih, kx_i_h, ky_jh, ky_j_h, kz_kh, kz_k_h = harmonic_faces_3d(neighbors_3d(kxp),
                                                                    neighbors_3d(kzp))
    b_ih, b_i_h, b_jh, b_j_h, b_kh, b_k_h = average_faces_3d(neighbors_3d(bgugp))
    p = neighbors_3d(p1p)
    p0 = p0p[:, 1:-1, 1:-1, 1:-1]

    cf = rock_compressibility(cfg.phi)
    cr0 = cfg.phi * cf * invBg0
    cp1 = cfg.Sgi * (cfg.phi * dinvBg0 + cr0)

    inv_dxx = 1.0 / (cfg.dx * cfg.dx)
    inv_dyy = 1.0 / (cfg.dy * cfg.dy)
    inv_dzz = 1.0 / (cfg.dz * cfg.dz)
    a1 = C * kx_i_h * cfg.krgo * b_i_h * inv_dxx
    a2 = C * ky_j_h * cfg.krgo * b_j_h * inv_dyy
    a3 = C * kx_ih * cfg.krgo * b_ih * inv_dxx
    a4 = C * ky_jh * cfg.krgo * b_jh * inv_dyy
    a5 = C * kz_k_h * cfg.krgo * b_k_h * inv_dzz
    a6 = C * kz_kh * cfg.krgo * b_kh * inv_dzz
    a_acc = (1.0 / D) * (cp1 / t1)

    p2 = (p.ij - p0) * (1.0 + t2 / torch.clamp_min(t1, 1e-12)) + p0
    tde = (dv / D) * cp1 * (
        2.0 * EPSILON / t1
        + (t2 * p0 + t1 * p2 - (t1 + t2) * p.ij) / (t1 * t2 + t2 * t2))

    # the twin's order (faces i-1/2, j-1/2, i+1/2, j+1/2, k-1/2, k+1/2), not
    # that of ops.stencil.seven_point_divergence
    divq = dv * ((-a1 * p.i_1) + (-a2 * p.j_1) + (-a5 * p.k_1)
                 + ((a1 + a2 + a3 + a4 + a5 + a6) * p.ij)
                 + (-a3 * p.i1) + (-a4 * p.j1) + (-a6 * p.k1) + q / dv)
    acc = dv * a_acc * (p.ij - p0)
    dom = divq + acc
    ibc = qwell * divq
    mbc_cell = q + dv * cfg.Sgi * cfg.phi * (invBg1 - invBg0) / (D * t1)
    return dom, ibc, tde, -mbc_cell.sum(dim=(1, 2, 3))


def gc_stencil_residual_reference(p0, p1p, kxp, Sg0, Sg1, krgo1p, krog1p,
                                  invBg0, invBo0, Rs0, Rv0, dinvBg0, dinvBo0, dRs0, dRv0,
                                  invBg1p, invBo1p, invug1p, invuo1p, Rs1p, Rv1p,
                                  qfg, qdg, qfo, qvo, qwell, tsteps, cfg: GCStencilConfig):
    """(dom_g, dom_o, ibc, trn_g, trn_o, mbc_g, mbc_o) with the operation
    order of the reference's ``_residual_math_gc``: upstream relperm faces,
    face-averaged property products, four 5-point divergences (gg, go, oo,
    og) and the chord-slope accumulation. So = 1 − Swmin − Sg."""
    C, D, phi = cfg.C, cfg.D, cfg.phi
    dv = cfg.dx * cfg.dy * cfg.dz
    t1 = tsteps[:, 0].reshape(-1, 1, 1)
    t2 = tsteps[:, 1].reshape(-1, 1, 1)

    kfaces = harmonic_faces(neighbors(kxp))
    pn = neighbors(p1p)
    p1 = pn.ij
    invBg1, invBo1, Rs1, Rv1 = (f[:, 1:-1, 1:-1] for f in (invBg1p, invBo1p, Rs1p, Rv1p))
    So0 = 1.0 - cfg.Swmin - Sg0
    So1 = 1.0 - cfg.Swmin - Sg1

    RsinvBo0, RvinvBg0 = Rs0 * invBo0, Rv0 * invBg0
    RsinvBo1, RvinvBg1 = Rs1 * invBo1, Rv1 * invBg1
    mg0 = phi * (invBg0 * Sg0 + RsinvBo0 * So0)
    mo0 = phi * (invBo0 * So0 + RvinvBg0 * Sg0)
    mg1 = phi * (invBg1 * Sg1 + RsinvBo1 * So1)
    mo1 = phi * (invBo1 * So1 + RvinvBg1 * Sg1)
    ratio = 1.0 + t2 / torch.clamp_min(t1, 1e-12)
    mg2 = (mg1 - mg0) * ratio + mg0
    mo2 = (mo1 - mo0) * ratio + mo0

    rte = EPSILON * 0.25
    denom_t = t1 * t2 + t2 * t2
    trn_g = (dv / D) * (rte / t1 + (t2 * mg0 + t1 * mg2 - (t1 + t2) * mg1) / denom_t)
    trn_o = (dv / D) * (rte / t1 + (t2 * mo0 + t1 * mo2 - (t1 + t2) * mo1) / denom_t)

    kgo = upstream_faces(neighbors(krgo1p), pn)
    kog = upstream_faces(neighbors(krog1p), pn)
    bgug = average_faces(neighbors(invBg1p * invug1p))
    bouo = average_faces(neighbors(invBo1p * invuo1p))
    rvbgug = average_faces(neighbors(Rv1p * invBg1p * invug1p))
    rsbouo = average_faces(neighbors(Rs1p * invBo1p * invuo1p))

    # the chord slope keeps the reference's safe_dp form: a plain division
    # by dp would give a NaN gradient where dp = 0 even though it is masked
    dp = p1 - p0
    moving = dp.abs() > 0
    safe_dp = torch.where(moving, dp, torch.ones_like(dp))
    d_Sg = torch.where(moving, (Sg1 - Sg0) / safe_dp, torch.zeros_like(dp))
    d_So = torch.where(moving, (So1 - So0) / safe_dp, torch.zeros_like(dp))

    d_RsinvBo = Rs0 * dinvBo0 + invBo0 * dRs0
    d_RvinvBg = Rv0 * dinvBg0 + invBg0 * dRv0

    cf = rock_compressibility(phi)
    cprgg = phi * cf * invBg0
    cprgo = phi * cf * RsinvBo0
    cproo = phi * cf * invBo0
    cprog = phi * cf * RvinvBg0

    inv_d = (1.0 / (cfg.dx * cfg.dx),) * 2 + (1.0 / (cfg.dy * cfg.dy),) * 2

    def trans(kr_faces, prop_faces):
        return tuple(C * kf * kr * pr * iv
                     for kf, kr, pr, iv in zip(kfaces, kr_faces, prop_faces, inv_d))

    agg = trans(kgo, bgug)
    ago = trans(kog, rsbouo)
    aoo = trans(kog, bouo)
    aog = trans(kgo, rvbgug)

    inv_Dt = 1.0 / (D * t1)
    cpgg = inv_Dt * (phi * invBg1 * d_Sg + Sg0 * (phi * dinvBg0 + cprgg)) * dp
    cpgo = inv_Dt * (phi * RsinvBo1 * d_So + So0 * (phi * d_RsinvBo + cprgo)) * dp
    cpoo = inv_Dt * (phi * invBo1 * d_So + So0 * (phi * dinvBo0 + cproo)) * dp
    cpog = inv_Dt * (phi * RvinvBg1 * d_Sg + Sg0 * (phi * d_RvinvBg + cprog)) * dp

    divq_gg = five_point_divergence(*agg, pn, qfg / dv, dv)
    divq_go = five_point_divergence(*ago, pn, qdg / dv, dv)
    divq_oo = five_point_divergence(*aoo, pn, qfo / dv, dv)
    divq_og = five_point_divergence(*aog, pn, qvo / dv, dv)

    dom_g = (divq_gg + dv * cpgg) + (divq_go + dv * cpgo)
    dom_o = (divq_oo + dv * cpoo) + (divq_og + dv * cpog)
    ibc = qwell * ((divq_gg + divq_go) + (divq_oo + divq_og))

    mbc_g_cell = (qfg + qdg) + dv * inv_Dt * phi * (
        (Sg1 * invBg1 - Sg0 * invBg0) + (So1 * RsinvBo1 - So0 * RsinvBo0))
    mbc_o_cell = (qfo + qvo) + dv * inv_Dt * phi * (
        (So1 * invBo1 - So0 * invBo0) + (Sg1 * RvinvBg1 - Sg0 * RvinvBg0))
    return (dom_g, dom_o, ibc, trn_g, trn_o,
            -mbc_g_cell.sum(dim=(1, 2)), -mbc_o_cell.sum(dim=(1, 2)))


# ---------------------------------------------------------------------------
# explicit adjoints (the plain versions of the backward kernels)
# ---------------------------------------------------------------------------
# Each is derived by hand from its plain forward and written in plain tensor
# ops, with no autograd, as the backward kernel computes it cell by cell: a
# padded input's gradient is the sum of each cell's contributions at its
# centre and its four neighbours, in that order (_gather5), and Δt's is the
# per-sample sum of each cell's part. A padded input's halo gets what the
# boundary cells' stencils read there; the corners get 0.

def _gather5(c: Neighbors) -> torch.Tensor:
    """(B, H+2, W+2): each cell's contributions at its centre and at its
    i+1, i-1, j+1, j-1 neighbours, summed in that order."""
    B, H, W = c.ij.shape
    g = c.ij.new_zeros((B, H + 2, W + 2))
    g[:, 1:-1, 1:-1] += c.ij
    g[:, 1:-1, 2:] += c.i1
    g[:, 1:-1, :-2] += c.i_1
    g[:, 2:, 1:-1] += c.j1
    g[:, :-2, 1:-1] += c.j_1
    return g


def _centre(c: torch.Tensor) -> torch.Tensor:
    """(B, H+2, W+2) with ``c`` inside and a zero halo."""
    return _gather5(Neighbors(c, *(torch.zeros_like(c),) * 4))


def _harmonic_adjoint(k: Neighbors, g) -> Neighbors:
    """Contributions of the face cotangents ``g`` (ih, i_h, jh, j_h) of
    harmonic_faces(k): d(2ab/(a+b))/da = 2(b/(a+b))²."""
    def parts(c, n):
        s = c + n
        rc, rn = n / s, c / s
        return 2.0 * rc * rc, 2.0 * rn * rn              # d/dcentre, d/dneighbour
    (c_ih, n_ih), (c_i_h, n_i_h) = parts(k.ij, k.i1), parts(k.ij, k.i_1)
    (c_jh, n_jh), (c_j_h, n_j_h) = parts(k.ij, k.j1), parts(k.ij, k.j_1)
    return Neighbors(((g[0] * c_ih + g[1] * c_i_h) + g[2] * c_jh) + g[3] * c_j_h,
                     g[0] * n_ih, g[1] * n_i_h, g[2] * n_jh, g[3] * n_j_h)


def _average_adjoint(g) -> Neighbors:
    """Contributions of the face cotangents of average_faces."""
    return Neighbors(0.5 * (((g[0] + g[1]) + g[2]) + g[3]), 0.5 * g[0], 0.5 * g[1],
                     0.5 * g[2], 0.5 * g[3])


def _upstream_adjoint(p: Neighbors, g) -> Neighbors:
    """Contributions of the face cotangents of upstream_faces(kr, p): each
    face's goes to the side it took its value from (ties to the centre)."""
    up = (p.i1 - p.ij <= 0.0, p.ij - p.i_1 <= 0.0, p.j1 - p.ij <= 0.0, p.ij - p.j_1 <= 0.0)
    zero = torch.zeros_like(p.ij)
    own = [torch.where(u, gf, zero) for u, gf in zip(up, g)]
    return Neighbors(((own[0] + own[1]) + own[2]) + own[3],
                     *(torch.where(u, zero, gf) for u, gf in zip(up, g)))


def _face_drops(p: Neighbors):
    """p_ij − p_neighbour at each face (ih, i_h, jh, j_h): a face
    transmissibility's factor in the 5-point divergence."""
    return p.ij - p.i1, p.ij - p.i_1, p.ij - p.j1, p.ij - p.j_1


def _divergence_adjoint(G, a, total):
    """The pressure contributions of five_point_divergence(*a, p, ...)
    whose inner sum has cotangent G; ``total`` is the forward's Σa."""
    return G * total, -(G * a[0]), -(G * a[1]), -(G * a[2]), -(G * a[3])


def _mul5(a, b) -> Neighbors:
    """Pointwise product of two five-point tuples."""
    return Neighbors(*(x * y for x, y in zip(a, b)))


def _add5(*cs) -> Neighbors:
    """Neighbors-wise sum of contribution tuples, in the given order."""
    out = list(cs[0])
    for c in cs[1:]:
        out = [o + x for o, x in zip(out, c)]
    return Neighbors(*out)


def _ratio_adjoint(g_ratio, t1, t2):
    """(dL/dt1, dL/dt2) through ratio = 1 + t2/clamp_min(t1, 1e-12):
    the clamp passes no gradient below its bound."""
    m = torch.clamp_min(t1, 1e-12)
    g_m = -(g_ratio * t2) / (m * m)
    return torch.where(t1 >= 1e-12, g_m, torch.zeros_like(g_m)), g_ratio / m


def _cell_adjoint(p0, p_ij, invBg0, invBg1, dinvBg0, g_dom, g_tde, g_mbc, t1, t2, a_acc, cfg):
    """The cell-local part of the DG adjoint (accumulation, tde, mbc; B1's
    statements with a_acc in place of a5): (g_pij, g_p0, g_invBg0,
    g_invBg1, g_dinvBg0, g_cell, g_t1, g_t2)."""
    D = cfg.D
    dv = cfg.dx * cfg.dy * cfg.dz
    phi_cf = cfg.phi * rock_compressibility(cfg.phi)
    cp1 = cfg.Sgi * (cfg.phi * dinvBg0 + phi_cf * invBg0)
    ratio = 1.0 + t2 / torch.clamp_min(t1, 1e-12)
    dp = p_ij - p0
    p2 = dp * ratio + p0
    num = t2 * p0 + t1 * p2 - (t1 + t2) * p_ij
    den = t1 * t2 + t2 * t2
    X = 2.0 * EPSILON / t1 + num / den
    dB = invBg1 - invBg0
    Dt = D * t1
    K = dv * cfg.Sgi * cfg.phi

    # acc = (dv·a_acc)·dp, a_acc = (1/D)·(cp1/t1)
    g_dp = g_dom * (dv * a_acc)
    g_q5 = ((g_dom * dp) * dv) * (1.0 / D)
    g_cp1 = g_q5 / t1
    g_t1 = -(g_q5 * cp1) / (t1 * t1)
    # tde = ((dv/D)·cp1)·X, X = 2ε/t1 + num/den
    g_X = g_tde * ((dv / D) * cp1)
    g_cp1 = g_cp1 + (g_tde * X) * (dv / D)
    g_t1 = g_t1 - (g_X * (2.0 * EPSILON)) / (t1 * t1)
    g_num = g_X / den
    g_den = -(g_X * num) / (den * den)
    g_t1 = g_t1 + g_num * p2 - g_num * p_ij + g_den * t2
    g_t2 = g_num * p0 - g_num * p_ij + ((g_den * t1 + g_den * t2) + g_den * t2)
    g_p0 = g_num * t2
    g_p2 = g_num * t1
    g_pij = -(g_num * (t1 + t2))
    # p2 = dp·ratio + p0
    g_dp = g_dp + g_p2 * ratio
    g_p0 = g_p0 + g_p2
    r1, r2 = _ratio_adjoint(g_p2 * dp, t1, t2)
    g_t1, g_t2 = g_t1 + r1, g_t2 + r2
    g_pij = g_pij + g_dp
    g_p0 = g_p0 - g_dp
    # cp1 = Sgi·(phi·dinvBg0 + phi_cf·invBg0)
    g_in = g_cp1 * cfg.Sgi
    g_dinvBg0 = g_in * cfg.phi
    g_invBg0 = g_in * phi_cf
    # mbc = −Σ (q + K·dB/(D·t1))
    g_cell = (-g_mbc).reshape((-1,) + (1,) * (p0.dim() - 1)).expand_as(p0)
    g_KdB = g_cell / Dt
    g_invBg1 = g_KdB * K
    g_invBg0 = g_invBg0 - g_KdB * K
    g_t1 = g_t1 - ((g_cell * (K * dB)) / (Dt * Dt)) * D
    return g_pij, g_p0, g_invBg0, g_invBg1, g_dinvBg0, g_cell, g_t1, g_t2


def dg_stencil_residual_backward_reference(p0p, p1p, kxp, bgugp, invBg0, invBg1, dinvBg0, q,
                                           qwell, tsteps, g_dom, g_ibc, g_tde, g_mbc,
                                           cfg: StencilConfig):
    """The gradients of :func:`dg_stencil_residual_reference`'s inputs
    (p0p, p1p, kxp, bgugp, invBg0, invBg1, dinvBg0, q, qwell, tsteps) for the
    output cotangents (g_dom, g_ibc, g_tde, g_mbc), derived by hand: the
    plain version of B1's backward kernel."""
    C, D = cfg.C, cfg.D
    dv = cfg.dx * cfg.dy * cfg.dz
    t1 = tsteps[:, 0].reshape(-1, 1, 1)
    t2 = tsteps[:, 1].reshape(-1, 1, 1)
    phi_cf = cfg.phi * rock_compressibility(cfg.phi)
    inv_d = (1.0 / (cfg.dx * cfg.dx),) * 2 + (1.0 / (cfg.dy * cfg.dy),) * 2

    # the forward's intermediates
    k = neighbors(kxp)
    kf = harmonic_faces(k)
    b = neighbors(bgugp)
    bf = average_faces(b)
    p = neighbors(p1p)
    cp1 = cfg.Sgi * (cfg.phi * dinvBg0 + phi_cf * invBg0)
    # a1..a4 in the face order (ih, i_h, jh, j_h): a3, a1, a4, a2
    a = [C * kx * cfg.krgo * bx * iv for kx, bx, iv in zip(kf, bf, inv_d)]
    total = ((a[1] + a[3]) + a[0]) + a[2]
    a5 = (1.0 / D) * (cp1 / t1)
    divq = dv * ((-a[1] * p.i_1) + (-a[3] * p.j_1) + (total * p.ij) + (-a[0] * p.i1)
                 + (-a[2] * p.j1) + q / dv)

    # divq = dv·(Σ ... + q/dv), read by dom and ibc
    G = (g_dom + qwell * g_ibc) * dv
    g_a = [G * d for d in _face_drops(p)]
    c_p = _divergence_adjoint(G, a, total)
    # a = (((C·kf)·krgo)·bf)·inv_d
    w = [ga * iv for ga, iv in zip(g_a, inv_d)]
    g_kf = [((wf * bx) * cfg.krgo) * C for wf, bx in zip(w, bf)]
    g_bf = [wf * ((C * kx) * cfg.krgo) for wf, kx in zip(w, kf)]

    (g_pij, g_p0, g_invBg0, g_invBg1, g_dinvBg0, g_cell, g_t1, g_t2) = _cell_adjoint(
        p0p[:, 1:-1, 1:-1], p.ij, invBg0, invBg1, dinvBg0, g_dom, g_tde, g_mbc, t1, t2, a5, cfg)
    g_q = G / dv + g_cell

    c_p = Neighbors(c_p[0] + g_pij, *c_p[1:])
    return (_centre(g_p0), _gather5(c_p), _gather5(_harmonic_adjoint(k, g_kf)),
            _gather5(_average_adjoint(g_bf)), g_invBg0, g_invBg1, g_dinvBg0, g_q,
            (g_ibc * divq).sum(dim=0),
            torch.stack([g_t1.sum(dim=(1, 2)), g_t2.sum(dim=(1, 2))], dim=1))


def dg3d_stencil_residual_backward_reference(p0p, p1p, kxp, kzp, bgugp, invBg0, invBg1,
                                             dinvBg0, q, qwell, tsteps, g_dom, g_ibc, g_tde,
                                             g_mbc, cfg: StencilConfig):
    """The gradients of :func:`dg3d_stencil_residual_reference`'s inputs
    (DG3D_ARGS) for the output cotangents (g_dom, g_ibc, g_tde, g_mbc),
    derived by hand: the plain version of B2's backward kernel.

    The divergence's part is written face by face (the pull form the kernel
    computes): a face between padded positions m and m+1 along one axis
    has the transmissibility a = C·kf·krgo·bf/d², kf = 2·k₊·k₋/(k₊+k₋) and
    bf = 0.5·(b₊+b₋) (₊ the position m+1, ₋ the position m), which both
    cells beside it compute alike; with G = (g_dom + qwell·g_ibc)·dv at the
    cells and 0 on the halo, its cotangent is (p₊ − p₋)·(G₊ − G₋), and it
    gives p1p a·(G₊ − G₋) at ₊ and the negation at ₋. A face counts only
    where a cell lies on one side of it. Each padded position sums its faces
    in the order i−1, i+1, j−1, j+1, k−1, k+1 (p1p then adds its cell's
    own terms), so the edge and corner halo lines, which no face with a
    cell reaches, get exact zeros."""
    C = cfg.C
    dv = cfg.dx * cfg.dy * cfg.dz
    t1 = tsteps[:, 0].reshape(-1, 1, 1, 1)
    t2 = tsteps[:, 1].reshape(-1, 1, 1, 1)
    centre = (slice(None), slice(1, -1), slice(1, -1), slice(1, -1))

    kfaces = harmonic_faces_3d(neighbors_3d(kxp), neighbors_3d(kzp))
    bfaces = average_faces_3d(neighbors_3d(bgugp))
    inv = (1.0 / (cfg.dx * cfg.dx), 1.0 / (cfg.dy * cfg.dy), 1.0 / (cfg.dz * cfg.dz))
    # a1..a6 as the forward has them (faces i-1/2, j-1/2, i+1/2, j+1/2, k-1/2, k+1/2)
    a1, a2, a3, a4, a5, a6 = (C * kf * cfg.krgo * bf * iv for kf, bf, iv in zip(
        (kfaces[1], kfaces[3], kfaces[0], kfaces[2], kfaces[5], kfaces[4]),
        (bfaces[1], bfaces[3], bfaces[0], bfaces[2], bfaces[5], bfaces[4]),
        (inv[0], inv[1], inv[0], inv[1], inv[2], inv[2])))
    p = neighbors_3d(p1p)
    divq = dv * ((-a1 * p.i_1) + (-a2 * p.j_1) + (-a5 * p.k_1)
                 + ((a1 + a2 + a3 + a4 + a5 + a6) * p.ij)
                 + (-a3 * p.i1) + (-a4 * p.j1) + (-a6 * p.k1) + q / dv)
    cp1 = cfg.Sgi * (cfg.phi * dinvBg0 + cfg.phi * rock_compressibility(cfg.phi) * invBg0)
    a_acc = (1.0 / cfg.D) * (cp1 / t1)
    (g_pij, g_p0, g_invBg0, g_invBg1, g_dinvBg0, g_cell, g_t1, g_t2) = _cell_adjoint(
        p0p[centre], p.ij, invBg0, invBg1, dinvBg0, g_dom, g_tde, g_mbc, t1, t2, a_acc, cfg)

    G = torch.zeros_like(p1p)
    G[centre] = (g_dom + qwell * g_ibc) * dv
    cell = torch.zeros_like(p1p, dtype=torch.bool)
    cell[centre] = True
    g_p1p, g_kxp, g_kzp, g_bgugp = (torch.zeros_like(p1p) for _ in range(4))
    for axis, kp, g_k, iv in ((3, kxp, g_kxp, inv[0]), (2, kxp, g_kxp, inv[1]),
                              (1, kzp, g_kzp, inv[2])):
        n = p1p.shape[axis]
        lo, hi = (lambda t: t.narrow(axis, 0, n - 1)), (lambda t: t.narrow(axis, 1, n - 1))
        k_p, k_m, b_p, b_m = hi(kp), lo(kp), hi(bgugp), lo(bgugp)
        valid = hi(cell) | lo(cell)
        kf = 2.0 * k_p * k_m / (k_p + k_m)
        bf = 0.5 * (b_p + b_m)
        a = C * kf * cfg.krgo * bf * iv
        dG = hi(G) - lo(G)
        w = ((hi(p1p) - lo(p1p)) * dG) * iv
        g_kf = ((w * bf) * cfg.krgo) * C
        g_bf = w * ((C * kf) * cfg.krgo)
        s = k_p + k_m
        r_p, r_m = k_m / s, k_p / s
        zero = torch.zeros_like(a)

        def put(g, plus, minus):
            # the face below each position (it is the face's + side), then the one above
            hi(g).add_(torch.where(valid, plus, zero))
            lo(g).add_(torch.where(valid, minus, zero))

        ad = a * dG
        put(g_p1p, ad, -ad)
        put(g_k, g_kf * (2.0 * r_p * r_p), g_kf * (2.0 * r_m * r_m))
        put(g_bgugp, 0.5 * g_bf, 0.5 * g_bf)
    g_p1p[centre] += g_pij
    g_p0p = torch.zeros_like(p0p)
    g_p0p[centre] = g_p0
    return (g_p0p, g_p1p, g_kxp, g_kzp, g_bgugp, g_invBg0, g_invBg1, g_dinvBg0,
            G[centre] / dv + g_cell, (g_ibc * divq).sum(dim=0),
            torch.stack([g_t1.sum(dim=(1, 2, 3)), g_t2.sum(dim=(1, 2, 3))], dim=1))


def gc_stencil_residual_backward_reference(p0, p1p, kxp, Sg0, Sg1, krgo1p, krog1p,
                                           invBg0, invBo0, Rs0, Rv0, dinvBg0, dinvBo0, dRs0,
                                           dRv0, invBg1p, invBo1p, invug1p, invuo1p, Rs1p, Rv1p,
                                           qfg, qdg, qfo, qvo, qwell, tsteps,
                                           g_dom_g, g_dom_o, g_ibc, g_trn_g, g_trn_o, g_mbc_g,
                                           g_mbc_o, cfg: GCStencilConfig):
    """The gradients of :func:`gc_stencil_residual_reference`'s 27 inputs
    (GC_ARGS, qwell, tsteps) for the cotangents of its seven outputs,
    derived by hand: the plain version of B3's backward kernel."""
    C, D, phi = cfg.C, cfg.D, cfg.phi
    dv = cfg.dx * cfg.dy * cfg.dz
    t1 = tsteps[:, 0].reshape(-1, 1, 1)
    t2 = tsteps[:, 1].reshape(-1, 1, 1)
    phi_cf = phi * rock_compressibility(phi)
    So_max = 1.0 - cfg.Swmin
    S = dv / D
    rte = EPSILON * 0.25
    inv_d = (1.0 / (cfg.dx * cfg.dx),) * 2 + (1.0 / (cfg.dy * cfg.dy),) * 2

    # the forward's intermediates, as gc_stencil_residual_reference has them
    k = neighbors(kxp)
    kf = harmonic_faces(k)
    p = neighbors(p1p)
    bg, bo, ug, uo, rs, rv = (neighbors(f) for f in (invBg1p, invBo1p, invug1p, invuo1p,
                                                      Rs1p, Rv1p))
    p1, invBg1, invBo1, Rs1, Rv1 = p.ij, bg.ij, bo.ij, rs.ij, rv.ij
    So0, So1 = So_max - Sg0, So_max - Sg1
    RsinvBo0, RvinvBg0 = Rs0 * invBo0, Rv0 * invBg0
    RsinvBo1, RvinvBg1 = Rs1 * invBo1, Rv1 * invBg1
    mg0 = phi * (invBg0 * Sg0 + RsinvBo0 * So0)
    mo0 = phi * (invBo0 * So0 + RvinvBg0 * Sg0)
    mg1 = phi * (invBg1 * Sg1 + RsinvBo1 * So1)
    mo1 = phi * (invBo1 * So1 + RvinvBg1 * Sg1)
    ratio = 1.0 + t2 / torch.clamp_min(t1, 1e-12)
    mg2 = (mg1 - mg0) * ratio + mg0
    mo2 = (mo1 - mo0) * ratio + mo0
    den = t1 * t2 + t2 * t2
    num_g = t2 * mg0 + t1 * mg2 - (t1 + t2) * mg1
    num_o = t2 * mo0 + t1 * mo2 - (t1 + t2) * mo1

    kgo = upstream_faces(neighbors(krgo1p), p)
    kog = upstream_faces(neighbors(krog1p), p)
    bgug_p, bouo_p = neighbors(invBg1p * invug1p), neighbors(invBo1p * invuo1p)
    rvbg_p, rsbo_p = neighbors(Rv1p * invBg1p), neighbors(Rs1p * invBo1p)
    bgug, bouo = average_faces(bgug_p), average_faces(bouo_p)
    rvbgug = average_faces(neighbors(Rv1p * invBg1p * invug1p))
    rsbouo = average_faces(neighbors(Rs1p * invBo1p * invuo1p))

    dp = p1 - p0
    moving = dp.abs() > 0
    zero = torch.zeros_like(dp)
    safe_dp = torch.where(moving, dp, torch.ones_like(dp))
    dSg, dSo = Sg1 - Sg0, So1 - So0
    d_Sg = torch.where(moving, dSg / safe_dp, zero)
    d_So = torch.where(moving, dSo / safe_dp, zero)
    d_RsinvBo = Rs0 * dinvBo0 + invBo0 * dRs0
    d_RvinvBg = Rv0 * dinvBg0 + invBg0 * dRv0
    Ck = [C * kx for kx in kf]
    props = (bgug, rsbouo, bouo, rvbgug)                      # gg, go, oo, og
    krs = (kgo, kog, kog, kgo)
    a = [[ck * kr[f] * pr[f] * iv for f, (ck, iv) in enumerate(zip(Ck, inv_d))]
         for kr, pr in zip(krs, props)]
    totals = [((ax[1] + ax[3]) + ax[0]) + ax[2] for ax in a]
    inv_Dt = 1.0 / (D * t1)
    A_gg = phi * invBg1 * d_Sg + Sg0 * (phi * dinvBg0 + phi_cf * invBg0)
    A_go = phi * RsinvBo1 * d_So + So0 * (phi * d_RsinvBo + phi_cf * RsinvBo0)
    A_oo = phi * invBo1 * d_So + So0 * (phi * dinvBo0 + phi_cf * invBo0)
    A_og = phi * RvinvBg1 * d_Sg + Sg0 * (phi * d_RvinvBg + phi_cf * RvinvBg0)
    K = dv * inv_Dt * phi
    E_g = (Sg1 * invBg1 - Sg0 * invBg0) + (So1 * RsinvBo1 - So0 * RsinvBo0)
    E_o = (So1 * invBo1 - So0 * invBo0) + (Sg1 * RvinvBg1 - Sg0 * RvinvBg0)

    # the four divergences: dv·(Σ ... + q/dv), the gas pair read by dom_g,
    # the oil pair by dom_o, all four by ibc; G is the inner sums' cotangent
    g_ibc_cell = qwell * g_ibc
    G_g = (g_dom_g + g_ibc_cell) * dv
    G_o = (g_dom_o + g_ibc_cell) * dv
    Gs = (G_g, G_g, G_o, G_o)
    drops = _face_drops(p)
    c_p = _add5(*(_divergence_adjoint(G, ax, tot) for G, ax, tot in zip(Gs, a, totals)))
    # a = (((C·kf)·kr)·pr)·inv_d, per divergence and face
    g_kf, g_kgo, g_kog, g_props = [], [], [], [[], [], [], []]
    for f, (ck, iv, d) in enumerate(zip(Ck, inv_d, drops)):
        w = [(G * d) * iv for G in Gs]
        wp = [wx * pr[f] for wx, pr in zip(w, props)]
        for x in range(4):
            g_props[x].append(w[x] * (ck * krs[x][f]))
        g_kf.append(((((wp[0] * kgo[f]) + wp[1] * kog[f]) + wp[2] * kog[f]) + wp[3] * kgo[f]) * C)
        g_kgo.append((wp[0] + wp[3]) * ck)
        g_kog.append((wp[1] + wp[2]) * ck)

    # cp = (inv_Dt·A)·dp, read by dom (not ibc) as dv·cp
    g_dp = zero
    g_invDt = zero
    g_A = []
    G_cp = (g_dom_g * dv, g_dom_o * dv)
    for G, A in zip((G_cp[0], G_cp[0], G_cp[1], G_cp[1]), (A_gg, A_go, A_oo, A_og)):
        g_dp = g_dp + G * (inv_Dt * A)
        g_invDt = g_invDt + (G * dp) * A
        g_A.append((G * dp) * inv_Dt)
    g_invBg1 = (g_A[0] * d_Sg) * phi
    g_d_Sg = g_A[0] * (phi * invBg1)
    g_Sg0 = g_A[0] * (phi * dinvBg0 + phi_cf * invBg0)
    g_in = g_A[0] * Sg0
    g_dinvBg0 = g_in * phi
    g_invBg0 = g_in * phi_cf
    g_RsinvBo1 = (g_A[1] * d_So) * phi
    g_d_So = g_A[1] * (phi * RsinvBo1)
    g_So0 = g_A[1] * (phi * d_RsinvBo + phi_cf * RsinvBo0)
    g_in = g_A[1] * So0
    g_dRsinvBo = g_in * phi
    g_RsinvBo0 = g_in * phi_cf
    g_invBo1 = (g_A[2] * d_So) * phi
    g_d_So = g_d_So + g_A[2] * (phi * invBo1)
    g_So0 = g_So0 + g_A[2] * (phi * dinvBo0 + phi_cf * invBo0)
    g_in = g_A[2] * So0
    g_dinvBo0 = g_in * phi
    g_invBo0 = g_in * phi_cf
    g_RvinvBg1 = (g_A[3] * d_Sg) * phi
    g_d_Sg = g_d_Sg + g_A[3] * (phi * RvinvBg1)
    g_Sg0 = g_Sg0 + g_A[3] * (phi * d_RvinvBg + phi_cf * RvinvBg0)
    g_in = g_A[3] * Sg0
    g_dRvinvBg = g_in * phi
    g_RvinvBg0 = g_in * phi_cf
    # d_RsinvBo = Rs0·dinvBo0 + invBo0·dRs0; d_RvinvBg likewise
    g_Rs0 = g_dRsinvBo * dinvBo0
    g_dinvBo0 = g_dinvBo0 + g_dRsinvBo * Rs0
    g_invBo0 = g_invBo0 + g_dRsinvBo * dRs0
    g_dRs0 = g_dRsinvBo * invBo0
    g_Rv0 = g_dRvinvBg * dinvBg0
    g_dinvBg0 = g_dinvBg0 + g_dRvinvBg * Rv0
    g_invBg0 = g_invBg0 + g_dRvinvBg * dRv0
    g_dRv0 = g_dRvinvBg * invBg0
    # the chord slopes: where(moving, ΔS/safe_dp, 0)
    q_Sg = torch.where(moving, g_d_Sg / safe_dp, zero)
    q_So = torch.where(moving, g_d_So / safe_dp, zero)
    g_Sg1 = q_Sg
    g_Sg0 = g_Sg0 - q_Sg
    g_So1 = q_So
    g_So0 = g_So0 - q_So
    g_dp = g_dp - torch.where(moving, (q_Sg * dSg) / safe_dp + (q_So * dSo) / safe_dp, zero)

    # mbc = −Σ ((q + q') + K·E), K = (dv·inv_Dt)·phi
    g_mg = (-g_mbc_g).reshape(-1, 1, 1).expand_as(p0)
    g_mo = (-g_mbc_o).reshape(-1, 1, 1).expand_as(p0)
    g_E = g_mg * K
    g_Sg1 = g_Sg1 + g_E * invBg1
    g_invBg1 = g_invBg1 + g_E * Sg1
    g_Sg0 = g_Sg0 - g_E * invBg0
    g_invBg0 = g_invBg0 - g_E * Sg0
    g_So1 = g_So1 + g_E * RsinvBo1
    g_RsinvBo1 = g_RsinvBo1 + g_E * So1
    g_So0 = g_So0 - g_E * RsinvBo0
    g_RsinvBo0 = g_RsinvBo0 - g_E * So0
    g_E = g_mo * K
    g_So1 = g_So1 + g_E * invBo1
    g_invBo1 = g_invBo1 + g_E * So1
    g_So0 = g_So0 - g_E * invBo0
    g_invBo0 = g_invBo0 - g_E * So0
    g_Sg1 = g_Sg1 + g_E * RvinvBg1
    g_RvinvBg1 = g_RvinvBg1 + g_E * Sg1
    g_Sg0 = g_Sg0 - g_E * RvinvBg0
    g_RvinvBg0 = g_RvinvBg0 - g_E * Sg0
    g_invDt = g_invDt + ((g_mg * E_g + g_mo * E_o) * phi) * dv
    g_t1 = -((g_invDt * inv_Dt) * inv_Dt) * D

    # trn = S·(rte/t1 + num/den), num = t2·m0 + t1·m2 − (t1+t2)·m1,
    # m2 = (m1 − m0)·ratio + m0
    g_t2 = zero
    g_ratio = zero
    g_m = []
    for g_trn, num, m0, m1, m2 in ((g_trn_g, num_g, mg0, mg1, mg2),
                                   (g_trn_o, num_o, mo0, mo1, mo2)):
        gS = g_trn * S
        g_num = gS / den
        g_den = -(gS * num) / (den * den)
        g_t1 = g_t1 - (gS * rte) / (t1 * t1) + g_num * m2 - g_num * m1 + g_den * t2
        g_t2 = g_t2 + g_num * m0 - g_num * m1 + ((g_den * t1 + g_den * t2) + g_den * t2)
        g_m2 = g_num * t1
        g_ratio = g_ratio + g_m2 * (m1 - m0)
        g_m.append((g_num * t2 - g_m2 * ratio + g_m2, -(g_num * (t1 + t2)) + g_m2 * ratio))
    r1, r2 = _ratio_adjoint(g_ratio, t1, t2)
    g_t1, g_t2 = g_t1 + r1, g_t2 + r2
    (g_mg0, g_mg1), (g_mo0, g_mo1) = g_m
    # m = phi·(...)
    g_in = g_mg0 * phi
    g_invBg0 = g_invBg0 + g_in * Sg0
    g_Sg0 = g_Sg0 + g_in * invBg0
    g_RsinvBo0 = g_RsinvBo0 + g_in * So0
    g_So0 = g_So0 + g_in * RsinvBo0
    g_in = g_mo0 * phi
    g_invBo0 = g_invBo0 + g_in * So0
    g_So0 = g_So0 + g_in * invBo0
    g_RvinvBg0 = g_RvinvBg0 + g_in * Sg0
    g_Sg0 = g_Sg0 + g_in * RvinvBg0
    g_in = g_mg1 * phi
    g_invBg1 = g_invBg1 + g_in * Sg1
    g_Sg1 = g_Sg1 + g_in * invBg1
    g_RsinvBo1 = g_RsinvBo1 + g_in * So1
    g_So1 = g_So1 + g_in * RsinvBo1
    g_in = g_mo1 * phi
    g_invBo1 = g_invBo1 + g_in * So1
    g_So1 = g_So1 + g_in * invBo1
    g_RvinvBg1 = g_RvinvBg1 + g_in * Sg1
    g_Sg1 = g_Sg1 + g_in * RvinvBg1
    # the products, and So = So_max − Sg
    g_Rs0 = g_Rs0 + g_RsinvBo0 * invBo0
    g_invBo0 = g_invBo0 + g_RsinvBo0 * Rs0
    g_Rv0 = g_Rv0 + g_RvinvBg0 * invBg0
    g_invBg0 = g_invBg0 + g_RvinvBg0 * Rv0
    g_Rs1 = g_RsinvBo1 * invBo1
    g_invBo1 = g_invBo1 + g_RsinvBo1 * Rs1
    g_Rv1 = g_RvinvBg1 * invBg1
    g_invBg1 = g_invBg1 + g_RvinvBg1 * Rv1
    g_Sg0 = g_Sg0 - g_So0
    g_Sg1 = g_Sg1 - g_So1

    # the padded fields: face products at each stencil point, then the
    # centre-only terms
    pg = [_average_adjoint(g) for g in g_props]              # gg, go, oo, og
    g_bg = _add5(_mul5(pg[0], ug), _mul5(_mul5(pg[3], ug), rv))
    g_ug = _add5(_mul5(pg[0], bg), _mul5(pg[3], rvbg_p))
    g_rv = _mul5(_mul5(pg[3], ug), bg)
    g_bo = _add5(_mul5(pg[2], uo), _mul5(_mul5(pg[1], uo), rs))
    g_uo = _add5(_mul5(pg[2], bo), _mul5(pg[1], rsbo_p))
    g_rs = _mul5(_mul5(pg[1], uo), bo)
    c_p = Neighbors(c_p.ij + g_dp, *c_p[1:])
    g_bg = Neighbors(g_bg.ij + g_invBg1, *g_bg[1:])
    g_bo = Neighbors(g_bo.ij + g_invBo1, *g_bo[1:])
    g_rs = Neighbors(g_rs.ij + g_Rs1, *g_rs[1:])
    g_rv = Neighbors(g_rv.ij + g_Rv1, *g_rv[1:])

    g_q = [G / dv for G in Gs]
    ibc_sum = ((five_point_divergence(*a[0], p, qfg / dv, dv)
                + five_point_divergence(*a[1], p, qdg / dv, dv))
               + (five_point_divergence(*a[2], p, qfo / dv, dv)
                  + five_point_divergence(*a[3], p, qvo / dv, dv)))
    return (-g_dp, _gather5(c_p), _gather5(_harmonic_adjoint(k, g_kf)), g_Sg0, g_Sg1,
            _gather5(_upstream_adjoint(p, g_kgo)), _gather5(_upstream_adjoint(p, g_kog)),
            g_invBg0, g_invBo0, g_Rs0, g_Rv0, g_dinvBg0, g_dinvBo0, g_dRs0, g_dRv0,
            _gather5(g_bg), _gather5(g_bo), _gather5(g_ug), _gather5(g_uo), _gather5(g_rs),
            _gather5(g_rv), g_q[0] + g_mg, g_q[1] + g_mg, g_q[2] + g_mo, g_q[3] + g_mo,
            (g_ibc * ibc_sum).sum(dim=0),
            torch.stack([g_t1.sum(dim=(1, 2)), g_t2.sum(dim=(1, 2))], dim=1))


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------
_FIELDS_2D = ("C", "krgo", "inv_dxx", "inv_dyy", "inv_D", "D", "dv", "dv_over_D", "phi",
              "phi_cf", "Sgi", "dv_Sgi_phi", "two_eps")

#: B3's centred and padded inputs, each in GC_ARGS order: the backward
#: kernel writes the first's gradients itself and gathers the second's
GC_CENTRED = tuple(n for n in GC_ARGS if n not in GC_PADDED)
GC_PADDED_ORDER = tuple(n for n in GC_ARGS if n in GC_PADDED)
GC_OUTPUTS = ("dom_g", "dom_o", "ibc", "trn_g", "trn_o", "mbc_g", "mbc_o")


@functools.lru_cache(maxsize=None)
def _pack(struct_cls, cfg: StencilConfig):
    """StencilConfig's products, folded in double as JAX folds them from
    Python floats, then rounded to float in the kernel's struct; one struct
    per config."""
    dv = cfg.dx * cfg.dy * cfg.dz
    v = dict(C=cfg.C, krgo=cfg.krgo, inv_dxx=1.0 / (cfg.dx * cfg.dx),
             inv_dyy=1.0 / (cfg.dy * cfg.dy), inv_dzz=1.0 / (cfg.dz * cfg.dz),
             inv_D=1.0 / cfg.D, D=cfg.D, dv=dv, dv_over_D=dv / cfg.D, phi=cfg.phi,
             phi_cf=cfg.phi * rock_compressibility(cfg.phi), Sgi=cfg.Sgi,
             dv_Sgi_phi=dv * cfg.Sgi * cfg.phi, two_eps=2.0 * EPSILON)
    return struct_cls(**{name: v[name] for name, _ in struct_cls._fields_})


class _Scalars(ctypes.Structure):
    """``DGStencilScalars`` of csrc/dg_stencil.cu."""
    _fields_ = [(name, ctypes.c_float) for name in _FIELDS_2D]


class _Scalars3D(ctypes.Structure):
    """``DG3DStencilScalars`` of csrc/dg3d_stencil.cu: B1's, then inv_dzz."""
    _fields_ = [(name, ctypes.c_float) for name in _FIELDS_2D + ("inv_dzz",)]


class _ScalarsGC(ctypes.Structure):
    """``GCStencilScalars`` of csrc/gc_stencil.cu."""
    _fields_ = [(name, ctypes.c_float) for name in (
        "C", "inv_dxx", "inv_dyy", "D", "dv", "dv_over_D", "phi", "phi_cf", "So_max", "rte")]


class _PointersGC(ctypes.Structure):
    """``GCStencilArgs`` of csrc/gc_stencil.cu: the device pointers of the
    inputs (GC_ARGS, qwell, tsteps), the outputs, the balances' partial sums
    and the per-sample tickets."""
    _fields_ = [(name, ctypes.c_void_p) for name in GC_ARGS + (
        "qwell", "tsteps") + GC_OUTPUTS + ("partial", "tickets")]


class _BwdArgs(ctypes.Structure):
    """``DGStencilBwdArgs`` of csrc/dg_stencil.cu."""
    _fields_ = [(name, ctypes.c_void_p) for name in DG_ARGS + (
        "g_dom", "g_ibc", "g_tde", "g_mbc") + tuple(f"grad_{n}" for n in DG_ARGS if n != "qwell")
        + ("partial", "tickets")]


class _BwdArgs3D(ctypes.Structure):
    """``DG3DStencilBwdArgs`` of csrc/dg3d_stencil.cu."""
    _fields_ = [(name, ctypes.c_void_p) for name in DG3D_ARGS + (
        "g_dom", "g_ibc", "g_tde", "g_mbc") + tuple(f"grad_{n}" for n in DG3D_ARGS if n != "qwell")
        + ("partial", "tickets")]


class _BwdArgsGC(ctypes.Structure):
    """``GCStencilBwdArgs`` of csrc/gc_stencil.cu: the inputs (in a
    ``GCStencilArgs`` whose outputs stay null), the output cotangents, the
    centred and the padded inputs' gradients, dL/dtsteps, the partial sums
    and the tickets."""
    _fields_ = ([("x", _PointersGC)]
                + [(name, ctypes.c_void_p) for name in tuple(f"g_{o}" for o in GC_OUTPUTS)
                   + tuple(f"grad_{n}" for n in GC_CENTRED)]
                + [("grad_padded", ctypes.c_void_p * len(GC_PADDED_ORDER))]
                + [(name, ctypes.c_void_p) for name in ("grad_tsteps", "partial", "tickets")])


class TilePlan(ctypes.Structure):
    """How B1's and B3's kernels, forward and backward, cut a sample's
    padded (H+2, W+2) plane (``stencil_adjoint::TilePlan`` of
    csrc/stencil_adjoint.cuh): ``n_ti`` × ``n_tj`` tiles of ``tw`` × ``tj``
    positions (columns × rows), one block each; the last column and row of
    tiles may reach past the plane."""
    _fields_ = [(name, ctypes.c_int) for name in ("tw", "tj", "n_ti", "n_tj")]


#: the largest tile (width, height) of B1's and B3's backward kernels, in
#: padded positions (at most 1024; a block has up to 320 threads, each taking
#: cells in turn); chosen from measured times on the card (PERF.md)
BWD_TILE = (32, 32)
#: the padded inputs each backward kernel stages over a tile and its
#: two-position ring, and those it gathers into five slot arrays a tile
BWD_INPUTS = {"dg": (3, 3), "gc": (10, 10)}


def bwd_tile_shared_bytes(tw: int, tj: int, n_staged: int, n_gathered: int) -> int:
    """The dynamic shared memory of a block with a ``tw`` × ``tj`` tile
    (``stencil_adjoint::tile_shared_floats`` of csrc/stencil_adjoint.cuh,
    in bytes)."""
    return 4 * (n_staged * (tj + 4) * (tw + 4) + n_gathered * 5 * tj * tw)


def tile_plan(H: int, W: int, tile: Tuple[int, int], shared_bytes_of,
              shared_bytes: int) -> TilePlan:
    """The fewest tiles of at most ``tile`` = (columns, rows) positions
    across and down the padded (H+2, W+2) plane, each as small as that count
    allows, so that the tiles cover it with the least overhang; while a
    block's shared memory (``shared_bytes_of(tw, tj)``) exceeds
    ``shared_bytes``, the tile's longer side is narrowed, which adds tiles
    along it."""
    Hp, Wp = H + 2, W + 2
    cap_w, cap_h = tile
    while True:
        n_ti, n_tj = -(-Wp // cap_w), -(-Hp // cap_h)
        tw, tj = -(-Wp // n_ti), -(-Hp // n_tj)
        if shared_bytes_of(tw, tj) <= shared_bytes:
            return TilePlan(tw, tj, n_ti, n_tj)
        if tw == tj == 1:
            raise ValueError(f"no tile fits {shared_bytes} bytes of shared memory")
        if tw >= tj:
            cap_w = tw - 1
        else:
            cap_h = tj - 1


def bwd_tile_plan(H: int, W: int, inputs: Tuple[int, int], shared_bytes: int) -> TilePlan:
    """The backward kernels' :func:`tile_plan`: tiles of at most
    :data:`BWD_TILE` positions whose staged and gathered ``inputs`` fit
    ``shared_bytes``."""
    return tile_plan(H, W, BWD_TILE, lambda tw, tj: bwd_tile_shared_bytes(tw, tj, *inputs),
                     shared_bytes)


#: the largest tile (width, height) of B1's and B3's forward kernels, in
#: padded positions (at most 1024; a thread takes one or two of them, see
#: fwd_passes); chosen from measured times on the card (PERF.md)
FWD_TILE = (32, 32)
#: the padded inputs each forward kernel stages over a tile and its
#: one-position ring (B1's p0p, read at the centre only, is not staged)
FWD_STAGED = {"dg": 3, "gc": 10}


def fwd_tile_shared_bytes(tw: int, tj: int, n_staged: int) -> int:
    """The dynamic shared memory of a forward block with a ``tw`` × ``tj``
    tile (``stencil_adjoint::staged_floats`` with a one-position ring, in
    bytes)."""
    return 4 * n_staged * (tj + 2) * (tw + 2)


def fwd_tile_plan(H: int, W: int, kind: str, shared_bytes: int) -> TilePlan:
    """The forward kernels' :func:`tile_plan` for ``kind`` ("dg" or "gc"):
    tiles of at most :data:`FWD_TILE` positions whose staged inputs fit
    ``shared_bytes``."""
    return tile_plan(H, W, FWD_TILE, lambda tw, tj: fwd_tile_shared_bytes(tw, tj, FWD_STAGED[kind]),
                     shared_bytes)


def fwd_passes(plan: TilePlan, B: int, sms: int) -> int:
    """The tile's positions each thread of a forward block takes for
    ``plan`` at batch ``B`` on a device of ``sms`` SMs: one while the grid
    (``B`` × tiles blocks) has at most one block per SM, so that each SM's
    one block computes its cells at once; two otherwise, so that smaller
    blocks, more of them resident, overlap one another's staging and sums
    (measured on the card: PERF.md). The kernel's block is then whole warps
    of at most 512 threads (``stencil_adjoint::forward_threads``), so a
    tile of over 512 positions takes two a thread either way."""
    return 1 if B * plan.n_ti * plan.n_tj <= sms else 2


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _shared_budget(kind: str, direction: str, device: torch.device) -> int:
    """The dynamic shared memory a block of ``kind``'s forward or backward
    kernel (``direction`` "fwd" or "bwd") may have on ``device`` (the
    per-block opt-in limit less the kernel's static shared memory), asked
    of the library once per device."""
    lib = _library() if kind == "dg" else _library_gc()
    fn = getattr(lib, f"{kind}_stencil_{direction}_shared_budget")
    budget = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = fn(ctypes.byref(budget))
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {err}")
    return budget.value


def _fwd_plan(kind: str, like: torch.Tensor) -> TilePlan:
    H, W = like.shape[-2:]
    return fwd_tile_plan(H, W, kind, _shared_budget(kind, "fwd", like.device))


def _bwd_plan(kind: str, like: torch.Tensor) -> TilePlan:
    H, W = like.shape[-2:]
    return bwd_tile_plan(H, W, BWD_INPUTS[kind], _shared_budget(kind, "bwd", like.device))


@functools.lru_cache(maxsize=None)
def _pack_gc(cfg: GCStencilConfig) -> _ScalarsGC:
    """GCStencilConfig's products, folded in double as JAX folds them from
    Python floats, then rounded to float in the kernel's struct; one struct
    per config."""
    dv = cfg.dx * cfg.dy * cfg.dz
    return _ScalarsGC(C=cfg.C, inv_dxx=1.0 / (cfg.dx * cfg.dx), inv_dyy=1.0 / (cfg.dy * cfg.dy),
                      D=cfg.D, dv=dv, dv_over_D=dv / cfg.D, phi=cfg.phi,
                      phi_cf=cfg.phi * rock_compressibility(cfg.phi), So_max=1.0 - cfg.Swmin,
                      rte=EPSILON * 0.25)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("dg_stencil.cu")
    lib.dg_stencil_forward.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 3
                                       + [TilePlan, ctypes.c_int, _Scalars, ctypes.c_void_p])
    lib.dg_stencil_forward.restype = ctypes.c_int
    lib.dg_stencil_backward.argtypes = ([ctypes.POINTER(_BwdArgs)] + [ctypes.c_int] * 3
                                        + [TilePlan, _Scalars, ctypes.c_void_p])
    lib.dg_stencil_backward.restype = ctypes.c_int
    for direction in ("fwd", "bwd"):
        fn = getattr(lib, f"dg_stencil_{direction}_shared_budget")
        fn.argtypes, fn.restype = [ctypes.POINTER(ctypes.c_int)], ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _library_3d() -> ctypes.CDLL:
    lib = load_library("dg3d_stencil.cu")
    lib.dg3d_stencil_num_blocks.argtypes = [ctypes.c_int] * 5
    lib.dg3d_stencil_num_blocks.restype = ctypes.c_int
    lib.dg3d_stencil_forward.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 4
                                         + [_Scalars3D, ctypes.c_void_p])
    lib.dg3d_stencil_forward.restype = ctypes.c_int
    lib.dg3d_stencil_backward.argtypes = ([ctypes.POINTER(_BwdArgs3D)] + [ctypes.c_int] * 4
                                          + [_Scalars3D, ctypes.c_void_p])
    lib.dg3d_stencil_backward.restype = ctypes.c_int
    return lib


_TICKETS = {}
_RETIRED_TICKETS = []


def _tickets(device: torch.device, B: int) -> torch.Tensor:
    """The per-sample tickets of the kernels' ticketed sums (the forward
    and the backward kernel of each of B1, B2 and B3) on ``device``: zero
    between launches (each launch's last block of a sample resets its own),
    so one buffer per device serves every launch in stream order.

    A CUDA graph keeps the address of the buffer it captured, so a buffer
    outgrown by a larger batch is kept alive, never freed. The trainer's
    eager warm-up steps allocate it before any capture."""
    t = _TICKETS.get(device)
    if t is None or t.numel() < B:
        if t is not None:
            _RETIRED_TICKETS.append(t)
        t = _TICKETS[device] = torch.zeros(max(B, 64), dtype=torch.int32, device=device)
    return t


@functools.lru_cache(maxsize=None)
def _library_gc() -> ctypes.CDLL:
    lib = load_library("gc_stencil.cu")
    lib.gc_stencil_forward.argtypes = ([ctypes.POINTER(_PointersGC)] + [ctypes.c_int] * 3
                                       + [TilePlan, ctypes.c_int, _ScalarsGC, ctypes.c_void_p])
    lib.gc_stencil_forward.restype = ctypes.c_int
    lib.gc_stencil_backward.argtypes = ([ctypes.POINTER(_BwdArgsGC)] + [ctypes.c_int] * 3
                                        + [TilePlan, _ScalarsGC, ctypes.c_void_p])
    lib.gc_stencil_backward.restype = ctypes.c_int
    for direction in ("fwd", "bwd"):
        fn = getattr(lib, f"gc_stencil_{direction}_shared_budget")
        fn.argtypes, fn.restype = [ctypes.POINTER(ctypes.c_int)], ctypes.c_int
    return lib


def _alloc(like: torch.Tensor, shapes):
    """One torch.empty for several float32 tensors of ``like``'s device,
    handed out as contiguous views."""
    sizes = [math.prod(s) for s in shapes]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=like.device)
    return [v.view(s) for v, s in zip(flat.split(sizes), shapes)]


def _call(fn, device, *args):
    """Call a C launcher with PyTorch's current stream on ``device``; raise
    if it reports a CUDA error (a refused launch never runs, and a later
    synchronise would not report it).

    Under a CUDA graph capture the current stream is the capture stream, so
    the launch is recorded into the graph. The launchers neither synchronise
    nor allocate, and their scalars (``_pack``) are constants of the case; a
    wrapper must keep it so, with no host read of a device value
    (``.item()``, ``.cpu()``), for the training step to stay capturable."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {err} at launch")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _cuda_forward(*args):
    global launches
    *ins, cfg = args
    lib = _library()
    q = ins[7]
    B, H, W = q.shape
    plan = _fwd_plan("dg", q)
    # the outputs (dom, ibc, tde, mbc) and the ticketed sum's partials (one
    # per tile) in one allocation
    dom, ibc, tde, mbc, partial = _alloc(q, (q.shape,) * 3 + ((B,), (B, plan.n_ti * plan.n_tj)))
    _call(lib.dg_stencil_forward, q.device,
          *(t.data_ptr() for t in tuple(ins) + (dom, ibc, tde, partial, mbc,
                                                _tickets(q.device, B))),
          B, H, W, plan, fwd_passes(plan, B, _sm_count(q.device)), _pack(_Scalars, cfg))
    launches += 1
    return dom, ibc, tde, mbc


def _cuda_forward_3d(*args):
    global launches_3d
    *ins, cfg = args
    lib = _library_3d()
    q = ins[8]
    B, D, H, W = q.shape
    n_blocks = lib.dg3d_stencil_num_blocks(1, B, D, H, W)
    dom, ibc, tde, mbc, partial = _alloc(q, (q.shape,) * 3 + ((B,), (B, n_blocks)))
    _call(lib.dg3d_stencil_forward, q.device,
          *(t.data_ptr() for t in tuple(ins) + (dom, ibc, tde, partial, mbc,
                                                _tickets(q.device, B))),
          B, D, H, W, _pack(_Scalars3D, cfg))
    launches_3d += 1
    return dom, ibc, tde, mbc


def _cuda_forward_gc(*args):
    global launches_gc
    *ins, cfg = args
    lib = _library_gc()
    p0 = ins[0]
    B, H, W = p0.shape
    plan = _fwd_plan("gc", p0)
    # dom_g dom_o ibc trn_g trn_o mbc_g mbc_o and the ticketed sums' partials
    # (two per tile) in one allocation
    out = _alloc(p0, (p0.shape,) * 5 + ((B,),) * 2 + ((B, plan.n_ti * plan.n_tj, 2),))
    ptrs = _PointersGC(*(t.data_ptr() for t in tuple(ins) + tuple(out)),
                       _tickets(p0.device, B).data_ptr())
    _call(lib.gc_stencil_forward, p0.device, ctypes.byref(ptrs), B, H, W, plan,
          fwd_passes(plan, B, _sm_count(p0.device)), _pack_gc(cfg))
    launches_gc += 1
    return tuple(out[:7])


def _grad_buffers(kind: str, like: torch.Tensor, grid, need):
    """An empty gradient for each input of the ``kind`` stencil that
    ``need`` flags, keyed by its index: one allocation per gradient, so that
    autograd frees each once it is consumed (one allocation for all would
    keep all alive as long as any)."""
    shapes = _shapes(kind, like.shape[0], *grid)
    return {i: torch.empty(shape, dtype=torch.float32, device=like.device)
            for i, shape in enumerate(shapes) if need[i]}


def _refuse_qwell(need, i):
    if need[i]:
        raise NotImplementedError("the backward kernel gives no gradient for qwell, the "
                                  "well-cell indicator; it is a constant of the loss")


def _cuda_backward(saved, grads, cfg, need):
    """B1's backward kernel, one launch: the gradients of the inputs in
    ``need`` (a flag per input), None for the others."""
    global launches_bwd
    _refuse_qwell(need, 8)
    lib = _library()
    q = saved[7]
    B, H, W = q.shape
    plan = _bwd_plan("dg", q)
    out = _grad_buffers("dg", q, (H, W), need)
    partial = torch.empty((B, plan.n_ti * plan.n_tj, 2), dtype=torch.float32, device=q.device)
    cots = [g.contiguous() for g in grads]
    args = _BwdArgs(*(t.data_ptr() for t in tuple(saved) + tuple(cots)),
                    *(_ptr(out.get(i)) for i in range(len(DG_ARGS)) if i != 8),
                    partial.data_ptr(), _tickets(q.device, B).data_ptr())
    _call(lib.dg_stencil_backward, q.device, ctypes.byref(args), B, H, W, plan,
          _pack(_Scalars, cfg))
    launches_bwd += 1
    return tuple(out.get(i) for i in range(len(DG_ARGS)))


def _cuda_backward_3d(saved, grads, cfg, need):
    """B2's backward kernel, one launch: the gradients of the inputs in
    ``need`` (a flag per input), None for the others."""
    global launches_3d_bwd
    _refuse_qwell(need, 9)
    lib = _library_3d()
    q = saved[8]
    B, D, H, W = q.shape
    n_blocks = lib.dg3d_stencil_num_blocks(0, B, D, H, W)
    out = _grad_buffers("dg3d", q, (D, H, W), need)
    partial = torch.empty((B, n_blocks, 2), dtype=torch.float32, device=q.device)
    cots = [g.contiguous() for g in grads]
    args = _BwdArgs3D(*(t.data_ptr() for t in tuple(saved) + tuple(cots)),
                      *(_ptr(out.get(i)) for i in range(len(DG3D_ARGS)) if i != 9),
                      partial.data_ptr(), _tickets(q.device, B).data_ptr())
    _call(lib.dg3d_stencil_backward, q.device, ctypes.byref(args), B, D, H, W,
          _pack(_Scalars3D, cfg))
    launches_3d_bwd += 1
    return tuple(out.get(i) for i in range(len(DG3D_ARGS)))


def _cuda_backward_gc(saved, grads, cfg, need):
    """B3's backward kernel, one launch: the gradients of the inputs in
    ``need`` (a flag per input), None for the others."""
    global launches_gc_bwd
    _refuse_qwell(need, len(GC_ARGS))
    lib = _library_gc()
    p0 = saved[0]
    B, H, W = p0.shape
    plan = _bwd_plan("gc", p0)
    out = _grad_buffers("gc", p0, (H, W), need)
    partial = torch.empty((B, plan.n_ti * plan.n_tj, 2), dtype=torch.float32, device=p0.device)
    index = {n: i for i, n in enumerate(GC_ARGS)}
    cots = [g.contiguous() for g in grads]
    padded = (ctypes.c_void_p * len(GC_PADDED_ORDER))(
        *(_ptr(out.get(index[n])) for n in GC_PADDED_ORDER))
    args = _BwdArgsGC(_PointersGC(*(t.data_ptr() for t in saved)),
                      *(t.data_ptr() for t in cots), *(_ptr(out.get(index[n])) for n in GC_CENTRED),
                      padded, _ptr(out.get(len(GC_ARGS) + 1)), partial.data_ptr(),
                      _tickets(p0.device, B).data_ptr())
    _call(lib.gc_stencil_backward, p0.device, ctypes.byref(args), B, H, W, plan,
          _pack_gc(cfg))
    launches_gc_bwd += 1
    return tuple(out.get(i) for i in range(len(GC_ARGS) + 2))


# ---------------------------------------------------------------------------
# public ops
# ---------------------------------------------------------------------------
def _plain_backward(reference, ctx, grads):
    """The gradient of the recomputed plain version, for the inputs that
    need one (the reference's custom-vjp backward)."""
    saved = ctx.saved_tensors
    need = ctx.needs_input_grad[:len(saved)]
    args = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
    with torch.enable_grad():
        outs = reference(*args, ctx.cfg)
    wanted = [a for a, n in zip(args, need) if n]
    live = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
    got = iter(torch.autograd.grad([o for o, _ in live], wanted, [g for _, g in live],
                                   allow_unused=True)
               if wanted and live else [None] * len(wanted))
    return tuple(next(got) if n else None for n in need) + (None,)


class DGStencilResidualFn(torch.autograd.Function):
    """B1. Forward: the kernel (the plain version for CPU tensors).
    Backward: the backward kernel (autograd through the recomputed plain
    version for CPU tensors)."""

    @staticmethod
    def forward(ctx, *args):
        *tensors, cfg = args
        ctx.save_for_backward(*tensors)
        ctx.cfg = cfg
        if tensors[0].is_cuda:
            return _cuda_forward(*args)
        return dg_stencil_residual_reference(*args)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        if saved[0].is_cuda:
            return _cuda_backward(saved, grads, ctx.cfg, ctx.needs_input_grad) + (None,)
        return _plain_backward(dg_stencil_residual_reference, ctx, grads)


class DG3DStencilResidualFn(torch.autograd.Function):
    """B2. Forward: the kernel (the plain version for CPU tensors).
    Backward: the backward kernel (autograd through the recomputed plain
    version for CPU tensors)."""

    @staticmethod
    def forward(ctx, *args):
        *tensors, cfg = args
        ctx.save_for_backward(*tensors)
        ctx.cfg = cfg
        if tensors[0].is_cuda:
            return _cuda_forward_3d(*args)
        return dg3d_stencil_residual_reference(*args)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        if saved[0].is_cuda:
            return _cuda_backward_3d(saved, grads, ctx.cfg, ctx.needs_input_grad) + (None,)
        return _plain_backward(dg3d_stencil_residual_reference, ctx, grads)


class GCStencilResidualFn(torch.autograd.Function):
    """B3. Forward: the kernel (the plain version for CPU tensors).
    Backward: the backward kernel (autograd through the recomputed plain
    version for CPU tensors)."""

    @staticmethod
    def forward(ctx, *args):
        *tensors, cfg = args
        ctx.save_for_backward(*tensors)
        ctx.cfg = cfg
        if tensors[0].is_cuda:
            return _cuda_forward_gc(*args)
        return gc_stencil_residual_reference(*args)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        if saved[0].is_cuda:
            return _cuda_backward_gc(saved, grads, ctx.cfg, ctx.needs_input_grad) + (None,)
        return _plain_backward(gc_stencil_residual_reference, ctx, grads)


@functools.lru_cache(maxsize=64)
def _shapes(kind: str, B: int, *grid: int):
    """The shapes each argument of a stencil op must have."""
    padded = (B,) + tuple(n + 2 for n in grid)
    centred = (B,) + grid
    if kind == "gc":
        return tuple(padded if n in GC_PADDED else centred for n in GC_ARGS) + (grid, (B, 2))
    n_padded = 5 if kind == "dg3d" else 4
    return (padded,) * n_padded + (centred,) * 4 + (grid, (B, 2))


def _check(names, tensors, shapes):
    """float32, the expected shapes, contiguous, one device — or raise."""
    device = tensors[0].device
    for t, shape in zip(tensors, shapes):
        if (t.dtype is not torch.float32 or t.shape != shape or not t.is_contiguous()
                or t.device != device):
            break
    else:
        return
    for name, t, shape in zip(names, tensors, shapes):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, {names[0]} on {device}")


def dg_stencil_residual(p0p, p1p, kxp, bgugp, invBg0, invBg1, dinvBg0, q, qwell, tsteps,
                        cfg: StencilConfig) -> Tuple[torch.Tensor, ...]:
    """Fused DG residual (B1): (dom, ibc, tde, mbc) from padded/centred fields.

    Args (B = batch, H/W = grid), all float32 and contiguous on one device:
      p0p, p1p      (B, H+2, W+2) edge-padded pressures at n0/n1
      kxp           (B, H+2, W+2) padded permeability (mD)
      bgugp         (B, H+2, W+2) padded invBg·invug at n1
      invBg0/1      (B, H, W)     centre 1/Bg at n0/n1
      dinvBg0       (B, H, W)     d(1/Bg)/dP at n0
      q             (B, H, W)     well rates at n1
      qwell         (H, W)        well-cell indicator
      tsteps        (B, 2)        per-sample (Δt1, Δt2)

    On a GPU the gradient of every input but qwell comes from B1's backward
    kernel; asking it for qwell's raises ``NotImplementedError``.
    """
    if q.dim() != 3:
        raise ValueError(f"q must be (B, H, W), got {tuple(q.shape)}")
    args = (p0p, p1p, kxp, bgugp, invBg0, invBg1, dinvBg0, q, qwell, tsteps)
    _check(DG_ARGS, args, _shapes("dg", *q.shape))
    return DGStencilResidualFn.apply(*args, cfg)


def dg3d_stencil_residual(p0p, p1p, kxp, kzp, bgugp, invBg0, invBg1, dinvBg0, q, qwell,
                          tsteps, cfg: StencilConfig) -> Tuple[torch.Tensor, ...]:
    """Fused 3D DG residual (B2): (dom, ibc, tde, mbc) from padded/centred
    volumes, in the argument order of the reference's
    ``dg3d_stencil_residual``.

    Args (B = batch, D/H/W = grid), all float32 and contiguous on one device:
      p0p, p1p      (B, D+2, H+2, W+2) edge-padded pressures at n0/n1
      kxp           (B, D+2, H+2, W+2) padded horizontal permeability (mD)
      kzp           (B, D+2, H+2, W+2) padded vertical permeability, already
                                       scaled by kv/kh (no further scaling)
      bgugp         (B, D+2, H+2, W+2) padded invBg·invug at n1
      invBg0/1      (B, D, H, W)       centre 1/Bg at n0/n1
      dinvBg0       (B, D, H, W)       d(1/Bg)/dP at n0
      q             (B, D, H, W)       well rates at n1
      qwell         (D, H, W)          well-cell indicator
      tsteps        (B, 2)             per-sample (Δt1, Δt2)
    """
    if q.dim() != 4:
        raise ValueError(f"q must be (B, D, H, W), got {tuple(q.shape)}")
    args = (p0p, p1p, kxp, kzp, bgugp, invBg0, invBg1, dinvBg0, q, qwell, tsteps)
    _check(DG3D_ARGS, args, _shapes("dg3d", *q.shape))
    return DG3DStencilResidualFn.apply(*args, cfg)


def gc_stencil_residual(*args) -> Tuple[torch.Tensor, ...]:
    """Fused gas-condensate two-phase residual (B3):
    (dom_g, dom_o, ibc, trn_g, trn_o, mbc_g, mbc_o).

    Args (B = batch, H/W = grid), all float32 and contiguous on one device:
    the 25 fields of :data:`GC_ARGS` in that order — padded (B, H+2, W+2)
    for the ten in :data:`GC_PADDED`, centred (B, H, W) for the others
    (p0 is centred) — then qwell (H, W), the well-cell indicator, tsteps
    (B, 2), the per-sample (Δt1, Δt2), and the :class:`GCStencilConfig`.

    On a GPU the gradient of every input but qwell comes from B3's backward
    kernel; asking it for qwell's raises ``NotImplementedError``.
    """
    *tensors, cfg = args
    names = GC_ARGS + ("qwell", "tsteps")
    if len(tensors) != len(names) or not isinstance(cfg, GCStencilConfig):
        raise TypeError(f"gc_stencil_residual takes the {len(names)} tensors "
                        f"{', '.join(names)} and a GCStencilConfig")
    p0 = tensors[0]
    if p0.dim() != 3:
        raise ValueError(f"p0 must be (B, H, W), got {tuple(p0.shape)}")
    _check(names, tensors, _shapes("gc", *p0.shape))
    return GCStencilResidualFn.apply(*tensors, cfg)


def dg_stencil_residual_backward(*args):
    """B1's backward on its own: the gradients of the ten inputs of
    :func:`dg_stencil_residual` for the cotangents (g_dom, g_ibc, g_tde,
    g_mbc), from ``(*inputs, *cotangents, cfg)``. On CUDA tensors the
    backward kernel computes every gradient but qwell's (None); on CPU
    tensors its plain version, :func:`dg_stencil_residual_backward_reference`,
    computes all ten."""
    *tensors, cfg = args
    if not tensors[0].is_cuda:
        return dg_stencil_residual_backward_reference(*args)
    return _cuda_backward(tensors[:10], tensors[10:], cfg, (True,) * 8 + (False, True))


def dg3d_stencil_residual_backward(*args):
    """B2's backward on its own: the gradients of the eleven inputs of
    :func:`dg3d_stencil_residual` for the cotangents (g_dom, g_ibc, g_tde,
    g_mbc), from ``(*inputs, *cotangents, cfg)``. On CUDA tensors the
    backward kernel computes every gradient but qwell's (None); on CPU
    tensors its plain version,
    :func:`dg3d_stencil_residual_backward_reference`, computes all eleven."""
    *tensors, cfg = args
    if not tensors[0].is_cuda:
        return dg3d_stencil_residual_backward_reference(*args)
    return _cuda_backward_3d(tensors[:11], tensors[11:], cfg, (True,) * 9 + (False, True))


def gc_stencil_residual_backward(*args):
    """B3's backward on its own: the gradients of the 27 inputs of
    :func:`gc_stencil_residual` for the cotangents of its seven outputs,
    from ``(*inputs, *cotangents, cfg)``. On CUDA tensors the backward
    kernel computes every gradient but qwell's (None); on CPU tensors its
    plain version, :func:`gc_stencil_residual_backward_reference`, computes
    all 27."""
    *tensors, cfg = args
    n = len(GC_ARGS) + 2
    if not tensors[0].is_cuda:
        return gc_stencil_residual_backward_reference(*args)
    return _cuda_backward_gc(tensors[:n], tensors[n:], cfg,
                             (True,) * len(GC_ARGS) + (False, True))
