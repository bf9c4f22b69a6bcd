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
  through the kernel (or, for tensors on the CPU, the plain version);
  backward recomputes the plain version and differentiates it, as the
  reference's ``jax.custom_vjp`` differentiates its jnp twin (``:568-571``,
  ``:313-316``, ``:529-540``). Hand-written backward kernels are later work.

:func:`dg_stencil_residual`, :func:`dg3d_stencil_residual` and
:func:`gc_stencil_residual` are the public ops. A CUDA tensor goes to the
kernel, or the call raises: there is no fallback to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from srm_tpu_torch.kernels.build import load_library
from srm_tpu_torch.ops.stencil import (average_faces, average_faces_3d, five_point_divergence,
                                       harmonic_faces, harmonic_faces_3d, neighbors,
                                       neighbors_3d, upstream_faces)

EPSILON = 1e-7

#: launches of the B1 (2D) kernel; the plain version never counts
launches = 0
#: launches of the B2 (3D) kernel; the plain version never counts
launches_3d = 0
#: launches of the B3 (gas-condensate) kernel; the plain version never counts
launches_gc = 0


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
# CUDA kernels
# ---------------------------------------------------------------------------
_FIELDS_2D = ("C", "krgo", "inv_dxx", "inv_dyy", "inv_D", "D", "dv", "dv_over_D", "phi",
              "phi_cf", "Sgi", "dv_Sgi_phi", "two_eps")


def _pack(struct_cls, cfg: StencilConfig):
    """StencilConfig's products, folded in double as JAX folds them from
    Python floats, then rounded to float in the kernel's struct."""
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
    inputs (GC_ARGS, qwell, tsteps), the outputs and the mbc scratch."""
    _fields_ = [(name, ctypes.c_void_p) for name in GC_ARGS + (
        "qwell", "tsteps", "dom_g", "dom_o", "ibc", "trn_g", "trn_o", "partial_g",
        "partial_o", "mbc_g", "mbc_o")]


def _pack_gc(cfg: GCStencilConfig) -> _ScalarsGC:
    """GCStencilConfig's products, folded in double as JAX folds them from
    Python floats, then rounded to float in the kernel's struct."""
    dv = cfg.dx * cfg.dy * cfg.dz
    return _ScalarsGC(C=cfg.C, inv_dxx=1.0 / (cfg.dx * cfg.dx), inv_dyy=1.0 / (cfg.dy * cfg.dy),
                      D=cfg.D, dv=dv, dv_over_D=dv / cfg.D, phi=cfg.phi,
                      phi_cf=cfg.phi * rock_compressibility(cfg.phi), So_max=1.0 - cfg.Swmin,
                      rte=EPSILON * 0.25)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("dg_stencil.cu")
    lib.dg_stencil_num_blocks.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.dg_stencil_num_blocks.restype = ctypes.c_int
    lib.dg_stencil_forward.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 3
                                       + [_Scalars, ctypes.c_void_p])
    lib.dg_stencil_forward.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _library_3d() -> ctypes.CDLL:
    lib = load_library("dg3d_stencil.cu")
    lib.dg3d_stencil_num_blocks.argtypes = [ctypes.c_int] * 3
    lib.dg3d_stencil_num_blocks.restype = ctypes.c_int
    lib.dg3d_stencil_forward.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 4
                                         + [_Scalars3D, ctypes.c_void_p])
    lib.dg3d_stencil_forward.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _library_gc() -> ctypes.CDLL:
    lib = load_library("gc_stencil.cu")
    lib.gc_stencil_num_blocks.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.gc_stencil_num_blocks.restype = ctypes.c_int
    lib.gc_stencil_forward.argtypes = ([ctypes.POINTER(_PointersGC)] + [ctypes.c_int] * 3
                                       + [_ScalarsGC, ctypes.c_void_p])
    lib.gc_stencil_forward.restype = ctypes.c_int
    return lib


def _launch(fn, q, n_blocks, ins, dims, scalars):
    """Allocate the outputs and the (B, n_blocks) mbc scratch, call the C
    launcher on the current stream, raise on a refused launch."""
    B = q.shape[0]
    dom, ibc, tde = (torch.empty_like(q) for _ in range(3))
    mbc = torch.empty((B,), dtype=q.dtype, device=q.device)
    partial = torch.empty((B, n_blocks), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*(t.data_ptr() for t in tuple(ins) + (dom, ibc, tde, partial, mbc)),
                 *dims, scalars, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {err} at launch")
    return dom, ibc, tde, mbc


def _cuda_forward(*args):
    global launches
    *ins, cfg = args
    lib = _library()
    B, H, W = ins[7].shape
    out = _launch(lib.dg_stencil_forward, ins[7], lib.dg_stencil_num_blocks(H, W), ins,
                  (B, H, W), _pack(_Scalars, cfg))
    launches += 1
    return out


def _cuda_forward_3d(*args):
    global launches_3d
    *ins, cfg = args
    lib = _library_3d()
    B, D, H, W = ins[8].shape
    out = _launch(lib.dg3d_stencil_forward, ins[8], lib.dg3d_stencil_num_blocks(D, H, W), ins,
                  (B, D, H, W), _pack(_Scalars3D, cfg))
    launches_3d += 1
    return out


def _cuda_forward_gc(*args):
    global launches_gc
    *ins, cfg = args
    lib = _library_gc()
    p0 = ins[0]
    B, H, W = p0.shape
    n_blocks = lib.gc_stencil_num_blocks(H, W)
    fields = [torch.empty_like(p0) for _ in range(5)]          # dom_g dom_o ibc trn_g trn_o
    partial = [torch.empty((B, n_blocks), dtype=p0.dtype, device=p0.device) for _ in range(2)]
    mbc = [torch.empty((B,), dtype=p0.dtype, device=p0.device) for _ in range(2)]
    ptrs = _PointersGC(*(t.data_ptr() for t in tuple(ins) + tuple(fields + partial + mbc)))
    with torch.cuda.device(p0.device):
        stream = torch.cuda.current_stream(p0.device).cuda_stream
        err = lib.gc_stencil_forward(ctypes.byref(ptrs), B, H, W, _pack_gc(cfg), stream)
    if err != 0:
        raise RuntimeError(f"gc_stencil_forward: CUDA error {err} at launch")
    launches_gc += 1
    return tuple(fields) + tuple(mbc)


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
    Backward: autograd through the recomputed plain version."""

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
        return _plain_backward(dg_stencil_residual_reference, ctx, grads)


class DG3DStencilResidualFn(torch.autograd.Function):
    """B2. Forward: the kernel (the plain version for CPU tensors).
    Backward: autograd through the recomputed plain version."""

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
        return _plain_backward(dg3d_stencil_residual_reference, ctx, grads)


class GCStencilResidualFn(torch.autograd.Function):
    """B3. Forward: the kernel (the plain version for CPU tensors).
    Backward: autograd through the recomputed plain version."""

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
        return _plain_backward(gc_stencil_residual_reference, ctx, grads)


def _check(tensors: dict, want: dict):
    """float32, the expected shapes, contiguous, one device — or raise."""
    first, device = next((k, t.device) for k, t in tensors.items())
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must have shape {want[name]}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, {first} on {device}")


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
    """
    if q.dim() != 3:
        raise ValueError(f"q must be (B, H, W), got {tuple(q.shape)}")
    B, H, W = q.shape
    padded, centred = (B, H + 2, W + 2), (B, H, W)
    _check(dict(p0p=p0p, p1p=p1p, kxp=kxp, bgugp=bgugp, invBg0=invBg0, invBg1=invBg1,
                dinvBg0=dinvBg0, q=q, qwell=qwell, tsteps=tsteps),
           dict(p0p=padded, p1p=padded, kxp=padded, bgugp=padded, invBg0=centred,
                invBg1=centred, dinvBg0=centred, q=centred, qwell=(H, W), tsteps=(B, 2)))
    return DGStencilResidualFn.apply(p0p, p1p, kxp, bgugp, invBg0, invBg1, dinvBg0, q,
                                     qwell, tsteps, cfg)


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
    B, D, H, W = q.shape
    padded, centred = (B, D + 2, H + 2, W + 2), (B, D, H, W)
    _check(dict(p0p=p0p, p1p=p1p, kxp=kxp, kzp=kzp, bgugp=bgugp, invBg0=invBg0,
                invBg1=invBg1, dinvBg0=dinvBg0, q=q, qwell=qwell, tsteps=tsteps),
           dict(p0p=padded, p1p=padded, kxp=padded, kzp=padded, bgugp=padded,
                invBg0=centred, invBg1=centred, dinvBg0=centred, q=centred,
                qwell=(D, H, W), tsteps=(B, 2)))
    return DG3DStencilResidualFn.apply(p0p, p1p, kxp, kzp, bgugp, invBg0, invBg1, dinvBg0,
                                       q, qwell, tsteps, cfg)


def gc_stencil_residual(*args) -> Tuple[torch.Tensor, ...]:
    """Fused gas-condensate two-phase residual (B3):
    (dom_g, dom_o, ibc, trn_g, trn_o, mbc_g, mbc_o).

    Args (B = batch, H/W = grid), all float32 and contiguous on one device:
    the 25 fields of :data:`GC_ARGS` in that order — padded (B, H+2, W+2)
    for the ten in :data:`GC_PADDED`, centred (B, H, W) for the others
    (p0 is centred) — then qwell (H, W), the well-cell indicator, tsteps
    (B, 2), the per-sample (Δt1, Δt2), and the :class:`GCStencilConfig`.
    """
    *tensors, cfg = args
    names = GC_ARGS + ("qwell", "tsteps")
    if len(tensors) != len(names) or not isinstance(cfg, GCStencilConfig):
        raise TypeError(f"gc_stencil_residual takes the {len(names)} tensors "
                        f"{', '.join(names)} and a GCStencilConfig")
    p0 = tensors[0]
    if p0.dim() != 3:
        raise ValueError(f"p0 must be (B, H, W), got {tuple(p0.shape)}")
    B, H, W = p0.shape
    want = {n: (B, H + 2, W + 2) if n in GC_PADDED else (B, H, W) for n in GC_ARGS}
    want.update(qwell=(H, W), tsteps=(B, 2))
    _check(dict(zip(names, tensors)), want)
    return GCStencilResidualFn.apply(*tensors, cfg)
