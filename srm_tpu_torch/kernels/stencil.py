"""Fused dry-gas stencil residual: CUDA kernel, plain version, gradient.

Port of ``srm_tpu/kernels/stencil_pallas.py::dg_stencil_residual`` (kernel
B1). Three pieces, as in the reference:

* :func:`dg_stencil_residual_reference` — the plain PyTorch version, a
  straight batched port of ``_residual_math`` / ``_jnp_forward``
  (``stencil_pallas.py:57-103, 151-160``). The CPU path and the checks of
  the kernel use it.
* the CUDA kernel ``csrc/dg_stencil.cu``, built with ``nvcc`` for
  ``sm_90a`` at first use and called through ctypes on PyTorch's current
  stream. ``launches`` counts its launches.
* :class:`DGStencilResidualFn` — the ``torch.autograd.Function``: forward
  through the kernel (or, for tensors on the CPU, the plain version);
  backward recomputes the plain version and differentiates it, as the
  reference's ``jax.custom_vjp`` differentiates its jnp twin
  (``stencil_pallas.py:568-571``). A hand-written backward kernel is later
  work.

:func:`dg_stencil_residual` is the public op. A CUDA tensor goes to the
kernel, or the call raises: there is no fallback to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from srm_tpu_torch.kernels.build import load_library
from srm_tpu_torch.ops.stencil import average_faces, five_point_divergence, harmonic_faces, neighbors

EPSILON = 1e-7

#: number of launches of the CUDA kernel (the plain version never counts)
launches = 0


class StencilConfig(NamedTuple):
    C: float
    D: float
    dx: float
    dy: float
    dz: float
    Sgi: float
    krgo: float          # constant DG relperm at Sgi
    phi: float           # constant porosity


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


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------
class _Scalars(ctypes.Structure):
    """``DGStencilScalars`` of csrc/dg_stencil.cu: StencilConfig's products,
    folded in double as JAX folds them from Python floats, then rounded."""
    _fields_ = [(name, ctypes.c_float) for name in (
        "C", "krgo", "inv_dxx", "inv_dyy", "inv_D", "D", "dv", "dv_over_D", "phi",
        "phi_cf", "Sgi", "dv_Sgi_phi", "two_eps")]

    @classmethod
    def from_config(cls, cfg: StencilConfig) -> "_Scalars":
        dv = cfg.dx * cfg.dy * cfg.dz
        return cls(C=cfg.C, krgo=cfg.krgo, inv_dxx=1.0 / (cfg.dx * cfg.dx),
                   inv_dyy=1.0 / (cfg.dy * cfg.dy), inv_D=1.0 / cfg.D, D=cfg.D, dv=dv,
                   dv_over_D=dv / cfg.D, phi=cfg.phi,
                   phi_cf=cfg.phi * rock_compressibility(cfg.phi), Sgi=cfg.Sgi,
                   dv_Sgi_phi=dv * cfg.Sgi * cfg.phi, two_eps=2.0 * EPSILON)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("dg_stencil.cu")
    lib.dg_stencil_num_blocks.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.dg_stencil_num_blocks.restype = ctypes.c_int
    lib.dg_stencil_forward.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 3
                                       + [_Scalars, ctypes.c_void_p])
    lib.dg_stencil_forward.restype = ctypes.c_int
    return lib


def _cuda_forward(p0p, p1p, kxp, bgugp, invBg0, invBg1, dinvBg0, q, qwell, tsteps,
                  cfg: StencilConfig):
    global launches
    lib = _library()
    B, H, W = q.shape
    dom, ibc, tde = (torch.empty_like(q) for _ in range(3))
    mbc = torch.empty((B,), dtype=q.dtype, device=q.device)
    partial = torch.empty((B, lib.dg_stencil_num_blocks(H, W)), dtype=q.dtype, device=q.device)
    ins = (p0p, p1p, kxp, bgugp, invBg0, invBg1, dinvBg0, q, qwell, tsteps)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dg_stencil_forward(
            *(t.data_ptr() for t in ins + (dom, ibc, tde, partial, mbc)),
            B, H, W, _Scalars.from_config(cfg), stream)
    if err != 0:
        raise RuntimeError(f"dg_stencil_forward: CUDA error {err} at launch")
    launches += 1
    return dom, ibc, tde, mbc


# ---------------------------------------------------------------------------
# public op
# ---------------------------------------------------------------------------
class DGStencilResidualFn(torch.autograd.Function):
    """Forward: the kernel (the plain version for CPU tensors). Backward:
    autograd through the recomputed plain version."""

    @staticmethod
    def forward(ctx, p0p, p1p, kxp, bgugp, invBg0, invBg1, dinvBg0, q, qwell, tsteps, cfg):
        args = (p0p, p1p, kxp, bgugp, invBg0, invBg1, dinvBg0, q, qwell, tsteps)
        ctx.save_for_backward(*args)
        ctx.cfg = cfg
        if q.is_cuda:
            return _cuda_forward(*args, cfg)
        return dg_stencil_residual_reference(*args, cfg)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:len(saved)]
        args = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
        with torch.enable_grad():
            outs = dg_stencil_residual_reference(*args, ctx.cfg)
        wanted = [a for a, n in zip(args, need) if n]
        live = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in live], wanted, [g for _, g in live],
                                       allow_unused=True)
                   if wanted and live else [None] * len(wanted))
        return tuple(next(got) if n else None for n in need) + (None,)


def _check(p0p, p1p, kxp, bgugp, invBg0, invBg1, dinvBg0, q, qwell, tsteps):
    if q.dim() != 3:
        raise ValueError(f"q must be (B, H, W), got {tuple(q.shape)}")
    B, H, W = q.shape
    want = {"p0p": (B, H + 2, W + 2), "p1p": (B, H + 2, W + 2), "kxp": (B, H + 2, W + 2),
            "bgugp": (B, H + 2, W + 2), "invBg0": (B, H, W), "invBg1": (B, H, W),
            "dinvBg0": (B, H, W), "q": (B, H, W), "qwell": (H, W), "tsteps": (B, 2)}
    got = dict(p0p=p0p, p1p=p1p, kxp=kxp, bgugp=bgugp, invBg0=invBg0, invBg1=invBg1,
               dinvBg0=dinvBg0, q=q, qwell=qwell, tsteps=tsteps)
    for name, t in got.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must have shape {want[name]}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def dg_stencil_residual(p0p, p1p, kxp, bgugp, invBg0, invBg1, dinvBg0, q, qwell, tsteps,
                        cfg: StencilConfig) -> Tuple[torch.Tensor, ...]:
    """Fused DG residual: (dom, ibc, tde, mbc) from padded/centred fields.

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
    _check(p0p, p1p, kxp, bgugp, invBg0, invBg1, dinvBg0, q, qwell, tsteps)
    return DGStencilResidualFn.apply(p0p, p1p, kxp, bgugp, invBg0, invBg1, dinvBg0, q,
                                     qwell, tsteps, cfg)
