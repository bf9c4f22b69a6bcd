"""PhysicsLoss: finite-volume PDE residual loss over the multi-model SRM.

Port of ``srm_tpu/losses/physics_loss.py`` in physics, data and mixed mode
(``physics_mode_fraction``, with ``td_loss_normalization`` and
``sg_td_focus``), with Model 2 on a strided input (``dt_input_stride``),
rematerialized network forwards (``remat_forwards``) and a scalar or
per-cell porosity: dry gas in 2D (Nz = 1) and 3D (Nz > 1), ``_residuals_dg``
(``:493-574``) and ``_residuals_dg_3d`` (``:576-653``, its fused branch),
and gas condensate in 2D, ``_residuals_gc`` (``:694-793``, its fused
branch ``:743-771``), and in 3D, ``_residuals_gc_3d`` (``:795-960``);
``loss_and_metrics`` (``:971-1055``; its sums and counts are
:meth:`PhysicsLoss.weighted_sse`'s), ``pinn_batch_sse_grad``
(``:1057-1074``) and ``per_term_grad_norms`` (``:1076-1107``). Under a
data-parallel mesh (:meth:`PhysicsLoss.set_mesh`, set by the trainer) each
rank evaluates its block of the batch, and the statistics that the JAX
package takes over its mesh's whole batch (the label stds of
``td_loss_normalization``, the Sg focus's mean) are taken over every
rank's block.
:meth:`PhysicsLoss.residuals` dispatches on the fluid and on ``Nz > 1``,
as the reference does (``:473-480``).

One evaluation: Model 2 gives the per-sample Δt1 on ``x`` and Δt2 on ``x1``
(``x`` with its time channel shifted by the normalized Δt1); Model 1 (and,
for gas condensate, Model 1S with its Sg clipped to [0, Sgi]) and the PVT
run once on the doubled batch ``[x; x1]``; the well model gives rates and
BHP at n1; the fused stencil (``srm_tpu_torch.kernels.stencil``: B1 for dry
gas in 2D, B2 in 3D, B3 for gas condensate in 2D) gives the residual fields
and tank balances; the weighted SSE sums the terms of each phase (gas, and
oil for gas condensate). In 3D the vertical permeability is
``vertical_anisotropy · kx``, padded and passed to the stencil pre-scaled.
Every network forward goes through :meth:`PhysicsLoss._net`.

``use_cuda_stencil`` mirrors the reference's ``use_pallas_stencil``
(``:269-275``, ``:321-328``): it is on where the models live on a GPU and
off on the CPU, as the reference's is on a TPU only, and off with a
per-cell porosity (the kernels take a scalar one; logged) and for gas
condensate in 3D (no fused op in either package). On, the residual goes
through the fused op, which launches the CUDA kernel. Off, each fluid runs
the port of the reference's unfused residual, which sums the well rates and
the accumulation of each tank balance apart: :func:`dg_residual_from_fields`
(``:73-125``) for dry gas in 2D, :func:`dg3d_residual_from_fields` (the
inline branch ``:655-685``) in 3D, :func:`gc_residual_from_fields`
(``:128-249``) for gas condensate in 2D and :func:`gc3d_residual_from_fields`
(``:795-960``) in 3D, each with the loss's porosity field.

Feature layout: ``x`` is the woven normalized tensor, ``(B, 1, H, W, 5)``
in 2D and ``(B, 1, D, H, W, 5)`` in 3D, with channels
``(z, y, x, time, permx)``.

On a mesh's space axis (:meth:`PhysicsLoss.set_mesh` with a
``make_mesh(n, spatial=k)``) each rank evaluates its rows of H
(``self.rows``, ``parallel/halo.py``): the networks and the ghost-cell pads
take their halos from the neighbours, the kernels run unchanged on the
halo-padded block, the well grids, the porosity field and the well-cell
indicator are the block's rows, and the strided Δt input keeps the global
phase of ``::s``. A per-sample mean (Δt) is a local sum over the whole
grid's count, summed over the space group; a per-sample sum (the tank
balances' mbc) is summed over it. A term that is then equal on every rank
of a space group (mbc²) is counted on its space rank 0 only, since the
trainer sums the loss over every rank; the cell terms stay local. The
counts that :meth:`PhysicsLoss.weighted_sse` returns are the whole grid's.
With ``remat_forwards`` the backward pass recomputes each network's forward
whole, its halo exchanges included, in the same order on every rank.
"""

from __future__ import annotations

import functools
import logging
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from srm_tpu_torch.config import (
    DEFAULT_GENERAL_CONFIG,
    DEFAULT_RESERVOIR_CONFIG,
    DEFAULT_SCAL_CONFIG,
    DEFAULT_WELLS_CONFIG,
    get_conversion_constants,
    get_optimizer_model_mapping,
)
from srm_tpu_torch.kernels.stencil import (EPSILON, GC_ARGS, GC_PADDED, GCStencilConfig,
                                           StencilConfig, dg3d_stencil_residual,
                                           dg_stencil_residual, gc_stencil_residual)
from srm_tpu_torch.ops.stencil import (average_faces, average_faces_3d, five_point_divergence,
                                       harmonic_faces, harmonic_faces_3d, neighbors,
                                       neighbors_3d, pad_symmetric, pad_symmetric_3d,
                                       seven_point_divergence, upstream_faces,
                                       upstream_faces_3d)
from srm_tpu_torch.parallel.halo import Rows, sum_over_space
from srm_tpu_torch.parallel.mesh import mean_over
from srm_tpu_torch.physics.relperm import RelativePermeability, clip
from srm_tpu_torch.physics.wells import scatter_to_grid
from srm_tpu_torch.utils.stats import denormalize, normalize_diff

log = logging.getLogger(__name__)

# loss-term order (the reference's LOSS_TERMS)
LOSS_TERMS = ("dom", "dbc", "nbc", "ibc", "ic", "mbc", "cmbc", "tde", "td")


def dg_residual_from_fields(p0, p1, invBg0, invBg1, bgug1, dinvBg0, q1c, q_well, kx_c, phi_c,
                            t1, t2, krgo, C: float, D: float, dx: float, dy: float, dz: float,
                            Sgi: float, rows=None):
    """Dry-gas 5-point residual from centred (B, H, W) fields, the
    reference's unfused ``dg_residual_from_fields`` (``:73-125``) with its
    operation order: (dom, ibc, mbc, tde). ``bgug1`` is invBg1·invug1 (the
    reference forms that product inside), ``phi_c`` a porosity field, ``t1``
    and ``t2`` are (B, 1, 1) and ``krgo`` the relperm at Sgi. Unlike the
    fused op, the tank balance sums the well rates and the accumulation
    apart. ``rows``: the fields' rows of H on a space axis (their pads take
    the neighbours' rows; mbc is then this block's partial sum)."""
    dv = dx * dy * dz
    kx_ih, kx_i_h, ky_jh, ky_j_h = harmonic_faces(neighbors(pad_symmetric(kx_c, rows)))
    cf = 97.32e-6 / (1.0 + 55.8721 * phi_c**1.428586)
    pn = neighbors(pad_symmetric(p1, rows))
    b_ih, b_i_h, b_jh, b_j_h = average_faces(neighbors(pad_symmetric(bgug1, rows)))
    cr0 = phi_c * cf * invBg0
    cp1 = Sgi * (phi_c * dinvBg0 + cr0)
    inv_dxx = 1.0 / (dx * dx)
    inv_dyy = 1.0 / (dy * dy)
    a1 = C * kx_i_h * krgo * b_i_h * inv_dxx
    a2 = C * ky_j_h * krgo * b_j_h * inv_dyy
    a3 = C * kx_ih * krgo * b_ih * inv_dxx
    a4 = C * ky_jh * krgo * b_jh * inv_dyy
    a5 = (1.0 / D) * (cp1 / t1)
    p2 = (p1 - p0) * (1.0 + t2 / torch.clamp_min(t1, 1e-12)) + p0
    tde = (dv / D) * cp1 * (2.0 * EPSILON / t1
                            + (t2 * p0 + t1 * p2 - (t1 + t2) * p1) / (t1 * t2 + t2**2))
    divq = five_point_divergence(a3, a1, a4, a2, pn, q1c / dv, dv)
    dom = divq + dv * a5 * (p1 - p0)
    ibc = q_well * divq
    mbc = (-q1c.sum(dim=(1, 2))
           - (dv * Sgi * phi_c * (invBg1 - invBg0) / (D * t1)).sum(dim=(1, 2)))
    return dom, ibc, mbc, tde


def dg3d_residual_from_fields(p0, p1, invBg0, invBg1, bgug1, dinvBg0, q1c, q_well, kx_c, kz_c,
                              phi_c, t1, t2, krgo, C: float, D: float, dx: float, dy: float,
                              dz: float, Sgi: float, rows=None):
    """Dry-gas 7-point residual from centred (B, D, H, W) fields, the
    reference's unfused 3D branch (``_residuals_dg_3d``, ``:655-685``) with
    its operation order: (dom, ibc, mbc, tde). As
    :func:`dg_residual_from_fields`, with ``kz_c`` the vertical permeability
    (vertical_anisotropy·kx), ``t1``, ``t2`` (B, 1, 1, 1) and ``rows`` as
    there."""
    dv = dx * dy * dz
    kx_ih, kx_i_h, ky_jh, ky_j_h, kz_kh, kz_k_h = harmonic_faces_3d(
        neighbors_3d(pad_symmetric_3d(kx_c, rows)), neighbors_3d(pad_symmetric_3d(kz_c, rows)))
    cf = 97.32e-6 / (1.0 + 55.8721 * phi_c**1.428586)
    pn = neighbors_3d(pad_symmetric_3d(p1, rows))
    b_ih, b_i_h, b_jh, b_j_h, b_kh, b_k_h = average_faces_3d(
        neighbors_3d(pad_symmetric_3d(bgug1, rows)))
    cr0 = phi_c * cf * invBg0
    cp1 = Sgi * (phi_c * dinvBg0 + cr0)
    inv_dxx = 1.0 / (dx * dx)
    inv_dyy = 1.0 / (dy * dy)
    inv_dzz = 1.0 / (dz * dz)
    a1 = C * kx_i_h * krgo * b_i_h * inv_dxx
    a2 = C * ky_j_h * krgo * b_j_h * inv_dyy
    a3 = C * kx_ih * krgo * b_ih * inv_dxx
    a4 = C * ky_jh * krgo * b_jh * inv_dyy
    a5 = C * kz_k_h * krgo * b_k_h * inv_dzz
    a6 = C * kz_kh * krgo * b_kh * inv_dzz
    a_acc = (1.0 / D) * (cp1 / t1)
    p2 = (p1 - p0) * (1.0 + t2 / torch.clamp_min(t1, 1e-12)) + p0
    tde = (dv / D) * cp1 * (2.0 * EPSILON / t1
                            + (t2 * p0 + t1 * p2 - (t1 + t2) * p1) / (t1 * t2 + t2**2))
    divq = seven_point_divergence(a3, a1, a4, a2, a6, a5, pn, q1c / dv, dv)
    dom = divq + dv * a_acc * (p1 - p0)
    ibc = q_well * divq
    axes = tuple(range(1, q1c.dim()))
    mbc = -q1c.sum(dim=axes) - (dv * Sgi * phi_c * (invBg1 - invBg0) / (D * t1)).sum(dim=axes)
    return dom, ibc, mbc, tde


def gc_residual_from_fields(p0, p1, Sg0, Sg1, invBg0, invBo0, Rs0, Rv0, invBg1, invBo1, invug1,
                            invuo1, Rs1, Rv1, dinvBg0, dinvBo0, dRs0, dRv0, krgo1, krog1,
                            qfg1c, qdg1c, qfo1c, qvo1c, q_well, kx_c, phi_c, t1, t2,
                            C: float, D: float, dx: float, dy: float, dz: float, Swmin: float,
                            rows=None):
    """Gas-condensate two-phase residual from centred (B, H, W) fields, the
    reference's unfused ``gc_residual_from_fields`` (``:128-249``) with its
    operation order: (dom_g, dom_o, ibc, mbc_g, mbc_o, trn_g, trn_o).
    ``phi_c`` is a porosity field, ``t1`` and ``t2`` are (B, 1, 1). Unlike the
    fused op, each tank balance sums the well rates and the accumulation
    apart, so the small accumulation is not rounded into the large well
    rate cell by cell. ``rows`` as in :func:`dg_residual_from_fields`."""
    return _gc_residual(p0, p1, Sg0, Sg1, invBg0, invBo0, Rs0, Rv0, invBg1, invBo1, invug1,
                        invuo1, Rs1, Rv1, dinvBg0, dinvBo0, dRs0, dRv0, krgo1, krog1,
                        (qfg1c, qdg1c, qfo1c, qvo1c), q_well, kx_c, None, phi_c, t1, t2,
                        C, D, dx, dy, dz, Swmin, rows)


def gc3d_residual_from_fields(p0, p1, Sg0, Sg1, invBg0, invBo0, Rs0, Rv0, invBg1, invBo1,
                              invug1, invuo1, Rs1, Rv1, dinvBg0, dinvBo0, dRs0, dRv0, krgo1,
                              krog1, qfg1c, qdg1c, qfo1c, qvo1c, q_well, kx_c, kz_c, phi_c, t1,
                              t2, C: float, D: float, dx: float, dy: float, dz: float,
                              Swmin: float, rows=None):
    """Gas-condensate two-phase 7-point residual from centred (B, D, H, W)
    fields, the reference's ``_residuals_gc_3d`` (``:795-960``) with its
    operation order: as :func:`gc_residual_from_fields`, with the four
    upstream-weighted fluxes over six faces, ``kz_c`` the vertical
    permeability (vertical_anisotropy·kx) and ``t1``, ``t2`` (B, 1, 1, 1)."""
    return _gc_residual(p0, p1, Sg0, Sg1, invBg0, invBo0, Rs0, Rv0, invBg1, invBo1, invug1,
                        invuo1, Rs1, Rv1, dinvBg0, dinvBo0, dRs0, dRv0, krgo1, krog1,
                        (qfg1c, qdg1c, qfo1c, qvo1c), q_well, kx_c, kz_c, phi_c, t1, t2,
                        C, D, dx, dy, dz, Swmin)


def _gc_residual(p0, p1, Sg0, Sg1, invBg0, invBo0, Rs0, Rv0, invBg1, invBo1, invug1, invuo1,
                 Rs1, Rv1, dinvBg0, dinvBo0, dRs0, dRv0, krgo1, krog1, rates, q_well, kx_c,
                 kz_c, phi_c, t1, t2, C, D, dx, dy, dz, Swmin, rows=None):
    """The two-phase residual of :func:`gc_residual_from_fields` (2D,
    ``kz_c`` None) and :func:`gc3d_residual_from_fields` (3D): the cell-local
    statements are the same in the reference's two branches, the faces and
    the divergence are the 5- or 7-point ones."""
    dv = dx * dy * dz
    if kz_c is None:
        pad = functools.partial(pad_symmetric, rows=rows)
        nb, div = neighbors, five_point_divergence
        kfaces = harmonic_faces(nb(pad(kx_c)))
        faces, upstream = average_faces, upstream_faces
        inv_d = (1.0 / (dx * dx),) * 2 + (1.0 / (dy * dy),) * 2
    else:
        pad = functools.partial(pad_symmetric_3d, rows=rows)
        nb, div = neighbors_3d, seven_point_divergence
        kfaces = harmonic_faces_3d(nb(pad(kx_c)), nb(pad(kz_c)))
        faces, upstream = average_faces_3d, upstream_faces_3d
        inv_d = ((1.0 / (dx * dx),) * 2 + (1.0 / (dy * dy),) * 2
                 + (1.0 / (dz * dz),) * 2)
    cf = 97.32e-6 / (1.0 + 55.8721 * phi_c**1.428586)
    So0 = 1.0 - Swmin - Sg0
    So1 = 1.0 - Swmin - Sg1

    RsinvBo0, RvinvBg0 = Rs0 * invBo0, Rv0 * invBg0
    RsinvBo1, RvinvBg1 = Rs1 * invBo1, Rv1 * invBg1
    mg0 = phi_c * (invBg0 * Sg0 + RsinvBo0 * So0)
    mo0 = phi_c * (invBo0 * So0 + RvinvBg0 * Sg0)
    mg1 = phi_c * (invBg1 * Sg1 + RsinvBo1 * So1)
    mo1 = phi_c * (invBo1 * So1 + RvinvBg1 * Sg1)
    ratio = 1.0 + t2 / torch.clamp_min(t1, 1e-12)
    mg2 = (mg1 - mg0) * ratio + mg0
    mo2 = (mo1 - mo0) * ratio + mo0

    rte = EPSILON * 0.25
    denom_t = t1 * t2 + t2**2
    trn_g = (dv / D) * (rte / t1 + (t2 * mg0 + t1 * mg2 - (t1 + t2) * mg1) / denom_t)
    trn_o = (dv / D) * (rte / t1 + (t2 * mo0 + t1 * mo2 - (t1 + t2) * mo1) / denom_t)

    pn = nb(pad(p1))
    kr_g = upstream(nb(pad(krgo1)), pn)
    kr_o = upstream(nb(pad(krog1)), pn)

    def favg(f):
        return faces(nb(pad(f)))

    bgug_faces = favg(invBg1 * invug1)
    bouo_faces = favg(invBo1 * invuo1)
    rvbgug_faces = favg(Rv1 * invBg1 * invug1)
    rsbouo_faces = favg(Rs1 * invBo1 * invuo1)

    # the chord slope's safe_dp form: no NaN gradient where dp = 0
    dp = p1 - p0
    moving = dp.abs() > 0
    safe_dp = torch.where(moving, dp, torch.ones_like(dp))
    d_Sg = torch.where(moving, (Sg1 - Sg0) / safe_dp, torch.zeros_like(dp))
    d_So = torch.where(moving, (So1 - So0) / safe_dp, torch.zeros_like(dp))

    d_RsinvBo = Rs0 * dinvBo0 + invBo0 * dRs0
    d_RvinvBg = Rv0 * dinvBg0 + invBg0 * dRv0

    cprgg = phi_c * cf * invBg0
    cprgo = phi_c * cf * RsinvBo0
    cproo = phi_c * cf * invBo0
    cprog = phi_c * cf * RvinvBg0

    def trans(kr_faces, prop_faces):
        return tuple(C * kf * kr * pr * iv
                     for kf, kr, pr, iv in zip(kfaces, kr_faces, prop_faces, inv_d))

    agg = trans(kr_g, bgug_faces)
    ago = trans(kr_o, rsbouo_faces)
    aoo = trans(kr_o, bouo_faces)
    aog = trans(kr_g, rvbgug_faces)

    inv_Dt = 1.0 / (D * t1)
    cpgg = inv_Dt * (phi_c * invBg1 * d_Sg + Sg0 * (phi_c * dinvBg0 + cprgg)) * dp
    cpgo = inv_Dt * (phi_c * RsinvBo1 * d_So + So0 * (phi_c * d_RsinvBo + cprgo)) * dp
    cpoo = inv_Dt * (phi_c * invBo1 * d_So + So0 * (phi_c * dinvBo0 + cproo)) * dp
    cpog = inv_Dt * (phi_c * RvinvBg1 * d_Sg + Sg0 * (phi_c * d_RvinvBg + cprog)) * dp

    qfg1c, qdg1c, qfo1c, qvo1c = rates
    divq_gg = div(*agg, pn, qfg1c / dv, dv)
    divq_go = div(*ago, pn, qdg1c / dv, dv)
    divq_oo = div(*aoo, pn, qfo1c / dv, dv)
    divq_og = div(*aog, pn, qvo1c / dv, dv)

    dom_g = (divq_gg + dv * cpgg) + (divq_go + dv * cpgo)
    dom_o = (divq_oo + dv * cpoo) + (divq_og + dv * cpog)
    ibc = q_well * ((divq_gg + divq_go) + (divq_oo + divq_og))

    axes = tuple(range(1, qfg1c.dim()))
    mbc_gg = dv * inv_Dt * phi_c * (Sg1 * invBg1 - Sg0 * invBg0)
    mbc_go = dv * inv_Dt * phi_c * (So1 * RsinvBo1 - So0 * RsinvBo0)
    mbc_oo = dv * inv_Dt * phi_c * (So1 * invBo1 - So0 * invBo0)
    mbc_og = dv * inv_Dt * phi_c * (Sg1 * RvinvBg1 - Sg0 * RvinvBg0)
    mbc_g = -(qfg1c + qdg1c).sum(dim=axes) - (mbc_gg + mbc_go).sum(dim=axes)
    mbc_o = -(qfo1c + qvo1c).sum(dim=axes) - (mbc_oo + mbc_og).sum(dim=axes)
    return dom_g, dom_o, ibc, mbc_g, mbc_o, trn_g, trn_o


def porosity_field(res: Dict) -> Optional[np.ndarray]:
    """None for a scalar porosity, else the per-cell field as float32
    (Nz, Ny, Nx), from any array of the grid's cell count, (Ny, Nx),
    (Nz, Ny, Nx) or flat (``srm_tpu/losses/physics_loss.py:315-329``); a
    field of another cell count raises, as the simulator's
    ``_phi_from_config`` does."""
    poro = np.asarray(res["porosity"], np.float32)
    if poro.ndim == 0:
        return None
    n = res["Nz"] * res["Ny"] * res["Nx"]
    if poro.size != n:
        raise ValueError(f"porosity field has {poro.size} cells, grid has {n}")
    return poro.reshape(res["Nz"], res["Ny"], res["Nx"])


def fused_stencil_selected(device: torch.device, phi_field=None) -> bool:
    """Whether the loss computes its residual through the fused op (kernels
    B1-B3): on a CUDA device, unless the porosity is a per-cell field. The
    kernels take a scalar porosity, so a field runs the unfused residual on
    the card too, as the reference turns its Pallas stencil off
    (``srm_tpu/losses/physics_loss.py:325-328``); that choice is logged."""
    if device.type != "cuda":
        return False
    if phi_field is not None:
        log.info("per-cell porosity: fused CUDA stencil disabled (scalar-phi kernel); "
                 "using the unfused residual")
        return False
    return True


_LOGICAL_NAMES = {"pressure": "pressure", "time_step": "time_step",
                  "fluid_property": "pvt_model", "well_rate_bhp": "well_rate_bhp_model",
                  "saturation": "saturation_model"}


def untrainable_layers(module: torch.nn.Module) -> List[str]:
    """The layers of ``module`` that the reference's loss cannot run in its
    training forward: every BatchNorm, every residual block with dropout
    and every encoder–decoder with a dropout level, by name (none for a
    model that is a plain callable)."""
    from srm_tpu_torch.nn.encoder_decoder import EncoderDecoder
    from srm_tpu_torch.nn.residual import BatchNorm, ResidualBlock
    out = []
    named = module.named_modules() if isinstance(module, torch.nn.Module) else ()
    for n, m in named:
        if isinstance(m, BatchNorm):
            out.append(f"{n} (BatchNorm)")
        elif isinstance(m, ResidualBlock) and m.dropout_rate > 0:
            out.append(f"{n} (dropout {m.dropout_rate})")
        elif isinstance(m, EncoderDecoder) and m.has_dropout:
            out.append(f"{n or 'network'} (dropout {m.dropout_rate})")
    return out


class PhysicsLoss:
    """Dry-gas and gas-condensate PDE residual losses with per-model
    gradients."""

    def __init__(self, models: Dict[str, Any], data_summary,
                 optimizer_model_names_map: Optional[Dict[str, str]] = None,
                 general_config: Optional[Dict] = None,
                 reservoir_config: Optional[Dict] = None,
                 wells_config: Optional[Dict] = None,
                 scal_config: Optional[Dict] = None,
                 fluid_type: Optional[str] = None):
        self.models = models
        self.general_config = general_config or DEFAULT_GENERAL_CONFIG
        self.reservoir_config = res = reservoir_config or DEFAULT_RESERVOIR_CONFIG
        self.wells_config = wells_config or DEFAULT_WELLS_CONFIG
        self.scal_config = scal_config or DEFAULT_SCAL_CONFIG
        g = self.general_config
        self.fluid_type = (fluid_type or g["fluid_type"]).upper()
        self.physics_mode_fraction = float(g["physics_mode_fraction"])
        if self.fluid_type not in ("DG", "GC"):
            raise ValueError(f"Unknown fluid type: {self.fluid_type}. Use 'DG' or 'GC'.")
        # td (label) error scaling: None (raw), "balance" (the 2nd+ labels'
        # errors rescaled to the 1st label's batch std) or "label_std" (every
        # error over its label's batch std); the Sg td error's dropout focus
        self.td_normalization = g.get("td_loss_normalization")
        self.sg_td_focus = float(g.get("sg_td_focus") or 0.0)
        # Model 2 on a spatially strided input (its field is only averaged)
        self.dt_input_stride = int(g.get("dt_input_stride", 1) or 1)
        # every network forward recomputed in the backward pass (_net)
        self.remat_forwards = bool(g.get("remat_forwards", False))
        self.optimizer_model_names_map = (optimizer_model_names_map
                                          or get_optimizer_model_mapping(self.fluid_type))

        self.device = next(models["pressure"].parameters()).device
        # porosity: a scalar, or a per-cell field stored as (Nz, Ny, Nx) on
        # the device, phi0 its mean (:315-329)
        field = porosity_field(res)
        self.phi0 = float(res["porosity"]) if field is None else float(field.mean())
        self.phi_field = None if field is None else torch.from_numpy(field).to(self.device)
        self._phi_whole = self.phi_field
        # the 3D gas-condensate residual has no fused op, in either package
        self.use_cuda_stencil = (fused_stencil_selected(self.device, self.phi_field)
                                 and not (self.fluid_type == "GC" and res["Nz"] > 1))

        units = get_conversion_constants(g["srm_units"])
        self.C, self.D = units["C"], units["D"]
        self.dx = res["length"] / res["Nx"]
        self.dy = res["width"] / res["Ny"]
        self.dz = res["thickness"] / res["Nz"]
        self.Swmin = self.scal_config["end_points"]["Swmin"]
        self.Sgi = 1.0 - self.Swmin
        self.relperm = RelativePermeability.from_config(
            self.scal_config["end_points"], self.scal_config["corey_exponents"])
        if self.fluid_type == "GC":
            self.stencil_cfg = GCStencilConfig(C=self.C, D=self.D, dx=self.dx, dy=self.dy,
                                               dz=self.dz, Swmin=self.Swmin, phi=self.phi0)
        else:
            krgo_sgi = float(self.relperm(torch.tensor(self.Sgi, dtype=torch.float32))[1])
            self.stencil_cfg = StencilConfig(C=self.C, D=self.D, dx=self.dx, dy=self.dy,
                                             dz=self.dz, Sgi=self.Sgi, krgo=krgo_sgi,
                                             phi=self.phi0)
            # the unfused residual's krgo, a device tensor made here: a step
            # captured in a CUDA graph may not copy from the host
            self.krgo_sgi = self.relperm(torch.tensor(self.Sgi, dtype=torch.float32,
                                                      device=self.device))[1]

        # well-cell indicator: (H, W) in 2D, (D, H, W) in 3D (:356-365)
        conn = models["well_rate_bhp_model"].well_data["connection_index"]
        self.Nz = res["Nz"]
        self.kv_kh = res.get("vertical_anisotropy", 1.0)
        grid = (scatter_to_grid((1, self.Nz, res["Ny"], res["Nx"]), conn, 1.0) if self.Nz > 1
                else scatter_to_grid((1, res["Ny"], res["Nx"]), conn[:, 1:], 1.0))
        self.q_well_idx = self._q_well_whole = torch.from_numpy(grid[0]).to(self.device)

        ds = data_summary
        nc = g["data_normalization"]
        self.norm = dict(method=nc["feature_normalization_method"],
                         limits=tuple(nc["normalization_limits"]))
        self.t_row = torch.from_numpy(ds.row("time")).to(self.device)
        self.k_row = torch.from_numpy(ds.row("permx")).to(self.device)
        self.k_is_log = ds.is_log("permx")

        # loss keys and weights per phase (:376-386)
        self.phases = ("gas",) if self.fluid_type == "DG" else ("gas", "oil")
        w = g["default_weights"]
        self.loss_keys = {ph: [f"{t}_{ph[0]}" for t in LOSS_TERMS] for ph in self.phases}
        self.weights = {ph: {"dom": w[ph]["dom"], "dbc": w[ph]["obc"], "nbc": w[ph]["obc"],
                             "ibc": w[ph]["ibc"], "ic": w[ph]["ic"], "mbc": w[ph]["mbc"],
                             "cmbc": w[ph]["cmbc"], "tde": w[ph]["tde"], "td": w[ph]["td"]}
                        for ph in self.phases}
        # the conv nets train, and the PVT where it is the polynomial one
        # (its coefficients); the spline PVT has no parameters (:387-400).
        # The optimizer config's "trainable": False is not read, as in the
        # reference (ROADMAP C20)
        trainable = {"pressure", "time_step", "saturation"}
        pvt = models.get("pvt_model")
        if getattr(getattr(pvt, "pvt_layer", pvt), "fitting_method", None) == "polynomial":
            trainable.add("fluid_property")
        self.trainable_models_keys = [k for k in self.optimizer_model_names_map
                                      if k in trainable]
        #: the data-parallel mesh whose ranks hold the rest of the batch
        #: (:meth:`set_mesh`); None: this process's batch is the batch
        self.mesh = None
        #: this rank's rows of H on a space axis (``parallel/halo.py``'s
        #: ``Rows``); None: the whole grid
        self.rows = None

    def set_mesh(self, mesh) -> None:
        """Take the whole-batch statistics of the loss (the label stds and
        the Sg focus's mean) and the well model's iteration logs over
        ``mesh``'s ranks, each of which evaluates its block of the batch;
        a mesh without a process group, or None, is this process alone. On
        a space axis this rank then evaluates its rows of H (``rows``): the
        well-cell indicator, the porosity field and the well grids become
        the block's."""
        self.mesh = mesh if mesh is not None and mesh.group is not None else None
        self.rows = (Rows.split(self.mesh, self.reservoir_config["Ny"])
                     if self.mesh is not None and self.mesh.space_size > 1 else None)
        lo, hi = (0, None) if self.rows is None else (self.rows.lo, self.rows.hi)
        self.q_well_idx = self._q_well_whole[..., lo:hi, :].contiguous()
        if self._phi_whole is not None:
            self.phi_field = self._phi_whole[..., lo:hi, :]
        well = self.models.get("well_rate_bhp_model")
        if well is not None:
            well.mesh = self.mesh
            well.set_rows(self.rows)

    @staticmethod
    def logical_name(optimizer_key: str) -> str:
        return _LOGICAL_NAMES[optimizer_key]

    # ------------------------------------------------------------------
    def _denorm_permx(self, k: torch.Tensor) -> torch.Tensor:
        return denormalize(k, self.k_row, is_log=self.k_is_log, **self.norm)

    def _norm_dt(self, dt: torch.Tensor) -> torch.Tensor:
        return normalize_diff(dt, self.t_row, is_log=False, **self.norm)

    def _phi(self, like: torch.Tensor) -> torch.Tensor:
        """The porosity on the field ``like``'s (B, [D,] H, W) shape: the
        scalar filled in, or the per-cell field broadcast (:405-411)."""
        if self.phi_field is None:
            return torch.full_like(like, self.phi0)
        phi = self.phi_field.reshape(self.phi_field.shape[-(like.dim() - 1):])
        return phi.to(like.dtype).expand(like.shape)

    def _net(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """One trainable model's forward (network and HardLayer), the
        reference's ``_net`` (``srm_tpu/losses/physics_loss.py:425-447``).
        Model 2 runs on every ``dt_input_stride``-th cell of the height and
        width axes of the channels-last input (never the depth or the
        channels). With ``remat_forwards`` the call is checkpointed as
        ``jax.checkpoint`` wraps ``mod.apply``: the backward pass recomputes
        the forward (its dtype casts included) instead of keeping its
        activations. No ported network draws random numbers, so the RNG
        state is neither saved nor restored, which a CUDA graph capture
        would not allow. On a space axis the recompute repeats the forward's
        halo exchanges inside the backward pass; it runs the whole forward
        (no early stop), so every rank issues the same messages in the same
        order whatever tensors its autograd graph saved. A network with
        dropout or BatchNorm is refused, as the reference's loss fails on it
        (:func:`untrainable_layers`)."""
        mod = self.models[name]
        refused = untrainable_layers(mod)
        if refused:
            raise ValueError(
                f"{name}: {', '.join(refused)} cannot run in the loss's training forward. The "
                f"reference's loss applies its networks with training=True and neither a "
                f"dropout rng nor a mutable batch_stats collection, which fails for these "
                f"layers (ROADMAP C19); evaluate them with training=False outside the loss")
        s = self.dt_input_stride
        rows = self.rows
        if name == "time_step" and s > 1:
            if rows is None:
                x = x[..., ::s, ::s, :]
            else:                                       # the global phase of ::s
                rows, start = rows.strided(s)
                x = x[..., start::s, ::s, :]
        if not self.remat_forwards:
            return mod(x) if rows is None else mod(x, rows=rows)
        if rows is None:
            return checkpoint(mod, x, use_reentrant=False, preserve_rng_state=False)
        with set_checkpoint_early_stop(False):
            return checkpoint(mod, x, use_reentrant=False, preserve_rng_state=False, rows=rows)

    def _dt_mean(self, f: torch.Tensor) -> torch.Tensor:
        """Each sample's Δt: the mean of Model 2's field (B, T, [D,] H, W, 1)
        over its cells; on a space axis the local sum over the whole
        (strided) grid's count, summed over the space group."""
        dims = tuple(range(1, f.dim() - 1))
        if self.rows is None:
            return f.mean(dim=dims, keepdim=True)
        rows = self.rows
        if self.dt_input_stride > 1:
            rows = rows.strided(self.dt_input_stride)[0]
        cells = math.prod(f.shape[1:-1]) // max(rows.count, 1) * rows.n
        return sum_over_space(f.sum(dim=dims, keepdim=True), self.mesh) / cells

    def _stencil_fields(self, f: torch.Tensor) -> torch.Tensor:
        """A model field (B, 1, H, W, 1) or (B, 1, D, H, W, 1) as the
        stencil's contiguous (B, H, W) or (B, D, H, W)."""
        return f.reshape((f.shape[0],) + tuple(f.shape[2:-1])).contiguous()

    def stencil_inputs(self, x: torch.Tensor) -> Tuple[Tuple[torch.Tensor, ...], Dict]:
        """The network forwards of one evaluation: the fused stencil's tensor
        arguments (ten for B1, eleven for B2, twenty-seven for B3, and in
        the B3 layout with 3D padding for the 3D gas-condensate residual,
        which has no fused op) and the model outputs
        (srm_tpu/losses/physics_loss.py:496-552, :600-644, :706-759,
        :820-856)."""
        m = self.models
        vol = self._stencil_fields
        kx_c = vol(self._denorm_permx(x[..., 4:5]))                 # (B, [D,] H, W)
        pad = functools.partial(pad_symmetric_3d if self.Nz > 1 else pad_symmetric,
                                rows=self.rows)

        dt0f = self._net("time_step", x)
        tstep = self._dt_mean(dt0f)
        x1 = torch.cat([x[..., :3], x[..., 3:4] + self._norm_dt(tstep), x[..., 4:]], dim=-1)
        dt1f = self._net("time_step", x1)
        tstep2 = self._dt_mean(dt1f)
        tsteps = torch.cat([tstep.reshape(-1, 1), tstep2.reshape(-1, 1)], dim=1)

        # pressure, saturation and PVT at n0 and n1 as one doubled-batch forward
        B = x.shape[0]
        x01 = torch.cat([x, x1], dim=0)
        p01 = self._net("pressure", x01)
        pvt01 = m["pvt_model"](p01)
        p0f, p1f = p01[:B], p01[B:]
        pvt0, pvt1 = pvt01[:, :, :B], pvt01[:, :, B:]
        outputs = {"p_n0": p0f, "p_n1": p1f, "tstep": tstep, "tstep2": tstep2}
        well = m["well_rate_bhp_model"]

        if self.fluid_type == "GC":
            # Sg is pinned to Sgi at t0 by its HardLayer; clipped to the
            # physical range with JAX's gradient at the bounds (:717-718)
            Sg01 = clip(self._net("saturation_model", x01), 0.0, self.Sgi)
            Sg0f, Sg1f = Sg01[:B], Sg01[B:]
            q1, pwf1 = well.compute_rates_and_bhp(x1, p1f, m["pvt_model"], Sg_n1=Sg1f)
            # PVT rows (invBg, invBo, invug, invuo, Rs, Rv, Vro)
            invBg0, invBo0, _, _, Rs0, Rv0 = (vol(pvt0[0, i]) for i in range(6))
            invBg1, invBo1, invug1, invuo1, Rs1, Rv1 = (vol(pvt1[0, i]) for i in range(6))
            dinvBg0, dinvBo0, dRs0, dRv0 = (vol(pvt0[1, i]) for i in (0, 1, 4, 5))
            Sg0, Sg1 = vol(Sg0f), vol(Sg1f)
            krog1, krgo1 = self.relperm(Sg1)
            # the ten padded fields (GC_PADDED_ORDER) as one stacked pad
            p1p, kxp, krgo1p, krog1p, invBg1p, invBo1p, invug1p, invuo1p, Rs1p, Rv1p = pad(
                torch.stack([vol(p1f), kx_c, krgo1, krog1, invBg1, invBo1, invug1, invuo1, Rs1,
                             Rv1])).unbind(0)
            args = (vol(p0f), p1p, kxp, Sg0, Sg1, krgo1p, krog1p,
                    invBg0, invBo0, Rs0, Rv0, dinvBg0, dinvBo0, dRs0, dRv0,
                    invBg1p, invBo1p, invug1p, invuo1p, Rs1p, Rv1p,
                    *(vol(q) for q in q1), self.q_well_idx, tsteps)
            outputs.update(Sg_n0=Sg0f, Sg_n1=Sg1f, q=q1, pwf=pwf1)
            return args, outputs

        q1, pwf1 = well.compute_rates_and_bhp(x1, p1f, m["pvt_model"])
        invBg0, dinvBg0 = vol(pvt0[0, 0]), vol(pvt0[1, 0])
        invBg1, invug1 = vol(pvt1[0, 0]), vol(pvt1[0, 1])
        perm = [kx_c, self.kv_kh * kx_c] if self.Nz > 1 else [kx_c]
        # the padded fields (p0p, p1p, kxp[, kzp], bgugp) as one stacked pad
        args = pad(torch.stack([vol(p0f), vol(p1f), *perm, invBg1 * invug1])).unbind(0) + (
            invBg0, invBg1, dinvBg0, vol(q1), self.q_well_idx, tsteps)
        outputs.update(q=q1, pwf=pwf1)
        return args, outputs

    def _gc_unfused(self, *args):
        """:func:`gc_residual_from_fields` (2D) or
        :func:`gc3d_residual_from_fields` (3D, with kz = vertical_anisotropy
        · kx) on the fused op's arguments, whose padded fields they take
        back to their centres (they pad them themselves), with the loss's
        porosity."""
        qwell, tsteps = args[len(GC_ARGS):]
        inner = (slice(None),) + (slice(1, -1),) * qwell.dim()
        f = {n: a[inner] if n in GC_PADDED else a for n, a in zip(GC_ARGS, args)}
        shape = (-1,) + (1,) * qwell.dim()
        perm = (f["kxp"], self.kv_kh * f["kxp"]) if qwell.dim() == 3 else (f["kxp"],)
        fn = gc3d_residual_from_fields if qwell.dim() == 3 else gc_residual_from_fields
        cfg = self.stencil_cfg
        return fn(
            *(f[n] for n in ("p0", "p1p", "Sg0", "Sg1", "invBg0", "invBo0", "Rs0", "Rv0",
                             "invBg1p", "invBo1p", "invug1p", "invuo1p", "Rs1p", "Rv1p",
                             "dinvBg0", "dinvBo0", "dRs0", "dRv0", "krgo1p", "krog1p",
                             "qfg", "qdg", "qfo", "qvo")),
            qwell, *perm, self._phi(f["p0"]), tsteps[:, 0].reshape(shape),
            tsteps[:, 1].reshape(shape), cfg.C, cfg.D, cfg.dx, cfg.dy, cfg.dz, cfg.Swmin,
            self.rows)

    def _dg_unfused(self, *args):
        """:func:`dg_residual_from_fields` (2D) or
        :func:`dg3d_residual_from_fields` (3D) on the fused op's arguments,
        whose padded fields they take back to their centres (they pad them
        themselves), with the reference's krgo from the relperm at Sgi and
        the loss's porosity."""
        cfg = self.stencil_cfg
        *padded, invBg0, invBg1, dinvBg0, q, qwell, tsteps = args
        inner = (slice(None),) + (slice(1, -1),) * (q.dim() - 1)
        p0, p1, kx, *kz, bgug1 = (f[inner] for f in padded)
        shape = (-1,) + (1,) * (q.dim() - 1)
        fn = dg3d_residual_from_fields if kz else dg_residual_from_fields
        return fn(p0, p1, invBg0, invBg1, bgug1, dinvBg0, q, qwell, kx, *kz,
                  self._phi(p0), tsteps[:, 0].reshape(shape),
                  tsteps[:, 1].reshape(shape), self.krgo_sgi, cfg.C, cfg.D, cfg.dx, cfg.dy, cfg.dz,
                  cfg.Sgi, self.rows)

    def residuals(self, x: torch.Tensor) -> Dict[str, Any]:
        """Residual fields per phase (srm_tpu/losses/physics_loss.py:473-480,
        :493-574, :576-653, :694-793, :795-960). In 3D, dom, ibc and tde
        take the pressure field's (B, 1, D, H, W) layout, as the reference
        returns them."""
        args, outputs = self.stencil_inputs(x)
        shape = tuple(outputs["p_n0"].shape[:-1])
        if self.fluid_type == "GC":
            if self.use_cuda_stencil:
                dom_g, dom_o, ibc, trn_g, trn_o, mbc_g, mbc_o = gc_stencil_residual(
                    *args, self.stencil_cfg)
            else:
                dom_g, dom_o, ibc, mbc_g, mbc_o, trn_g, trn_o = self._gc_unfused(*args)
            # the blocks' partial tank balances, summed over the space group
            mbc_g, mbc_o = sum_over_space(mbc_g, self.mesh), sum_over_space(mbc_o, self.mesh)
            if self.Nz > 1:
                dom_g, dom_o, ibc, trn_g, trn_o = (f.reshape(shape) for f in (
                    dom_g, dom_o, ibc, trn_g, trn_o))
            zeros = torch.zeros_like(dom_g)
            return {
                "gas": {"dom": dom_g, "dbc": zeros, "nbc": zeros, "ibc": ibc, "ic": zeros,
                        "mbc": mbc_g, "cmbc": zeros, "tde": trn_g},
                "oil": {"dom": dom_o, "dbc": zeros, "nbc": zeros, "ibc": ibc, "ic": zeros,
                        "mbc": mbc_o, "cmbc": zeros, "tde": trn_o},
                "outputs": outputs,
            }
        if self.use_cuda_stencil:
            fn = dg3d_stencil_residual if self.Nz > 1 else dg_stencil_residual
            dom, ibc, tde, mbc = fn(*args, self.stencil_cfg)
        else:
            dom, ibc, mbc, tde = self._dg_unfused(*args)
        mbc = sum_over_space(mbc, self.mesh)
        if self.Nz > 1:
            dom, ibc, tde = (f.reshape(shape) for f in (dom, ibc, tde))
        zeros = torch.zeros_like(dom)
        return {
            "gas": {"dom": dom, "dbc": zeros, "nbc": zeros, "ibc": ibc, "ic": zeros,
                    "mbc": mbc, "cmbc": zeros, "tde": tde},
            "outputs": outputs,
        }

    def _data_outputs(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The model outputs of data mode: one forward, no residual
        (``srm_tpu/losses/physics_loss.py:1000-1008``)."""
        p0f = self._net("pressure", x)
        dt0f = self._net("time_step", x)
        outputs = {"p_n0": p0f, "p_n1": p0f, "tstep": self._dt_mean(dt0f)}
        if self.fluid_type == "GC":
            outputs["Sg_n0"] = clip(self._net("saturation_model", x), 0.0, self.Sgi)
        return outputs

    def _td_errors(self, outs: Dict[str, torch.Tensor], y) -> List[torch.Tensor]:
        """Each label's error (model output at n0 − label: the pressure, and
        for gas condensate Sg), scaled by ``td_loss_normalization`` and, for
        Sg, by the dropout focus (:1010-1031). The label stds are ddof 0, as
        ``jnp.std``, floored at 1e-8; they and the focus's mean are over the
        whole batch (:meth:`_label_statistics`)."""
        keys = ["PRESSURE"] if self.fluid_type == "DG" else ["PRESSURE", "SGAS"]
        labels = [y[k] for k in keys if k in y] if isinstance(y, dict) else [y]
        model_out = [outs["p_n0"]] + ([outs["Sg_n0"]] if self.fluid_type == "GC" else [])
        labels = [lab.reshape(out.shape) for lab, out in zip(labels, model_out)]
        td = [out - lab for lab, out in zip(labels, model_out)]
        scaled = self.td_normalization in ("label_std", "balance")
        focus = self.sg_td_focus > 0.0 and len(td) > 1
        # the Sg focus weighs cells whose label departs from Sgi
        dev = (labels[1] - self.Sgi).abs() if focus else None
        stds, dev_mean = self._label_statistics(labels if scaled else [], dev)
        if self.td_normalization == "label_std":
            td = [e / s for e, s in zip(td, stds)]
        elif scaled and len(td) > 1:
            td = [td[0]] + [e * (stds[0] / s) for e, s in zip(td[1:], stds[1:])]
        if focus:
            # mean-1 weight toward cells whose Sg label departs from Sgi;
            # its square root, because the SSE squares it
            rel = dev / torch.clamp_min(dev_mean, 1e-12)
            w = (1.0 + self.sg_td_focus * rel) / (1.0 + self.sg_td_focus)
            td[1] = td[1] * torch.sqrt(w)
        return td

    def _label_statistics(self, labels: List[torch.Tensor], dev: Optional[torch.Tensor]):
        """The std (ddof 0, floored at 1e-8) of each label and the mean of
        ``dev`` (None: none) over the whole batch. The JAX package takes them
        over the global batch of its mesh (``jnp.std``, ``jnp.mean`` in one
        program), so under :attr:`mesh` they are taken over every rank's
        block, in two passes: the means (with ``dev``'s), then the mean
        squared deviations from them (a one-pass sum of squares in float32
        loses about four digits at 5,000 psia). Labels carry no gradient:
        the collectives need none."""
        if self.mesh is None:
            return ([torch.clamp_min(lab.std(correction=0), 1e-8) for lab in labels],
                    None if dev is None else dev.mean())
        means = mean_over(labels + ([] if dev is None else [dev]), self.mesh)
        var = mean_over([torch.square(lab - m) for lab, m in zip(labels, means)], self.mesh)
        return ([torch.clamp_min(torch.sqrt(v), 1e-8) for v in var],
                None if dev is None else means[-1])

    def weighted_sse(self, x: torch.Tensor, y):
        """(total, wsse, counts, outputs): the total weighted SSE, each
        phase's and term's weighted SSE and its error's element count (of
        this batch; a zero term's error may be a 0-dim zero) and the model
        outputs (:971-1055). Each phase's td term compares a model output at
        n0 with its label (the pressure for gas, Sg for oil).
        ``physics_mode_fraction`` f: f >= 1 is physics mode (td weight from
        the config, 0 by default); f == 0 is data mode (one forward, zero
        residuals, a td weight of 0 taken as 1); 0 < f < 1 is the
        reference's mixed mode (the physics weights scaled by f, the td
        weights, 0 taken as 1, by 1 − f)."""
        f_raw = self.physics_mode_fraction
        physics = f_raw >= 1.0
        f = min(max(f_raw, 0.0), 1.0)
        mixed = 0.0 < f < 1.0
        if physics or f_raw > 0.0:
            res = self.residuals(x)
            outs = res["outputs"]
        else:
            outs = self._data_outputs(x)
            zero = x.new_zeros(())
            res = {ph: {t: zero for t in LOSS_TERMS if t != "td"} for ph in self.phases}
        td = self._td_errors(outs, y)
        rows = self.rows
        # on a space axis, a per-sample term (mbc, equal on every rank of a
        # space group after its sum) is counted on space rank 0 only
        once = rows is not None and self.mesh.space_rank != 0
        total = x.new_zeros(())
        wsse: Dict[str, Dict[str, torch.Tensor]] = {ph: {} for ph in self.phases}
        counts: Dict[str, Dict[str, int]] = {ph: {} for ph in self.phases}
        for i, ph in enumerate(self.phases):
            for t in LOSS_TERMS:
                w = self.weights[ph][t]
                if t == "td":
                    err = td[i] if i < len(td) else x.new_zeros(())
                    if not physics and w == 0.0:
                        w = 1.0
                    if mixed:
                        w = w * (1.0 - f)
                else:
                    err = res[ph][t]
                    if mixed:
                        w = w * f
                cell = err.dim() >= 3
                if once and not cell:
                    w = 0.0
                wsse[ph][t] = w * torch.sum(torch.square(err))
                # the whole grid's count: this block's cells over its rows
                counts[ph][t] = (err.numel() // max(rows.count, 1) * rows.n
                                 if rows is not None and cell else err.numel())
                total = total + wsse[ph][t]
        return total, wsse, counts, outs

    def loss_and_metrics(self, x: torch.Tensor, y) -> Tuple[torch.Tensor, Dict]:
        """Total weighted SSE and the per-phase, per-term weighted MSEs
        (:971-1055; see :meth:`weighted_sse`), with the outputs under
        ``aux["outputs"]``."""
        total, wsse, counts, outs = self.weighted_sse(x, y)
        aux: Dict[str, Any] = {ph: {t: wsse[ph][t] / max(float(counts[ph][t]), 1.0)
                                    for t in LOSS_TERMS} for ph in self.phases}
        aux["outputs"] = outs
        return total, aux

    def gradients(self, total: torch.Tensor) -> Dict[str, List[torch.Tensor]]:
        """The gradient of ``total`` with respect to each trainable model's
        parameters, keyed by optimizer key, as lists in
        ``module.parameters()`` order (zeros where ``total`` does not
        depend on a parameter)."""
        keys = self.trainable_models_keys
        params = [list(self.models[self.logical_name(k)].parameters()) for k in keys]
        flat = [p for ps in params for p in ps]
        # data mode leaves Model 2 out of the loss: its gradient is zero, as
        # the reference's
        grads = torch.autograd.grad(total, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, flat)]
        out, i = {}, 0
        for k, ps in zip(keys, params):
            out[k] = grads[i:i + len(ps)]
            i += len(ps)
        return out

    def pinn_batch_sse_grad(self, x: torch.Tensor, y):
        """(aux, grads_by_key, total): :meth:`loss_and_metrics` and
        :meth:`gradients` of its total."""
        total, aux = self.loss_and_metrics(x, y)
        return aux, self.gradients(total), total

    def per_term_grad_norms(self, x: torch.Tensor, y) -> Dict[str, Dict[str, float]]:
        """The L2 norm of each loss term's gradient with respect to each
        trainable model's parameters, ``{"<phase>/<term>": {<model>: norm}}``
        with the terms' weighted MSEs as in ``loss_and_metrics``'s aux (the
        reference's ``per_term_grad_norms``, ``:1076-1107``). One backward
        per (phase, term), eager: a diagnostic, never part of the training
        step. A term that does not depend on a model (a zero residual, an
        unused label) has norm 0. On a space axis each term's gradients are
        summed over the space group (the whole grid's) before the norm."""
        _, aux = self.loss_and_metrics(x, y)
        names = sorted({self.logical_name(k) for k in self.trainable_models_keys})
        params = {n: list(self.models[n].parameters()) for n in names}
        flat = [p for n in names for p in params[n]]
        out: Dict[str, Dict[str, float]] = {}
        for ph in self.phases:
            for t in LOSS_TERMS:
                term = aux[ph][t]
                grads = (torch.autograd.grad(term, flat, retain_graph=True, allow_unused=True)
                         if term.requires_grad else [None] * len(flat))
                if self.rows is not None:
                    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, flat)]
                    summed = torch.cat([g.reshape(-1) for g in grads])
                    dist.all_reduce(summed, group=self.mesh.space_group)
                    grads = [v.view_as(p) for v, p in zip(
                        summed.split([p.numel() for p in flat]), flat)]
                row, i = {}, 0
                for n in names:
                    sq = sum(float((g.double() ** 2).sum()) for g in grads[i:i + len(params[n])]
                             if g is not None)
                    row[n] = float(np.sqrt(sq))
                    i += len(params[n])
                out[f"{ph}/{t}"] = row
        return out
