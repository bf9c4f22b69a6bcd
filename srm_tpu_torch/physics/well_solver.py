"""Well rates and bottom-hole pressure (Peaceman-type well model).

Port of the non-iterative path of ``srm_tpu/physics/well_solver.py`` for dry
gas and gas condensate: ``WellRatesPressure.compute_rates_and_bhp``
(``:395-455``) with ``_non_iterative_method`` (``:315-341``), the direct
λ-scaling BHP solve, ``_compute_phase_rates`` (``:293-312``) and, for gas
condensate, the phase mobilities of ``_mobilities`` (``:228-234``), the
condensate rate from Rv and ``_split_condensate_components``
(``:457-469``). Well properties are scattered onto the ``unit_target_shape``
grid once, as device tensors; the Peaceman radius and well index come from
the unnormalized permeability.

The blocking factor is off, as it is by default in the reference, so every
blocking term is exactly 1; turning it on raises ``NotImplementedError``, as
the Newton BHP solve and the root solvers are not ported yet. Clips are
written as ``minimum(maximum(..))``: torch's ``clamp`` passes the whole
gradient at a bound where JAX's ``clip`` splits it 0.5/0.5, and
``maximum``/``minimum`` split it as JAX does.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from srm_tpu_torch.config import (
    DEFAULT_GENERAL_CONFIG,
    DEFAULT_RESERVOIR_CONFIG,
    DEFAULT_SCAL_CONFIG,
    DEFAULT_WELLS_CONFIG,
    get_conversion_constants,
)
from srm_tpu_torch.physics.relperm import RelativePermeability, clip
from srm_tpu_torch.physics.wells import WellDataProcessor, conn_shutins_mask, scatter_to_grid
from srm_tpu_torch.utils.stats import denormalize

class WellRatesPressure:
    """Non-trainable well rate/BHP model for dry gas ("DG") and gas
    condensate ("GC")."""

    def __init__(self, data_summary, device: torch.device,
                 fluid_type: str = "DG",
                 general_config: Optional[Dict] = None,
                 reservoir_config: Optional[Dict] = None,
                 wells_config: Optional[Dict] = None,
                 scal_config: Optional[Dict] = None,
                 use_blocking_factor: bool = False):
        self.fluid_type = fluid_type.upper()
        if self.fluid_type not in ("DG", "GC"):
            raise ValueError(f"Unknown fluid type: {fluid_type}. Use 'DG' or 'GC'.")
        if use_blocking_factor:
            raise NotImplementedError("the blocking-factor integral is not ported yet")
        g = general_config or DEFAULT_GENERAL_CONFIG
        res = reservoir_config or DEFAULT_RESERVOIR_CONFIG
        wells = wells_config or DEFAULT_WELLS_CONFIG
        scal = scal_config or DEFAULT_SCAL_CONFIG
        units = get_conversion_constants(g["srm_units"])
        self.C, self.D = units["C"], units["D"]
        self.kx_ky = res["horizontal_anisotropy"]
        self.dx = res["length"] / res["Nx"]
        self.dy = res["width"] / res["Ny"]
        self.dz = res["thickness"] / res["Nz"]

        self.well_data = WellDataProcessor(wells["connections"]).get_well_data()
        conn = self.well_data["connection_index"]
        shp = tuple(g["unit_target_shape"])

        def grid(values):
            return torch.from_numpy(scatter_to_grid(shp, conn, values)).to(device)

        self.well_id = grid(1.0)
        self.rw = grid(self.well_data["wellbore_radius"])
        self.q0 = grid(self.well_data["control_mode_value"])
        self.pwf_min = grid(self.well_data["minimum_bhp"])
        self.completion_ratio = grid(self.well_data["completion_ratio"])
        self.shutin_windows = torch.from_numpy(self.well_data["shutin_days"]).to(device)

        self.relperm = RelativePermeability.from_config(scal["end_points"],
                                                        scal["corey_exponents"])
        # DG gas relperm at the (constant) initial gas saturation
        self.krgo = float(self.relperm(torch.tensor(self.relperm.sg_max, dtype=torch.float32))[1])

        nc = g["data_normalization"]
        self.norm = dict(method=nc["feature_normalization_method"],
                         limits=tuple(nc["normalization_limits"]))
        ds = data_summary
        self.t_idx, self.k_idx = ds.get_key_index("time"), ds.get_key_index("permx")
        self.t_row = torch.from_numpy(ds.table_np[self.t_idx]).to(device)
        self.k_row = torch.from_numpy(ds.table_np[self.k_idx]).to(device)
        self.t_is_log, self.k_is_log = ds.is_log("time"), ds.is_log("permx")

    def compute_rates_and_bhp(self, x_n1: torch.Tensor, p_n1: torch.Tensor,
                              model_PVT: Callable[[torch.Tensor], torch.Tensor],
                              Sg_n1: Optional[torch.Tensor] = None):
        """(q, pwf) for dry gas, ((qgg, qgo, qoo, qog), pwf) for gas
        condensate. ``x_n1`` is the normalized feature tensor
        ``[..., (z, y, x, t, k)]``; ``p_n1`` the pressure and ``Sg_n1`` the
        gas saturation (gas condensate only), both ``(B, T, H, W, 1)``."""
        t_n1 = denormalize(x_n1[..., self.t_idx: self.t_idx + 1], self.t_row,
                           is_log=self.t_is_log, **self.norm)
        kx_n1 = denormalize(x_n1[..., self.k_idx: self.k_idx + 1], self.k_row,
                            is_log=self.k_is_log, **self.norm)
        shutins_id = conn_shutins_mask(t_n1, self.well_data["connection_index"],
                                       self.shutin_windows,
                                       time_axis=max(t_n1.ndim - 5, 0))

        ky_n1 = self.kx_ky * kx_n1
        ro = 0.28 * torch.sqrt(torch.sqrt(ky_n1 / kx_n1) * self.dx**2
                               + torch.sqrt(kx_n1 / ky_n1) * self.dy**2) / (
            torch.pow(ky_n1 / kx_n1, 0.25) + torch.pow(kx_n1 / ky_n1, 0.25))
        rw = torch.where(self.rw > 0, self.rw, torch.ones_like(self.rw))
        Ck = shutins_id * (
            2 * np.pi * self.completion_ratio * kx_n1 * self.dz * self.C
        ) / torch.log(ro / rw)

        pvt = model_PVT(p_n1)
        if self.fluid_type == "DG":
            mg = self.krgo * pvt[0, 0] * pvt[0, 1]        # krgo · invBg · invug
        else:
            invBg, invBo, invug, invuo, Rs, Rv = (pvt[0, i] for i in range(6))
            krog, krgo = self.relperm(Sg_n1)
            mg = krgo * invBg * invug + krog * invBo * invuo * Rs
            mo = krog * invBo * invuo + krgo * invBg * invug * Rv

        # non-iterative BHP (srm_tpu/physics/well_solver.py:315-341); the
        # blocking factor is off, so every blocking term is exactly 1
        q_target, min_bhp = self.q0, self.pwf_min
        zero = p_n1.new_zeros(())
        dp_max = p_n1 - min_bhp + 1e-12
        qg_max = self.well_id * Ck * mg * dp_max
        qg_opt = torch.maximum(torch.minimum(q_target, qg_max), zero)
        denom = self.well_id * Ck * mg
        lam = torch.where(denom != 0, qg_opt / (denom + 1e-12), zero)
        lam = clip(lam, 0.0, 1.0)
        pwf = p_n1 - lam * dp_max
        pwf = self.well_id * clip(pwf, min_bhp, p_n1)

        # phase rates at that BHP (srm_tpu/physics/well_solver.py:293-312)
        dp = p_n1 - pwf + 1e-12
        qg_max = self.well_id * Ck * mg * dp
        qg = torch.maximum(torch.minimum(q_target, qg_max), zero)
        if self.fluid_type == "DG":
            return qg, pwf
        qo_max = self.well_id * Ck * mo * dp
        qo = torch.maximum(torch.minimum(qg * (1.0 / (Rv + 1e-12)), qo_max), zero)

        # the rates split by mobility fraction (:457-469)
        mgg = krgo * invBg * invug
        mgo = krog * invBo * invuo * Rs
        moo = krog * invBo * invuo
        mog = krgo * invBg * invug * Rv
        return (qg * (mgg / (mgg + mgo + 1e-12)), qg * (mgo / (mgg + mgo + 1e-12)),
                qo * (moo / (moo + mog + 1e-12)), qo * (mog / (moo + mog + 1e-12))), pwf
