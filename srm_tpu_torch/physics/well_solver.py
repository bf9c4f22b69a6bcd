"""Well rates and bottom-hole pressure (Peaceman-type well model).

Port of ``srm_tpu/physics/well_solver.py`` for dry gas and gas condensate:
``WellRatesPressure.compute_rates_and_bhp`` (``:395-455``) with both BHP
solves, the direct λ-scaling one (``_non_iterative_method``, ``:315-341``,
the default) and Newton on ``q(pwf) = q_target`` with a finite-difference
derivative (``_iterative_method``, ``:343-392``); the phase rates
(``:293-312``), the phase mobilities (``:228-234``) and, for gas
condensate, the condensate rate from Rv and the split by mobility fraction
(``:457-469``); the optional blocking-factor integral
(``compute_blocking_integral_and_factor``, ``:237-290``: a trapezoid over
``n_intervals`` pressure steps from p to pwf, the PVT at each and, for gas
condensate, a per-interval saturation root) and its three root solvers
(:func:`solve_newton`, :func:`solve_bisection`,
:func:`solve_chandrupatla`, ``:58-156``). Well properties are scattered
onto the ``unit_target_shape`` grid once, as device tensors; the Peaceman
radius and well index come from the unnormalized permeability.

Every loop runs a fixed number of trips with per-lane masks
(``torch.where``), as the JAX package's ``fori_loop``s do: no trip depends
on the data and nothing is read on the host, so a CUDA graph captures the
whole solve, and reverse-mode autograd flows through it (the loss
differentiates through the Newton BHP and the blocking integral). Newton's
derivative is ``jax.jvp``'s along ones, taken as a vector-Jacobian product
of the lane-wise cost (:func:`_value_and_slope`); each interval's
saturation root is recorded on a graph of its own (:class:`_OwnGraph`), so
that those slopes walk that graph alone. Clips are written as ``minimum(maximum(..))``: torch's
``clamp`` passes the whole gradient at a bound where JAX's ``clip`` splits
it 0.5/0.5, and ``maximum``/``minimum`` split it as JAX does.

``log_iterations`` writes the λ (direct solve) or pwf (Newton) history to a
text file per call, as the JAX package does from inside ``jit``. A CUDA
graph cannot call the host, so the solve writes the history into device
buffers and a counter, and :meth:`WellRatesPressure.flush_iteration_logs`
writes the files from them after the step: at once after an eager call,
and after each replay from the trainer. That costs one synchronisation per
step, only when ``log_iterations`` is on. Under a data-parallel mesh the
files hold the whole batch, as the JAX package's ``jax.debug.callback``
receives its mesh's global arrays once: each rank's block is gathered and
rank 0 writes. The JAX package also passes its active-trip count (``jnp.any``
over the batch) to the logger, which never writes it; the port computes none.

On a mesh's space axis (:meth:`WellRatesPressure.set_rows`) the well
grids, and the connections whose shut-in windows the mask reads, are this
rank's rows of H: a rank that holds no row of a well computes nothing for
it. Every solve (the direct and the Newton BHP, the blocking integral) is
cell by cell, so it needs nothing else. The iteration logs keep each
rank's rows of the histories; the flush gathers them over the space group
along H, then over the data axis along the batch, and rank 0 writes the
files that one process writes for the whole grid and batch.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Optional

import numpy as np
import torch

from srm_tpu_torch.config import (
    DEFAULT_GENERAL_CONFIG,
    DEFAULT_RESERVOIR_CONFIG,
    DEFAULT_SCAL_CONFIG,
    DEFAULT_WELLS_CONFIG,
    get_conversion_constants,
)
from srm_tpu_torch.parallel.mesh import gather_rows
from srm_tpu_torch.physics.relperm import RelativePermeability, clip
from srm_tpu_torch.physics.wells import WellDataProcessor, conn_shutins_mask, scatter_to_grid
from srm_tpu_torch.utils.profiling import log_tensor_to_file
from srm_tpu_torch.utils.stats import denormalize

log = logging.getLogger(__name__)

Cost = Callable[[torch.Tensor], torch.Tensor]


def _signed(d: torch.Tensor, mag: float) -> torch.Tensor:
    """+mag where d >= 0, else -mag."""
    return torch.where(d >= 0, d.new_full((), mag), d.new_full((), -mag))


def _value_and_slope(cost: Cost, x: torch.Tensor):
    """(cost(x), d cost/dx) of a lane-wise cost (each output lane depends on
    the same lane of ``x`` alone), differentiable in turn where grad is on.
    ``jax.jvp`` along ones gives the JAX package's slope; for a lane-wise
    cost the vector-Jacobian product with ones is the same diagonal, taken
    here by reverse mode (PyTorch's forward mode runs a slow path for every
    constant operand, whose tangent is a zero tensor)."""
    outer = torch.is_grad_enabled()
    with torch.enable_grad():
        xg = x if x.requires_grad else x.detach().requires_grad_()
        f = cost(xg)
        if not f.requires_grad:                  # a cost that does not depend on x
            return f, torch.zeros_like(f)
        df, = torch.autograd.grad(f, xg, torch.ones_like(f), create_graph=outer)
    return (f, df) if outer else (f.detach(), df)


def solve_newton(cost: Cost, ref: torch.Tensor, max_iters: int = 20,
                 max_value: float = 1.0, eps: float = 1e-3) -> torch.Tensor:
    """Newton root of cost(x) = 0 per lane, from max_value/2, clipped to
    [0, max_value] at each of ``max_iters`` trips; the derivative is that of
    ``jax.jvp`` along ones (``well_solver.py:58-69``), differentiable in
    reverse mode as JAX's is."""
    x = torch.ones_like(ref) * 0.5 * max_value
    for _ in range(max_iters):
        f, df = _value_and_slope(cost, x)
        x = clip(x - f / (df + _signed(df, 1e-12)), 0.0, max_value)
    return x


def solve_bisection(cost: Cost, ref: torch.Tensor, max_iters: int = 20,
                    tol: float = 1e-6, max_value: float = 1.0) -> torch.Tensor:
    """Plain bisection on [0, max_value] (``well_solver.py:72-90``)."""
    lo = torch.zeros_like(ref)
    hi = torch.ones_like(ref) * max_value
    f_lo = cost(lo)
    for _ in range(max_iters):
        mid = 0.5 * (lo + hi)
        f_mid = cost(mid)
        same_side = (f_mid * f_lo) > 0
        lo, f_lo, hi = (torch.where(same_side, mid, lo), torch.where(same_side, f_mid, f_lo),
                        torch.where(same_side, hi, mid))
    return 0.5 * (lo + hi)


def solve_chandrupatla(cost: Cost, ref: torch.Tensor, max_iters: int = 20,
                       tol: float = 1e-6, max_value: float = 1.0) -> torch.Tensor:
    """Chandrupatla's bracketing root solve on [0, max_value]
    (``well_solver.py:93-156``): inverse-quadratic interpolation where the
    bracket's shape admits it, bisection otherwise; converged lanes freeze
    (t → 0). Without a sign change on the interval, the bracket end with the
    smaller |cost|. ``torch.sign`` is 0 at 0, as ``jnp.sign`` is."""
    tiny = 1e-30

    def safe(d):
        return torch.where(d.abs() > tiny, d, _signed(d, tiny))

    b = torch.zeros_like(ref)                    # bracket ends: b and a
    a = torch.ones_like(ref) * max_value
    fb, fa = cost(b), cost(a)
    no_bracket = torch.sign(fa) == torch.sign(fb)
    best_end = torch.where(fa.abs() <= fb.abs(), a, b)
    c, fc = b, fb
    t = torch.full_like(ref, 0.5)
    for _ in range(max_iters):
        xt = a + t * (b - a)
        ft = cost(xt)
        # xt replaces a; the old a moves to b when the sign flipped, else to c
        same = torch.sign(ft) == torch.sign(fa)
        c, fc, b, fb = (torch.where(same, a, b), torch.where(same, fa, fb),
                        torch.where(same, b, a), torch.where(same, fb, fa))
        a, fa = xt, ft
        # inverse-quadratic step when the bracket is well shaped
        xi = (a - b) / safe(c - b)
        phi = (fa - fb) / safe(fc - fb)
        iqi_ok = torch.logical_and(phi**2 < xi, (1.0 - phi) ** 2 < 1.0 - xi)
        t_iqi = (fa / safe(fb - fa)) * (fc / safe(fb - fc)) \
            + ((c - a) / safe(b - a)) * (fa / safe(fc - fa)) * (fb / safe(fc - fb))
        t = torch.where(iqi_ok, t_iqi, t.new_full((), 0.5))
        # clamp away from the bracket ends; converged lanes get t = 0
        # (a tensor numerator: a Python one divides as reciprocal × tol)
        width = (b - a).abs()
        tlim = width.new_full((), tol) / torch.maximum(width, width.new_full((), tiny))
        tlim = torch.minimum(tlim, width.new_full((), 0.5))
        t = torch.where(width <= tol, t.new_zeros(()), clip(t, tlim, 1.0 - tlim))
    return torch.where(no_bracket, best_end, torch.where(fa.abs() <= fb.abs(), a, b))


_ROOT_SOLVERS = {"newton": solve_newton, "bisection": solve_bisection}


class _OwnGraph(torch.autograd.Function):
    """``fn(*inputs)`` recorded on a graph of its own: the inputs enter it
    as fresh leaves, and the backward pulls their gradients from it, so the
    value and the gradients are ``fn``'s called directly (summed in another
    order). An ``autograd.grad`` inside ``fn`` (Newton's slope) then walks
    this graph alone and not every node upstream of the inputs, which would
    cost each of a step's hundreds of slopes the whole step's graph."""

    @staticmethod
    def forward(ctx, fn, *inputs):
        leaves = [x.detach().requires_grad_(x.requires_grad) for x in inputs]
        with torch.enable_grad():
            out = fn(*leaves)
        ctx.leaves, ctx.out = leaves, out
        return out.detach()

    @staticmethod
    def backward(ctx, grad):
        wanted = [x for x in ctx.leaves if x.requires_grad]
        grads = iter(torch.autograd.grad(ctx.out, wanted, grad, retain_graph=True,
                                         allow_unused=True)
                     if wanted and ctx.out.requires_grad else [None] * len(wanted))
        return (None,) + tuple(next(grads) if x.requires_grad else None for x in ctx.leaves)


class WellRatesPressure:
    """Non-trainable well rate/BHP model for dry gas ("DG") and gas
    condensate ("GC"), with the JAX package's knobs and defaults
    (``well_solver.py:162-178``)."""

    def __init__(self, data_summary, device: torch.device,
                 fluid_type: str = "DG",
                 general_config: Optional[Dict] = None,
                 reservoir_config: Optional[Dict] = None,
                 wells_config: Optional[Dict] = None,
                 scal_config: Optional[Dict] = None,
                 use_blocking_factor: bool = False, solver: str = "newton",
                 n_intervals: int = 8, n_root_iter: int = 20, max_iters: int = 10,
                 tol: float = 1e-6, compute_mo: bool = False, use_non_iterative: bool = True,
                 log_iterations: bool = False, log_dir: Optional[str] = None):
        self.fluid_type = fluid_type.upper()
        if self.fluid_type not in ("DG", "GC"):
            raise ValueError(f"Unknown fluid type: {fluid_type}. Use 'DG' or 'GC'.")
        self.use_blocking_factor = use_blocking_factor
        self.solver = solver
        self.n_intervals = n_intervals
        self.n_root_iter = n_root_iter
        self.max_iters = max_iters
        self.tol = tol
        self.compute_mo = compute_mo
        self.use_non_iterative = use_non_iterative
        self.log_iterations = log_iterations
        self.log_dir = log_dir
        # per logged history: (history, final, device count of writes), and
        # the count already written to files
        self._log_buffers: Dict[tuple, tuple] = {}
        self._log_written: Dict[tuple, int] = {}
        #: the data-parallel mesh whose ranks solve the rest of the batch
        #: (``PhysicsLoss.set_mesh``): the logs hold the whole batch
        self.mesh = None

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

        #: the well grids over the whole H; :meth:`set_rows` takes this
        #: rank's rows of them
        self._grids = {"well_id": grid(1.0), "rw": grid(self.well_data["wellbore_radius"]),
                       "q0": grid(self.well_data["control_mode_value"]),
                       "pwf_min": grid(self.well_data["minimum_bhp"]),
                       "completion_ratio": grid(self.well_data["completion_ratio"])}
        self._shutin_all = torch.from_numpy(self.well_data["shutin_days"]).to(device)
        self.rows = None
        self.set_rows(None)

        self.relperm = RelativePermeability.from_config(scal["end_points"],
                                                        scal["corey_exponents"])
        self.Sg_max = self.relperm.sg_max
        # Sg where the caller gives none (dry gas): a device tensor made here,
        # as a captured step may not copy from the host
        self.sg_max_t = torch.tensor(self.Sg_max, dtype=torch.float32, device=device)
        # DG gas relperm at the (constant) initial gas saturation
        self.krgo = float(self.relperm(torch.tensor(self.Sg_max, dtype=torch.float32))[1])

        nc = g["data_normalization"]
        self.norm = dict(method=nc["feature_normalization_method"],
                         limits=tuple(nc["normalization_limits"]))
        ds = data_summary
        self.t_idx, self.k_idx = ds.get_key_index("time"), ds.get_key_index("permx")
        self.t_row = torch.from_numpy(ds.table_np[self.t_idx]).to(device)
        self.k_row = torch.from_numpy(ds.table_np[self.k_idx]).to(device)
        self.t_is_log, self.k_is_log = ds.is_log("time"), ds.is_log("permx")

    def set_rows(self, rows) -> None:
        """This rank's rows of H (a ``parallel/halo.py`` ``Rows``, H being
        axis -3 of the well grids), or the whole grid with None: the well
        grids and the connections (their row index made local) with their
        shut-in windows."""
        self.rows = rows
        lo, hi = (0, None) if rows is None else (rows.lo, rows.hi)
        for name, g in self._grids.items():
            setattr(self, name, g[..., lo:hi, :, :])
        conn = np.asarray(self.well_data["connection_index"])
        keep = np.ones(len(conn), bool) if rows is None else (conn[:, 1] >= lo) & (conn[:, 1] < hi)
        self.local_connections = conn[keep] - np.array([0, lo, 0])
        self.shutin_windows = self._shutin_all[torch.from_numpy(np.flatnonzero(keep)).to(
            self._shutin_all.device)] if not keep.all() else self._shutin_all

    # -- properties and mobilities -----------------------------------------------
    def _props(self, pvt: torch.Tensor):
        """(invBg, invBo, invug, invuo, Rs, Rv) from the stacked PVT values;
        None for the properties dry gas does not have."""
        if self.fluid_type == "DG":
            return pvt[0, 0], None, pvt[0, 1], None, None, None
        return tuple(pvt[0, i] for i in range(6))

    def _mobilities(self, kr, props):
        """(mg, mo) from the relative permeabilities ``kr`` = (krog, krgo)
        (dry gas: None, krgo at Sg_max; mo None) and the PVT values
        ``props`` (``well_solver.py:228-234``)."""
        invBg, invBo, invug, invuo, Rs, Rv = props
        if self.fluid_type == "DG":
            return self.krgo * invBg * invug, None
        krog, krgo = kr
        return (krgo * invBg * invug + krog * invBo * invuo * Rs,
                krog * invBo * invuo + krgo * invBg * invug * Rv)

    def _root(self, cost: Cost, ref: torch.Tensor) -> torch.Tensor:
        solve = _ROOT_SOLVERS.get(self.solver, solve_chandrupatla)
        return solve(cost, ref, self.n_root_iter, max_value=self.Sg_max)

    def _saturation_root(self, Sg_n1, mg_n1, mo_n1, invBg1, invBo1, invug1, invuo1, Rs1, Rv1):
        """The gas saturation at which the phase mobilities at the interval's
        end keep their ratio at p (``well_solver.py:262-276``), by the root
        solver ``solver``; ``Sg_n1`` gives only the shape."""
        def cost(Sg):
            krog, krgo = self.relperm(Sg)
            mg = krgo * invBg1 * invug1 + krog * invBo1 * invuo1 * Rs1
            mo = (krog * invBo1 * invuo1 + krgo * invBg1 * invug1 * Rv1
                  if self.compute_mo else torch.zeros_like(mg))
            return self.well_id * (mo * mg_n1 - mo_n1 * mg)

        return self._root(cost, Sg_n1)

    # -- the blocking integral (well_solver.py:237-290) -----------------------------
    def compute_blocking_integral_and_factor(self, p_n1, Sg_n1, model_PVT, pwf_n1,
                                             eps: float = 1e-12):
        """(Ig, Io, blk_g, blk_o): the phase mobilities integrated over the
        pressure path from p to pwf (trapezoid over ``n_intervals`` steps)
        and the blocking factors, the integrals over mobility × Δp; all ones
        with the blocking factor off."""
        if not self.use_blocking_factor:
            ones = torch.ones_like(p_n1)
            return ones, ones, ones, ones
        zero = p_n1.new_zeros(())
        kr_n1 = None if self.fluid_type == "DG" else self.relperm(Sg_n1)
        mg_n1, mo_n1 = self._mobilities(kr_n1, self._props(model_PVT(p_n1)))
        if mo_n1 is None:
            mo_n1 = torch.zeros_like(mg_n1)
        sum_g = sum_o = torch.zeros_like(p_n1)
        mg_prev, mo_prev = mg_n1, mo_n1
        n = self.n_intervals
        for i in range(n):
            p0 = p_n1 + (pwf_n1 - p_n1) * (i / n)
            p1 = p_n1 + (pwf_n1 - p_n1) * ((i + 1) / n)
            props1 = self._props(model_PVT(p1))
            kr1 = None                                   # dry gas: Sg_max, krgo constant
            if self.fluid_type == "GC":
                Sg1 = _OwnGraph.apply(self._saturation_root, Sg_n1, mg_n1, mo_n1, *props1)
                Sg1 = torch.where(kr_n1[0] < 1e-3, torch.ones_like(Sg1) * self.Sg_max, Sg1)
                kr1 = self.relperm(Sg1)
            mg1, mo1 = self._mobilities(kr1, props1)
            if mo1 is None or not self.compute_mo:
                mo1 = torch.zeros_like(mg1)
            dp = p0 - p1
            sum_g = sum_g + 0.5 * (mg_prev + mg1) * dp
            sum_o = sum_o + 0.5 * (mo_prev + mo1) * dp * (1.0 if self.compute_mo else 0.0)
            mg_prev, mo_prev = mg1, mo1
        dp = p_n1 - pwf_n1 + eps
        blk_g = torch.where(mg_n1 * dp != 0, sum_g / (mg_n1 * dp + eps), zero)
        blk_o = torch.where(mo_n1 * dp != 0, sum_o / (mo_n1 * dp + eps), zero)
        return sum_g, sum_o, blk_g, blk_o

    def _blocking(self, p_n1, Sg_n1, model_PVT, pwf, mg_n1, mo_n1):
        """(blk_g, blk_o) of the phase rates at ``pwf`` (``:293-302``); None
        for a factor that is exactly 1 (the blocking factor off; blk_o
        without ``compute_mo``), which then multiplies nothing."""
        if not self.use_blocking_factor:
            return None, None
        Ig, Io = self.compute_blocking_integral_and_factor(p_n1, Sg_n1, model_PVT, pwf)[:2]
        dp = p_n1 - pwf + 1e-12
        blk_g = Ig / (mg_n1 * dp + 1e-12)
        blk_o = Io / (mo_n1 * dp + 1e-12) if self.compute_mo and mo_n1 is not None else None
        return blk_g, blk_o

    # -- phase rates (well_solver.py:293-312) -------------------------------------
    def _phase_rates(self, p_n1, pwf, Sg_n1, mg_n1, mo_n1, Rv_n1, model_PVT, Ck, q_target):
        blk_g, blk_o = self._blocking(p_n1, Sg_n1, model_PVT, pwf, mg_n1, mo_n1)
        zero = p_n1.new_zeros(())
        dp = p_n1 - pwf + 1e-12
        wc = self.well_id * Ck
        qg_max = (wc if blk_g is None else wc * blk_g) * mg_n1 * dp
        qg = torch.maximum(torch.minimum(q_target, qg_max), zero)
        if self.fluid_type == "DG":
            return qg, None
        qo_max = (wc if blk_o is None else wc * blk_o) * mo_n1 * dp
        qo = torch.maximum(torch.minimum(qg * (1.0 / (Rv_n1 + 1e-12)), qo_max), zero)
        return qg, qo

    # -- BHP solves ---------------------------------------------------------------
    def _non_iterative_method(self, p_n1, Sg_n1, mg_n1, mo_n1, model_PVT, Ck, q_target,
                              min_bhp):
        """Direct λ-scaling solve (``well_solver.py:315-341``)."""
        zero = p_n1.new_zeros(())
        dp_max = p_n1 - min_bhp + 1e-12
        blk_g_max, _ = self._blocking(p_n1, Sg_n1, model_PVT, min_bhp, mg_n1, mo_n1)
        wc = self.well_id * Ck
        if blk_g_max is not None:
            wc = wc * blk_g_max
        qg_max = wc * mg_n1 * dp_max
        qg_opt = torch.maximum(torch.minimum(q_target, qg_max), zero)
        denom = wc * mg_n1
        lam = torch.where(denom != 0, qg_opt / (denom + 1e-12), zero)
        lam = clip(lam, 0.0, 1.0 if blk_g_max is None else blk_g_max)
        pwf = p_n1 - lam * dp_max
        pwf = self.well_id * clip(pwf, min_bhp, p_n1)
        if self.log_iterations:
            self._log("lambda_opt", "lambda_non_iterative", lam[None], pwf)
        return pwf

    def _iterative_method(self, p_n1, Sg_n1, mg_n1, mo_n1, Rv_n1, model_PVT, Ck, q_target,
                          min_bhp):
        """Newton on qg(pwf) = q_target with a finite-difference derivative
        (ε = 14.7 psi), ``max_iters`` trips; a lane whose rate is within
        ``tol`` of its target keeps its pwf (``well_solver.py:343-392``)."""
        eps = p_n1.new_full((), 14.7)

        def qg_of(pwf):
            return self._phase_rates(p_n1, pwf, Sg_n1, mg_n1, mo_n1, Rv_n1, model_PVT, Ck,
                                     q_target)[0]

        pwf = min_bhp + 0.5 * (p_n1 - min_bhp)
        hist = []
        for _ in range(self.max_iters):
            qg = qg_of(pwf)
            active = (qg - q_target).abs() > self.tol
            dq = (qg_of(pwf + eps) - qg) / eps
            pwf_new = clip(pwf - (qg - q_target) / (dq + 1e-12), min_bhp, p_n1)
            pwf = torch.where(active, pwf_new, pwf)
            if self.log_iterations:
                hist.append(pwf)
        if self.log_iterations:
            self._log("pwf_iterations", "pwf_iterative", torch.stack(hist), pwf)
        return pwf

    # -- the main entry (well_solver.py:395-455) -------------------------------------
    def compute_rates_and_bhp(self, x_n1: torch.Tensor, p_n1: torch.Tensor,
                              model_PVT: Callable[[torch.Tensor], torch.Tensor],
                              Sg_n1: Optional[torch.Tensor] = None):
        """(q, pwf) for dry gas, ((qgg, qgo, qoo, qog), pwf) for gas
        condensate. ``x_n1`` is the normalized feature tensor
        ``[..., (z, y, x, t, k)]``; ``p_n1`` the pressure and ``Sg_n1`` the
        gas saturation (gas condensate; None: Sg_max), both
        ``(B, T, H, W, 1)``."""
        t_n1 = denormalize(x_n1[..., self.t_idx: self.t_idx + 1], self.t_row,
                           is_log=self.t_is_log, **self.norm)
        kx_n1 = denormalize(x_n1[..., self.k_idx: self.k_idx + 1], self.k_row,
                            is_log=self.k_is_log, **self.norm)
        shutins_id = (conn_shutins_mask(t_n1, self.local_connections, self.shutin_windows,
                                        time_axis=max(t_n1.ndim - 5, 0))
                      if len(self.local_connections) else torch.zeros_like(t_n1))

        ky_n1 = self.kx_ky * kx_n1
        ro = 0.28 * torch.sqrt(torch.sqrt(ky_n1 / kx_n1) * self.dx**2
                               + torch.sqrt(kx_n1 / ky_n1) * self.dy**2) / (
            torch.pow(ky_n1 / kx_n1, 0.25) + torch.pow(kx_n1 / ky_n1, 0.25))
        rw = torch.where(self.rw > 0, self.rw, torch.ones_like(self.rw))
        Ck = shutins_id * (
            2 * np.pi * self.completion_ratio * kx_n1 * self.dz * self.C
        ) / torch.log(ro / rw)

        if Sg_n1 is None:
            Sg_n1 = self.sg_max_t
        props = self._props(model_PVT(p_n1))
        kr = None if self.fluid_type == "DG" else self.relperm(Sg_n1)
        mg, mo = self._mobilities(kr, props)
        Rv = props[5]
        q_target, min_bhp = self.q0, self.pwf_min
        if self.use_non_iterative:
            pwf = self._non_iterative_method(p_n1, Sg_n1, mg, mo, model_PVT, Ck, q_target,
                                             min_bhp)
        else:
            pwf = self._iterative_method(p_n1, Sg_n1, mg, mo, Rv, model_PVT, Ck, q_target,
                                         min_bhp)
        qg, qo = self._phase_rates(p_n1, pwf, Sg_n1, mg, mo, Rv, model_PVT, Ck, q_target)
        if self.fluid_type == "DG":
            return qg, pwf

        # the rates split by mobility fraction (:457-469)
        invBg, invBo, invug, invuo, Rs, Rv = props
        krog, krgo = kr
        mgg = krgo * invBg * invug
        mgo = krog * invBo * invuo * Rs
        moo = krog * invBo * invuo
        mog = krgo * invBg * invug * Rv
        return (qg * (mgg / (mgg + mgo + 1e-12)), qg * (mgo / (mgg + mgo + 1e-12)),
                qo * (moo / (moo + mog + 1e-12)), qo * (mog / (moo + mog + 1e-12))), pwf

    # -- iteration logs -----------------------------------------------------------
    def _log(self, tensor_name: str, file_prefix: str, hist: torch.Tensor,
             final: torch.Tensor) -> None:
        """Keep a call's history in this history's device buffers (made on
        the first, eager call of each shape: a capture cannot initialise
        memory) and count the write; outside a capture, write the file."""
        key = (tensor_name, file_prefix, tuple(hist.shape))
        bufs = self._log_buffers.get(key)
        capturing = hist.is_cuda and torch.cuda.is_current_stream_capturing()
        if bufs is None:
            if capturing:
                raise RuntimeError(f"log_iterations: the first {file_prefix} call of shape "
                                   f"{tuple(hist.shape)} is inside a CUDA graph capture; "
                                   f"run it eagerly first (the trainer's warm-up steps do)")
            bufs = (torch.empty_like(hist), torch.empty_like(final),
                    torch.zeros((), dtype=torch.int64, device=hist.device))
            self._log_buffers[key] = bufs
            self._log_written[key] = 0
        bufs[0].copy_(hist.detach())
        bufs[1].copy_(final.detach())
        bufs[2].add_(1)
        if not capturing:
            self.flush_iteration_logs()

    def flush_iteration_logs(self) -> int:
        """Write a file for each history that a call (or a replay) wrote
        since the last flush; returns the number of files. One host read of
        the counters, so one synchronisation. A history written more than
        once in between keeps its last call's values, and the loss of the
        others is logged. Under a mesh every rank calls it (the trainer and
        an eager call do), and rank 0 writes the whole batch's histories."""
        if not self._log_buffers:
            return 0
        keys = list(self._log_buffers)
        counts = torch.stack([self._log_buffers[k][2] for k in keys]).cpu().tolist()
        files = 0
        for key, count in zip(keys, counts):
            new = count - self._log_written[key]
            if new <= 0:
                continue
            if new > 1:
                log.warning("log_iterations: %d %s histories were overwritten before being "
                            "written; the last one is written", new - 1, key[1])
            hist, final, _ = self._log_buffers[key]
            arrays = [hist.cpu().numpy(), final.cpu().numpy()]
            if self.mesh is not None:
                # the JAX package's callback receives the whole batch and
                # grid of its mesh, once: each rank's block, gathered (its
                # rows of H, axis -3, first), written by rank 0
                arrays = gather_rows(arrays, self.mesh, axes=(1, 0), h_axes=(-3, -3))
            if arrays is not None:
                log_tensor_to_file(arrays[0], None, arrays[1], tensor_name=key[0],
                                   file_prefix=key[1], well_specific=True,
                                   directory=self.log_dir)
                files += 1
            self._log_written[key] = count
        return files
