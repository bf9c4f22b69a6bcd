"""Implicit finite-volume reference simulator (the label generator).

Port of ``srm_tpu/sim/fv_simulator.py``: the same scheme as the physics
loss, so a perfectly trained surrogate zeroes the residual on its labels.

* 5/7-point stencil, harmonic-mean face permeability, arithmetic face
  averages of ``invBg·invug``;
* accumulation with the chord slope ΔinvBg/Δp and rock compressibility;
* Peaceman wells, rate targets clipped by the min-BHP drawdown bound,
  shut-in windows;
* backward Euler in time; dry gas by Picard sweeps, gas condensate by Newton
  iterations on the diagonal Schur complement (one linear solve in δp).

Where the reference ``vmap``s one realization, every function here takes a
leading realization axis: each vector is ``(c, N)``, each dot product a sum
per row, and the solvers' scalars (``done``, ``alpha``, ``beta``, ``rho``,
``omega``) are ``(c,)`` tensors. Realizations run on the device of ``kx``.

The linear solve is ``torch.linalg.solve`` on the dense matrix for small
grids and a matrix-free Jacobi-preconditioned CG (dry gas) or BiCGStab (gas
condensate) on the structured face grids for large ones (``solver``). The
dense matrices are written without accumulation: each off-diagonal entry
belongs to exactly one face and is assigned, and the diagonal is the
structured diagonal plus the accumulation, so two runs on a GPU give the
same bits (a scatter-add there reorders its sums with atomics).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

class FVProblem(NamedTuple):
    """Static problem description (shapes, geometry, wells) for the solver."""

    shape: Tuple[int, int, int]          # (Nz, Ny, Nx)
    face_pairs: np.ndarray               # (F, 2) flat cell indices per face
    face_geom: np.ndarray                # (F,) C * A/d geometric factor
    dv: float                            # cell volume dx*dy*dz
    phi: Any                             # porosity: float, or (N,) per-cell field
    Pi: float                            # initial pressure
    Sgi: float                           # initial gas saturation
    krgo: float                          # constant DG relperm at Sgi
    D: float                             # volume conversion constant
    well_cells: np.ndarray               # (W,) flat indices
    q_target: np.ndarray                 # (W,) signed control rates
    pwf_min: np.ndarray                  # (W,)
    well_ck_geom: np.ndarray             # (W,) 2π·cr·dz·C / ln(ro/rw), kx factored out
    shutin_windows: np.ndarray           # (W, S, 2)


def _build_faces(Nz: int, Ny: int, Nx: int, dx: float, dy: float, dz: float,
                 C: float, kv_kh: float = 1.0):
    """Static face index pairs + geometric transmissibility factors, in
    x-, y-, z-face blocks."""
    idx = np.arange(Nz * Ny * Nx).reshape(Nz, Ny, Nx)
    pairs, geom, kscale = [], [], []
    if Nx > 1:
        a, b = idx[:, :, :-1].reshape(-1), idx[:, :, 1:].reshape(-1)
        pairs.append(np.stack([a, b], 1))
        geom.append(np.full(a.size, C * dy * dz / dx))
        kscale.append(np.ones(a.size))
    if Ny > 1:
        a, b = idx[:, :-1, :].reshape(-1), idx[:, 1:, :].reshape(-1)
        pairs.append(np.stack([a, b], 1))
        geom.append(np.full(a.size, C * dx * dz / dy))
        kscale.append(np.ones(a.size))
    if Nz > 1:
        a, b = idx[:-1, :, :].reshape(-1), idx[1:, :, :].reshape(-1)
        pairs.append(np.stack([a, b], 1))
        geom.append(np.full(a.size, C * dx * dy / dz))
        kscale.append(np.full(a.size, kv_kh))   # vertical permeability scale
    return (np.concatenate(pairs, 0), np.concatenate(geom, 0),
            np.concatenate(kscale, 0))


def _phi_from_config(res: Dict):
    """Scalar porosity, or a flattened (N,) per-cell field if the config holds
    an array or nested list."""
    poro = np.asarray(res["porosity"], np.float32)
    if poro.ndim == 0:
        return float(poro)
    n = res["Nz"] * res["Ny"] * res["Nx"]
    flat = poro.reshape(-1)
    if flat.size != n:
        raise ValueError(f"porosity field has {flat.size} cells, grid has {n}")
    return flat


def build_problem(reservoir_config: Dict, wells_config: Dict, scal_config: Dict,
                  general_config: Dict, relperm=None) -> Tuple[FVProblem, np.ndarray]:
    """FVProblem from the standard config bundle. Returns (problem, kscale)."""
    from srm_tpu_torch.config import get_conversion_constants
    from srm_tpu_torch.physics.relperm import RelativePermeability
    from srm_tpu_torch.physics.wells import WellDataProcessor

    res = reservoir_config
    Nz, Ny, Nx = res["Nz"], res["Ny"], res["Nx"]
    dx = res["length"] / Nx
    dy = res["width"] / Ny
    dz = res["thickness"] / Nz
    units = get_conversion_constants(general_config["srm_units"])
    C, D = units["C"], units["D"]

    pairs, geom, kscale = _build_faces(Nz, Ny, Nx, dx, dy, dz, C,
                                       res.get("vertical_anisotropy", 1.0))

    relperm = relperm or RelativePermeability.from_config(
        scal_config["end_points"], scal_config["corey_exponents"])
    Swmin = scal_config["end_points"]["Swmin"]
    Sgi = 1.0 - Swmin
    krgo = float(relperm(torch.tensor(Sgi, dtype=torch.float32))[1])

    wd = WellDataProcessor(wells_config["connections"]).get_well_data()
    conn = np.asarray(wd["connection_index"], np.int64)       # (W, 3) (k, j, i)
    well_cells = conn[:, 0] * Ny * Nx + conn[:, 1] * Nx + conn[:, 2]

    # Peaceman geometric part of the well index (kx multiplies in later):
    # Ck = 2π·cr·kx·dz·C / ln(ro/rw), isotropic ro = 0.28·sqrt(dx²+dy²)/2
    kx_ky = res.get("horizontal_anisotropy", 1.0)
    ro = 0.28 * np.sqrt(np.sqrt(kx_ky) * dx**2 + np.sqrt(1.0 / kx_ky) * dy**2) / (
        kx_ky**0.25 + (1.0 / kx_ky) ** 0.25)
    rw = np.asarray(wd["wellbore_radius"], np.float64)
    cr = np.asarray(wd["completion_ratio"], np.float64)
    ck_geom = 2.0 * np.pi * cr * dz * C / np.log(ro / np.where(rw > 0, rw, 1.0))

    windows = np.asarray(wd["shutin_days"], np.float32)
    if windows.ndim == 2:
        windows = windows[:, None, :]

    prob = FVProblem(
        shape=(Nz, Ny, Nx), face_pairs=pairs, face_geom=geom,
        dv=dx * dy * dz, phi=_phi_from_config(res), Pi=res["initialization"]["Pi"],
        Sgi=Sgi, krgo=krgo, D=D,
        well_cells=well_cells,
        q_target=np.asarray(wd["control_mode_value"], np.float32),
        pwf_min=np.asarray(wd["minimum_bhp"], np.float32),
        well_ck_geom=ck_geom.astype(np.float32),
        shutin_windows=windows,
    )
    return prob, kscale


# grids at or below this cell count use the dense solve; larger grids (3D:
# 39×39×10 = 15,210 cells → a 0.9 GB dense matrix per realization) switch
# to the matrix-free iterative path
_DENSE_MAX_CELLS = 4096

# the iterative solvers test whether every realization has converged once
# every this many trips (one host synchronisation each)
_CHECK_EVERY = 32


def _split_face_grids(Gflat: torch.Tensor, shape: Tuple[int, int, int]):
    """Split the flat face array ``(c, F)`` (x-, y-, z-face blocks in
    ``_build_faces`` order) into per-axis grids ``Gx (c,Nz,Ny,Nx-1)``,
    ``Gy (c,Nz,Ny-1,Nx)``, ``Gz (c,Nz-1,Ny,Nx)`` (``None`` for absent axes)."""
    Nz, Ny, Nx = shape
    c = Gflat.shape[0]
    out = []
    off = 0
    for cnt, gshape in (((Nx - 1) * Ny * Nz, (Nz, Ny, Nx - 1)),
                        ((Ny - 1) * Nx * Nz, (Nz, Ny - 1, Nx)),
                        ((Nz - 1) * Ny * Nx, (Nz - 1, Ny, Nx))):
        if gshape[0] and gshape[1] and gshape[2]:
            out.append(Gflat[:, off:off + cnt].reshape((c,) + gshape))
            off += cnt
        else:
            out.append(None)
    return tuple(out)


def _axis_avg(m3: torch.Tensor):
    """Arithmetic face averages of a cell field ``(c, Nz, Ny, Nx)`` along x/y/z."""
    return (0.5 * (m3[..., :, :, :-1] + m3[..., :, :, 1:]) if m3.shape[-1] > 1 else None,
            0.5 * (m3[..., :, :-1, :] + m3[..., :, 1:, :]) if m3.shape[-2] > 1 else None,
            0.5 * (m3[..., :-1, :, :] + m3[..., 1:, :, :]) if m3.shape[-3] > 1 else None)


def _axis_upstream(v3: torch.Tensor, p3: torch.Tensor):
    """Per-axis upstream select of cell field ``v3``: the higher-pressure
    side, the lower index on a tie (strict ``>``, as the reference)."""
    vx = (torch.where(p3[..., :, :, 1:] > p3[..., :, :, :-1], v3[..., :, :, 1:],
                      v3[..., :, :, :-1]) if v3.shape[-1] > 1 else None)
    vy = (torch.where(p3[..., :, 1:, :] > p3[..., :, :-1, :], v3[..., :, 1:, :],
                      v3[..., :, :-1, :]) if v3.shape[-2] > 1 else None)
    vz = (torch.where(p3[..., 1:, :, :] > p3[..., :-1, :, :], v3[..., 1:, :, :],
                      v3[..., :-1, :, :]) if v3.shape[-3] > 1 else None)
    return vx, vy, vz


def _lo_hi(axis: int):
    """Index tuples of a face's low-side and high-side cells along ``axis``
    (-1 x, -2 y, -3 z) of a ``(c, Nz, Ny, Nx)`` field."""
    lo = [slice(None)] * 4
    hi = [slice(None)] * 4
    lo[axis] = slice(None, -1)
    hi[axis] = slice(1, None)
    return tuple(lo), tuple(hi)


_FACES = (_lo_hi(-1), _lo_hi(-2), _lo_hi(-3))


def _stencil_apply(x3: torch.Tensor, Tx, Ty, Tz) -> torch.Tensor:
    """(F x)(cell) = Σ_faces T·(x_cell − x_neighbor), structured form. Each
    face's flux is added to its low cell and taken from its high cell, in
    the reference's order (x, y, z; per axis low side, then high side)."""
    out = torch.zeros_like(x3)
    for T, (lo, hi) in zip((Tx, Ty, Tz), _FACES):
        if T is not None:
            d = T * (x3[lo] - x3[hi])
            out[lo] += d
            out[hi] -= d
    return out


def _stencil_diag(x3_like: torch.Tensor, Tx, Ty, Tz) -> torch.Tensor:
    """Diagonal of the structured flux operator, shaped like ``x3_like``."""
    out = torch.zeros_like(x3_like)
    for T, (lo, hi) in zip((Tx, Ty, Tz), _FACES):
        if T is not None:
            out[lo] += T
            out[hi] += T
    return out


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-realization dot product of ``(c, N)`` vectors → ``(c,)``."""
    return (a * b).sum(-1)


def _pcg_fixed(mv, b: torch.Tensor, x0: torch.Tensor, diag: torch.Tensor, iters: int,
               tol: float, stats: Optional[Dict] = None) -> torch.Tensor:
    """Jacobi-preconditioned CG with a fixed trip count, masked per
    realization: once ``‖r‖ ≤ tol·‖b‖`` its step sizes are zero, so later
    trips leave its ``x`` and ``r`` exactly as they are.

    The loop stops early, every ``_CHECK_EVERY`` trips, when every
    realization is done: the trips it skips would change no bit of ``x``.
    That holds while the masked trips' vectors stay finite (a zero step
    times an infinite ``p`` would be NaN), as they do on any system this
    solver converges on."""
    bnorm2 = _dot(b, b)
    thresh2 = (tol * tol) * bnorm2
    x = x0
    r = b - mv(x0)
    z = r / diag
    p = z
    rz = _dot(r, z)
    trips = iters
    for it in range(iters):
        done = _dot(r, r) <= thresh2
        if it % _CHECK_EVERY == 0 and it and bool(done.all()):
            trips = it
            break
        Ap = mv(p)
        denom = _dot(p, Ap)
        alpha = torch.where(done | (denom.abs() < 1e-30), 0.0, rz / denom)[:, None]
        x = x + alpha * p
        r = r - alpha * Ap
        z = r / diag
        rz_new = _dot(r, z)
        beta = torch.where(rz.abs() < 1e-30, 0.0, rz_new / rz)[:, None]
        p = z + beta * p
        rz = rz_new
    if stats is not None:
        stats.setdefault("trips", []).append(trips)
    return x


def _bicgstab_fixed(mv, b: torch.Tensor, x0: torch.Tensor, diag: torch.Tensor, iters: int,
                    tol: float, stats: Optional[Dict] = None) -> torch.Tensor:
    """Jacobi-preconditioned BiCGStab with a fixed trip count, masked per
    realization, for the nonsymmetric gas-condensate Schur complement; stops
    early as :func:`_pcg_fixed` does, with the same exactness (``alpha`` and
    ``omega`` are zero for a converged realization)."""
    bnorm2 = _dot(b, b)
    thresh2 = (tol * tol) * bnorm2
    eps = 1e-30
    c = b.shape[0]
    x = x0
    r = b - mv(x0)
    rhat = r
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    rho = alpha = omega = b.new_ones((c,))
    trips = iters
    for it in range(iters):
        done = _dot(r, r) <= thresh2
        if it % _CHECK_EVERY == 0 and it and bool(done.all()):
            trips = it
            break
        rho_new = _dot(rhat, r)
        beta = torch.where((rho * omega).abs() < eps, 0.0,
                           (rho_new / torch.where(rho.abs() < eps, eps, rho))
                           * (alpha / torch.where(omega.abs() < eps, eps, omega)))
        p = r + beta[:, None] * (p - omega[:, None] * v)
        phat = p / diag
        v = mv(phat)
        denom = _dot(rhat, v)
        alpha_new = torch.where(done | (denom.abs() < eps), 0.0, rho_new / denom)
        s = r - alpha_new[:, None] * v
        shat = s / diag
        t = mv(shat)
        tt = _dot(t, t)
        omega_new = torch.where(done | (tt < eps), 0.0, _dot(t, s) / tt)
        x = x + alpha_new[:, None] * phat + omega_new[:, None] * shat
        r = s - omega_new[:, None] * t
        rho, alpha, omega = rho_new, alpha_new, omega_new
    if stats is not None:
        stats.setdefault("trips", []).append(trips)
    return x


def _dg_operator(x: torch.Tensor, shape, acc, Tx, Ty, Tz) -> torch.Tensor:
    """The dry-gas system ``acc·x + F x`` on the structured face grids."""
    c = x.shape[0]
    return acc * x + _stencil_apply(x.reshape((c,) + tuple(shape)), Tx, Ty, Tz).reshape(c, -1)


def _schur_operator(x: torch.Tensor, shape, Tgx, Tgy, Tgz, Tox, Toy, Toz, dAg_dp, dAo_dp,
                    r) -> torch.Tensor:
    """The gas-condensate Schur complement ``(Fg + dAg_dp) x − r·(Fo + dAo_dp) x``."""
    c = x.shape[0]
    x3 = x.reshape((c,) + tuple(shape))
    fg = _stencil_apply(x3, Tgx, Tgy, Tgz).reshape(c, -1)
    fo = _stencil_apply(x3, Tox, Toy, Toz).reshape(c, -1)
    return fg + dAg_dp * x - r * (fo + dAo_dp * x)


class _BlockedSolve:
    """One iterative solver (``"cg"`` or ``"bicgstab"``) on static buffers.

    The operator's operands, the preconditioner and the solver's state live
    in tensors of this object; each solve fills them with ``copy_`` and then
    runs blocks of ``_CHECK_EVERY`` trips that update the state in place,
    each trip the eager loop's (:func:`_pcg_fixed`, :func:`_bicgstab_fixed`)
    operation for operation, so the result and the trip count are its bits.
    Between blocks the host reads one flag (every realization done), where
    the eager loop tests ``done``. With ``graph`` (a CUDA device) each block
    length is captured once as a CUDA graph, after a warm-up block on a side
    stream, in a memory pool of this solver's own, and replayed; a capture
    that fails raises."""

    _STATE = {"cg": ("x", "r", "z", "p"), "bicgstab": ("x", "r", "rhat", "p", "v")}
    _SCALARS = {"cg": ("rz",), "bicgstab": ("rho", "alpha", "omega")}

    def __init__(self, kind: str, operator, shape, operands, b: torch.Tensor, graph: bool):
        self.kind, self.graph = kind, graph
        self.ops = [None if t is None else torch.zeros_like(t) for t in operands]
        self.mv = lambda x: operator(x, shape, *self.ops)   # noqa: E731
        self.v = {k: torch.zeros_like(b) for k in self._STATE[kind] + ("diag",)}
        self.s = {k: b.new_zeros(b.shape[:1]) for k in self._SCALARS[kind] + ("thresh2",)}
        self.flag = torch.zeros((), dtype=torch.bool, device=b.device)
        self.graphs: Dict[int, Any] = {}
        self.pool = torch.cuda.graph_pool_handle() if graph else None

    def _cg_trip(self) -> None:
        v, s = self.v, self.s
        x, r, z, p, diag, rz = v["x"], v["r"], v["z"], v["p"], v["diag"], s["rz"]
        done = _dot(r, r) <= s["thresh2"]
        Ap = self.mv(p)
        denom = _dot(p, Ap)
        alpha = torch.where(done | (denom.abs() < 1e-30), 0.0, rz / denom)[:, None]
        x.copy_(x + alpha * p)
        r.copy_(r - alpha * Ap)
        z.copy_(r / diag)
        rz_new = _dot(r, z)
        beta = torch.where(rz.abs() < 1e-30, 0.0, rz_new / rz)[:, None]
        p.copy_(z + beta * p)
        rz.copy_(rz_new)

    def _bicgstab_trip(self) -> None:
        v, s = self.v, self.s
        x, r, rhat, p, vv, diag = v["x"], v["r"], v["rhat"], v["p"], v["v"], v["diag"]
        rho, alpha, omega = s["rho"], s["alpha"], s["omega"]
        eps = 1e-30
        done = _dot(r, r) <= s["thresh2"]
        rho_new = _dot(rhat, r)
        beta = torch.where((rho * omega).abs() < eps, 0.0,
                           (rho_new / torch.where(rho.abs() < eps, eps, rho))
                           * (alpha / torch.where(omega.abs() < eps, eps, omega)))
        p.copy_(r + beta[:, None] * (p - omega[:, None] * vv))
        phat = p / diag
        vv.copy_(self.mv(phat))
        denom = _dot(rhat, vv)
        alpha_new = torch.where(done | (denom.abs() < eps), 0.0, rho_new / denom)
        s_ = r - alpha_new[:, None] * vv
        shat = s_ / diag
        t = self.mv(shat)
        tt = _dot(t, t)
        omega_new = torch.where(done | (tt < eps), 0.0, _dot(t, s_) / tt)
        x.copy_(x + alpha_new[:, None] * phat + omega_new[:, None] * shat)
        r.copy_(s_ - omega_new[:, None] * t)
        rho.copy_(rho_new)
        alpha.copy_(alpha_new)
        omega.copy_(omega_new)

    def _block(self, n: int) -> None:
        trip = self._cg_trip if self.kind == "cg" else self._bicgstab_trip
        for _ in range(n):
            trip()
        r = self.v["r"]
        self.flag.copy_((_dot(r, r) <= self.s["thresh2"]).all())

    def _capture(self, n: int) -> None:
        dev = self.flag.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._block(n)                      # warm-up; _start overwrites the state
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool):
            self._block(n)
        self.graphs[n] = graph

    def _start(self, b: torch.Tensor, x0: torch.Tensor, tol: float) -> None:
        """The eager loop's set-up, into the state buffers."""
        v, s = self.v, self.s
        s["thresh2"].copy_((tol * tol) * _dot(b, b))
        v["x"].copy_(x0)
        v["r"].copy_(b - self.mv(x0))
        if self.kind == "cg":
            v["z"].copy_(v["r"] / v["diag"])
            v["p"].copy_(v["z"])
            s["rz"].copy_(_dot(v["r"], v["z"]))
        else:
            v["rhat"].copy_(v["r"])
            v["p"].zero_()
            v["v"].zero_()
            for k in ("rho", "alpha", "omega"):
                s[k].fill_(1.0)

    def solve(self, operands, b, x0, diag, iters: int, tol: float) -> Tuple[torch.Tensor, int, int]:
        """(x, trips, blocks run) for the system with these operands."""
        for buf, t in zip(self.ops, operands):
            if buf is not None:
                buf.copy_(t)
        self.v["diag"].copy_(diag)
        step = max(1, min(_CHECK_EVERY, iters))
        starts = range(0, iters, step)
        if self.graph:
            for n in {min(step, iters - i) for i in starts} - set(self.graphs):
                self._capture(n)
        self._start(b, x0, tol)
        trips, blocks = iters, 0
        for i in starts:
            if i and bool(self.flag):
                trips = i
                break
            n = min(step, iters - i)
            if self.graph:
                self.graphs[n].replay()
            else:
                self._block(n)
            blocks += 1
        return self.v["x"].clone(), trips, blocks


class SolverGraphs:
    """The iterative solves' static buffers and CUDA graphs, one
    :class:`_BlockedSolve` per (solver, grid, operand shapes, dtype,
    device): made at the first solve of that kind and reused across sweeps,
    time steps and chunks. ``graph=False`` runs the same blocks eagerly (the
    CPU tests hold them to the eager loops). ``captures`` and ``replays``
    count graphs recorded and replayed."""

    def __init__(self, graph: bool = True):
        self.graph = graph
        self.captures = 0
        self.replays = 0
        self._solvers: Dict[tuple, _BlockedSolve] = {}

    def solve(self, kind: str, operator, shape, operands, b, x0, diag, iters: int,
              tol: float) -> Tuple[torch.Tensor, int]:
        key = (kind, tuple(shape), tuple(None if t is None else tuple(t.shape) for t in operands),
               tuple(b.shape), b.dtype, b.device)
        solver = self._solvers.get(key)
        if solver is None:
            solver = self._solvers[key] = _BlockedSolve(kind, operator, shape, operands, b,
                                                        self.graph)
        before = len(solver.graphs)
        x, trips, blocks = solver.solve(operands, b, x0, diag, iters, tol)
        self.captures += len(solver.graphs) - before
        if self.graph:
            self.replays += blocks
        return x, trips


def _iterative(kind: str, operator, shape, operands, b, x0, diag, iters: int, tol: float,
               stats: Optional[Dict], solvers: Optional[SolverGraphs]) -> torch.Tensor:
    """One iterative solve: on ``solvers``' blocks where given, else the
    eager loop (the reference)."""
    if solvers is None:
        loop = _pcg_fixed if kind == "cg" else _bicgstab_fixed
        return loop(lambda x: operator(x, shape, *operands), b, x0=x0, diag=diag,
                    iters=iters, tol=tol, stats=stats)
    x, trips = solvers.solve(kind, operator, shape, operands, b, x0, diag, iters, tol)
    if stats is not None:
        stats.setdefault("trips", []).append(trips)
    return x


def _solvers_for(device: torch.device, cuda_graph: Optional[bool],
                 solvers: Optional[SolverGraphs]) -> Optional[SolverGraphs]:
    """The blocks to solve on: ``solvers`` where given; else graphs on a
    CUDA device unless ``cuda_graph=False``, and the eager loops on the CPU
    (``cuda_graph=True`` there raises)."""
    on_cuda = device.type == "cuda"
    if cuda_graph and not on_cuda:
        raise ValueError(f"cuda_graph=True needs a CUDA device, the simulation runs on {device}")
    if solvers is not None:
        return solvers
    return SolverGraphs() if (on_cuda if cuda_graph is None else cuda_graph) else None


def _solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.solve`` of each realization's dense system. On the CPU
    one system at a time: a batched LU there can hang in MKL's row swaps
    when PyTorch runs more than one thread. On a CUDA device, up to the
    dense path's ``_DENSE_MAX_CELLS``, through MAGMA where PyTorch has it:
    its batched LU and triangular solves treat each matrix alone, so a
    realization's solution does not depend on how many share its chunk,
    where cuSOLVER's batched path (PyTorch's default) changes its algorithm
    with the batch size, so that the labels of a realization changed with
    its chunk (``tools/solve_backends.py`` compares the backends). Above
    that size (the 3D grids' dense reference solve, N = 15,210) MAGMA's
    solve fails on an H100, and cuSOLVER's runs."""
    if A.device.type == "cpu":
        return torch.stack([torch.linalg.solve(a, v) for a, v in zip(A, b)])
    if not torch.cuda.has_magma or A.shape[-1] > _DENSE_MAX_CELLS:
        return torch.linalg.solve(A, b)
    backends = torch.backends.cuda
    before = backends.preferred_linalg_library()
    backends.preferred_linalg_library("magma")
    try:
        return torch.linalg.solve(A, b)
    finally:
        backends.preferred_linalg_library(before)


def _resolve_solver(solver: str, n_cells: int) -> bool:
    """True → dense (one ``torch.linalg.solve`` per sweep), False →
    matrix-free iterative (Jacobi-preconditioned CG / BiCGStab). ``'auto'``
    picks dense for small grids and iterative once the dense matrix would
    dominate device memory."""
    if solver == "dense":
        return True
    if solver in ("cg", "iterative", "bicgstab"):
        return False
    if solver != "auto":
        raise ValueError(f"unknown solver {solver!r}")
    return n_cells <= _DENSE_MAX_CELLS


class _Setup:
    """What both simulations derive from the problem and the realizations'
    permeability ``kx (c, N)``, on ``kx``'s device and in its dtype: float32
    where the reference's arrays are (JAX without x64)."""

    def __init__(self, prob: FVProblem, kscale: np.ndarray, kx: torch.Tensor, times):
        dev = kx.device
        self.c, self.N = kx.shape
        self.shape = prob.shape
        tensor = lambda a, dtype=kx.dtype: torch.as_tensor(  # noqa: E731
            np.asarray(a), dtype=dtype, device=dev)
        self.i1 = tensor(prob.face_pairs[:, 0], torch.long)
        self.i2 = tensor(prob.face_pairs[:, 1], torch.long)
        k1, k2 = kx[:, self.i1], kx[:, self.i2]
        # harmonic-mean face permeability × geometric factor
        kf = tensor(kscale) * 2.0 * k1 * k2 / (k1 + k2 + 1e-30)
        self.G = tensor(prob.face_geom) * kf                       # (c, F)

        wc = np.asarray(prob.well_cells, np.int64)
        self.wc = tensor(wc, torch.long)
        self.q_t = tensor(prob.q_target)
        self.pwf_min = tensor(prob.pwf_min)
        self.ck = tensor(prob.well_ck_geom) * kx[:, self.wc]       # full Peaceman WI
        # wells that share a cell are summed in well order, then written once
        cells, first = np.unique(wc, return_index=True)
        groups = [np.flatnonzero(wc == cell) for cell in cells]
        self.well_slots = [tensor([g[j] if j < len(g) else g[0] for g in groups], torch.long)
                           for j in range(max(len(g) for g in groups))]
        self.well_extra = [tensor([j < len(g) for g in groups], torch.bool)
                           for j in range(len(self.well_slots))]
        self.cells = tensor(cells, torch.long)

        # per-step scalars, as the reference computes them in float32
        t = np.asarray(times, np.float32).reshape(-1)          # float32, as the reference
        self.T = t.size
        self.dt = tensor(np.maximum(t[1:] - t[:-1], np.float32(1e-6)))
        win = np.asarray(prob.shutin_windows, np.float32)
        t1 = t[1:, None, None]
        self.open_mask = tensor(np.logical_not(np.any((t1 >= win[None, :, :, 0])
                                                      & (t1 <= win[None, :, :, 1]), axis=-1)))

        phi = prob.phi
        self.cf_const = 97.32e-6 / (1.0 + 55.8721 * phi**1.428586)
        self.acc_scale = (prob.dv / prob.D) * prob.Sgi * phi
        if isinstance(phi, np.ndarray):
            self.cf_const, self.acc_scale = tensor(self.cf_const), tensor(self.acc_scale)
        self.phi = tensor(phi) if isinstance(phi, np.ndarray) else phi
        self.dv_D = tensor(prob.dv / prob.D)

    def well_sources(self, q_w: torch.Tensor) -> torch.Tensor:
        """``(c, W)`` well rates → ``(c, N)`` cell sources, a fixed-order sum."""
        vals = q_w[:, self.well_slots[0]]
        for slots, extra in zip(self.well_slots[1:], self.well_extra[1:]):
            vals = vals + torch.where(extra, q_w[:, slots], 0.0)
        out = q_w.new_zeros((self.c, self.N))
        out[:, self.cells] = vals
        return out

    def grid(self, v: torch.Tensor) -> torch.Tensor:
        return v.reshape((self.c,) + tuple(self.shape))

    def assemble(self, Tf: torch.Tensor, diag: torch.Tensor) -> torch.Tensor:
        """Dense ``(c, N, N)`` operator with −Tf on each face's two
        off-diagonal entries (each assigned once) and ``diag`` on the
        diagonal."""
        A = Tf.new_zeros((self.c, self.N, self.N))
        A[:, self.i1, self.i2] = -Tf
        A[:, self.i2, self.i1] = -Tf
        A.diagonal(dim1=1, dim2=2).copy_(diag)
        return A


def _batched(kx) -> Tuple[torch.Tensor, bool]:
    kx = torch.as_tensor(kx)
    return (kx[None], True) if kx.dim() == 1 else (kx, False)


def simulate_dry_gas(prob: FVProblem, kscale: np.ndarray, kx, times,
                     pvt_fn: Callable[[torch.Tensor], torch.Tensor], n_picard: int = 6,
                     solver: str = "auto", cg_tol: float = 1e-7,
                     cg_maxiter: int = 1000, stats: Optional[Dict] = None,
                     cuda_graph: Optional[bool] = None,
                     solvers: Optional[SolverGraphs] = None) -> torch.Tensor:
    """Pressure snapshots ``(c, T, N)`` for the realizations ``kx (c, N)``
    (or ``(T, N)`` for one ``kx (N,)``).

    ``kx`` — unnormalized permeability (flattened feature order z, y, x) on
    the device and in the dtype to run in (the reference's is float32);
    ``times`` — (T,) days, strictly increasing, ``times[0]`` is the initial
    condition (p = Pi); ``pvt_fn(p) → [2, P, *p.shape]`` as the PVT layer. ``solver`` — ``'dense'`` | ``'cg'`` |
    ``'auto'``: the system is symmetric positive definite, so the iterative
    path is Jacobi-preconditioned CG on the structured face operator. A
    ``stats`` dict collects the iterative solver's trips per solve. On a
    CUDA device the iterative solves run as CUDA graphs of
    ``_CHECK_EVERY`` trips (:class:`SolverGraphs`; ``solvers`` reuses one
    across calls), bitwise the eager loop that ``cuda_graph=False`` runs
    and that the CPU runs."""
    kx, single = _batched(kx)
    s = _Setup(prob, kscale, kx, times)
    c, N = s.c, s.N
    solvers = _solvers_for(kx.device, cuda_graph, solvers)

    def pvt_props(p):
        out = pvt_fn(p)
        return out[0, 0], out[0, 1], out[1, 0]       # invBg, invug, dinvBg

    dense = _resolve_solver(solver, N)
    if not dense:
        Gx, Gy, Gz = _split_face_grids(s.G, s.shape)

    ps = kx.new_empty((c, s.T, N))
    p_n = torch.full((c, N), prob.Pi, dtype=kx.dtype, device=kx.device)
    ps[:, 0] = p_n
    for n in range(s.T - 1):
        dt, open_mask = s.dt[n], s.open_mask[n]
        invBg_n, _, dinvBg_n = pvt_props(p_n)
        p = p_n
        for _ in range(n_picard):
            invBg, invug, _ = pvt_props(p)
            mob = invBg * invug
            # face mobility: arithmetic average of invBg·invug (as the loss)
            if dense:
                Tf = s.G * (prob.krgo * 0.5 * (mob[:, s.i1] + mob[:, s.i2]))
                Tx, Ty, Tz = _split_face_grids(Tf, s.shape)
            else:
                mx, my, mz = _axis_avg(s.grid(mob))
                Tx = Gx * (prob.krgo * mx) if Gx is not None else None
                Ty = Gy * (prob.krgo * my) if Gy is not None else None
                Tz = Gz * (prob.krgo * mz) if Gz is not None else None
            # accumulation: chord-slope ΔinvBg/Δp + rock compressibility
            dp = p - p_n
            chord = torch.where(dp.abs() > 1e-3, (invBg - invBg_n) / dp, dinvBg_n)
            acc = s.acc_scale * (chord + s.cf_const * invBg_n) / dt      # (c, N)
            # wells: rate target clipped by the min-BHP drawdown bound
            mg_w = prob.krgo * mob[:, s.wc]
            q_max = s.ck * mg_w * torch.clamp_min(p[:, s.wc] - s.pwf_min, 0.0)
            q_w = open_mask * torch.where(s.q_t >= 0.0, torch.minimum(s.q_t, q_max), s.q_t)
            b = acc * p_n - s.well_sources(q_w)
            diag = acc + _stencil_diag(s.grid(acc), Tx, Ty, Tz).reshape(c, N)
            if dense:
                p = _solve(s.assemble(Tf, diag), b)
            else:
                p = _iterative("cg", _dg_operator, s.shape, (acc, Tx, Ty, Tz), b, p,
                               diag, cg_maxiter, cg_tol, stats, solvers)
        ps[:, n + 1] = p_n = p
    return ps[0] if single else ps


def _unit_masses(vals, Sg, Swmin: float):
    """Surface gas and oil per unit pore volume from the PVT values."""
    invBg, invBo, Rs, Rv = vals[0], vals[1], vals[4], vals[5]
    So = 1.0 - Swmin - Sg
    return invBg * Sg + Rs * invBo * So, invBo * So + Rv * invBg * Sg


def simulate_gas_condensate(prob: FVProblem, kscale: np.ndarray, kx, times,
                            pvt_fn: Callable[[torch.Tensor], torch.Tensor],
                            relperm, Swmin: float, n_newton: int = 8,
                            solver: str = "auto", cg_tol: float = 1e-7,
                            cg_maxiter: int = 1000,
                            stats: Optional[Dict] = None,
                            cuda_graph: Optional[bool] = None,
                            solvers: Optional[SolverGraphs] = None) -> torch.Tensor:
    """Two-phase (gas-condensate) snapshots ``(c, T, N, 2)`` — (p, Sg) — for
    the realizations ``kx (c, N)`` (or ``(T, N, 2)`` for one ``kx (N,)``).

    Per-cell unknowns (p, Sg) with So = 1 − Swmin − Sg; surface-mass
    conservation in the loss's scheme (gas: free + dissolved in oil; oil:
    free + vaporized in gas; upstream relperm at faces, arithmetic face
    averages of the PVT products); Peaceman wells under surface-gas-rate
    control with the min-BHP clip, the oil rate split by the mobility ratio.
    Backward Euler, Newton on the accumulation with Picard-lagged fluxes;
    δSg eliminated per cell (diagonal Schur complement), so each iteration
    is one linear solve in δp: dense, or Jacobi-preconditioned BiCGStab on
    the structured face operators (the Schur matrix is nonsymmetric), graphed
    on a CUDA device as in :func:`simulate_dry_gas`."""
    kx, single = _batched(kx)
    s = _Setup(prob, kscale, kx, times)
    c, N = s.c, s.N
    solvers = _solvers_for(kx.device, cuda_graph, solvers)
    phi0, Sgi = s.phi, prob.Sgi

    def nonzero(a):
        return torch.where(a.abs() > 1e-30, a, -1e-30)

    dense = _resolve_solver(solver, N)
    if not dense:
        Gx, Gy, Gz = _split_face_grids(s.G, s.shape)

    out = kx.new_empty((c, s.T, N, 2))
    p_n = torch.full((c, N), prob.Pi, dtype=kx.dtype, device=kx.device)
    Sg_n = torch.full((c, N), Sgi, dtype=kx.dtype, device=kx.device)
    out[:, 0, :, 0], out[:, 0, :, 1] = p_n, Sg_n
    for n in range(s.T - 1):
        dt, open_mask = s.dt[n], s.open_mask[n]
        cdt = s.dv_D / dt
        vals_n = pvt_fn(p_n)[0]                     # [7, c, N] values
        ug_n, uo_n = _unit_masses(vals_n, Sg_n, Swmin)
        p, Sg = p_n, Sg_n
        for _ in range(n_newton):
            vals, der = pvt_fn(p)
            invBg, invBo, invug, invuo, Rs, Rv = (vals[i] for i in range(6))
            dinvBg, dinvBo, dRs, dRv = der[0], der[1], der[4], der[5]
            So = 1.0 - Swmin - Sg
            krog, krgo = relperm(Sg)
            bgug = invBg * invug
            bouo = invBo * invuo
            rsbouo = Rs * bouo
            rvbgug = Rv * bgug

            if dense:
                # upstream relperm on faces (i1 upstream unless p rises toward i2)
                i1, i2 = s.i1, s.i2
                up = (p[:, i2] - p[:, i1]) > 0
                krgo_f = torch.where(up, krgo[:, i2], krgo[:, i1])
                krog_f = torch.where(up, krog[:, i2], krog[:, i1])
                lam_g = (krgo_f * 0.5 * (bgug[:, i1] + bgug[:, i2])
                         + krog_f * 0.5 * (rsbouo[:, i1] + rsbouo[:, i2]))
                lam_o = (krog_f * 0.5 * (bouo[:, i1] + bouo[:, i2])
                         + krgo_f * 0.5 * (rvbgug[:, i1] + rvbgug[:, i2]))
                Tg, To = s.G * lam_g, s.G * lam_o
                Tgs, Tos = _split_face_grids(Tg, s.shape), _split_face_grids(To, s.shape)
                diag_g = _stencil_diag(s.grid(p), *Tgs).reshape(c, N)
                diag_o = _stencil_diag(s.grid(p), *Tos).reshape(c, N)
                Fg, Fo = s.assemble(Tg, diag_g), s.assemble(To, diag_o)
                fg_apply = lambda x: torch.bmm(Fg, x[..., None])[..., 0]    # noqa: E731
                fo_apply = lambda x: torch.bmm(Fo, x[..., None])[..., 0]    # noqa: E731
            else:
                # structured face grids (no gather/scatter on the hot path)
                p3 = s.grid(p)
                kg_up = _axis_upstream(s.grid(krgo), p3)
                ko_up = _axis_upstream(s.grid(krog), p3)
                Tgs, Tos = [], []
                for Ga, kg, ko, bg, bo, rs, rv in zip(
                        (Gx, Gy, Gz), kg_up, ko_up, _axis_avg(s.grid(bgug)),
                        _axis_avg(s.grid(bouo)), _axis_avg(s.grid(rsbouo)),
                        _axis_avg(s.grid(rvbgug))):
                    Tgs.append(None if Ga is None else Ga * (kg * bg + ko * rs))
                    Tos.append(None if Ga is None else Ga * (ko * bo + kg * rv))
                diag_g = _stencil_diag(p3, *Tgs).reshape(c, N)
                diag_o = _stencil_diag(p3, *Tos).reshape(c, N)
                fg_apply = lambda x: _stencil_apply(s.grid(x), *Tgs).reshape(c, N)  # noqa: E731
                fo_apply = lambda x: _stencil_apply(s.grid(x), *Tos).reshape(c, N)  # noqa: E731

            # wells: surface-gas-rate control, min-BHP drawdown clip; the oil
            # rate follows the phase mobility ratio at the well cell
            mg_w = (krgo * bgug + krog * rsbouo)[:, s.wc]
            mo_w = (krog * bouo + krgo * rvbgug)[:, s.wc]
            qg_max = s.ck * mg_w * torch.clamp_min(p[:, s.wc] - s.pwf_min, 0.0)
            qg_w = open_mask * torch.where(s.q_t >= 0.0, torch.minimum(s.q_t, qg_max), s.q_t)
            qo_w = qg_w * mo_w / (mg_w + 1e-30)

            # accumulations with rock compressibility φ(p) = φ0·(1+cf·(p−p_n))
            phi_p = phi0 * (1.0 + s.cf_const * (p - p_n))
            ug, uo = _unit_masses(vals, Sg, Swmin)
            Rg = cdt * (phi_p * ug - phi0 * ug_n) + fg_apply(p) + s.well_sources(qg_w)
            Ro = cdt * (phi_p * uo - phi0 * uo_n) + fo_apply(p) + s.well_sources(qo_w)

            dug_dp = dinvBg * Sg + (dRs * invBo + Rs * dinvBo) * So
            duo_dp = dinvBo * So + (dRv * invBg + Rv * dinvBg) * Sg
            dug_dS = invBg - Rs * invBo
            duo_dS = Rv * invBg - invBo                  # < 0 (invBo dominates)
            dAg_dp = cdt * (phi0 * s.cf_const * ug + phi_p * dug_dp)
            dAo_dp = cdt * (phi0 * s.cf_const * uo + phi_p * duo_dp)
            dAg_dS = cdt * phi_p * dug_dS
            dAo_dS = cdt * phi_p * duo_dS

            # Schur complement: eliminate the (diagonal) δSg block
            r = dAg_dS / nonzero(dAo_dS)
            jop_apply = lambda x: fo_apply(x) + dAo_dp * x       # noqa: E731
            rhs = -Rg + r * Ro
            s_diag = (diag_g + dAg_dp) - r * (diag_o + dAo_dp)
            if dense:
                # (Fg + dAg_dp·I) − r·(Fo + dAo_dp·I), its diagonal from the vectors
                S = Fg - r[:, :, None] * Fo
                S.diagonal(dim1=1, dim2=2).copy_(s_diag)
                dp = _solve(S, rhs)
            else:
                dp = _iterative("bicgstab", _schur_operator, s.shape,
                                (*Tgs, *Tos, dAg_dp, dAo_dp, r), rhs, torch.zeros_like(rhs),
                                s_diag, cg_maxiter, cg_tol, stats, solvers)
            dSg = (-Ro - jop_apply(dp)) / nonzero(dAo_dS)
            p = torch.clamp(p + dp, 14.7, 1e4)
            Sg = torch.clamp(Sg + dSg, 0.0, Sgi)
        out[:, n + 1, :, 0] = p_n = p
        out[:, n + 1, :, 1] = Sg_n = Sg
    return out[0] if single else out


@torch.no_grad()
def mass_balance(prob: FVProblem, kscale: np.ndarray, kx, times, out: torch.Tensor,
                 pvt_fn, relperm=None, Swmin: Optional[float] = None) -> torch.Tensor:
    """The scheme's conservation residual at each step of a simulation:
    (Σ_cells Δ(surface mass) + Σ_wells q·Δt) / Σ_wells q·Δt, with the well
    rates rebuilt from the step's new state as the simulator clips them.
    Dry gas from pressures ``out (c, T, N)`` → ``(c, T-1)``; gas condensate
    from ``out (c, T, N, 2)`` → ``(c, T-1, 2)``, gas then oil. Picard and
    Newton stop after a fixed count, so it is small, not zero."""
    kx, _ = _batched(kx)
    s = _Setup(prob, kscale, kx, times)
    wc, dt = s.wc, s.dt
    ck = s.ck[:, None]                                             # (c, 1, W)
    if out.dim() == 3:                                             # dry gas
        p0, p1 = out[:, :-1], out[:, 1:]
        (invBg0, _), (invBg1, invug1) = pvt_fn(p0)[0], pvt_fn(p1)[0]
        dmass = s.acc_scale * ((invBg1 - invBg0) + s.cf_const * invBg0 * (p1 - p0))
        q_max = ck * (prob.krgo * (invBg1 * invug1)[..., wc]) * torch.clamp_min(
            p1[..., wc] - s.pwf_min, 0.0)
        q = s.open_mask * torch.where(s.q_t >= 0, torch.minimum(s.q_t, q_max), s.q_t)
        qdt = q.sum(-1) * dt
        return (dmass.sum(-1) + qdt) / qdt
    p0, p1 = out[:, :-1, :, 0], out[:, 1:, :, 0]
    sg0, sg1 = out[:, :-1, :, 1], out[:, 1:, :, 1]
    v0, v1 = pvt_fn(p0)[0], pvt_fn(p1)[0]
    ug0, uo0 = _unit_masses(v0, sg0, Swmin)
    ug1, uo1 = _unit_masses(v1, sg1, Swmin)
    phi_p = s.phi * (1.0 + s.cf_const * (p1 - p0))
    invBg, invBo, invug, invuo, Rs, Rv = (v1[i] for i in range(6))
    krog, krgo = relperm(sg1)
    bgug, bouo = invBg * invug, invBo * invuo
    mg = (krgo * bgug + krog * Rs * bouo)[..., wc]
    mo = (krog * bouo + krgo * Rv * bgug)[..., wc]
    qg_max = ck * mg * torch.clamp_min(p1[..., wc] - s.pwf_min, 0.0)
    qg = s.open_mask * torch.where(s.q_t >= 0, torch.minimum(s.q_t, qg_max), s.q_t)
    qo = qg * mo / (mg + 1e-30)
    errs = []
    for u0, u1, q in ((ug0, ug1, qg), (uo0, uo1, qo)):
        dm = s.dv_D * (phi_p * u1 - s.phi * u0)
        qdt = q.sum(-1) * dt
        errs.append((dm.sum(-1) + qdt) / qdt)
    return torch.stack(errs, -1)


def _chunks(flat: torch.Tensor, chunk: int):
    """Blocks of ``chunk`` realizations; the tail block is padded with
    copies of its last realization (as the reference keeps one compiled
    shape), and the pad count is returned with each block."""
    K = flat.shape[0]
    for s in range(0, K, chunk):
        block = flat[s:s + chunk]
        pad = 0
        if block.shape[0] < chunk and s > 0:
            pad = chunk - block.shape[0]
            block = torch.cat([block, block[-1:].expand(pad, -1)])
        yield block, pad


def _device(device) -> torch.device:
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no usable CUDA device: the simulator runs on the GPU by default; "
                           'pass device="cpu" to run it on the CPU')
    return device


def simulate_realizations(prob: FVProblem, kscale: np.ndarray, kx_fields: np.ndarray,
                          times, pvt_fn, n_picard: int = 6, chunk: int = 16,
                          solver: str = "auto", cg_tol: float = 1e-7,
                          cg_maxiter: int = 1000, device=None,
                          stats: Optional[Dict] = None,
                          cuda_graph: Optional[bool] = None) -> np.ndarray:
    """(K, Nz, Ny, Nx) × (T,) → (K, T, Nz, Ny, Nx) pressures, on ``device``
    (default ``"cuda"``; it raises without a card), ``chunk`` realizations
    at a time: each dense Picard sweep holds a (chunk, N, N) system and its
    LU factors. The iterative solves' graphs are captured once for all
    chunks."""
    dev = _device(device)
    solvers = _solvers_for(dev, cuda_graph, None)
    K = kx_fields.shape[0]
    flat = torch.as_tensor(np.asarray(kx_fields, np.float32).reshape(K, -1), device=dev)
    outs = []
    for block, pad in _chunks(flat, chunk):
        ps = simulate_dry_gas(prob, kscale, block, times, pvt_fn, n_picard, solver=solver,
                              cg_tol=cg_tol, cg_maxiter=cg_maxiter, stats=stats,
                              cuda_graph=cuda_graph, solvers=solvers)
        outs.append(ps[:ps.shape[0] - pad].cpu().numpy())
    ps = np.concatenate(outs, axis=0)
    return ps.reshape((K, ps.shape[1]) + tuple(prob.shape))


def simulate_realizations_gc(prob: FVProblem, kscale: np.ndarray, kx_fields: np.ndarray,
                             times, pvt_fn, relperm, Swmin: float, n_newton: int = 8,
                             chunk: int = 16, solver: str = "auto", cg_tol: float = 1e-7,
                             cg_maxiter: int = 1000, device=None,
                             stats: Optional[Dict] = None,
                             cuda_graph: Optional[bool] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Gas condensate over realizations → (P, Sg), each ``(K, T, Nz, Ny,
    Nx)``; chunked like :func:`simulate_realizations`. The JAX package
    takes half its dry-gas chunk here (each Newton iteration holds two dense
    flux matrices and the Schur system, sized for a TPU's memory); on an
    H100 the default case's test split (140 realizations × 74 times) took
    264.2 s at chunk 16 against 476.6 s at 8, bitwise equal
    (``tools/label_chunks.py``), so the port's default is 16."""
    dev = _device(device)
    solvers = _solvers_for(dev, cuda_graph, None)
    K = kx_fields.shape[0]
    flat = torch.as_tensor(np.asarray(kx_fields, np.float32).reshape(K, -1), device=dev)
    outs = []
    for block, pad in _chunks(flat, chunk):
        ps = simulate_gas_condensate(prob, kscale, block, times, pvt_fn, relperm, Swmin,
                                     n_newton, solver=solver, cg_tol=cg_tol,
                                     cg_maxiter=cg_maxiter, stats=stats,
                                     cuda_graph=cuda_graph, solvers=solvers)
        outs.append(ps[:ps.shape[0] - pad].cpu().numpy())
    ps = np.concatenate(outs, axis=0)
    grid = ps.reshape((K, ps.shape[1]) + tuple(prob.shape) + (2,))
    return grid[..., 0], grid[..., 1]
