"""The simulator's blocked iterative solves (what a CUDA device replays as
CUDA graphs), its label chunk and its environment knobs, on the CPU.

``SolverGraphs(graph=False)`` runs the blocks of ``_CHECK_EVERY`` trips
that the card captures, eagerly: each trip updates static buffers in place
with the eager loop's operations, so the result must be the eager loop's
bits and ``stats["trips"]`` its trip count, on a 9×9×9 dry-gas problem (CG)
and a 9×9×9 gas-condensate problem (BiCGStab), at the default trip cap and
at one that is not a multiple of the block (the tail block). Both stay
within ``tests/test_torch_sim.py``'s tolerances of the JAX simulator.
"""

import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srm_tpu.config import DEFAULT_GENERAL_CONFIG as J_GENERAL
from srm_tpu.config import DEFAULT_RESERVOIR_CONFIG as J_RESERVOIR
from srm_tpu.config import DEFAULT_SCAL_CONFIG as J_SCAL
from srm_tpu.physics.relperm import RelativePermeability as JaxRelativePermeability
from srm_tpu.sim import build_problem as jax_build_problem
from srm_tpu.sim import simulate_dry_gas as jax_simulate_dry_gas
from srm_tpu.sim import simulate_gas_condensate as jax_simulate_gas_condensate
from srm_tpu_torch.config import (DEFAULT_GENERAL_CONFIG, DEFAULT_RESERVOIR_CONFIG,
                                  DEFAULT_SCAL_CONFIG, DEFAULT_WELLS_CONFIG)
from srm_tpu_torch.physics.relperm import RelativePermeability
from srm_tpu_torch.sim import (build_problem, fv_simulator, simulate_dry_gas,
                               simulate_gas_condensate, simulate_labels)
from srm_tpu_torch.sim.fv_simulator import SolverGraphs, simulate_realizations_gc
from srm_tpu_torch.tools import label_chunks
from test_fv_simulator import _pvt_fn as jax_pvt_fn
from test_torch_sim import PSIA_TOL, port_processor, port_pvt, seeded_kx
from test_torch_sim_gc import SG_TOL, SWMIN

N9 = 9 * 9 * 9


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def wells9(drawdown=False):
    wells = copy.deepcopy(DEFAULT_WELLS_CONFIG)
    for conn in wells["connections"]:
        conn["i"] = min(conn["i"] * 9 // 39, 8)
        conn["j"] = min(conn["j"] * 9 // 39, 8)
        if drawdown:
            conn["minimum_bhp"] = 1500.0
            conn["value"] *= 4.0
    return wells


def problems9(drawdown=False):
    """Both packages' 9×9×9 problem (the 3D grid the iterative path runs)."""
    out = []
    for res0, scal, g, build in ((J_RESERVOIR, J_SCAL, J_GENERAL, jax_build_problem),
                                 (DEFAULT_RESERVOIR_CONFIG, DEFAULT_SCAL_CONFIG,
                                  DEFAULT_GENERAL_CONFIG, build_problem)):
        res = copy.deepcopy(res0)
        res["Nx"] = res["Ny"] = res["Nz"] = 9
        out.append(build(res, wells9(drawdown), scal, copy.deepcopy(g)))
    return out


def relperm():
    return RelativePermeability.from_config(DEFAULT_SCAL_CONFIG["end_points"],
                                            DEFAULT_SCAL_CONFIG["corey_exponents"])


def two_realizations(seed):
    """Two fields that converge at different trips."""
    return torch.from_numpy(np.stack([seeded_kx(seed, N9), 20.0 * seeded_kx(seed + 1, N9)]))


@pytest.mark.parametrize("maxiter", [1000, 40])
def test_blocked_cg_is_bitwise_the_eager_loop(maxiter):
    (jp, jk), (tp, tk) = problems9()
    kx = two_realizations(0)
    times = np.array([0.0, 30.0, 60.0, 90.0], np.float32)
    eager, blocked = {}, {}
    want = simulate_dry_gas(tp, tk, kx, times, port_pvt(), solver="cg", cg_maxiter=maxiter,
                            stats=eager)
    solvers = SolverGraphs(graph=False)
    got = simulate_dry_gas(tp, tk, kx, times, port_pvt(), solver="cg", cg_maxiter=maxiter,
                           stats=blocked, solvers=solvers)
    assert torch.equal(got, want)
    assert blocked["trips"] == eager["trips"] and len(eager["trips"]) == 3 * 6, (blocked, eager)
    # one solver (its buffers, on a card its graphs) for every sweep and step
    assert len(solvers._solvers) == 1 and solvers.replays == solvers.captures == 0
    if maxiter == 40:
        assert set(eager["trips"]) == {40}          # the 8-trip tail block ran
        return
    assert max(eager["trips"]) < maxiter
    ref = np.stack([np.asarray(jax_simulate_dry_gas(jp, jk, jnp.asarray(k.numpy()), times,
                                                    jax_pvt_fn("DG"), solver="cg"))
                    for k in kx])
    assert np.abs(got.numpy() - ref).max() < PSIA_TOL, np.abs(got.numpy() - ref).max()


@pytest.mark.parametrize("maxiter", [1000, 40])
def test_blocked_bicgstab_is_bitwise_the_eager_loop(maxiter):
    """One realization whose solves stop early at some steps and run the
    trip cap at others."""
    (jp, jk), (tp, tk) = problems9()
    kx = torch.from_numpy(seeded_kx(4, N9))[None]
    times = np.array([0.0, 10.0, 20.0], np.float32)
    run = lambda stats, **kw: simulate_gas_condensate(  # noqa: E731
        tp, tk, kx, times, port_pvt("GC"), relperm(), SWMIN, n_newton=3, solver="bicgstab",
        cg_maxiter=maxiter, stats=stats, **kw)
    eager, blocked = {}, {}
    want = run(eager)
    got = run(blocked, solvers=SolverGraphs(graph=False))
    assert torch.equal(got, want)
    assert blocked["trips"] == eager["trips"] and len(eager["trips"]) == 2 * 3, (blocked, eager)
    if maxiter == 40:
        assert set(eager["trips"]) == {40}
        return
    # float32 BiCGStab in 3D mostly stalls above the 1e-7 tolerance and runs
    # the cap (the reference runs the cap always); one solve here converges
    # and stops at a check
    assert min(eager["trips"]) < maxiter
    jrp = JaxRelativePermeability.from_config(J_SCAL["end_points"], J_SCAL["corey_exponents"])
    ref = np.stack([np.asarray(jax_simulate_gas_condensate(
        jp, jk, jnp.asarray(k.numpy()), times, jax_pvt_fn("GC"), jrp, SWMIN, n_newton=3,
        solver="bicgstab")) for k in kx])
    got = got.numpy()
    assert np.abs(got[..., 0] - ref[..., 0]).max() < PSIA_TOL
    assert np.abs(got[..., 1] - ref[..., 1]).max() < SG_TOL


def test_graphs_need_a_cuda_device():
    (_, _), (tp, tk) = problems9()
    with pytest.raises(ValueError, match="CUDA"):
        simulate_dry_gas(tp, tk, two_realizations(0), np.array([0.0, 30.0], np.float32),
                         port_pvt(), solver="cg", cuda_graph=True)


@pytest.mark.parametrize("fluid, loop", [("DG", "_pcg_fixed"), ("GC", "_bicgstab_fixed")])
def test_environment_knobs_reach_the_solver(tmp_path, monkeypatch, fluid, loop):
    """``SRM_TPU_SIM_SOLVER/CHUNK/TOL/MAXITER`` reach the iterative loop's
    trip cap and tolerance and the simulation's chunk of realizations."""
    seen = {"iters": set(), "tol": set(), "chunks": []}
    inner = getattr(fv_simulator, loop)

    def spy_loop(mv, b, x0, diag, iters, tol, stats=None):
        seen["iters"].add(iters)
        seen["tol"].add(tol)
        return inner(mv, b, x0, diag, iters, tol, stats)

    sim = "simulate_dry_gas" if fluid == "DG" else "simulate_gas_condensate"
    outer = getattr(fv_simulator, sim)

    def spy_sim(prob, kscale, kx, *a, **kw):
        seen["chunks"].append(kx.shape[0])
        return outer(prob, kscale, kx, *a, **kw)

    monkeypatch.setattr(fv_simulator, loop, spy_loop)
    monkeypatch.setattr(fv_simulator, sim, spy_sim)
    for name, value in (("SOLVER", "iterative"), ("CHUNK", "1"), ("TOL", "1e-5"),
                        ("MAXITER", "64")):
        monkeypatch.setenv(f"SRM_TPU_SIM_{name}", value)
    proc = port_processor(tmp_path, fluid)
    permx = proc.generate_kle_splits()["test"][:2]
    times = proc.generate_time_tensor()["test"].reshape(-1)[:3]
    labels = simulate_labels(proc, "test", permx=permx, times=times, device="cpu")
    assert np.isfinite(labels["PRESSURE"]).all()
    assert seen == {"iters": {64}, "tol": {1e-5}, "chunks": [1, 1]}, seen


def test_gc_labels_are_bitwise_equal_at_chunks_8_and_16():
    """The default case's dense path at 9×9 on 20 realizations: 3 chunks of
    8 (the tail padded) against 2 of 16. (On the CPU the chunk can move a
    label by an ulp's consequences where a block ends in a vector loop's
    tail: the next test shows one at 13×13.)"""
    res = copy.deepcopy(DEFAULT_RESERVOIR_CONFIG)
    res["Nx"] = res["Ny"] = 9
    tp, tk = build_problem(res, wells9(drawdown=True), DEFAULT_SCAL_CONFIG,
                           copy.deepcopy(DEFAULT_GENERAL_CONFIG))
    kx = np.stack([seeded_kx(s, 81) for s in range(20)]).reshape(20, 1, 9, 9)
    times = np.array([0.0, 100.0, 200.0, 400.0], np.float32)
    run = lambda chunk: simulate_realizations_gc(  # noqa: E731
        tp, tk, kx, times, port_pvt("GC"), relperm(), SWMIN, n_newton=4, chunk=chunk,
        device="cpu")
    (p8, s8), (p16, s16) = run(8), run(16)
    assert p8.shape == (20, 4, 1, 9, 9) and p8.min() < tp.Pi - 50.0
    assert p8.tobytes() == p16.tobytes() and s8.tobytes() == s16.tobytes()


def test_label_chunks_compares_the_labels_across_chunks(tmp_path, monkeypatch):
    """``tools/label_chunks.compare``: ``simulate_labels`` under each
    ``SRM_TPU_SIM_CHUNK``, on the processor's device (here the CPU), 20
    realizations of the 13×13 drawdown case, 4 times; its flag is what the
    labels show, and the override is put back afterwards.

    On the CPU these labels are not bitwise equal across the two chunks: one
    cell of realization 15 at the last time differs by 0.0088 psia. A block
    of 8 realizations of 169 cells ends in a vector loop's scalar tail,
    where PyTorch's CPU kernels round some functions (``pow`` with a
    fractional exponent, ``softplus``) differently from their vectorized
    body; whether a chunk size changes a label there depends on the
    values. The decision on the card's chunk rests on the card's labels."""
    monkeypatch.setenv("SRM_TPU_SIM_CHUNK", "3")
    proc = port_processor(tmp_path, "GC", drawdown=True)
    permx = np.stack([seeded_kx(s, 169) for s in range(20)]).reshape(20, 1, 13, 13)
    times = np.array([0.0, 100.0, 200.0, 400.0], np.float32)
    got = label_chunks.compare(proc, permx, times, (8, 16))
    assert set(got["seconds"]) == {"8", "16"} and os.environ["SRM_TPU_SIM_CHUNK"] == "3"
    assert got["shapes"] == {"PRESSURE": [20, 4, 1, 13, 13], "SGAS": [20, 4, 1, 13, 13]}
    labels = []
    for chunk in ("8", "16"):
        monkeypatch.setenv("SRM_TPU_SIM_CHUNK", chunk)
        labels.append(simulate_labels(proc, "test", permx=permx, times=times))
    gap = max(float(np.abs(labels[0][k] - labels[1][k]).max()) for k in labels[0])
    assert got["bitwise_equal"] == (gap == 0.0)
    assert gap < 0.05                       # an ulp's consequences, not another solution
