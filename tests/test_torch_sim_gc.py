"""The port's two-phase (gas-condensate) FV simulator, its labels through
the dataset and the saturation RMSE, against the JAX package's on the same
inputs, on the CPU.

The 13×13 problem runs with ``test_fv_simulator_gc``'s drawdown wells
(minimum BHP 1500 psia, rates ×4), so that the pressure crosses the dew
point and the saturation moves. Tolerances: pressures within 0.1 psia and Sg
within 1e-3 of the reference (its own bounds between its dense and
iterative solvers); the RMSE within 1e-4 relative.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srm_tpu.config import DEFAULT_GENERAL_CONFIG as J_GENERAL
from srm_tpu.config import DEFAULT_SCAL_CONFIG as J_SCAL
from srm_tpu.physics.relperm import RelativePermeability as JaxRelativePermeability
from srm_tpu.sim import build_problem as jax_build_problem
from srm_tpu.sim import simulate_gas_condensate as jax_simulate_gas_condensate
from srm_tpu_torch.config import (DEFAULT_GENERAL_CONFIG, DEFAULT_RESERVOIR_CONFIG,
                                  DEFAULT_SCAL_CONFIG)
from srm_tpu_torch.physics.relperm import RelativePermeability
from srm_tpu_torch.sim import build_problem, fv_simulator, simulate_gas_condensate
from test_fv_simulator import _pvt_fn as jax_pvt_fn
from test_torch_sim import (PSIA_TOL, jax_processor, labelled_port_case, port_processor,
                            port_pvt, seeded_kx, small_wells)

SG_TOL = 1e-3
SWMIN = DEFAULT_SCAL_CONFIG["end_points"]["Swmin"]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def relperm():
    scal = DEFAULT_SCAL_CONFIG
    return RelativePermeability.from_config(scal["end_points"], scal["corey_exponents"])


def problems():
    """Both packages' 13×13 problem with the drawdown wells."""
    res = copy.deepcopy(DEFAULT_RESERVOIR_CONFIG)
    res["Nx"] = res["Ny"] = 13
    wells = small_wells(drawdown=True)
    return (jax_build_problem(res, wells, J_SCAL, copy.deepcopy(J_GENERAL)),
            build_problem(res, wells, DEFAULT_SCAL_CONFIG, copy.deepcopy(DEFAULT_GENERAL_CONFIG)))


@pytest.mark.parametrize("solver", ["dense", "bicgstab"])
def test_matches_reference(solver):
    """Measured on the CPU: dense 0.018 psia and 4.0e-6 Sg apart, BiCGStab
    0.010 psia and 2.9e-6."""
    (jp, jk), (tp, tk) = problems()
    kx = seeded_kx(1, 13 * 13)
    times = np.linspace(0, 1500, 12).astype(np.float32)
    jrp = JaxRelativePermeability.from_config(J_SCAL["end_points"], J_SCAL["corey_exponents"])
    want = np.asarray(jax_simulate_gas_condensate(jp, jk, jnp.asarray(kx), times,
                                                  jax_pvt_fn("GC"), jrp, SWMIN, solver=solver))
    got = simulate_gas_condensate(tp, tk, torch.from_numpy(kx), times, port_pvt("GC"),
                                  relperm(), SWMIN, solver=solver).numpy()
    assert got.shape == want.shape == (12, 169, 2)
    # the case crosses the dew point and condensate drops out
    assert want[..., 0].min() < 3700.0 and want[..., 1].min() < tp.Sgi - 0.05
    assert np.abs(got[..., 0] - want[..., 0]).max() < PSIA_TOL
    assert np.abs(got[..., 1] - want[..., 1]).max() < SG_TOL


def test_early_exit_is_bitwise_the_full_trip_count(monkeypatch):
    _, (tp, tk) = problems()
    kx = torch.from_numpy(np.stack([seeded_kx(4, 169), 20.0 * seeded_kx(5, 169)]))
    times = np.array([0.0, 200.0, 400.0], np.float32)
    run = lambda stats: simulate_gas_condensate(  # noqa: E731
        tp, tk, kx, times, port_pvt("GC"), relperm(), SWMIN, n_newton=3, solver="bicgstab",
        cg_maxiter=300, stats=stats)
    early, full = {}, {}
    got = run(early)
    monkeypatch.setattr(fv_simulator, "_CHECK_EVERY", 10 ** 9)
    want = run(full)
    assert max(early["trips"]) < 300 and set(full["trips"]) == {300}, (early, full)
    assert torch.equal(got, want)


# -- the reference's physical checks, on the port alone ------------------------
def test_depletes_and_condenses():
    """Above the dew point Sg stays at Sgi; once the drawdown crosses it,
    condensate drops out while the pressure keeps falling."""
    _, (prob, kscale) = problems()
    kx = torch.full((169,), 30.0)
    times = np.linspace(0.0, 1500.0, 31).astype(np.float32)
    out = simulate_gas_condensate(prob, kscale, kx, times, port_pvt("GC"), relperm(),
                                  SWMIN).numpy()
    p, sg = out[..., 0], out[..., 1]
    assert np.isfinite(out).all()
    np.testing.assert_allclose(p[0], prob.Pi)
    np.testing.assert_allclose(sg[0], prob.Sgi, atol=1e-5)
    assert (np.diff(p.mean(axis=1)) < 0).all()
    above = p.min(axis=1) > 4100.0
    assert above[:3].all()
    np.testing.assert_allclose(sg[above], prob.Sgi, atol=2e-3)
    assert p.min() < 3700.0
    assert sg[-1].mean() < prob.Sgi - 0.05
    assert sg.min() >= 0.0 and sg.max() <= prob.Sgi + 1e-5


def test_mass_balance():
    """Σ_cells Δ(surface mass) ≈ −Σ_wells q·Δt per step and per component,
    within 2%; ``fv_simulator.mass_balance`` gives the same."""
    _, (prob, kscale) = problems()
    pvt, rp = port_pvt("GC"), relperm()
    kx = np.exp(np.random.RandomState(3).uniform(2.5, 4.0, 169)).astype(np.float32)
    times = np.array([0.0, 200.0, 400.0, 600.0, 800.0], np.float32)
    out = simulate_gas_condensate(prob, kscale, torch.from_numpy(kx), times, pvt, rp, SWMIN,
                                  n_newton=12)
    helper = fv_simulator.mass_balance(prob, kscale, kx, times, out[None], pvt, rp,
                                       SWMIN)[0].numpy()
    with torch.no_grad():
        vals = [pvt(o[:, 0])[0].numpy() for o in out]
        kr = [tuple(a.numpy() for a in rp(o[:, 1])) for o in out]
    out = out.numpy()
    p, sg = out[..., 0], out[..., 1]
    cf = 97.32e-6 / (1.0 + 55.8721 * prob.phi**1.428586)

    def unit_masses(v, s):
        so = 1.0 - SWMIN - s
        return v[0] * s + v[4] * v[1] * so, v[1] * so + v[5] * v[0] * s

    wc = prob.well_cells
    for n in range(len(times) - 1):
        dt = float(times[n + 1] - times[n])
        ug0, uo0 = unit_masses(vals[n], sg[n])
        ug1, uo1 = unit_masses(vals[n + 1], sg[n + 1])
        phi_p = prob.phi * (1.0 + cf * (p[n + 1] - p[n]))
        dm_g = (prob.dv / prob.D) * (phi_p * ug1 - prob.phi * ug0)
        dm_o = (prob.dv / prob.D) * (phi_p * uo1 - prob.phi * uo0)
        invBg, invBo, invug, invuo, Rs, Rv = vals[n + 1][:6]
        krog, krgo = kr[n + 1]
        bgug, bouo = invBg * invug, invBo * invuo
        mg = krgo * bgug + krog * Rs * bouo
        mo = krog * bouo + krgo * Rv * bgug
        ck = prob.well_ck_geom * kx[wc]
        qg_max = ck * mg[wc] * np.maximum(p[n + 1][wc] - prob.pwf_min, 0.0)
        qg = np.where(prob.q_target >= 0, np.minimum(prob.q_target, qg_max), prob.q_target)
        qo = qg * mo[wc] / (mg[wc] + 1e-30)
        total_qg, total_qo = float(qg.sum()) * dt, float(qo.sum()) * dt
        assert total_qg > 0 and total_qo > 0
        assert abs(float(dm_g.sum()) + total_qg) < 0.02 * total_qg
        assert abs(float(dm_o.sum()) + total_qo) < 0.02 * total_qo
        # the package's check (chip_smoke.py runs it on the card) computes the same
        want = [(float(dm_g.sum()) + total_qg) / total_qg,
                (float(dm_o.sum()) + total_qo) / total_qo]
        np.testing.assert_allclose(helper[n], want, rtol=0, atol=1e-4)


# -- labels through the dataset and the saturation RMSE ------------------------
@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    jax_out = jax_processor(tmp_path_factory.mktemp("jax_gc"), "GC", drawdown=True
                            ).get_or_generate_training_data()
    port_out = port_processor(tmp_path_factory.mktemp("port_gc"), "GC", drawdown=True
                              ).get_or_generate_training_data()
    return jax_out, port_out


@pytest.mark.parametrize("split", [3, 4])          # test, pred
def test_dataset_labels_match_reference(datasets, split):
    (jx, jy), = datasets[0][split]
    (tx, ty), = datasets[1][split]
    np.testing.assert_allclose(tx, jx, rtol=1e-6, atol=1e-6)
    assert set(ty) == set(jy) == {"PRESSURE", "SGAS"}
    assert np.asarray(jy["SGAS"]).min() < 0.7             # two-phase labels
    assert np.abs(ty["PRESSURE"] - jy["PRESSURE"]).max() < PSIA_TOL
    assert np.abs(ty["SGAS"] - jy["SGAS"]).max() < SG_TOL


def test_saturation_rmse_matches_reference(tmp_path_factory):
    """Both packages' RMSE of the same weights on the port's labelled test
    split of the reference's 9×9 drawdown case (Pi 4300 psia, minimum BHP
    2000: condensate drops out in the labels)."""
    import jax

    from srm_tpu.eval.plotting import pressure_rmse as jax_pressure_rmse
    from srm_tpu.eval.plotting import saturation_rmse as jax_saturation_rmse
    from srm_tpu.examples.common import setup_case as jax_setup_case
    from srm_tpu_torch.eval.plotting import pressure_rmse, saturation_rmse
    from srm_tpu_torch.nn.convert import load_flax_params

    kw = dict(pi=4300.0, min_bhp=2000.0)
    jcase = jax_setup_case("GC", base_dir=str(tmp_path_factory.mktemp("jax_gc9")), nx=9,
                           n_realizations=6, **kw)
    tcase = labelled_port_case(tmp_path_factory.mktemp("port_gc9l"), "GC", **kw)
    load_flax_params(tcase["models"], jax.tree_util.tree_map(np.asarray, jcase["params"]))
    test = tcase["test_groups"]
    assert test[0][1]["SGAS"].min() < 0.76                # condensate in the labels
    want_s = jax_saturation_rmse(jcase["models"], jcase["params"], test)
    want_p = jax_pressure_rmse(jcase["models"], jcase["params"], test)
    got_s, got_p = saturation_rmse(tcase["models"], test), pressure_rmse(tcase["models"], test)
    assert 0 < want_s < 1.0 and 10.0 < want_p < 3500.0
    assert abs(got_s - want_s) <= 1e-4 * want_s, (got_s, want_s)
    assert abs(got_p - want_p) <= 1e-4 * want_p, (got_p, want_p)
