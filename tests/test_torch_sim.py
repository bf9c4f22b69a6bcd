"""The port's FV simulator (dry gas), its labels through the dataset, the
pressure RMSE and the time-to-accuracy tool, against the JAX package's on
the same inputs (numpy-seeded permeability, the same times), on the CPU.

Tolerances: pressures within 0.1 psia of the reference (its own bound
between its dense and iterative solvers). Measured on the CPU: dense 0.014
psia apart, CG at 13×13×3 0.004, the test split's labels through the
dataset 0.02. The RMSE within 1e-4 relative. The early exit of the
iterative solver changes no bit of its result.
"""

import copy
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srm_tpu.config import DEFAULT_GENERAL_CONFIG as J_GENERAL
from srm_tpu.sim import simulate_dry_gas as jax_simulate_dry_gas
from srm_tpu_torch.config import (DEFAULT_GENERAL_CONFIG, DEFAULT_RESERVOIR_CONFIG,
                                  DEFAULT_SCAL_CONFIG, DEFAULT_WELLS_CONFIG, get_configuration)
from srm_tpu_torch.data.pvt_table import load_pvt_table
from srm_tpu_torch.physics.pvt import make_spline_pvt, properties_for
from srm_tpu_torch.sim import build_problem, fv_simulator, simulate_dry_gas, simulate_labels
from test_fv_simulator import _pvt_fn as jax_pvt_fn
from test_fv_simulator import _small_problem as jax_small_problem

PSIA_TOL = 0.1


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def port_pvt(fluid="DG"):
    """The simulator's order-1 spline PVT."""
    return make_spline_pvt(get_configuration("pvt_layer", fluid_type=fluid), load_pvt_table(),
                           properties=properties_for(fluid), order=1)


def small_wells(drawdown=False):
    wells = copy.deepcopy(DEFAULT_WELLS_CONFIG)
    for conn in wells["connections"]:
        conn["i"] = min(conn["i"] // 3, 12)
        conn["j"] = min(conn["j"] // 3, 12)
        if drawdown:
            conn["minimum_bhp"] = 1500.0    # deep drawdown crosses the dew point
            conn["value"] *= 4.0
    return wells


def port_small_problem(nz=1, thickness_scale=1.0, kv_kh=None, wells=None):
    """The port's side of ``test_fv_simulator._small_problem`` (13×13×nz)."""
    res = copy.deepcopy(DEFAULT_RESERVOIR_CONFIG)
    res["Nx"] = res["Ny"] = 13
    res["Nz"] = nz
    res["thickness"] = res["thickness"] * thickness_scale
    if kv_kh is not None:
        res["vertical_anisotropy"] = kv_kh
    return build_problem(res, wells or small_wells(), DEFAULT_SCAL_CONFIG,
                         copy.deepcopy(DEFAULT_GENERAL_CONFIG))


def processor(cls, base_dir, general, fluid="DG", drawdown=False, device=None):
    """A data processor of either package at ``sim_proc``'s 13×13 case with
    6 realizations, the test split labelled by the simulator."""
    g = copy.deepcopy(general)
    g["fluid_type"] = fluid
    g["label_source"] = "simulator"
    g["unit_target_shape"] = (1, 1, 13, 13, 1)
    kw = {"device": device} if device is not None else {}
    proc = cls(base_dir=str(base_dir), general_config=g, **kw)
    proc.reservoir_config["Nx"] = proc.reservoir_config["Ny"] = 13
    proc.reservoir_config["realizations"]["permx"]["number"] = 6
    proc.reservoir_config["realizations"]["permx"]["conditional_values"] = {(5, 5, 0): 2.0}
    proc.wells_config = small_wells(drawdown)
    return proc


def port_processor(base_dir, fluid="DG", drawdown=False):
    from srm_tpu_torch.data.dataset import SRMDataProcessor
    return processor(SRMDataProcessor, base_dir, DEFAULT_GENERAL_CONFIG, fluid, drawdown,
                     device="cpu")


def jax_processor(base_dir, fluid="DG", drawdown=False):
    from srm_tpu.data.dataset import SRMDataProcessor
    return processor(SRMDataProcessor, base_dir, J_GENERAL, fluid, drawdown)


def seeded_kx(seed, n):
    return np.exp(np.random.default_rng(seed).normal(1.0, 0.5, n)).astype(np.float32)


# -- problem setup -------------------------------------------------------------
@pytest.mark.parametrize("nz, thickness_scale, kv_kh", [(1, 1.0, None), (3, 3.0, 0.1)])
def test_build_problem_fields_equal(nz, thickness_scale, kv_kh):
    jp, jk = jax_small_problem(nz, thickness_scale, kv_kh)
    tp, tk = port_small_problem(nz, thickness_scale, kv_kh)
    np.testing.assert_allclose(tk, jk, rtol=1e-6)
    for field in jp._fields:
        want, got = np.asarray(getattr(jp, field)), np.asarray(getattr(tp, field))
        assert got.shape == want.shape, field
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want, err_msg=field)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=field)


# -- the simulation against the reference -------------------------------------
def test_dense_matches_reference():
    jp, jk = jax_small_problem()
    tp, tk = port_small_problem()
    kx = seeded_kx(0, 13 * 13)
    times = np.linspace(0, 365, 12).astype(np.float32)
    want = np.asarray(jax_simulate_dry_gas(jp, jk, jnp.asarray(kx), times, jax_pvt_fn("DG"),
                                           solver="dense"))
    got = simulate_dry_gas(tp, tk, torch.from_numpy(kx), times, port_pvt(), solver="dense")
    assert got.shape == want.shape == (12, 169)
    assert want.min() < tp.Pi - 50.0                       # the case draws down
    assert np.abs(got.numpy() - want).max() < PSIA_TOL, np.abs(got.numpy() - want).max()


def test_cg_matches_reference_in_3d():
    jp, jk = jax_small_problem(nz=3, thickness_scale=3.0)
    tp, tk = port_small_problem(nz=3, thickness_scale=3.0)
    kx = seeded_kx(1, 3 * 13 * 13)
    times = np.linspace(0, 180, 6).astype(np.float32)
    want = np.asarray(jax_simulate_dry_gas(jp, jk, jnp.asarray(kx), times, jax_pvt_fn("DG"),
                                           solver="cg"))
    stats = {}
    got = simulate_dry_gas(tp, tk, torch.from_numpy(kx), times, port_pvt(), solver="cg",
                           stats=stats).numpy()
    assert np.abs(got - want).max() < PSIA_TOL, np.abs(got - want).max()
    # every solve converged well before the trip cap and stopped there
    assert len(stats["trips"]) == 5 * 6 and max(stats["trips"]) < 1000, stats


def test_early_exit_is_bitwise_the_full_trip_count(monkeypatch):
    """Two realizations that converge at different trips: stopping once
    both are done gives the bits of running every trip."""
    tp, tk = port_small_problem(nz=3, thickness_scale=3.0)
    kx = torch.from_numpy(np.stack([seeded_kx(2, 3 * 169), 20.0 * seeded_kx(3, 3 * 169)]))
    times = np.array([0.0, 30.0, 60.0], np.float32)
    run = lambda stats: simulate_dry_gas(tp, tk, kx, times, port_pvt(),  # noqa: E731
                                         solver="cg", cg_maxiter=400, stats=stats)
    early, full = {}, {}
    got = run(early)
    monkeypatch.setattr(fv_simulator, "_CHECK_EVERY", 10 ** 9)
    want = run(full)
    assert max(early["trips"]) < 400 and set(full["trips"]) == {400}, (early, full)
    assert torch.equal(got, want)


def test_simulate_realizations_chunks_like_one_batch():
    """Chunking (with the tail chunk padded) gives each realization what a
    batch of all of them gives, and the grid layout (K, T, Nz, Ny, Nx)."""
    tp, tk = port_small_problem()
    kx = np.stack([seeded_kx(s, 169) for s in range(5)]).reshape(5, 1, 13, 13)
    times = np.array([0.0, 20.0, 40.0], np.float32)
    got = fv_simulator.simulate_realizations(tp, tk, kx, times, port_pvt(), chunk=2,
                                             device="cpu")
    whole = simulate_dry_gas(tp, tk, torch.from_numpy(kx.reshape(5, -1)), times, port_pvt())
    assert got.shape == (5, 3, 1, 13, 13)
    np.testing.assert_allclose(got.reshape(5, 3, -1), whole.numpy(), rtol=0, atol=1e-3)


def test_labels_match_reference_on_the_full_grid(tmp_path):
    """The default case's grid (39×39) and test split, its first
    realization over the first 4 times: both packages' labels within 0.1
    psia (the whole split's labels and their predict-Pi RMSE on the card:
    PERF.md §6)."""
    from srm_tpu.sim import simulate_labels as jax_simulate_labels

    jproc, tproc = jax_processor(tmp_path / "jax"), port_processor(tmp_path / "port")
    for proc in (jproc, tproc):
        proc.reservoir_config = copy.deepcopy(DEFAULT_RESERVOIR_CONFIG)
        proc.wells_config = copy.deepcopy(DEFAULT_WELLS_CONFIG)
        proc.general_config["unit_target_shape"] = DEFAULT_GENERAL_CONFIG["unit_target_shape"]
    permx = tproc.generate_kle_splits()["test"][:1]
    times = tproc.generate_time_tensor()["test"][:4]
    want = jax_simulate_labels(jproc, "test", permx=permx, times=times)["PRESSURE"]
    got = simulate_labels(tproc, "test", permx=permx, times=times)["PRESSURE"]
    assert got.shape == want.shape == (1, 4, 1, 39, 39)
    assert want.min() < tproc.reservoir_config["initialization"]["Pi"] - 50.0
    assert np.abs(got - want).max() < PSIA_TOL, np.abs(got - want).max()


# -- the reference's physical checks, on the port alone ------------------------
@pytest.fixture(scope="module")
def sim_proc(tmp_path_factory):
    return port_processor(tmp_path_factory.mktemp("port_fvsim"))


def test_simulator_depletes(sim_proc):
    kle = sim_proc.generate_kle_splits()
    times = np.array([0.0, 15.0, 30.0, 60.0, 90.0], np.float32)
    p = simulate_labels(sim_proc, "test", permx=kle["test"], times=times)["PRESSURE"]
    assert p.shape[1:] == (5, 1, 13, 13) and p.dtype == np.float32
    assert np.isfinite(p).all()
    np.testing.assert_allclose(p[:, 0], sim_proc.reservoir_config["initialization"]["Pi"])
    # net production (4 producers vs 1 injector) → field pressure declines
    means = p.mean(axis=(0, 2, 3, 4))
    assert means[-1] < means[0] - 50.0
    assert (np.diff(means) < 0).all()
    assert p.min() > 1000.0 and p.max() <= 5000.0 + 1e-3


def test_simulator_mass_balance(sim_proc):
    """Σ_cells Δmass ≈ −Σ_wells q·Δt per step, within 2% (the lagged-rate
    Picard linearization); ``fv_simulator.mass_balance`` gives the same."""
    prob, kscale = build_problem(sim_proc.reservoir_config, sim_proc.wells_config,
                                 DEFAULT_SCAL_CONFIG, sim_proc.general_config)
    pvt = port_pvt()
    kx = np.asarray(sim_proc.generate_kle_splits()["train"][0], np.float32).reshape(-1)
    times = np.array([0.0, 10.0, 20.0], np.float32)
    ps = simulate_dry_gas(prob, kscale, torch.from_numpy(kx), times, pvt, n_picard=12)
    helper = fv_simulator.mass_balance(prob, kscale, kx, times, ps[None], pvt)[0].numpy()
    cf = 97.32e-6 / (1.0 + 55.8721 * prob.phi**1.428586)
    with torch.no_grad():
        props = [pvt(p)[0].numpy() for p in ps]
    ps = ps.numpy()
    for n in range(len(times) - 1):
        (invBg0, _), (invBg1, invug1) = props[n], props[n + 1]
        dt = float(times[n + 1] - times[n])
        dmass = (prob.dv / prob.D) * prob.Sgi * prob.phi * (
            (invBg1 - invBg0) + cf * invBg0 * (ps[n + 1] - ps[n]))
        wc = prob.well_cells
        mg = prob.krgo * (invBg1 * invug1)[wc]
        ck = prob.well_ck_geom * kx[wc]
        qmax = ck * mg * np.maximum(ps[n + 1][wc] - prob.pwf_min, 0.0)
        q = np.where(prob.q_target >= 0, np.minimum(prob.q_target, qmax), prob.q_target)
        total_dm, total_q = float(dmass.sum()), float(q.sum()) * dt
        assert total_q > 0
        assert abs(total_dm + total_q) < 0.02 * abs(total_q), (total_dm, total_q)
        # the package's check (chip_smoke.py runs it on the card) computes the same
        assert abs(helper[n] - (total_dm + total_q) / total_q) < 1e-4, helper


def test_3d_layered_matches_2d():
    """kv/kh = 0 and every well in layer 0: the 3-layer stack on the CG
    path gives the dense 2D solution in layer 0 and Pi in the others."""
    prob2d, ks2d = port_small_problem(nz=1)
    prob3d, ks3d = port_small_problem(nz=3, thickness_scale=3.0, kv_kh=0.0)
    assert prob3d.dv == pytest.approx(prob2d.dv)
    k2d = seeded_kx(2, 13 * 13)
    times = np.linspace(0, 180, 8).astype(np.float32)
    p2d = simulate_dry_gas(prob2d, ks2d, torch.from_numpy(k2d), times, port_pvt(),
                           solver="dense").numpy()
    p3d = simulate_dry_gas(prob3d, ks3d, torch.from_numpy(np.tile(k2d, 3)), times, port_pvt(),
                           solver="cg").numpy().reshape(len(times), 3, 13 * 13)
    Pi = prob2d.Pi
    assert p2d.min() < Pi - 50.0
    np.testing.assert_allclose(p3d[:, 1], Pi, atol=0.05)
    np.testing.assert_allclose(p3d[:, 2], Pi, atol=0.05)
    np.testing.assert_allclose(p3d[:, 0], p2d, atol=0.25)


def test_3d_float32_dense_is_the_inaccurate_solver():
    """On a 3D grid with the 3D cases' iid log-normal permeability
    (13×13×10, 3 times) the float32 dense solve lies ~0.5 psia from the
    float64 solution in both packages, while the CG path stays within 0.1
    psia of it: the reference's 0.1-psia bound between its two solvers
    holds in 2D only (ROADMAP C10). Measured on the CPU: port CG 0.008
    psia, port dense 0.49, reference dense 0.50."""
    res = copy.deepcopy(DEFAULT_RESERVOIR_CONFIG)
    res["Nz"] = 10
    res["Nx"] = res["Ny"] = 13
    prob, kscale = build_problem(res, small_wells(), DEFAULT_SCAL_CONFIG, DEFAULT_GENERAL_CONFIG)
    from srm_tpu.config import DEFAULT_SCAL_CONFIG as J_SCAL
    from srm_tpu.sim import build_problem as jax_build_problem
    jprob, jkscale = jax_build_problem(res, small_wells(), J_SCAL, J_GENERAL)
    spec = res["realizations"]["permx"]
    kx = np.exp(np.random.RandomState(2000).normal(np.log(spec["mean"]), spec["std"] / spec["mean"],
                                                   10 * 169)).astype(np.float32)
    times = np.arange(3, dtype=np.float32) * 5.0
    exact = simulate_dry_gas(prob, kscale, torch.from_numpy(kx).double(), times,
                             port_pvt().double(), solver="dense").numpy()
    gap = {solver: np.abs(simulate_dry_gas(prob, kscale, torch.from_numpy(kx), times, port_pvt(),
                                           solver=solver).numpy() - exact).max()
           for solver in ("cg", "dense")}
    ref_dense = np.asarray(jax_simulate_dry_gas(jprob, jkscale, jnp.asarray(kx), times,
                                                jax_pvt_fn("DG"), solver="dense"))
    assert gap["cg"] < PSIA_TOL, gap
    assert gap["dense"] > 3 * PSIA_TOL and np.abs(ref_dense - exact).max() > 3 * PSIA_TOL, gap


def test_simulator_refuses_the_cpu_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tp, tk = port_small_problem()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        fv_simulator.simulate_realizations(tp, tk, np.ones((1, 1, 13, 13), np.float32),
                                           np.array([0.0, 1.0], np.float32), port_pvt())


# -- labels through the dataset -------------------------------------------------
def _payload(groups):
    (x, y), = groups
    return np.asarray(x), {k: np.asarray(v) for k, v in y.items()}


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """Both packages' physics-mode datasets of the 13×13 case; each cache
    directory is then read by the other package."""
    jdir, tdir = tmp_path_factory.mktemp("jax_ds"), tmp_path_factory.mktemp("port_ds")
    jax_out = jax_processor(jdir).get_or_generate_training_data()
    port_out = port_processor(tdir).get_or_generate_training_data()
    return dict(jdir=jdir, tdir=tdir, jax=jax_out, port=port_out)


@pytest.mark.parametrize("split", [3, 4])          # test, pred
def test_dataset_labels_match_reference(datasets, split):
    jx, jy = _payload(datasets["jax"][split])
    tx, ty = _payload(datasets["port"][split])
    np.testing.assert_allclose(tx, jx, rtol=1e-6, atol=1e-6)
    assert set(ty) == set(jy) == {"PRESSURE"}
    assert ty["PRESSURE"].shape == jy["PRESSURE"].shape == tx.shape[:-1]
    assert np.abs(jy["PRESSURE"]).min() > 1000.0
    gap = np.abs(ty["PRESSURE"] - jy["PRESSURE"]).max()
    assert gap < PSIA_TOL, gap
    # train labels stay zero in physics mode
    assert not np.any(datasets["port"][1][0][1]["PRESSURE"])


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_each_package_reads_the_others_cache(datasets, reader):
    """The same config hash, the same npz layout: a package pointed at the
    other's cache directory loads its arrays unchanged."""
    if reader == "port":
        got = port_processor(datasets["jdir"]).get_or_generate_training_data()
        want = datasets["jax"]
    else:
        got = jax_processor(datasets["tdir"]).get_or_generate_training_data()
        want = datasets["port"]
    assert got[0] == want[0]                               # the same cache file
    for split in range(1, 5):
        (gx, gy), (wx, wy) = _payload(got[split]), _payload(want[split])
        np.testing.assert_array_equal(gx, wx)
        for k in wy:
            np.testing.assert_array_equal(gy[k], wy[k])


def test_dataset_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """The labels' time re-slicing (A15) is ported: in physics mode the
    simulator's test labels are re-sliced by ``array_pipeline.slices`` and
    trimmed with their features as the JAX package does, so both packages
    build the same dataset (each simulator replaced by the same seeded
    labels: the simulators themselves are held together above)."""
    def labels(proc, split, permx=None, times=None, **kw):
        rng = np.random.RandomState(3)
        shape = (permx.shape[0], times.shape[0]) + permx.shape[1:]
        return {"PRESSURE": rng.uniform(4000.0, 5000.0, shape).astype(np.float32)}

    monkeypatch.setattr("srm_tpu.sim.simulate_labels", labels)
    monkeypatch.setattr("srm_tpu_torch.sim.simulate_labels", labels)
    out = {}
    for name, make in (("jax", jax_processor), ("port", port_processor)):
        proc = make(tmp_path / name)
        proc.general_config["array_pipeline"] = {"slices": [0, 10, 20]}
        out[name] = proc.get_or_generate_training_data()[1:]
        times = proc.generate_time_tensor()["test"]
        permx = proc.generate_kle_splits()["test"]
    for split in range(4):
        (jx, jy), (tx, ty) = _payload(out["jax"][split]), _payload(out["port"][split])
        np.testing.assert_allclose(tx, jx, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(ty["PRESSURE"], jy["PRESSURE"])
    _, ty = _payload(out["port"][2])
    want = labels(None, "test", permx=permx, times=times)["PRESSURE"][:, [0, 10, 20]]
    np.testing.assert_array_equal(ty["PRESSURE"], want)


# -- accuracy -------------------------------------------------------------------
def labelled_port_case(base_dir, fluid="DG", **kw):
    """The port's 9×9 case (6 realizations) with its test split labelled by
    its simulator, on the CPU."""
    from srm_tpu_torch.examples.common import setup_case

    g = copy.deepcopy(DEFAULT_GENERAL_CONFIG)
    g["label_source"] = "simulator"
    return setup_case(fluid, base_dir=str(base_dir), nx=9, n_realizations=6, general_config=g,
                      device="cpu", **kw)


def test_pressure_rmse_matches_reference(dg9_case, tmp_path):
    """Both packages' RMSE of the same weights (the dg9 case's initial flax
    weights, loaded into the port's models) on the port's labelled test
    split."""
    import jax

    from srm_tpu.eval.plotting import pressure_rmse as jax_pressure_rmse
    from srm_tpu_torch.eval.plotting import pressure_rmse
    from srm_tpu_torch.nn.convert import load_flax_params

    tcase = labelled_port_case(tmp_path)
    load_flax_params(tcase["models"], jax.tree_util.tree_map(np.asarray, dg9_case["params"]))
    test = tcase["test_groups"]
    assert test[0][1]["PRESSURE"].min() > 1000.0
    want = jax_pressure_rmse(dg9_case["models"], dg9_case["params"], test)
    got = pressure_rmse(tcase["models"], test)
    assert 10.0 < want < 3500.0
    assert abs(got - want) <= 1e-4 * want, (got, want)


def test_rmse_experiment_trains_on_the_cpu(tmp_path, capsys):
    from srm_tpu_torch.tools import rmse_experiment

    out = rmse_experiment.main(["train", "--fluid", "DG", "--nx", "9", "--realizations", "6",
                                "--epochs", "1", "--device", "cpu", "--decay-steps", "250",
                                "--base-dir", str(tmp_path)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out is None and line["framework"] == "srm_tpu_torch" and line["device"] == "cpu"
    assert line["steps_per_epoch"] == 3 and line["decay_steps"] == 250
    (rec,) = line["trajectory"]
    assert rec["epoch"] == 1 and rec["steps"] == 3
    assert 0 < rec["rmse_psia"] < 3500.0 and line["rmse_predict_pi"] > 100.0
    # an untrained pressure model stays near Pi: its error is the labels' drawdown
    assert rec["pred_vs_pi_psia"] < rec["rmse_psia"] and rec["bias_psia"] > 0
    assert line["setup_s"] > 0 and rec["wall_s"] > 0


@pytest.mark.parametrize("flag, item", [(["--width", "64"], "A10"), (["--pad", "48"], "A10")])
def test_rmse_experiment_refuses_knobs_not_ported(tmp_path, flag, item, monkeypatch):
    """The knobs of ROADMAP ``item`` were refused until they were ported;
    now no flag is refused: each reaches the case's general config (the
    case build stops there; tests/test_torch_knobs.py builds one)."""
    from srm_tpu_torch.examples import common
    from srm_tpu_torch.tools import rmse_experiment

    key = {"--width": "network_width", "--pad": "spatial_pad_to"}[flag[0]]

    def stop(*a, general_config=None, **kw):
        raise SystemExit(f"{key}={general_config.get(key)}")

    monkeypatch.setattr(common, "setup_case", stop)
    with pytest.raises(SystemExit, match=f"^{key}={flag[1]}$"):
        rmse_experiment.main(["train", "--device", "cpu", "--base-dir", str(tmp_path), *flag])
