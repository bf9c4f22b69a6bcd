"""The port stands alone: it never imports JAX nor anything of the JAX
package (its training steps, on one process and over a process group, the
production and drawdown presets and the
well solver's Newton BHP and blocking factor among them, its data
generation and parsed labels, its simulator labels and its RMSE, its
predictor and serving bundle), its entry points run on the GPU unless the
caller asks for the CPU,
and its chip check imports nothing of the JAX package and refuses to run,
and prints no result, without a GPU or outside a checkout."""

import ast
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(args, cwd, env_extra=None, timeout=300):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "2",
           **(env_extra or {})}
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)


def _isolated_step(base_dir, case_kwargs: str, fluid: str = "DG", loss_code: str = "") -> str:
    """A script that imports every module of the port, builds a case with
    ``setup_case(fluid, ..., <case_kwargs>)`` (which may name the port's
    config module ``cfg``), runs ``loss_code`` (which may rebind ``loss``,
    the case's loss), takes one CPU train step and fails if JAX or any
    module of the JAX package (``srm_tpu``, ``srm_tpu.*``) was loaded."""
    return textwrap.dedent(f"""
        import importlib, pkgutil, sys
        import torch
        torch.set_num_threads(2)
        import srm_tpu_torch
        for mod in pkgutil.walk_packages(srm_tpu_torch.__path__, "srm_tpu_torch."):
            importlib.import_module(mod.name)
        import srm_tpu_torch.config as cfg
        from srm_tpu_torch.examples.common import setup_case
        from srm_tpu_torch.training.trainer import Trainer
        case = setup_case({fluid!r}, base_dir={str(base_dir)!r}, n_realizations=6,
                          device="cpu", {case_kwargs})
        loss = case["loss_fn"]
        {loss_code}
        trainer = Trainer(loss)
        nb, n = trainer.stage_dataset("train", case["train_groups"], 8)
        x, y, _, bs = trainer._resident["train"]
        metrics = trainer.train_step(x[:bs], {{k: v[:bs] for k, v in y.items()}})
        assert torch.isfinite(metrics["total"]), metrics
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax"))
        assert not loaded, loaded
        ref = sorted(m for m in sys.modules if m.split(".")[0] == "srm_tpu")
        assert not ref, ref
        print("isolated")
    """)


def test_port_never_imports_jax(tmp_path):
    proc = _run([sys.executable, "-c", _isolated_step(tmp_path, "nx=9")], cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "isolated" in proc.stdout


def test_port_3d_never_imports_jax(tmp_path):
    """The 3D path (uncorrelated fields, Conv3d networks, the 7-point
    stencil) stands alone as well."""
    script = _isolated_step(tmp_path, 'nx=9, nz=9, kle_method="uncorrelated"')
    proc = _run([sys.executable, "-c", script], cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "isolated" in proc.stdout


def test_port_gc_never_imports_jax(tmp_path):
    """The gas-condensate path (the saturation model, the seven-property
    PVT, the two-phase stencil) stands alone as well."""
    proc = _run([sys.executable, "-c", _isolated_step(tmp_path, "nx=9", fluid="GC")], cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "isolated" in proc.stdout


def test_production_step_never_imports_jax(tmp_path):
    """The production profile (bfloat16 networks, Model 2 on a strided
    input) stands alone as well."""
    script = _isolated_step(
        tmp_path, "nx=9, general_config=cfg.apply_production_overrides(cfg.DEFAULT_GENERAL_CONFIG)")
    proc = _run([sys.executable, "-c", script], cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "isolated" in proc.stdout


def test_gc3d_step_never_imports_jax(tmp_path):
    """Gas condensate in 3D (the two-phase 7-point residual, the 3D
    saturation model, zero labels) stands alone as well."""
    script = _isolated_step(
        tmp_path, 'nx=9, nz=9, kle_method="uncorrelated", '
                  'general_config=dict(cfg.DEFAULT_GENERAL_CONFIG, label_source="files")',
        fluid="GC")
    proc = _run([sys.executable, "-c", script], cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "isolated" in proc.stdout


def test_porosity_field_step_never_imports_jax(tmp_path):
    """A per-cell porosity field (the unfused residual with a field)
    stands alone as well."""
    loss_code = ("import copy, numpy as np; "
                 "from srm_tpu_torch.losses.physics_loss import PhysicsLoss; "
                 "res = copy.deepcopy(case['processor'].reservoir_config); "
                 "res['porosity'] = np.full((res['Nz'], res['Ny'], res['Nx']), 0.2, np.float32); "
                 "res['porosity'][..., :4] = 0.05; "
                 "loss = PhysicsLoss(case['models'], case['data_summary'], "
                 "general_config=case['general_config'], reservoir_config=res, "
                 "wells_config=case['processor'].wells_config); "
                 "assert loss.phi_field is not None")
    script = _isolated_step(tmp_path, "nx=9", loss_code=loss_code)
    proc = _run([sys.executable, "-c", script], cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "isolated" in proc.stdout


def test_remat_step_never_imports_jax(tmp_path):
    """Rematerialized forwards (``torch.utils.checkpoint``) with the padded
    and widened networks stand alone as well."""
    script = _isolated_step(
        tmp_path, "nx=9, general_config=dict(cfg.DEFAULT_GENERAL_CONFIG, remat_forwards=True, "
                  "spatial_pad_to=16, network_width=48)",
        loss_code="assert loss.remat_forwards")
    proc = _run([sys.executable, "-c", script], cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "isolated" in proc.stdout


def test_drawdown_step_never_imports_jax(tmp_path):
    """The drawdown recipe (every split labelled by the simulator, the
    mixed loss with balanced td errors) stands alone as well."""
    script = _isolated_step(
        tmp_path, "nx=9, general_config=cfg.apply_drawdown_overrides(cfg.DEFAULT_GENERAL_CONFIG), "
                  "**cfg.GC_DRAWDOWN_CASE", fluid="GC")
    proc = _run([sys.executable, "-c", script], cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "isolated" in proc.stdout


def test_polynomial_pvt_step_never_imports_jax(tmp_path):
    """The trainable polynomial PVT with its ``fluid_property`` optimizer
    (a third optimizer in the step) stands alone as well."""
    script = _isolated_step(
        tmp_path, 'nx=9, general_config=dict(cfg.DEFAULT_GENERAL_CONFIG, '
                  'pvt_fitting_method="polynomial")',
        loss_code='assert loss.trainable_models_keys == ["pressure", "time_step", '
                  '"fluid_property"]')
    proc = _run([sys.executable, "-c", script], cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "isolated" in proc.stdout


@pytest.mark.parametrize("fluid, kwargs", [
    ("DG", '{"use_non_iterative": False, "max_iters": 4}'),
    ("GC", '{"use_blocking_factor": True}'),
])
def test_well_solver_paths_never_import_jax(tmp_path, fluid, kwargs):
    """The well solver's Newton BHP (dry gas) and blocking factor (gas
    condensate, with its Newton saturation roots) inside a training step
    stand alone as well."""
    script = _isolated_step(tmp_path, f"nx=9, well_solver_kwargs={kwargs}", fluid=fluid,
                            loss_code="assert loss.models['well_rate_bhp_model'].max_iters")
    proc = _run([sys.executable, "-c", script], cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "isolated" in proc.stdout


def test_data_generation_and_parsed_labels_never_import_jax(tmp_path):
    """``generate-data`` (the KLE tree with its decks) and a dataset whose
    test labels are parsed from simulator files, re-sliced in time, stand
    alone as well."""
    script = textwrap.dedent(f"""
        import copy, os, sys
        import numpy as np
        from srm_tpu_torch.__main__ import main
        from srm_tpu_torch.config import DEFAULT_GENERAL_CONFIG
        from srm_tpu_torch.data.dataset import SRMDataProcessor
        assert main(["generate-data", "--base-dir", {str(tmp_path / "gen")!r},
                     "--realizations", "4"]) == 0
        g = copy.deepcopy(DEFAULT_GENERAL_CONFIG)
        g["unit_target_shape"] = (1, 1, 9, 9, 1)
        g["array_pipeline"] = {{"slices": [0, 2]}}
        proc = SRMDataProcessor(base_dir={str(tmp_path / "ds")!r}, general_config=g,
                                device="cpu")
        res = proc.reservoir_config
        res["Nx"] = res["Ny"] = 9
        res["realizations"]["permx"]["number"] = 6
        res["realizations"]["permx"]["conditional_values"] = {{(5, 5, 0): 2.0}}
        for c in proc.wells_config["connections"]:
            c["i"], c["j"] = min(c["i"] * 9 // 39, 8), min(c["j"] * 9 // 39, 8)
        dyn = os.path.join(proc.kle_folder(), "dat_files_test_" + proc.config_hash()[1],
                           "dynamic")
        os.makedirs(dyn)
        for k in range(4):
            with open(os.path.join(dyn, f"R_{{k}}.FUNRST"), "w") as f:
                for t in range(3):
                    f.write("'PRESSURE' 81 'REAL'\\n")
                    f.write(" ".join(str(4000.0 + t + k) for _ in range(81)) + "\\n")
        _, _, test, _ = proc.process_data()
        (x, y), = test
        assert y["PRESSURE"].shape == (4, 2, 1, 9, 9) and x.shape[1] == 2
        assert float(y["PRESSURE"][1, 1].max()) == 4003.0
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax"))
        assert not loaded, loaded
        ref = sorted(m for m in sys.modules if m.split(".")[0] == "srm_tpu")
        assert not ref, ref
        print("isolated")
    """)
    proc = _run([sys.executable, "-c", script], cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "isolated" in proc.stdout


def test_data_parallel_step_never_imports_jax(tmp_path):
    """A train step over two ranks (a gloo group meeting through a
    ``file://`` store; ``tests/torch_parallel_ranks.py``), its dataset built
    by rank 0 while rank 1 waits, stands alone as well, on each rank."""
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"out": str(tmp_path), "runs": [
        {"scenario": "step", "fluid": "DG", "base_dir": str(tmp_path / "data"), "nx": 9,
         "realizations": 6, "batch_size": 8}, {"scenario": "loaded"}]}))
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1", "WORLD_SIZE": "2",
           "STORE": str(tmp_path / "store")}
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_parallel_ranks.py"),
                               str(spec)], env={**env, "RANK": str(r)}, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        errors = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), [e[-3000:] for e in errors]
    import torch
    for r in range(2):
        step, loaded = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
        assert loaded == [] and np.isfinite(step["metrics"]["total"]), (loaded, step["metrics"])


def test_space_axis_step_never_imports_jax(tmp_path):
    """A train step over a space axis of two ranks (each rank its rows of
    H, the halo exchanges over gloo; ``tests/torch_parallel_ranks.py``),
    and one with ``remat_forwards`` (the exchanges repeated in the
    backward's recompute), stand alone as well, on each rank."""
    spec = tmp_path / "spec.json"
    step = {"scenario": "step", "fluid": "DG", "base_dir": str(tmp_path / "data"), "nx": 9,
            "realizations": 6, "batch_size": 8, "spatial": 2}
    spec.write_text(json.dumps({"out": str(tmp_path), "runs": [
        step, dict(step, config={"remat_forwards": True}), {"scenario": "loaded"}]}))
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1", "WORLD_SIZE": "2",
           "STORE": str(tmp_path / "store")}
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_parallel_ranks.py"),
                               str(spec)], env={**env, "RANK": str(r)}, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        errors = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), [e[-3000:] for e in errors]
    import torch
    for r in range(2):
        plain, remat, loaded = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
        assert loaded == [], loaded
        assert np.isfinite(plain["metrics"]["total"]), plain["metrics"]
        assert remat["metrics"] == plain["metrics"], (remat["metrics"], plain["metrics"])


def test_checkpoint_path_never_imports_jax(tmp_path):
    """The training driver's checkpoint and resume path (``utils/checkpoint.py``,
    ``torch.save`` files) stands alone as well."""
    script = textwrap.dedent(f"""
        import sys
        import torch
        torch.set_num_threads(2)
        from srm_tpu_torch.examples.common import setup_case
        from srm_tpu_torch.training.trainer import train_combined_models_unified
        from srm_tpu_torch.utils.checkpoint import CheckpointManager
        case = setup_case("DG", base_dir={str(tmp_path / "data")!r}, nx=9, n_realizations=6,
                          device="cpu")
        ckpt = {str(tmp_path / "ckpt")!r}
        for epochs, resume in ((1, False), (3, True)):
            _, history, best = train_combined_models_unified(
                case["train_groups"], case["val_groups"], case["loss_fn"],
                training_batch_size=32, epochs=epochs, verbose=0, checkpoint_dir=ckpt,
                resume=resume)
            assert best is not None and len(history["total_train_loss"]) == 1, history
        assert CheckpointManager(ckpt).latest_step() == 3
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax"))
        assert not loaded, loaded
        ref = sorted(m for m in sys.modules if m.split(".")[0] == "srm_tpu")
        assert not ref, ref
        print("isolated")
    """)
    proc = _run([sys.executable, "-c", script], cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "isolated" in proc.stdout


def test_simulator_labels_and_rmse_never_import_jax(tmp_path):
    """The FV simulator (``simulate_labels``), a case whose test split it
    labels, and the pressure RMSE against those labels stand alone as well."""
    script = textwrap.dedent(f"""
        import copy, sys
        import numpy as np
        import torch
        torch.set_num_threads(2)
        from srm_tpu_torch.config import DEFAULT_GENERAL_CONFIG
        from srm_tpu_torch.eval.plotting import pressure_rmse
        from srm_tpu_torch.examples.common import setup_case
        from srm_tpu_torch.sim import simulate_labels
        g = copy.deepcopy(DEFAULT_GENERAL_CONFIG)
        g["label_source"] = "simulator"
        case = setup_case("DG", base_dir={str(tmp_path)!r}, nx=9, n_realizations=6,
                          general_config=g, device="cpu")
        times = np.array([0.0, 30.0, 60.0], np.float32)
        p = simulate_labels(case["processor"], "test", times=times)["PRESSURE"]
        assert p.shape[1:] == (3, 1, 9, 9) and np.isfinite(p).all(), p.shape
        _, labels = case["test_groups"][0]
        assert labels["PRESSURE"].min() > 1000.0
        rmse = pressure_rmse(case["models"], case["test_groups"])
        assert np.isfinite(rmse) and rmse > 0, rmse
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax"))
        assert not loaded, loaded
        ref = sorted(m for m in sys.modules if m.split(".")[0] == "srm_tpu")
        assert not ref, ref
        print("isolated")
    """)
    proc = _run([sys.executable, "-c", script], cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "isolated" in proc.stdout


# the example drivers and the tools, each run on the CPU at a small size
# ({d}: a directory of its own)
_ENTRY_POINTS = {
    "example_dry_gas": """
        from srm_tpu_torch.examples.training_case_dry_gas import main
        main(["--nx", "9", "--realizations", "6", "--epochs", "1", "--device", "cpu",
              "--base-dir", {d!r}])""",
    "example_gas_condensate": """
        from srm_tpu_torch.examples.training_case_gas_condensate import main
        main(["--nx", "9", "--realizations", "6", "--epochs", "1", "--device", "cpu",
              "--base-dir", {d!r}])""",
    "mfu_probe": """
        from srm_tpu_torch.tools.mfu_probe import main
        assert len(main(["--device", "cpu", "--nx", "13", "--batch", "2", "--case", "base",
                         "--case", "bf16"])) == 2""",
    "flops_breakdown": """
        from srm_tpu_torch.tools.flops_breakdown import main
        assert main(["--device", "cpu", "--nx", "9", "--nz", "9", "--batch", "2",
                     "--realizations", "6", "--base-dir", {d!r}]) > 0""",
    "sg_head_probe": """
        from srm_tpu_torch.tools import sg_head_probe
        case = sg_head_probe.build_case(base_dir={d!r}, device="cpu", nx=9, realizations=6)
        sg_head_probe.probe(case, epochs=1, device="cpu")""",
    "rmse_report_and_salvage": """
        import json, os
        from srm_tpu_torch.tools import rmse_report, salvage_rmse_log
        from srm_tpu_torch.tools.rmse_experiment import eval_line
        log, out = os.path.join({d!r}, "run.log"), os.path.join({d!r}, "salvaged.json")
        open(log, "w").write(eval_line(5, 12.5, 80.0) + "\\n" + eval_line(10, 30.0, 40.0) + "\\n")
        rec = salvage_rmse_log.main([log, "--out", out])
        tf = os.path.join({d!r}, "tf.json")
        json.dump({{"trajectory": [{{"wall_s": 100.0, "step": 10, "rmse_psia": 50.0}}]}},
                  open(tf, "w"))
        rec["rmse_predict_pi"] = 263.4
        json.dump(rec, open(out, "w"))
        assert rmse_report.main([out, tf])["speedups_at_tf_levels"] == [3.3]""",
    "profiling_and_simulator_blocks": """
        import numpy as np, torch
        from srm_tpu_torch.utils.profiling import EpochTimer, trace
        from srm_tpu_torch.sim.fv_simulator import SolverGraphs
        from srm_tpu_torch.sim import simulate_dry_gas
        with trace({d!r}, device="cpu"):
            torch.ones(8).sum()
        timer = EpochTimer()
        timer.start()
        timer.stop(1)
        assert timer.summary()["count"] == 1""",
}


@pytest.mark.parametrize("entry", sorted(_ENTRY_POINTS))
def test_examples_and_tools_never_import_jax(tmp_path, entry):
    """The example drivers and the tools (and the profiling helpers and the
    simulator's solver blocks) stand alone as well."""
    body = textwrap.dedent(_ENTRY_POINTS[entry]).format(d=str(tmp_path))
    script = ("import sys\nimport torch\ntorch.set_num_threads(2)\n" + body + textwrap.dedent("""
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax"))
        assert not loaded, loaded
        ref = sorted(m for m in sys.modules if m.split(".")[0] == "srm_tpu")
        assert not ref, ref
        print("isolated")
    """))
    proc = _run([sys.executable, "-c", script], cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "isolated" in proc.stdout


def test_serving_path_never_imports_jax(tmp_path):
    """A CPU rollout (pressure, rates), an export and a served bundle, and
    the CLI's predict, stand alone as well."""
    script = textwrap.dedent(f"""
        import sys
        import numpy as np
        import torch
        torch.set_num_threads(2)
        from srm_tpu_torch.__main__ import main
        from srm_tpu_torch.eval import SRMPredictor, export_surrogate, load_surrogate
        from srm_tpu_torch.examples.common import setup_case
        case = setup_case("DG", base_dir={str(tmp_path)!r}, nx=9, n_realizations=6,
                          device="cpu")
        pred = SRMPredictor(case["models"], case["data_summary"], case["general_config"],
                            case["processor"].reservoir_config, batch_size=8)
        permx = case["processor"].generate_kle_splits()["test"][:2]
        p = pred.predict_pressure(permx, [0.0, 30.0])
        q, pwf = pred.predict_rates(permx, [0.0, 30.0])
        assert p.shape == (2, 2, 1, 9, 9) and np.isfinite(p).all() and np.isfinite(pwf).all()
        export_surrogate(pred, {str(tmp_path / "bundle")!r}, platforms=("cpu",))
        served = load_surrogate({str(tmp_path / "bundle")!r}, device="cpu")(
            "pressure", np.repeat(permx, 2, axis=0), np.array([0.0, 30.0] * 2, np.float32))
        assert np.allclose(served.reshape(p.shape), p, rtol=1e-5, atol=1e-3)
        assert main(["predict", "--nx", "9", "--realizations", "6", "--device", "cpu",
                     "--base-dir", {str(tmp_path)!r}]) == 0
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax"))
        assert not loaded, loaded
        ref = sorted(m for m in sys.modules if m.split(".")[0] == "srm_tpu")
        assert not ref, ref
        print("isolated")
    """)
    proc = _run([sys.executable, "-c", script], cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "isolated" in proc.stdout


@pytest.mark.parametrize("command", [
    ["-m", "srm_tpu_torch", "predict"],
    ["-m", "srm_tpu_torch", "export", "--out-dir", "bundle", "--platforms", "cpu"],
    ["-m", "srm_tpu_torch.tools.infer_vs_sim"],
])
def test_serving_entry_points_refuse_to_run_on_the_cpu_unasked(command, tmp_path):
    proc = _run([sys.executable, *command, "--nx", "9", "--base-dir", str(tmp_path)],
                cwd=tmp_path, env_extra={"PYTHONPATH": str(ROOT)})
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr, proc.stderr[-2000:]
    assert not (tmp_path / "bundle").exists()


def test_chip_smoke_imports_nothing_of_the_jax_package():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    bad = [m for m in names if m.split(".")[0] in ("srm_tpu", "jax", "jaxlib", "flax", "optax")]
    assert not bad, bad
    assert any(m.startswith("srm_tpu_torch") for m in names)


_NO_CUDA = """
import sys
import torch
assert not torch.cuda.is_available()
{body}
"""


def test_setup_case_refuses_to_run_on_the_cpu_unasked(tmp_path):
    body = (f"from srm_tpu_torch.examples.common import setup_case\n"
            f"setup_case('DG', base_dir={str(tmp_path)!r}, nx=9, n_realizations=6)\n")
    proc = _run([sys.executable, "-c", _NO_CUDA.format(body=body)], cwd=ROOT)
    assert proc.returncode != 0
    assert 'device="cpu"' in proc.stderr, proc.stderr[-2000:]
    assert not list(tmp_path.iterdir())           # it stopped before building anything


def test_cli_refuses_to_run_on_the_cpu_unasked(tmp_path):
    proc = _run([sys.executable, "-m", "srm_tpu_torch", "train", "--fluid", "GC", "--nx", "9",
                 "--realizations", "6", "--epochs", "1", "--base-dir", str(tmp_path)], cwd=ROOT)
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr, proc.stderr[-2000:]
    assert "final total train loss" not in proc.stdout


def test_cli_trains_gc_on_the_cpu_when_asked(tmp_path):
    proc = _run([sys.executable, "-m", "srm_tpu_torch", "train", "--fluid", "gc", "--nx", "9",
                 "--realizations", "6", "--epochs", "1", "--batch-size", "32", "--device",
                 "cpu", "--base-dir", str(tmp_path)], cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "device: cpu" in proc.stdout and "final total train loss" in proc.stdout


def _assert_refused(proc):
    assert proc.returncode != 0, proc.stdout[-2000:]
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_refuses_without_a_gpu():
    _assert_refused(_run([sys.executable, "chip_smoke.py"], cwd=ROOT))


def test_chip_smoke_refuses_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    _assert_refused(_run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env_extra={"PYTHONPATH": ""}))
