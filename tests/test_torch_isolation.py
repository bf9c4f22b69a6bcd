"""The port stands alone: it never imports JAX nor anything of the JAX
package, its entry points run on the GPU unless the caller asks for the CPU,
and its chip check imports nothing of the JAX package and refuses to run,
and prints no result, without a GPU or outside a checkout."""

import ast
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _run(args, cwd, env_extra=None, timeout=300):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "2",
           **(env_extra or {})}
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)


def _isolated_step(base_dir, case_kwargs: str, fluid: str = "DG") -> str:
    """A script that imports every module of the port, builds a case with
    ``setup_case(fluid, ..., <case_kwargs>)``, takes one CPU train step and
    fails if JAX or any module of the JAX package (``srm_tpu``,
    ``srm_tpu.*``) was loaded."""
    return textwrap.dedent(f"""
        import importlib, pkgutil, sys
        import torch
        torch.set_num_threads(2)
        import srm_tpu_torch
        for mod in pkgutil.walk_packages(srm_tpu_torch.__path__, "srm_tpu_torch."):
            importlib.import_module(mod.name)
        from srm_tpu_torch.examples.common import setup_case
        from srm_tpu_torch.training.trainer import Trainer
        case = setup_case({fluid!r}, base_dir={str(base_dir)!r}, n_realizations=6,
                          device="cpu", {case_kwargs})
        trainer = Trainer(case["loss_fn"])
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
