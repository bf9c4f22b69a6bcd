"""The port stands alone: it never imports JAX, and its chip check refuses to
run, and prints no result, without a GPU or outside a checkout."""

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


def _isolated_step(base_dir, case_kwargs: str) -> str:
    """A script that imports every module of the port, builds a case with
    ``setup_case(..., <case_kwargs>)``, takes one CPU train step and fails
    if JAX or any of the JAX package beyond ``srm_tpu.config`` was loaded."""
    return textwrap.dedent(f"""
        import importlib, pkgutil, sys
        import torch
        torch.set_num_threads(2)
        import srm_tpu_torch
        for mod in pkgutil.walk_packages(srm_tpu_torch.__path__, "srm_tpu_torch."):
            importlib.import_module(mod.name)
        from srm_tpu_torch.examples.common import setup_case
        from srm_tpu_torch.training.trainer import Trainer
        case = setup_case("DG", base_dir={str(base_dir)!r}, n_realizations=6, device="cpu",
                          {case_kwargs})
        trainer = Trainer(case["loss_fn"])
        nb, n = trainer.stage_dataset("train", case["train_groups"], 8)
        x, y, _, bs = trainer._resident["train"]
        metrics = trainer.train_step(x[:bs], {{k: v[:bs] for k, v in y.items()}})
        assert torch.isfinite(metrics["total"]), metrics
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax"))
        assert not loaded, loaded
        # srm_tpu.config is pure Python and numpy; nothing else of srm_tpu
        ref = sorted(m for m in sys.modules if m.startswith("srm_tpu.")
                     and not m.startswith("srm_tpu.config"))
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


def _assert_refused(proc):
    assert proc.returncode != 0, proc.stdout[-2000:]
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_refuses_without_a_gpu():
    _assert_refused(_run([sys.executable, "chip_smoke.py"], cwd=ROOT))


def test_chip_smoke_refuses_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    _assert_refused(_run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env_extra={"PYTHONPATH": ""}))
