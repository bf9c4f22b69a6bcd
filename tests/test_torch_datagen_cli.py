"""The port's ``generate-data`` command against the JAX package's: the
default case (39×39×1) at 6 realizations, with and without the Eclipse
decks, gives byte-identical file trees; the port's run loads nothing of
JAX or of the JAX package. Both commands run in processes with the same
environment: the float64 eigendecomposition of the covariance rounds by
LAPACK's thread count, so the bytes are the same for the same thread count."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from test_torch_datagen import _tree

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("no_dat", [False, True])
def test_generate_data_tree_matches_the_jax_cli(tmp_path, no_dat):
    flags = ["--realizations", "6"] + (["--no-dat"] if no_dat else [])
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "2",
           "PYTHONPATH": str(ROOT)}
    script = ("import sys\n"
              "from srm_tpu_torch.__main__ import main\n"
              "rc = main(sys.argv[1:])\n"
              "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'flax', 'optax', 'srm_tpu'))\n"
              "assert not bad, bad\n"
              "sys.exit(rc)\n")
    proc = subprocess.run([sys.executable, "-c", script, "generate-data", "--base-dir",
                           str(tmp_path / "port"), *flags], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "KLE dataset written to" in proc.stdout
    proc = subprocess.run([sys.executable, "-m", "srm_tpu", "generate-data", "--base-dir",
                           str(tmp_path / "jax"), *flags], cwd=tmp_path,
                          env={**env, "JAX_PLATFORMS": "cpu"}, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(got) == sorted(want)
    assert any(p.startswith(os.path.join("static_dynamic", "KLE_39x39x1_R6_")) for p in want)
    assert sum(p.endswith(".dat") for p in want) == (0 if no_dat else 6)
    for path in want:
        assert got[path] == want[path], path
