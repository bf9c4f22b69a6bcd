"""Serving export (``torch.export`` programs) round trip, ported from
``tests/test_serving.py``, and the port's bundle against the JAX package's.

The exported program must reproduce the live predictor on the same inputs,
serve any batch size through its symbolic batch dimension, load from its
directory alone (in a process that imports only ``torch``, ``numpy`` and
``json``), and agree with the JAX package's ``jax.export`` bundle built
from the same flax weights."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from srm_tpu_torch.eval.serving import ServingSurrogate, export_surrogate, load_surrogate
from test_torch_predictor import RTOL, ATOL_PSIA, dg, gc  # noqa: F401  (shared fixtures)

TIMES = [0.0, 10.0, 50.0]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def bundle(dg, tmp_path_factory):  # noqa: F811
    _, tp, _ = dg
    out = str(tmp_path_factory.mktemp("bundle"))
    paths = export_surrogate(tp, out, fields=("pressure",), platforms=("cpu",))
    return out, paths


def _flat(permx, times):
    """The (K, T) grid flattened into a batch, as the predictor does."""
    T = len(times)
    return np.repeat(permx, T, axis=0), np.tile(np.asarray(times, np.float32), permx.shape[0])


def test_export_roundtrip_matches_predictor(dg, bundle):  # noqa: F811
    _, tp, permx = dg
    out, paths = bundle
    assert set(paths) == {"pressure"} and set(paths["pressure"]) == {"cpu"}
    srv = load_surrogate(out, device="cpu")
    assert srv.fields == ["pressure"]
    assert srv.manifest["grid"] == [1, 13, 13]
    assert srv.manifest["fields"]["pressure"] == {
        "artifact": {"cpu": "pressure.cpu.pt2"}, "unit": "psia", "output": ["b", 1, 13, 13]}

    live = tp.predict_pressure(permx, TIMES)                # (K, T, 1, H, W)
    served = srv("pressure", *_flat(permx, TIMES)).reshape(live.shape)
    np.testing.assert_allclose(served, live, rtol=RTOL, atol=ATOL_PSIA)
    # the hard initial condition survives the export
    np.testing.assert_array_equal(served[:, 0], 5000.0)
    assert np.abs(served[:, 1:] - 5000.0).max() > 10.0


@pytest.mark.parametrize("b", [1, 3, 7])
def test_export_symbolic_batch(dg, bundle, b):  # noqa: F811
    """One program serves every batch size."""
    _, _, permx = dg
    srv = load_surrogate(bundle[0], device="cpu")
    vol = permx.shape[1:]
    px = np.broadcast_to(permx[0], (b,) + vol).copy()
    p = srv("pressure", px, np.linspace(0.0, 50.0, b, dtype=np.float32))
    assert p.shape == (b,) + vol
    assert np.isfinite(p).all()


def test_serving_needs_no_python_stack(dg, bundle):  # noqa: F811
    """A ServingSurrogate built from the directory alone serves."""
    _, _, permx = dg
    srv = ServingSurrogate(bundle[0], device="cpu")
    p = srv("pressure", permx, np.array([5.0, 25.0], np.float32))
    assert p.shape == permx.shape
    assert np.isfinite(p).all()


def test_bundle_loads_with_torch_alone(dg, bundle, tmp_path):  # noqa: F811
    """The promise of the reference's bundle: it loads with nothing but the
    framework. A fresh process imports only torch, numpy and json, serves
    the program named by the manifest, and loads no module of either
    package."""
    _, _, permx = dg
    out = bundle[0]
    px, t = _flat(permx, TIMES)
    np.save(tmp_path / "px.npy", px)
    np.save(tmp_path / "t.npy", t)
    script = textwrap.dedent(f"""
        import json, os, sys
        import numpy as np
        import torch
        out = {out!r}
        with open(os.path.join(out, "manifest.json")) as f:
            manifest = json.load(f)
        fn = torch.export.load(os.path.join(out, manifest["fields"]["pressure"]["artifact"]["cpu"])).module()
        with torch.no_grad():
            p = fn(torch.from_numpy(np.load({str(tmp_path / "px.npy")!r})),
                   torch.from_numpy(np.load({str(tmp_path / "t.npy")!r})))
        np.save({str(tmp_path / "served.npy")!r}, p.numpy())
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in
                        ("srm_tpu", "srm_tpu_torch", "jax", "jaxlib", "flax"))
        assert not loaded, loaded
        print("served", p.shape)
    """)
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "2", "PYTHONPATH": ""}
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "served" in proc.stdout
    want = load_surrogate(out, device="cpu")("pressure", px, t)
    np.testing.assert_array_equal(np.load(tmp_path / "served.npy"), want)


@pytest.mark.parametrize("fluid", ["DG", "GC"])
def test_bundle_matches_reference_bundle(fluid, dg, gc, tmp_path):  # noqa: F811
    """The port's bundle and the JAX package's ``jax.export`` bundle, built
    from the same flax weights, on the same raw inputs."""
    from srm_tpu.eval.serving import export_surrogate as jax_export
    from srm_tpu.eval.serving import load_surrogate as jax_load

    jp, tp, permx = dg if fluid == "DG" else gc
    fields = ("pressure", "saturation") if fluid == "GC" else ("pressure",)
    jax_export(jp, str(tmp_path / "jax"), fields=fields, platforms=("cpu",))
    export_surrogate(tp, str(tmp_path / "torch"), fields=fields, platforms=("cpu",))
    want, got = jax_load(str(tmp_path / "jax")), load_surrogate(str(tmp_path / "torch"), "cpu")
    assert got.fields == want.fields == sorted(fields)
    for key in ("grid", "channels", "inputs"):
        assert got.manifest[key] == want.manifest[key]
    px, t = _flat(permx, TIMES)
    for field in fields:
        w, g = want(field, px, t), got(field, px, t)
        assert g.shape == w.shape == (len(t), 1, 13, 13)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL_PSIA)


def test_cli_export_gc(tmp_path, capsys):
    """``export --fluid GC`` writes a bundle with both heads that loads and
    serves from the directory alone."""
    from srm_tpu_torch.__main__ import main

    out_dir = tmp_path / "bundle"
    rc = main(["export", "--fluid", "GC", "--nx", "9", "--realizations", "4", "--base-dir",
               str(tmp_path), "--out-dir", str(out_dir), "--platforms", "cpu", "--device",
               "cpu"])
    assert rc == 0
    assert "serving bundle written" in capsys.readouterr().out
    srv = load_surrogate(str(out_dir), device="cpu")
    assert srv.fields == ["pressure", "saturation"]
    px = np.exp(np.random.RandomState(0).randn(2, 1, 9, 9).astype(np.float32))
    for field in srv.fields:
        o = srv(field, px, np.array([0.0, 30.0], np.float32))
        assert o.shape == (2, 1, 9, 9)
        assert np.isfinite(o).all()


def test_serving_refuses_what_it_cannot_serve(dg, bundle, tmp_path):  # noqa: F811
    """No fallback: without a card, exporting for or serving on "cuda"
    raises; a bundle without a program for the platform asked for raises."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusals of a machine without a CUDA device")
    _, tp, _ = dg
    with pytest.raises(RuntimeError, match="CUDA device"):
        export_surrogate(tp, str(tmp_path / "b"), platforms=("cpu", "cuda"))
    assert not (tmp_path / "b").exists()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        load_surrogate(bundle[0])
    only_cuda = tmp_path / "only_cuda"
    shutil.copytree(bundle[0], only_cuda)
    manifest = json.loads((only_cuda / "manifest.json").read_text())
    manifest["platforms"] = ["cuda"]
    (only_cuda / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="no program for 'cpu'"):
        load_surrogate(str(only_cuda), device="cpu")
