"""The port's Eclipse parsers and the dataset's parsed-label branch against
the JAX package's: both parsers on the golden decks and on decks written
here (exact equality: the same numpy code), ``reshape_array``'s trim and
fallback cases, ``process_array``'s slices and axis merge, the shared
``combined_results.npz`` cache read across packages, and a 9×9 physics-mode
dataset whose test labels are parsed from simulator files and re-sliced in
time by ``array_pipeline.slices``."""

import copy
import os

import numpy as np
import pytest
import torch

from srm_tpu.config import DEFAULT_GENERAL_CONFIG
from srm_tpu.data import pipeline as jp
from srm_tpu.data.dataset import SRMDataProcessor as JaxProcessor
from srm_tpu_torch.data import pipeline as tp
from srm_tpu_torch.data.dataset import SRMDataProcessor

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
RSM_TARGETS = [["TIME"], "WGPR", "WBHP", ["WOPR", "15 15 1"], ["WOPR", "22 3 1"]]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def _same(a, b):
    """Equal nested dicts/lists of arrays: same keys, dtypes, shapes, bits."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and a.keys() == b.keys()
        for k in b:
            _same(a[k], b[k])
    elif isinstance(b, list):
        assert isinstance(a, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif b is None:
        assert a is None
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _funrst(blocks, per_line=4):
    """A keyword-block deck: [(keyword, values)] in order."""
    out = []
    for key, vals in blocks:
        out.append(f"'{key:<8}'  {len(vals)} 'REAL'")
        vals = list(vals)
        for i in range(0, len(vals), per_line):
            out.append(" " + " ".join(f"{v:.4f}" for v in vals[i:i + per_line]))
    return "\n".join(out) + "\n"


RSM_DECK = ("SUMMARY OF RUN R7\n1\n"
            "\tTIME\tWGPR\tWBHP\tWOPR\tWOPR\n"
            "\tDAYS\tMSCF/DAY\tPSIA\tSTB/DAY\tSTB/DAY\n"
            "\t\tP1\tP1\t15 15 1\t22 3 1\n"
            "\t1.0\t500.0\t4500.0\t12.5\t3.0\n"
            "\t2.0\t480.0\tbad\t12.0\n"            # a NaN cell and a ragged row
            "\n"
            "SUMMARY OF RUN R7\n"
            "\tTIME\tWGPR\n\tDAYS\tMSCF/DAY\n\t\tP1\n"
            "\t3.0\t470.0\n")


@pytest.mark.parametrize("source", ["golden", "deck"])
def test_tabular_parser_matches(source):
    text = open(os.path.join(GOLDEN, "sample.RSM")).read() if source == "golden" else RSM_DECK
    got, want = tp.parse_tabular_file(text, RSM_TARGETS), jp.parse_tabular_file(text, RSM_TARGETS)
    _same(got, want)
    assert want["TIME"] is not None and want["WOPR"]["15 15 1"] is not None
    if source == "deck":
        assert np.isnan(want["WBHP"][1]) and want["TIME"].tolist() == [1.0, 2.0, 3.0]
    assert tp.convert_target_spec(RSM_TARGETS) == jp.convert_target_spec(RSM_TARGETS)
    assert tp._split_segments(text) == jp._split_segments(text)


@pytest.mark.parametrize("source", ["golden", "deck"])
def test_continuous_parser_matches(source):
    if source == "golden":
        text = open(os.path.join(GOLDEN, "sample.FUNRST")).read()
    else:
        rng = np.random.RandomState(0)
        text = _funrst([("PRESSURE", rng.uniform(4000, 5000, 81)), ("SGAS", rng.uniform(0, 1, 81)),
                        ("PRESSURE", rng.uniform(4000, 5000, 81)), ("PORO", [0.2] * 5)])
        text += "\ngarbage line\n'SWAT'\n 0.22 x 0.3\n"
    keys = ["PRESSURE", "SGAS", "SWAT"]
    _same(tp.parse_continuous_file(text, keys), jp.parse_continuous_file(text, keys))


@pytest.mark.parametrize("n, shape", [
    (12, (3, 4)),            # exact: Fortran order
    (24, (3, 4)),            # a multiple: a leading axis
    (14, (3, 4)),            # longer: trimmed
    (9, (3, 4)),             # shorter and square: the square fallback
    (7, (3, 4)),             # shorter, not square: flat
    (5, None),               # no shape
])
def test_reshape_array_matches(n, shape):
    arr = np.arange(n, dtype=np.float32) * 1.5
    got, want = tp.reshape_array(arr, shape), jp.reshape_array(arr, shape)
    _same(got, want)
    if n == 12:
        assert want[1, 0] == 1.5 and want[0, 1] == 4.5


@pytest.mark.parametrize("slices, slice_dim, reshape_dims", [
    ([0, 2, 5], 1, (0, 1)),
    ([3], 1, None),
    (None, 1, (0, 1)),
    ([1, 0], 0, (1, 2)),
    ([0, 4], -1, (0, 1, 2)),
])
def test_process_array_matches(slices, slice_dim, reshape_dims):
    arr = np.random.RandomState(1).uniform(0, 1, (4, 6, 3, 5)).astype(np.float64)
    got = tp.process_array(arr, slices=slices, slice_dim=slice_dim, reshape_dims=reshape_dims)
    want = jp.process_array(arr, slices=slices, slice_dim=slice_dim, reshape_dims=reshape_dims)
    _same(got, want)
    assert want.dtype == np.float32
    with pytest.raises(ValueError, match="contiguous"):
        tp.process_array(arr, reshape_dims=(0, 2))


def _dynamic_dir(path, K=3, T=4, nx=5, ny=4, nz=1, seed=0):
    """K realizations' .FUNRST decks (PRESSURE and SGAS at T report steps,
    Eclipse F-order cells) and .RSM summaries; returns the arrays written,
    (K, T, Nx, Ny, Nz)."""
    os.makedirs(path, exist_ok=True)
    rng = np.random.RandomState(seed)
    p = rng.uniform(4000.0, 5000.0, (K, T, nx, ny, nz)).round(4)
    s = rng.uniform(0.0, 1.0, (K, T, nx, ny, nz)).round(4)
    for k in range(K):
        blocks = []
        for t in range(T):
            blocks += [("PRESSURE", p[k, t].reshape(-1, order="F")),
                       ("SGAS", s[k, t].reshape(-1, order="F"))]
        with open(os.path.join(path, f"CASE_{k:04d}.FUNRST"), "w") as f:
            f.write(_funrst(blocks))
        with open(os.path.join(path, f"CASE_{k:04d}.RSM"), "w") as f:
            f.write(RSM_DECK)
    return p, s


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_combined_results_shared_across_packages(tmp_path, writer):
    """Each package parses a directory and writes ``output/combined_results.npz``;
    the other reads that cache (the decks are gone) to the same arrays."""
    d = str(tmp_path / "dynamic")
    p, s = _dynamic_dir(d)
    first, second = (tp, jp) if writer == "port" else (jp, tp)
    want = first.run_pipeline_for_directory(d, shape=(5, 4, 1))
    assert os.path.isfile(os.path.join(d, "output", "combined_results.npz"))
    assert os.path.isfile(os.path.join(d, "output", "summary.json"))
    for f in os.listdir(d):
        if f.endswith((".FUNRST", ".RSM")):
            os.remove(os.path.join(d, f))
    got = second.run_pipeline_for_directory(d, shape=(5, 4, 1))
    _same(got, want)
    np.testing.assert_array_equal(want["PRESSURE"], p.astype(np.float32))
    np.testing.assert_array_equal(want["SGAS"], s.astype(np.float32))


def test_pipeline_from_config_matches(tmp_path):
    """The config-driven orchestrator and the array stage over the parsed
    cache: the same arrays in both packages."""
    d = str(tmp_path / "dynamic")
    _dynamic_dir(d, K=2, T=6)
    cfg = {"simulation_pipeline": {"enabled": True, "input_folder": d, "shape": (5, 4, 1)},
           "array_pipeline": {"keys": ["PRESSURE", "SGAS"], "slices": [0, 3, 5],
                              "reshape_dims": [0, 1]}}
    _same(tp.run_pipeline_from_config(cfg), jp.run_pipeline_from_config(cfg))
    arr_cfg = {"directory": os.path.join(d, "output"), "slices": [1, 2], "reshape_dims": [0, 1]}
    _same(tp.run_array_pipeline(arr_cfg), jp.run_array_pipeline(arr_cfg))


def test_parallel_parse_matches_serial(tmp_path):
    """The process pool (spawned workers) parses what the serial loop does."""
    d = str(tmp_path / "dynamic")
    _dynamic_dir(d, K=3, T=2)
    fv = {".FUNRST": ["PRESSURE", "SGAS"], ".RSM": [["TIME"], "WGPR"]}
    serial = tp.process_files_in_directory(d, fv, (5, 4, 1))
    _same(tp.process_files_in_directory(d, fv, (5, 4, 1), parallel=True, max_workers=2), serial)
    _same(serial, jp.process_files_in_directory(d, fv, (5, 4, 1)))


def _processor(cls, base, slices):
    """The dg9 case's resize (srm_tpu/examples/common.py:47-64), physics mode."""
    g = copy.deepcopy(DEFAULT_GENERAL_CONFIG)
    g["unit_target_shape"] = (1, 1, 9, 9, 1)
    if slices is not None:
        g["array_pipeline"] = {"slices": slices}
    proc = cls(base_dir=str(base), general_config=g)
    res = proc.reservoir_config
    res["Nx"] = res["Ny"] = 9
    for conn in proc.wells_config["connections"]:
        conn["i"] = min(int(conn["i"] * 9 / 39), 8)
        conn["j"] = min(int(conn["j"] * 9 / 39), 8)
    res["realizations"]["permx"]["conditional_values"] = {(5, 5, 0): 2.0}
    res["realizations"]["permx"]["number"] = 6
    return proc


@pytest.mark.parametrize("slices", [None, [0, 4, 9, 20]])
def test_parsed_labels_dataset_matches(tmp_path, slices):
    """A test split labelled from parsed simulator files (24 report steps,
    fewer than the features' times: both are trimmed to the common extent),
    re-sliced by ``array_pipeline.slices``: the port's groups, labels and
    statistics against the JAX package's ``process_data``, to float32
    rounding of the normalization (labels exact)."""
    out, stats = {}, {}
    for name, cls in (("jax", JaxProcessor), ("port", SRMDataProcessor)):
        proc = _processor(cls, tmp_path / name, slices)
        _, h = proc.config_hash()
        dyn = os.path.join(proc.kle_folder(), f"dat_files_test_{h}", "dynamic")
        p, _ = _dynamic_dir(dyn, K=4, T=24, nx=9, ny=9, seed=3)
        out[name] = proc.process_data()[:4]
        stats[name] = proc.load_training_statistics()
        assert os.path.isfile(os.path.join(dyn, "output", "combined_results.npz"))
    assert stats["port"] == stats["jax"]
    for split in range(4):
        (jx, jy), = out["jax"][split]
        (tx, ty), = out["port"][split]
        assert tx.shape == jx.shape and ty.keys() == jy.keys()
        np.testing.assert_allclose(tx, jx, rtol=1e-6, atol=1e-6)
        for k in jy:
            np.testing.assert_array_equal(ty[k], jy[k])
    (tx, ty), = out["port"][2]
    want = np.transpose(p, (0, 1, 4, 3, 2)).astype(np.float32)     # (K, T, Nz, Ny, Nx)
    if slices is not None:
        want = want[:, slices]
    assert tx.shape[:2] == want.shape[:2] == ty["PRESSURE"].shape[:2]
    np.testing.assert_array_equal(ty["PRESSURE"], want)
