"""The port's physics-mode dataset against the JAX package's: same cache
files, same arrays, same statistics."""

import copy
import os

import numpy as np
import pytest
import torch

from srm_tpu.config import DEFAULT_GENERAL_CONFIG
from srm_tpu.data import batching as jbatch
from srm_tpu.data.dataset import SRMDataProcessor as JaxProcessor
from srm_tpu_torch.data import batching as tbatch
from srm_tpu_torch.data.dataset import SRMDataProcessor
from srm_tpu_torch.data.kle import generate_kle_numpy
from srm_tpu.data.kle import generate_kle_numpy as jax_generate_kle_numpy


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def _resize(proc, nx=9, n=6):
    """The dg9 case's resize (srm_tpu/examples/common.py:47-64)."""
    res = proc.reservoir_config
    scale = nx / res["Nx"]
    res["Nx"] = res["Ny"] = nx
    for conn in proc.wells_config["connections"]:
        conn["i"] = min(int(conn["i"] * scale), nx - 1)
        conn["j"] = min(int(conn["j"] * scale), nx - 1)
    res["realizations"]["permx"]["conditional_values"] = {(5, 5, 0): 2.0}
    res["realizations"]["permx"]["number"] = n
    return proc


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    g = copy.deepcopy(DEFAULT_GENERAL_CONFIG)
    jp = _resize(JaxProcessor(base_dir=str(tmp_path_factory.mktemp("jax")), general_config=g))
    tp = _resize(SRMDataProcessor(base_dir=str(tmp_path_factory.mktemp("torch")),
                                  general_config=g))
    return jp, jp.get_or_generate_training_data(), tp, tp.get_or_generate_training_data()


def _pairs(groups_a, groups_b):
    assert len(groups_a) == len(groups_b)
    for (fa, la), (fb, lb) in zip(groups_a, groups_b):
        yield fa, fb
        assert la.keys() == lb.keys()
        for k in la:
            yield la[k], lb[k]


def test_same_cache_files(both):
    jp, jout, tp, tout = both
    assert tp.config_hash() == jp.config_hash()
    assert os.path.relpath(tout[0], tp.base_dir) == os.path.relpath(jout[0], jp.base_dir)
    _, h = tp.config_hash()
    stats = os.path.join(tp.kle_folder(), f"training_statistics_summary_{h}.json")
    assert os.path.isfile(stats)


@pytest.mark.parametrize("split", [1, 2, 3, 4], ids=["train", "val", "test", "pred"])
def test_same_arrays(both, split):
    _, jout, _, tout = both
    for a, b in _pairs(jout[split], tout[split]):
        assert a.shape == b.shape and a.dtype == b.dtype
        # identical woven features; float32 log/divide of two libraries in
        # the normalization may differ by an ulp
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)


def test_same_statistics(both):
    jp, _, tp, _ = both
    want, got = jp.load_training_statistics(), tp.load_training_statistics()
    assert want == got


def test_reads_the_reference_cache(both):
    """Pointed at the JAX package's cache directory, the port loads its npz."""
    jp, jout, _, _ = both
    tp = _resize(SRMDataProcessor(base_dir=jp.base_dir, general_config=jp.general_config))
    out = tp.get_or_generate_training_data()
    assert out[0] == jout[0]
    for a, b in _pairs(jout[1], out[1]):
        np.testing.assert_array_equal(a, b)


def test_kle_and_collapse_match_reference():
    kw = dict(Nx=7, Ny=6, Nz=1, seed=11, cond_values={(2, 3, 0): 2.0})
    a, na, _ = jax_generate_kle_numpy(5, **kw)
    b, nb, _ = generate_kle_numpy(5, **kw)
    assert na == nb
    np.testing.assert_array_equal(a, b)
    arr = np.arange(3 * 4 * 2 * 5, dtype=np.float32).reshape(3, 4, 2, 5)
    np.testing.assert_array_equal(tbatch.collapse_axes_fortran(arr),
                                  jbatch.collapse_axes_fortran(arr))


def test_collapse_groups_matches_batch_generator(both):
    _, jout, _, _ = both
    bg = jbatch.BatchGenerator(jout[1], batch_size=4, shuffle=False)
    x, y = tbatch.collapse_groups(jout[1])
    np.testing.assert_array_equal(x, bg.x_all)
    np.testing.assert_array_equal(y["PRESSURE"], bg.y_all["PRESSURE"])


def _batcher_groups(dict_labels: bool = True):
    """Two seeded (features, labels) groups of (K, T, H, W, C) samples (K 3
    and 2, T 5), labels a dict of two keys or one array."""
    rng = np.random.RandomState(5)
    groups = []
    for k in (3, 2):
        x = rng.standard_normal((k, 5, 4, 3, 2)).astype(np.float32)
        y = {"PRESSURE": rng.standard_normal((k, 5, 4, 3, 1)).astype(np.float32),
             "SGAS": rng.standard_normal((k, 5, 4, 3, 1)).astype(np.float32)}
        groups.append((x, y if dict_labels else y["PRESSURE"]))
    return groups


BATCHERS = {
    "in_order": dict(shuffle=False),
    "shuffle": dict(seed=3),
    "lhs_shuffle": dict(lhs_shuffle=True, seed=4),
    "lhs_in_order": dict(lhs_shuffle=True, shuffle=False),
    "keep_remainder": dict(drop_remainder=False, seed=5),
    "c_order": dict(collapse_order="C", seed=6),
    "no_collapse": dict(collapse_axes=None, shuffle=False),
    "stack_labels": dict(stack_labels=True, seed=7),
    "array_labels": dict(seed=8),
}


def _same(a, b):
    if isinstance(b, dict):
        assert list(a) == list(b)
        for k in b:
            _same(a[k], b[k])
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", list(BATCHERS))
def test_batch_generator_gives_the_jax_packages_batches(case):
    """The host batcher over the same groups gives the JAX package's
    batches bit for bit through two epochs (the ``RandomState`` shuffles
    and the LHS strata the same draws; F and C collapse, the remainder kept
    or dropped, stacked or array labels); ``epoch_batches`` likewise, or
    both raise where a short last batch cannot be laid out."""
    kw = dict(BATCHERS[case])
    groups = _batcher_groups(dict_labels=case != "array_labels")
    if case == "no_collapse":
        groups = [(x.reshape((-1,) + x.shape[2:]), {k: v.reshape((-1,) + v.shape[2:])
                                                     for k, v in y.items()})
                  for x, y in groups]
    want = jbatch.BatchGenerator(groups, batch_size=4, **kw)
    got = tbatch.BatchGenerator(groups, batch_size=4, **kw)
    assert len(got) == len(want) == (7 if case == "keep_remainder" else 6)
    np.testing.assert_array_equal(got.indices, want.indices)
    for _ in range(2):
        for i in range(len(want)):
            for a, b in zip(got[i], want[i]):
                _same(a, b)
        if len(want) * 4 == want.N or kw.get("drop_remainder", True):
            for a, b in zip(got.epoch_batches(), want.epoch_batches()):
                _same(a, b)
        else:
            for batcher in (got, want):
                with pytest.raises(ValueError):
                    batcher.epoch_batches()
        got.on_epoch_end()
        want.on_epoch_end()


def test_batch_generator_edge_cases_match_the_jax_package():
    """No groups: an empty batcher of length 0 in both; pairs that are not a
    list and an unknown collapse order raise ``ValueError`` in both; and
    ``lhs_shuffle_indices`` draws the JAX package's indices."""
    for mod in (jbatch, tbatch):
        empty = mod.BatchGenerator([], batch_size=4)
        assert len(empty) == 0 and empty.N == 0
        with pytest.raises(ValueError, match="list"):
            mod.BatchGenerator(tuple(_batcher_groups()), batch_size=4)
        with pytest.raises(ValueError, match="collapse_order"):
            mod.BatchGenerator(_batcher_groups(), batch_size=4, collapse_order="A")
    for n, seed in ((1, 0), (7, 42), (100, 3)):
        np.testing.assert_array_equal(tbatch.lhs_shuffle_indices(n, seed),
                                      jbatch.lhs_shuffle_indices(n, seed))


def _fake_simulate_labels(proc, split, permx=None, times=None, **kw):
    """Seeded labels of the simulator's shape (K, T, Nz, Ny, Nx), the same
    in both packages, in place of a simulator run."""
    rng = np.random.RandomState({"train": 1, "val": 2, "test": 3}[split])
    shape = (permx.shape[0], times.shape[0]) + permx.shape[1:]
    return {k: rng.uniform(4000.0, 5000.0, shape).astype(np.float32)
            for k in proc.label_keys()}


def test_non_physics_modes_are_refused(tmp_path, monkeypatch):
    """Data and mixed modes are ported (ROADMAP A11), and now so is what
    they were refused for, labels re-sliced in time (A15): in mixed mode
    with simulator labels every split's labels are re-sliced by
    ``array_pipeline.slices`` and trimmed with their features as the JAX
    package does; both packages build the same dataset (the simulator
    replaced by the same seeded labels in each)."""
    monkeypatch.setattr("srm_tpu.sim.simulate_labels", _fake_simulate_labels)
    monkeypatch.setattr("srm_tpu_torch.sim.simulate_labels", _fake_simulate_labels)
    g = copy.deepcopy(DEFAULT_GENERAL_CONFIG)
    g["physics_mode_fraction"] = 0.5
    g["label_source"] = "simulator"
    g["array_pipeline"] = {"slices": [0, 10]}
    out = {}
    for name, cls in (("jax", JaxProcessor), ("port", SRMDataProcessor)):
        proc = _resize(cls(base_dir=str(tmp_path / name), general_config=g))
        out[name] = proc.get_or_generate_training_data()[1:]
    for split, (ja, ta) in enumerate(zip(out["jax"], out["port"])):
        for fj, ft in _pairs(ja, ta):
            assert ft.shape == fj.shape
            np.testing.assert_allclose(ft, fj, rtol=1e-6, atol=1e-6, err_msg=str(split))
    # the train labels: the simulator's at the time indices 0 and 10
    (x, y), = out["port"][0]
    proc = _resize(SRMDataProcessor(base_dir=str(tmp_path / "port"), general_config=g))
    full = _fake_simulate_labels(proc, "train", permx=proc.generate_kle_splits()["train"],
                                 times=proc.generate_time_tensor()["train"])["PRESSURE"]
    assert x.shape[1] == 2 and y["PRESSURE"].shape == x.shape[:-1]
    np.testing.assert_array_equal(y["PRESSURE"], full[:, [0, 10]])