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


def test_non_physics_modes_are_refused(tmp_path):
    g = copy.deepcopy(DEFAULT_GENERAL_CONFIG)
    g["physics_mode_fraction"] = 0.5
    proc = _resize(SRMDataProcessor(base_dir=str(tmp_path), general_config=g))
    with pytest.raises(NotImplementedError):
        proc.get_or_generate_training_data()
