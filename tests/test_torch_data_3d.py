"""The port's 3D physics-mode dataset with the ``uncorrelated`` permeability
sampler against the JAX package's: same cache files, arrays and statistics,
and the woven 3D feature layout."""

import copy
import os

import numpy as np
import pytest
import torch

from srm_tpu.config import DEFAULT_GENERAL_CONFIG
from srm_tpu.data.dataset import SRMDataProcessor as JaxProcessor
from srm_tpu_torch.data.dataset import SRMDataProcessor

N = 9


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def _resize(proc, n=6):
    """setup_case(nx=9, nz=9, kle_method="uncorrelated")'s resize
    (srm_tpu/examples/common.py:47-66)."""
    res = proc.reservoir_config
    scale = N / res["Nx"]
    res["Nx"] = res["Ny"] = res["Nz"] = N
    proc.general_config["unit_target_shape"] = (1, N, N, N, 1)
    for conn in proc.wells_config["connections"]:
        conn["i"] = min(int(conn["i"] * scale), N - 1)
        conn["j"] = min(int(conn["j"] * scale), N - 1)
        conn["k"] = min(conn.get("k", 0), N - 1)
    res["realizations"]["permx"]["conditional_values"] = {(5, 5, 0): 2.0}
    res["realizations"]["permx"]["number"] = n
    res["realizations"]["permx"]["method"] = "uncorrelated"
    return proc


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    g = copy.deepcopy(DEFAULT_GENERAL_CONFIG)
    jp = _resize(JaxProcessor(base_dir=str(tmp_path_factory.mktemp("jax3d")), general_config=g))
    tp = _resize(SRMDataProcessor(base_dir=str(tmp_path_factory.mktemp("torch3d")),
                                  general_config=g))
    return jp, jp.get_or_generate_training_data(), tp, tp.get_or_generate_training_data()


def test_same_cache_files(both):
    jp, jout, tp, tout = both
    assert tp.config_hash() == jp.config_hash()
    assert os.path.relpath(tout[0], tp.base_dir) == os.path.relpath(jout[0], jp.base_dir)
    assert "9x9x9" in tout[0]


def test_uncorrelated_fields_equal_the_reference(both):
    jp, _, tp, _ = both
    want, got = jp.generate_kle_splits(), tp.generate_kle_splits()
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape[1:] == (N, N, N)
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("split", [1, 2, 3, 4], ids=["train", "val", "test", "pred"])
def test_same_arrays_and_3d_layout(both, split):
    _, jout, _, tout = both
    assert len(tout[split]) == len(jout[split])
    for (fa, la), (fb, lb) in zip(jout[split], tout[split]):
        # (K, T, 1, D, H, W, 5): the temporal singleton stays between the
        # sample axes and the volume (tests/test_3d.py:70-72)
        assert fb.shape == fa.shape and fb.shape[2:] == (1, N, N, N, 5)
        assert fb.dtype == fa.dtype == np.float32
        # identical woven features; float32 log/divide of two libraries in
        # the normalization may differ by an ulp
        np.testing.assert_allclose(fb, fa, rtol=1e-6, atol=1e-6)
        assert la.keys() == lb.keys()
        for k in la:
            np.testing.assert_array_equal(lb[k], la[k])


def test_same_statistics(both):
    jp, _, tp, _ = both
    assert tp.load_training_statistics() == jp.load_training_statistics()


def test_unknown_method_is_refused(tmp_path):
    """A method other than "uncorrelated" is no longer refused: as in the
    JAX package (srm_tpu/data/dataset.py:79-104) it takes the dense KLE
    sampler, so "gaussian_process" gives the "KLE" fields in both packages."""
    splits = {}
    for name, cls, method in (("port", SRMDataProcessor, "gaussian_process"),
                              ("jax", JaxProcessor, "gaussian_process"),
                              ("kle", SRMDataProcessor, "KLE")):
        proc = _resize(cls(base_dir=str(tmp_path / name),
                           general_config=copy.deepcopy(DEFAULT_GENERAL_CONFIG)))
        proc.reservoir_config["realizations"]["permx"]["method"] = method
        splits[name] = proc.generate_kle_splits()
    for split, want in splits["jax"].items():
        assert want.shape[1:] == (N, N, N)
        np.testing.assert_array_equal(splits["port"][split], want)
        np.testing.assert_array_equal(splits["kle"][split], want)
