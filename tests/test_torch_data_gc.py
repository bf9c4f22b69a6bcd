"""The port's gas-condensate physics-mode dataset against the JAX
package's, on the gc9 case (9×9, 6 realizations): the same cache files,
the same arrays (with zero SGAS labels beside the PRESSURE ones) and the
same statistics."""

import copy
import os

import numpy as np
import pytest
import torch

from srm_tpu.config import DEFAULT_GENERAL_CONFIG
from srm_tpu.data.dataset import SRMDataProcessor as JaxProcessor
from srm_tpu_torch.data.dataset import SRMDataProcessor
from test_torch_data import _pairs, _resize


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    g = copy.deepcopy(DEFAULT_GENERAL_CONFIG)
    g["fluid_type"] = "GC"
    jp = _resize(JaxProcessor(base_dir=str(tmp_path_factory.mktemp("jax_gc")), general_config=g))
    tp = _resize(SRMDataProcessor(base_dir=str(tmp_path_factory.mktemp("torch_gc")),
                                  general_config=g))
    return jp, jp.get_or_generate_training_data(), tp, tp.get_or_generate_training_data()


def test_same_cache_files(both):
    jp, jout, tp, tout = both
    assert tp.config_hash() == jp.config_hash()
    assert os.path.relpath(tout[0], tp.base_dir) == os.path.relpath(jout[0], jp.base_dir)
    dg = copy.deepcopy(jp.general_config)
    dg["fluid_type"] = "DG"
    assert _resize(SRMDataProcessor(base_dir=tp.base_dir, general_config=dg)).config_hash() \
        != tp.config_hash()                         # the fluid is part of the cache's name


@pytest.mark.parametrize("split", [1, 2, 3, 4], ids=["train", "val", "test", "pred"])
def test_same_arrays(both, split):
    _, jout, _, tout = both
    for _, labels in tout[split]:
        assert set(labels) == {"PRESSURE", "SGAS"}
        assert all(not v.any() for v in labels.values())    # physics mode: zero labels
    for a, b in _pairs(jout[split], tout[split]):
        assert a.shape == b.shape and a.dtype == b.dtype
        # identical woven features; float32 log/divide of two libraries in
        # the normalization may differ by an ulp (as test_torch_data)
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)


def test_same_statistics(both):
    jp, _, tp, _ = both
    assert jp.load_training_statistics() == tp.load_training_statistics()


def test_drawdown_case_names_the_reference_cache(tmp_path):
    """setup_case's pi and min_bhp (the reference's drawdown scenario
    arguments) reach the config hash as the JAX package's setup_case puts
    them there: both packages name the same dataset cache."""
    from srm_tpu.examples.common import setup_case as jax_setup_case
    from srm_tpu_torch.examples.common import setup_case
    kw = dict(nx=9, n_realizations=6, pi=4200.0, min_bhp=2500.0)
    jcase = jax_setup_case("GC", base_dir=str(tmp_path / "jax"), **kw)
    tcase = setup_case("GC", base_dir=str(tmp_path / "torch"), device="cpu", **kw)
    assert tcase["processor"].config_hash() == jcase["processor"].config_hash()
    assert tcase["processor"].reservoir_config["initialization"]["Pi"] == 4200.0
    assert os.path.relpath(tcase["data_path"], str(tmp_path / "torch")) == \
        os.path.relpath(jcase["data_path"], str(tmp_path / "jax"))
