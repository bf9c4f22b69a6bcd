"""The port's own copy of the configuration defaults against the JAX
package's: the same names and values, and the same config hash, so that the
two packages name and share the same dataset caches."""

import copy

import numpy as np
import pytest

import srm_tpu.config as jcfg
import srm_tpu_torch.config as tcfg

# every public name the JAX package's config exports
NAMES = sorted(n for n in dir(jcfg) if not n.startswith("_") and n.isupper())
FUNCTIONS = ["apply_production_overrides", "apply_drawdown_overrides",
             "production_optimizer_configs", "drawdown_optimizer_configs"]


def test_the_copy_exports_the_same_names():
    exported = {n for n in dir(jcfg) if not n.startswith("_")} - {"defaults"}
    assert exported <= set(dir(tcfg))


@pytest.mark.parametrize("name", NAMES)
def test_constants_are_equal(name):
    # WORKING_DIRECTORY included: both default to the repository's
    # _srm_data/, or to the same environment variable
    assert getattr(tcfg, name) == getattr(jcfg, name), name


@pytest.mark.parametrize("fn", FUNCTIONS)
def test_config_helpers_agree(fn):
    if fn.startswith("apply_"):
        args = (copy.deepcopy(jcfg.DEFAULT_GENERAL_CONFIG),)
    else:
        args = ()
    assert getattr(tcfg, fn)(*args) == getattr(jcfg, fn)(*args)


@pytest.mark.parametrize("config_type,kw", [
    ("encoder_decoder", {}), ("encoder_decoder", {"input_shape": (1, 1, 10, 39, 39, 5)}),
    ("residual", {}), ("hard_layer", {}), ("input_slice", {}),
    ("pvt_layer", {"fluid_type": "DG"}), ("pvt_layer", {"fluid_type": "GC"})])
def test_get_configuration_agrees(config_type, kw):
    assert tcfg.get_configuration(config_type, **kw) == jcfg.get_configuration(config_type, **kw)


def test_spline_source_is_the_same_table():
    """With fitting_method='spline' each package attaches its PVT table:
    the JAX package a DataSummary, the port a column dict of its own copy
    of the CSV. The knots and values are the same."""
    want = jcfg.get_configuration("pvt_layer", fluid_type="GC", fitting_method="spline")
    got = tcfg.get_configuration("pvt_layer", fluid_type="GC", fitting_method="spline")
    assert {k: v for k, v in got.items() if k != "spline_config"} == \
        {k: v for k, v in want.items() if k != "spline_config"}
    for col in ("pre", "invbg", "invbo", "invug", "invuo", "rs", "rv", "vro"):
        np.testing.assert_array_equal(got["spline_config"][col],
                                      np.asarray(want["spline_config"].lookup(col), np.float32))


def _case(fluid, nx=None, nz=None, n=None, pi=None, min_bhp=None):
    """(general, reservoir, wells) configs resized as setup_case resizes
    them (srm_tpu/examples/common.py:40-74)."""
    g = copy.deepcopy(jcfg.DEFAULT_GENERAL_CONFIG)
    g["fluid_type"] = fluid
    res = copy.deepcopy(jcfg.DEFAULT_RESERVOIR_CONFIG)
    wells = copy.deepcopy(jcfg.DEFAULT_WELLS_CONFIG)
    if nx or nz:
        nx, nz = nx or res["Nx"], nz or res["Nz"]
        res["Nx"] = res["Ny"] = nx
        res["Nz"] = nz
        g["unit_target_shape"] = (1, nz, nx, nx, 1) if nz > 1 else (1, 1, nx, nx, 1)
        res["realizations"]["permx"]["conditional_values"] = {(5, 5, 0): 2.0}
    if n:
        res["realizations"]["permx"]["number"] = n
    if nz and nz > 1:
        res["realizations"]["permx"]["method"] = "uncorrelated"
    if pi is not None:
        res["initialization"]["Pi"] = pi
    if min_bhp is not None:
        for conn in wells["connections"]:
            conn["minimum_bhp"] = min_bhp
    return g, res, wells


@pytest.mark.parametrize("case", [
    dict(fluid="DG"), dict(fluid="DG", nx=9, n=6), dict(fluid="DG", nx=39, nz=10, n=20),
    dict(fluid="GC"), dict(fluid="GC", nx=9, n=6), dict(fluid="GC", n=20),
    dict(fluid="GC", pi=4200.0, min_bhp=2500.0)])
def test_config_hash_agrees(case):
    """The dataset cache is shared only while the two hashes agree: DG 2D,
    DG 3D and GC, at the default, test and chip sizes."""
    g, res, wells = _case(**case)
    want = jcfg.generate_full_config_hash(g, res, wells)
    got = tcfg.generate_full_config_hash(copy.deepcopy(g), copy.deepcopy(res),
                                         copy.deepcopy(wells))
    assert got == want


def test_config_hash_tells_the_fluids_apart():
    g, res, wells = _case("DG")
    g_gc = dict(g, fluid_type="GC")
    assert tcfg.generate_full_config_hash(g, res, wells) != \
        tcfg.generate_full_config_hash(g_gc, res, wells)
