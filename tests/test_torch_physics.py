"""The port's normalization, relperm, spline PVT and well model against the
JAX package's, on the same numpy inputs."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srm_tpu.config import DEFAULT_GENERAL_CONFIG, DEFAULT_RESERVOIR_CONFIG, DEFAULT_WELLS_CONFIG
from srm_tpu.config import get_configuration
from srm_tpu.physics.pvt import make_pvt_layer
from srm_tpu.physics.relperm import RelativePermeability as JaxRelperm
from srm_tpu.physics.well_solver import WellRatesPressure as JaxWells
from srm_tpu.utils import stats as jstats
from srm_tpu_torch.data.pvt_table import load_pvt_table
from srm_tpu_torch.physics.pvt import make_spline_pvt
from srm_tpu_torch.physics.relperm import RelativePermeability
from srm_tpu_torch.physics.well_solver import WellRatesPressure
from srm_tpu_torch.utils import stats as tstats


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


ROW_LIN = np.array([0.0, 365.0, 180.0, 100.0, 10.0], np.float32)     # time-like
ROW_LOG = np.array([0.4, 12.0, 3.0, 1.5, 10.0], np.float32)          # permeability-like


@pytest.mark.parametrize("fn", ["normalize", "denormalize", "normalize_diff"])
@pytest.mark.parametrize("method,row,is_log", [
    ("lnk-linear-scaling", ROW_LIN, False),
    ("lnk-linear-scaling", ROW_LOG, True),
    ("linear-scaling", ROW_LIN, False),
    ("z-score", ROW_LOG, False),
])
def test_normalization_matches_reference(fn, method, row, is_log):
    rng = np.random.RandomState(1)
    x = (rng.uniform(0.5, 11.0, (4, 7)) if fn != "denormalize"
         else rng.uniform(-1, 1, (4, 7))).astype(np.float32)
    kw = dict(method=method, limits=(-1.0, 1.0), is_log=is_log)
    want = getattr(jstats, fn)(jnp.asarray(x), jnp.asarray(row), **kw)
    got = getattr(tstats, fn)(torch.from_numpy(x), torch.from_numpy(row), **kw)
    # float32 log/exp of two libraries: an ulp or two
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_normalization_round_trip_and_scrub():
    row = torch.from_numpy(ROW_LOG)
    x = torch.linspace(0.5, 11.0, 17)
    back = tstats.denormalize(tstats.normalize(x, row, is_log=True), row, is_log=True)
    torch.testing.assert_close(back, x, rtol=1e-5, atol=1e-5)
    bad = tstats.normalize(torch.tensor([-1.0, 0.0]), row, is_log=True)
    assert torch.equal(bad, torch.zeros(2))          # non-finite → 0, as the reference


def test_relperm_matches_reference():
    sg = np.linspace(0.0, 1.0, 101).astype(np.float32)
    want = JaxRelperm()(jnp.asarray(sg))
    got = RelativePermeability()(torch.from_numpy(sg))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7)


def _pvt_pair(order):
    cfg = get_configuration("pvt_layer", fluid_type="DG", fitting_method="spline")
    cfg["spline_order"] = order
    layer = make_pvt_layer(cfg)
    return (lambda p: layer.apply({}, p)), make_spline_pvt(cfg, load_pvt_table())


PRESSURES = np.concatenate([
    np.random.RandomState(2).uniform(500.0, 9000.0, 40),
    [10.0, 14.7, 14.70001, 100.0, 5000.0, 9999.99, 10000.0, 12000.0],   # band edges
]).astype(np.float32).reshape(2, 4, 6)


@pytest.mark.parametrize("order,atol_rel", [(1, 1e-5), (2, 2e-3)])
def test_spline_pvt_values_and_derivative(order, atol_rel):
    """Values and d/dP per property, with the clamp tangent 0 / 0.5 / 1 at
    and outside the band edges exactly as jax.jvp gives it.

    Tolerance: the float64 solve is shared and the float32 contraction over
    the 37 knots rounds in another order. Order 1 (the model map's) is well
    conditioned: ~1e-6 of each property's scale. Order 2 cancels terms
    ~1e9: both packages sit ~1e-3 of the invug scale away from a float64
    evaluation of the same weights, so they are held to 2e-3 of it."""
    jax_fn, pvt = _pvt_pair(order)
    want = np.asarray(jax_fn(jnp.asarray(PRESSURES)))
    got = pvt(torch.from_numpy(PRESSURES)).numpy()
    assert got.shape == want.shape == (2, 2) + PRESSURES.shape
    for k in range(2):
        for prop in range(2):
            w, g = want[k, prop], got[k, prop]
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=atol_rel * np.abs(w).max(),
                                       err_msg=f"order {order} output {k} property {prop}")
    edge = PRESSURES.reshape(-1)
    d = got[1, 0].reshape(-1)
    assert np.all(d[(edge < 14.7) | (edge > 10000.0)] == 0.0)
    np.testing.assert_allclose(d[edge == 14.7] * 2, got[1, 0].reshape(-1)[edge == 14.70001],
                               rtol=1e-3)


@pytest.mark.parametrize("order,atol_rel", [(1, 1e-4), (2, 2e-3)])
def test_spline_pvt_derivative_is_differentiable(order, atol_rel):
    """d/dP enters the loss: the gradient of a function of it (and of the
    values) with respect to the pressure matches reverse-mode through
    the reference's jvp (order 2 held looser for the conditioning above)."""
    jax_fn, pvt = _pvt_pair(order)
    p = np.random.RandomState(3).uniform(1000.0, 8000.0, (3, 5)).astype(np.float32)
    wts = np.random.RandomState(4).uniform(0.5, 1.5, (2, 2, 3, 5)).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(jax_fn(v) * wts))(jnp.asarray(p))
    pt = torch.from_numpy(p).requires_grad_(True)
    (pvt(pt) * torch.from_numpy(wts)).sum().backward()
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(want), rtol=1e-3,
                               atol=atol_rel * np.abs(np.asarray(want)).max())


class _Summary:
    """A statistics table both packages' well models read."""

    def __init__(self):
        stats = {"z": dict(min=40.0, max=40.0, mean=40.0, std=0.0),
                 "y": dict(min=100.0, max=2800.0, mean=1450.0, std=800.0),
                 "x": dict(min=100.0, max=2800.0, mean=1450.0, std=800.0),
                 "time": dict(min=0.0, max=250.0, mean=125.0, std=73.0),
                 "permx": dict(min=0.4, max=14.0, mean=3.0, std=1.5)}
        self.jax = jstats.DataSummary([stats])
        self.torch = tstats.DataSummary([stats])


def _well_case(nx=9):
    g = copy.deepcopy(DEFAULT_GENERAL_CONFIG)
    g["unit_target_shape"] = (1, 1, nx, nx, 1)
    res = copy.deepcopy(DEFAULT_RESERVOIR_CONFIG)
    res["Nx"] = res["Ny"] = nx
    wells = copy.deepcopy(DEFAULT_WELLS_CONFIG)
    for conn in wells["connections"]:
        conn["i"] = min(int(conn["i"] * nx / 39), nx - 1)
        conn["j"] = min(int(conn["j"] * nx / 39), nx - 1)
    rng = np.random.RandomState(5)
    B = 3
    x = rng.uniform(-1, 1, (B, 1, nx, nx, 5)).astype(np.float32)
    x[0, ..., 3] = -1.0                                    # one sample at t0
    p = rng.uniform(3500.0, 5200.0, (B, 1, nx, nx, 1)).astype(np.float32)
    # a well cell whose pressure sits exactly at the BHP floor
    c = wells["connections"][0]
    p[1, 0, c["j"], c["i"], 0] = c["minimum_bhp"]
    return g, res, wells, x, p


def test_well_rates_and_bhp_match_reference():
    g, res, wells, x, p = _well_case()
    ds = _Summary()
    jax_fn, pvt = _pvt_pair(1)
    jw = JaxWells(fluid_type="DG", data_summary=ds.jax, pvt_fn=jax_fn, general_config=g,
                  reservoir_config=res, wells_config=wells)
    tw = WellRatesPressure(ds.torch, torch.device("cpu"), general_config=g,
                           reservoir_config=res, wells_config=wells)

    def jloss(pp):
        q, pwf = jw.compute_rates_and_bhp(jnp.asarray(x), pp, None, model_PVT=jax_fn)
        return jnp.sum(q * 1.7) + jnp.sum(pwf * 0.3), (q, pwf)

    (_, (qj, pwfj)), gj = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(p))
    pt = torch.from_numpy(p).requires_grad_(True)
    qt, pwft = tw.compute_rates_and_bhp(torch.from_numpy(x), pt, pvt)
    (qt.sum() * 1.7 + pwft.sum() * 0.3).backward()
    assert qt.shape == pwft.shape == p.shape
    assert int((qt > 0).sum()) > 0
    # rates: float32 Peaceman index and PVT products in another rounding order
    np.testing.assert_allclose(qt.detach().numpy(), np.asarray(qj), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(pwft.detach().numpy(), np.asarray(pwfj), rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(gj), rtol=1e-3, atol=1e-5)
