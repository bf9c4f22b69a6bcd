"""The port's gas-condensate saturation model (Model 1S) with flax weights
carried across by load_flax_params, against the JAX package's on the same
inputs; and the GC model map."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srm_tpu.config import DEFAULT_GENERAL_CONFIG, DEFAULT_RESERVOIR_CONFIG, DEFAULT_SCAL_CONFIG
from srm_tpu.nn import modules as jmod
from srm_tpu_torch.nn import modules as tmod
from srm_tpu_torch.nn.convert import load_flax_params
from srm_tpu_torch.physics.pvt import GC_PROPERTIES
from srm_tpu_torch.utils.stats import DataSummary

# float32 convolutions in two libraries (XLA vs oneDNN) sum in another
# order; through ~12 layers that leaves ~1e-6 relative (as test_torch_nn)
RTOL = 1e-4
SGI = 1.0 - DEFAULT_SCAL_CONFIG["end_points"]["Swmin"]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def _saturation_models(nx, activation=None, seed=0):
    """(flax saturation model, its params, the torch model with them)."""
    res = copy.deepcopy(DEFAULT_RESERVOIR_CONFIG)
    res["Nx"] = res["Ny"] = nx
    g = copy.deepcopy(DEFAULT_GENERAL_CONFIG)
    g["fluid_type"] = "GC"
    if activation:
        g["sat_input_activation"] = activation
    jm = jmod.build_saturation_model(general_config=g, reservoir_config=res)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 1, nx, nx, 5), jnp.float32))
    tm = tmod.build_saturation_model((1, nx, nx, 5), g, res)
    load_flax_params({"saturation_model": tm},
                     {"saturation_model": jax.tree_util.tree_map(np.asarray, params)})
    return jm, params, tm


def _inputs(B, nx, seed=1):
    x = np.random.RandomState(seed).uniform(-1, 1, (B, 1, nx, nx, 5)).astype(np.float32)
    x[0, ..., 3] = -1.0                                   # first sample at t0
    return x


@pytest.mark.parametrize("nx,B", [(9, 2), (39, 1)], ids=["resize_9x9", "exact_39x39"])
@pytest.mark.parametrize("activation", [None, "abs"], ids=["softplus", "abs"])
def test_saturation_model_matches_flax(nx, B, activation):
    jm, params, tm = _saturation_models(nx, activation)
    x = _inputs(B, nx)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (B, 1, nx, nx, 1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want - SGI).max())
    assert np.all(got[0] == np.float32(SGI))              # pinned to Sgi at t0


def test_saturation_model_gradient_matches_flax():
    """The gradient of a weighted sum of Sg with respect to the input:
    softplus (the default departure activation) is the only piece the
    pressure model does not share."""
    jm, params, tm = _saturation_models(9)
    x = _inputs(2, 9)
    w = np.random.RandomState(3).uniform(0.5, 1.5, (2, 1, 9, 9, 1)).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(jm.apply(params, v) * w))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (tm(xt) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-4 * np.abs(np.asarray(want)).max())


def test_gc_model_map():
    """The GC map adds the saturation model and a seven-property PVT."""
    stats = {k: dict(min=0.0, max=1.0, mean=0.5, std=0.1)
             for k in ("z", "y", "x", "time", "permx")}
    models = tmod.build_model_map((2, 3, 1, 39, 39, 5), torch.device("cpu"), fluid_type="GC",
                                  data_summary=DataSummary([stats]))
    assert set(models) == {"pressure", "time_step", "pvt_model", "well_rate_bhp_model",
                           "saturation_model"}
    assert models["saturation_model"].hard_layer.init_value == pytest.approx(SGI)
    assert models["pvt_model"].w.shape[0] == len(GC_PROPERTIES)
    assert models["well_rate_bhp_model"].fluid_type == "GC"
