"""The port's networks with flax weights carried across by load_flax_params,
against the JAX package's modules on the same inputs."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srm_tpu.config import DEFAULT_GENERAL_CONFIG, DEFAULT_RESERVOIR_CONFIG
from srm_tpu.nn import modules as jmod
from srm_tpu_torch.nn import modules as tmod
from srm_tpu_torch.nn.common import safe_pow, scaled_tanh_lisht
from srm_tpu_torch.nn.convert import load_flax_params

# float32 convolutions in two libraries (XLA vs oneDNN) sum in another
# order; through ~12 layers that leaves ~1e-6 relative
RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def _models(nx, seed=0):
    """(flax models, their params as numpy, torch models with those weights)."""
    res = copy.deepcopy(DEFAULT_RESERVOIR_CONFIG)
    res["Nx"] = res["Ny"] = nx
    g = DEFAULT_GENERAL_CONFIG
    sample = jnp.zeros((1, 1, nx, nx, 5), jnp.float32)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    jp = jmod.build_pressure_model(general_config=g, reservoir_config=res)
    jt = jmod.build_time_step_model(general_config=g, reservoir_config=res)
    params = {"pressure": jp.init(k1, sample), "time_step": jt.init(k2, sample)}
    params_np = jax.tree_util.tree_map(np.asarray, params)
    torch_models = {"pressure": tmod.build_pressure_model((1, nx, nx, 5), g, res),
                    "time_step": tmod.build_time_step_model((1, nx, nx, 5), g)}
    load_flax_params(torch_models, params_np)
    return {"pressure": jp, "time_step": jt}, params, torch_models


def _inputs(B, nx, seed=1):
    x = np.random.RandomState(seed).uniform(-1, 1, (B, 1, nx, nx, 5)).astype(np.float32)
    x[0, ..., 3] = -1.0                                   # first sample at t0
    return x


@pytest.mark.parametrize("nx,B", [(9, 2), (39, 1)], ids=["resize_9x9", "exact_39x39"])
@pytest.mark.parametrize("name", ["pressure", "time_step"])
def test_model_matches_flax(nx, B, name):
    jm, params, tm = _models(nx)
    x = _inputs(B, nx)
    want = np.asarray(jm[name].apply(params[name], jnp.asarray(x)))
    with torch.no_grad():
        got = tm[name](torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (B, 1, nx, nx, 1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    if name == "pressure":
        # the backbone alone, where the function of the weights is not
        # hidden behind the HardLayer's Pi offset
        net = jm[name].network.apply({"params": params[name]["params"]["network"]},
                                     jnp.asarray(x))
        with torch.no_grad():
            tnet = tm[name].network(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(tnet, np.asarray(net), rtol=RTOL,
                                   atol=RTOL * np.abs(np.asarray(net)).max())


def test_hard_layer_exact_at_t0_with_finite_gradients():
    _, _, tm = _models(9)
    with torch.no_grad():                 # a network output far from zero
        tm["pressure"].network.output_proj.bias.fill_(100.0)
    x = torch.from_numpy(_inputs(2, 9))
    p = tm["pressure"](x)
    pi = DEFAULT_RESERVOIR_CONFIG["initialization"]["Pi"]
    assert torch.all(p[0] == pi)
    assert torch.all(p[1] < pi)
    p.sum().backward()
    for q in tm["pressure"].parameters():
        assert torch.isfinite(q.grad).all()


def test_safe_pow_gradient_is_zero_at_zero_base():
    x = torch.tensor([0.0, 0.25, 1.0], requires_grad=True)
    e = torch.full((3,), 0.5, requires_grad=True)
    y = safe_pow(x, e)
    y.sum().backward()
    torch.testing.assert_close(y.detach(), torch.tensor([0.0, 0.5, 1.0]))
    assert torch.isfinite(x.grad).all() and x.grad[0] == 0.0
    assert torch.isfinite(e.grad).all() and e.grad[0] == 0.0


def test_scaled_tanh_lisht_range():
    y = scaled_tanh_lisht(torch.linspace(-50, 50, 101), min_val=0.1, max_val=10.0)
    assert float(y.min()) >= 0.1 and float(y.max()) <= 10.0
    assert float(y[50]) == pytest.approx(0.1)


def test_converter_rejects_mismatched_grid():
    _, params, _ = _models(9)
    other = {"pressure": tmod.build_pressure_model((1, 13, 13, 5)),
             "time_step": tmod.build_time_step_model((1, 13, 13, 5))}
    with pytest.raises(ValueError, match="another grid"):
        load_flax_params(other, jax.tree_util.tree_map(np.asarray, params))
