"""The port's 3D networks (Model 1 over Conv3d/ConvTranspose3d, Model 2 as
``cnn3d``) with flax weights carried across by load_flax_params, against the
JAX package's modules on the same inputs; and the encoder's depth collapse
below Nz = 9 (ROADMAP C3)."""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srm_tpu.config import DEFAULT_GENERAL_CONFIG, DEFAULT_RESERVOIR_CONFIG
from srm_tpu.nn import modules as jmod
from srm_tpu_torch.nn import modules as tmod
from srm_tpu_torch.nn.convert import load_flax_params

# float32 convolutions in two libraries (XLA vs oneDNN) sum in another
# order; through ~12 layers that leaves ~1e-6 relative, as in 2D
RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def _res(nx, nz):
    res = copy.deepcopy(DEFAULT_RESERVOIR_CONFIG)
    res["Nx"] = res["Ny"] = nx
    res["Nz"] = nz
    return res


@functools.lru_cache(maxsize=None)
def _models(nx, nz, seed=0):
    """(flax models, their params, torch models with those weights); the
    tests only read them."""
    res, g = _res(nx, nz), DEFAULT_GENERAL_CONFIG
    sample = jnp.zeros((1, 1, nz, nx, nx, 5), jnp.float32)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    jp = jmod.build_pressure_model(general_config=g, reservoir_config=res)
    jt = jmod.build_time_step_model(general_config=g, reservoir_config=res)
    params = {"pressure": jp.init(k1, sample), "time_step": jt.init(k2, sample)}
    shape = (1, nz, nx, nx, 5)
    torch_models = {"pressure": tmod.build_pressure_model(shape, g, res),
                    "time_step": tmod.build_time_step_model(shape, g)}
    load_flax_params(torch_models, jax.tree_util.tree_map(np.asarray, params))
    return {"pressure": jp, "time_step": jt}, params, torch_models


def _inputs(B, nx, nz, seed=1):
    x = np.random.RandomState(seed).uniform(-1, 1, (B, 1, nz, nx, nx, 5)).astype(np.float32)
    x[0, ..., 3] = -1.0                                   # first sample at t0
    return x


@pytest.mark.parametrize("nx,nz,B", [(9, 9, 2), (39, 10, 1)],
                         ids=["resize_crop_9x9x9", "exact_hw_crop_39x39x10"])
@pytest.mark.parametrize("name", ["pressure", "time_step"])
def test_model_matches_flax(nx, nz, B, name):
    """9×9×9 takes the plane-wise H/W resize (15 → 9) and the depth crop
    (15 → 9, from layer 3); 39×39×10 lands on H/W exactly and crops the
    depth 15 → 10 from layer 2."""
    jm, params, tm = _models(nx, nz)
    x = _inputs(B, nx, nz)
    want = np.asarray(jm[name].apply(params[name], jnp.asarray(x)))
    with torch.no_grad():
        got = tm[name](torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (B, 1, nz, nx, nx, 1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    if name == "pressure":
        # the backbone alone, not hidden behind the HardLayer's Pi offset
        net = np.asarray(jm[name].network.apply(
            {"params": params[name]["params"]["network"]}, jnp.asarray(x)))
        with torch.no_grad():
            tnet = tm[name].network(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(tnet, net, rtol=RTOL, atol=RTOL * np.abs(net).max())


def test_hard_layer_exponent_is_per_cell():
    _, params, tm = _models(9, 9)
    kexp = tm["pressure"].hard_layer.kernel_exponent
    assert tuple(kexp.shape) == (1, 9, 9, 9, 1)
    assert kexp.shape == params["pressure"]["params"]["hard_layer"]["kernel_exponent"].shape


@pytest.mark.parametrize("nz", [3, 8])
def test_port_refuses_a_collapsing_depth(nz):
    """ROADMAP C3: below Nz = 9 the depth-4 encoder's strided convolutions
    reach depth 0 (at Nz=3: 3 → 1 → 0). The port raises a ValueError naming
    the smallest valid size instead of running zero-size convolutions."""
    model = tmod.build_pressure_model((1, nz, 9, 9, 5), DEFAULT_GENERAL_CONFIG, _res(9, nz))
    with pytest.raises(ValueError, match="at least 9"):
        model(torch.zeros(1, 1, nz, 9, 9, 5))


def test_reference_output_ignores_its_input_below_nz9():
    """ROADMAP C3, the fault itself: at Nz = 3 flax runs the zero-size
    convolutions, and the reference's pressure network gives the same output
    whatever the permeability channel holds."""
    res, g = _res(9, 3), DEFAULT_GENERAL_CONFIG
    jp = jmod.build_pressure_model(general_config=g, reservoir_config=res)
    x = jnp.asarray(_inputs(1, 9, 3))
    params = jp.init(jax.random.PRNGKey(0), x)
    net = lambda v: jp.network.apply({"params": params["params"]["network"]}, v)  # noqa: E731
    assert float(jnp.max(jnp.abs(net(x.at[..., 4].add(0.05)) - net(x)))) == 0.0
