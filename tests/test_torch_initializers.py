"""C18: the networks' initializer knob. The encoder–decoder reads
``residual_params["Kernel_Init"]`` and the residual net
``kernel_initializer`` (when it is a string), as the JAX package does, and
each of the five cases of ``get_initializer`` (the four names, ``None``
and an unknown name) draws from flax's distribution at flax's fans: the
port's weights against flax's initializer at the same shape, for a
convolution, a transposed convolution and a dense layer.

The check is statistical. Each sample holds N ≥ 36,864 weights: their
mean lies within 5 standard errors of 0; their standard deviation within
3% of the flax sample's (the relative standard error of one sample's
standard deviation at N = 36,864 is 0.30% for the truncated normal and
0.23% for the uniform, measured over 300 numpy draws, so 3% is over 7
standard errors of the ratio of two); their kurtosis within 0.1 of the flax
sample's (uniform 1.80, normal truncated at 2σ 2.37, standard errors 0.006
and 0.010 from the same draws); and their largest magnitude within the
distribution's bound (2σ of the
untruncated normal, or the uniform's limit), above 97% of it."""

import jax
import numpy as np
import pytest
import torch

from srm_tpu.nn.common import get_initializer
from srm_tpu_torch.config import get_configuration
from srm_tpu_torch.nn.common import init_conv_, initializer_name
from srm_tpu_torch.nn.encoder_decoder import EncoderDecoder
from srm_tpu_torch.nn.residual import ResidualNetwork

CASES = ["glorot_normal", "glorot_uniform", "he_normal", "he_uniform", None, "orthogonal"]
# flax's (scale, fan, distribution) of each case's initializer
FLAX = {"glorot_normal": (1.0, "avg", "normal"), "glorot_uniform": (1.0, "avg", "uniform"),
        "he_normal": (2.0, "in", "normal"), "he_uniform": (2.0, "in", "uniform")}
SELECTED = {"glorot_normal": "glorot_normal", "glorot_uniform": "glorot_uniform",
            "he_normal": "he_normal", "he_uniform": "he_uniform", None: "glorot_uniform",
            "orthogonal": "glorot_normal"}


def _bound(name, fan_in, fan_out):
    scale, mode, dist = FLAX[name]
    fan = fan_in if mode == "in" else (fan_in + fan_out) / 2.0
    std = np.sqrt(scale / fan)
    return 2.0 * std / 0.87962566103423978 if dist == "normal" else np.sqrt(3.0) * std


def _kurtosis(w):
    w = w - w.mean()
    return float((w ** 4).mean() / (w ** 2).mean() ** 2)


def _same_distribution(port, flax_sample, bound):
    port = np.asarray(port, np.float64).ravel()
    ref = np.asarray(flax_sample, np.float64).ravel()
    n = port.size
    assert n >= 36864
    assert abs(port.mean()) <= 5 * port.std() / np.sqrt(n)
    assert abs(port.std() / ref.std() - 1.0) <= 0.03
    assert abs(_kurtosis(port) - _kurtosis(ref)) <= 0.1
    assert np.abs(port).max() <= bound * (1 + 1e-6)
    assert np.abs(port).max() >= 0.97 * bound
    assert np.abs(ref).max() <= bound * (1 + 1e-6)


def test_the_selection_is_get_initializers():
    """The name each case selects: flax's table, ``None`` glorot uniform and
    any other name glorot normal."""
    for name in CASES:
        assert initializer_name(name) == SELECTED[name]
    ref = get_initializer(None)(jax.random.PRNGKey(0), (200, 300))
    assert np.abs(np.asarray(ref)).max() <= _bound("glorot_uniform", 200, 300) * 1.000001


# (torch layer, flax kernel shape, fan_in, fan_out)
LAYERS = {
    "conv": (lambda: torch.nn.Conv2d(64, 64, 3), (3, 3, 64, 64), 9 * 64, 9 * 64),
    "conv_uneven": (lambda: torch.nn.Conv2d(32, 128, 3), (3, 3, 32, 128), 9 * 32, 9 * 128),
    "deconv": (lambda: torch.nn.ConvTranspose2d(128, 32, 3), (3, 3, 128, 32), 9 * 128, 9 * 32),
    "conv3d": (lambda: torch.nn.Conv3d(16, 96, 3), (3, 3, 3, 16, 96), 27 * 16, 27 * 96),
    "dense": (lambda: torch.nn.Linear(192, 256), (192, 256), 192, 256),
}


@pytest.mark.parametrize("layer", list(LAYERS))
@pytest.mark.parametrize("name", CASES, ids=[str(c) for c in CASES])
def test_layer_weights_follow_flax(name, layer):
    make, shape, fan_in, fan_out = LAYERS[layer]
    module = make()
    init_conv_(module, torch.Generator().manual_seed(1), initializer_name(name))
    ref = get_initializer(name)(jax.random.PRNGKey(1), shape)
    _same_distribution(module.weight.detach().numpy(), ref,
                       _bound(SELECTED[name], fan_in, fan_out))
    assert not module.bias.detach().any()


@pytest.mark.parametrize("name", CASES, ids=[str(c) for c in CASES])
def test_networks_read_their_knob(name):
    """The knob reaches the networks' layers through ``from_config``: the
    encoder–decoder's extra convolution (108 → 108, 3×3), its first
    deconvolution (384 → 72) and its latent Dense (108 → 384), and the
    residual net's block convolution (64 → 64, 3×3) and ``dense`` block
    layer (256 → 256), each against flax's initializer at the same shape.
    The residual net reads only a string, so ``None`` is glorot normal
    there (``srm_tpu/nn/residual.py:115-117``)."""
    gen = torch.Generator().manual_seed(2)
    cfg = get_configuration("encoder_decoder")
    cfg["residual_params"]["Kernel_Init"] = name
    cfg["residual_params"]["Latent_Layer"]["Width"] = 384
    cfg["residual_params"]["Skip_Connections"]["Add"] = False
    ed = EncoderDecoder.from_config(cfg, in_channels=5, generator=gen)
    res = get_configuration("residual")
    res["kernel_initializer"] = name
    net = ResidualNetwork.from_config(dict(res, filters=64), in_channels=5, generator=gen)
    dense = ResidualNetwork.from_config(dict(res, network_type="dense", filters=256),
                                        in_channels=5, generator=gen)
    res_name = SELECTED[name] if name is not None else "glorot_normal"
    checks = [(ed.enc_extra[0].weight, (3, 3, 108, 108), SELECTED[name]),
              (ed.dec_deconvs[0].weight, (3, 3, 384, 72), SELECTED[name]),
              (ed.latent[0].weight, (108, 384), SELECTED[name]),
              (net.blocks[1].layer1.weight, (3, 3, 64, 64), res_name),
              (dense.blocks[1].layer1.weight, (256, 256), res_name)]
    for w, shape, want in checks:
        fan_in = int(np.prod(shape[:-1]))
        fan_out = int(np.prod(shape[:-2])) * shape[-1]
        ref = get_initializer(want)(jax.random.PRNGKey(3), shape)
        _same_distribution(w.detach().numpy(), ref, _bound(want, fan_in, fan_out))


def test_hard_layer_rbf_kernel_is_glorot_normal_always():
    from srm_tpu_torch.nn.hard_layer import HardLayer
    hl = HardLayer((1, 4, 4, 1), use_rbf=True, prop_channels=3,
                   generator=torch.Generator().manual_seed(0))
    bound = _bound("glorot_normal", 3, 1)
    assert hl.rbf_kernel.shape == (3, 1) and float(hl.rbf_kernel.detach().abs().max()) <= bound
