"""The network options that the model map turns off, built as
``tests/test_nn.py`` and ``tests/test_nn_variants.py`` build them, with flax
weights carried across by ``load_flax_module``, against the JAX package's
modules on the same numpy inputs: the encoder–decoder's skips, dropout and
``latent_flatten`` (2D and 3D), the residual net's ``dense`` blocks,
distribution head, BatchNorm, dropout, VAE head and
``include_output_layer=False``, the HardLayer's RBF and rectifier, the
composition's ``hard_enforcement_only``, slices and rectifier input, and
``PVTModuleWithHardLayer``. Dropout and BatchNorm are evaluated
(``training=False``); in a training forward the JAX package fails without a
dropout rng or a mutable ``batch_stats``, and the port's loss refuses them
(ROADMAP C19)."""

import copy

import flax.errors
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srm_tpu.config import get_configuration as jax_configuration
from srm_tpu.nn.encoder_decoder import EncoderDecoderModel
from srm_tpu.nn.hard_layer import HardLayer as JaxHardLayer
from srm_tpu.nn.modules import CompleteTrainableModule as JaxComplete
from srm_tpu.nn.modules import PVTModuleWithHardLayer as JaxPVTModule
from srm_tpu.nn.residual import ResidualNetworkLayer
from srm_tpu.physics.pvt import make_pvt_layer as jax_make_pvt_layer
from srm_tpu_torch.config import get_configuration
from srm_tpu_torch.nn.convert import load_flax_module
from srm_tpu_torch.nn.encoder_decoder import EncoderDecoder
from srm_tpu_torch.nn.hard_layer import HardLayer
from srm_tpu_torch.nn.modules import CompleteTrainableModule, PVTModuleWithHardLayer
from srm_tpu_torch.nn.residual import BatchNorm, ResidualNetwork
from srm_tpu_torch.physics.pvt import make_pvt_layer

# float32 layers in two libraries (XLA vs oneDNN) sum in another order;
# through ~12 layers that leaves ~1e-6 relative (as tests/test_torch_nn.py)
RTOL = 1e-4
# parameter gradients of sum(out · c), c a seeded field: the relative L2
# distance over all of a module's parameters (measured up to 5.4e-7 on the CPU)
GRAD_REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _uniform(shape, seed, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(np.float32)


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def _rel(got, want):
    num = np.sqrt(sum(float(((g - w).astype(np.float64) ** 2).sum()) for g, w in zip(got, want)))
    den = np.sqrt(sum(float((w.astype(np.float64) ** 2).sum()) for w in want))
    assert den > 0
    return num / den


def _grads_match(jmod, variables, tmod, x, **apply_kw):
    """jax.grad and autograd of sum(out · c) with respect to every param,
    the JAX gradient laid out as the port's parameters."""
    out = jmod.apply(variables, jnp.asarray(x), **apply_kw)
    c = _uniform(out.shape, 7)

    def fn(p):
        return jnp.sum(jmod.apply({**variables, "params": p}, jnp.asarray(x), **apply_kw) * c)

    gj = jax.grad(fn)(variables["params"])
    tkw = {k: torch.from_numpy(np.asarray(v)) if not isinstance(v, (bool, type(None))) else v
           for k, v in apply_kw.items()}
    params = list(tmod.parameters())
    gt = torch.autograd.grad((tmod(torch.from_numpy(x), **tkw) * torch.from_numpy(c)).sum(),
                             params)
    holder = copy.deepcopy(tmod)
    load_flax_module(holder, {"params": _np(gj)})
    want = [p.detach().numpy() for p in holder.parameters()]
    rel = _rel([g.numpy() for g in gt], want)
    assert rel <= GRAD_REL, f"relative gradient error {rel:.2e}"


# ---------------------------------------------------------------------------
# encoder–decoder
# ---------------------------------------------------------------------------
SKIPS = {"Add": True, "Layers": [1, 1, 1, 1]}
ED_CASES = {
    "skips_2d": (dict(skips=SKIPS), (2, 13, 13, 3)),
    "skips_partial_2d": (dict(skips={"Add": True, "Layers": [1, 0, 1, 0]}), (2, 13, 13, 3)),
    "skips_3d": (dict(skips=SKIPS, spatial_dims=3), (1, 9, 9, 9, 2)),
    "flatten_2d": (dict(flatten=128), (2, 17, 17, 3)),
    "flatten_narrow_2d": (dict(flatten=6), (2, 17, 17, 3)),
    "flatten_3d": (dict(flatten=128, spatial_dims=3), (1, 9, 9, 9, 2)),
    "flatten_skips_temporal_2d": (dict(flatten=128, skips=SKIPS, temporal=True),
                                  (2, 1, 13, 13, 5)),
    "dropout_eval_2d": (dict(dropout=[1, 0, 0, 1]), (2, 13, 13, 3)),
    "dropout_skips_eval_3d": (dict(dropout=[0, 1, 1, 0], skips=SKIPS, spatial_dims=3),
                              (1, 9, 9, 9, 2)),
}
ED_TRAINED = ("skips_2d", "skips_partial_2d", "skips_3d", "flatten_2d", "flatten_3d",
              "flatten_skips_temporal_2d")


def _ed_config(cfg, skips=None, flatten=None, dropout=None, spatial_dims=2, temporal=False):
    cfg["spatial_dims"] = spatial_dims
    cfg["temporal"] = temporal
    rp = cfg["residual_params"]
    rp["Skip_Connections"] = skips or {"Add": False, "Layers": [1, 1, 1, 1]}
    if flatten:
        rp["Latent_Layer"].update(Flatten=True, Width=flatten)
    if dropout:
        rp["Dropout"] = {"Add": True, "Rate": 0.2, "Layer": dropout}
    return cfg


def _ed(case, seed=0):
    opts, shape = ED_CASES[case]
    jcfg = _ed_config(jax_configuration("encoder_decoder"), **opts)
    tcfg = _ed_config(get_configuration("encoder_decoder"), **opts)
    jm = EncoderDecoderModel.from_config(jcfg)
    x = _uniform(shape, 1)
    variables = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    grid = shape[-1 - tcfg["spatial_dims"]:-1]
    tm = EncoderDecoder.from_config(tcfg, in_channels=shape[-1], grid=grid,
                                    generator=torch.Generator().manual_seed(seed))
    load_flax_module(tm, _np(variables))
    return jm, variables, tm, x


@pytest.mark.parametrize("case", list(ED_CASES))
def test_encoder_decoder_option_matches_flax(case):
    jm, variables, tm, x = _ed(case)
    want = jm.apply(variables, jnp.asarray(x), training=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), training=False).numpy()
    _close(got, want)


@pytest.mark.parametrize("case", ED_TRAINED)
def test_encoder_decoder_option_gradients_match_flax(case):
    jm, variables, tm, x = _ed(case)
    _grads_match(jm, variables, tm, x)


def test_encoder_decoder_option_layers():
    """The layers each option adds, under the reference's names: the skip
    projections where the channels differ (the latent's 128 against level
    4's 108 without ``dec_dense_start``), ``dec_dense_start`` with the
    innermost skip, and the flattened latent's width rule."""
    _, variables, tm, _ = _ed("skips_2d")
    p = variables["params"]
    assert "dec_dense_start" in p and tm.dec_dense_start is not None
    assert sorted(f"skip_proj_{k}" for k in tm.skip_proj) == sorted(
        k for k in p if k.startswith("skip_proj_"))
    _, variables, tm, _ = _ed("skips_partial_2d")
    assert "dec_dense_start" not in variables["params"] and tm.dec_dense_start is None
    for case, cells, channels in (("flatten_2d", 4, 32), ("flatten_narrow_2d", 4, 1),
                                  ("flatten_3d", 1, 128)):
        _, variables, tm, _ = _ed(case)
        kernel = variables["params"]["latent_dense"]["kernel"]
        assert kernel.shape == (cells * 108, cells * channels)
        assert tuple(tm.latent_dense.weight.shape) == (cells * channels, cells * 108)


@pytest.mark.parametrize("which", ["encoder_decoder", "residual"])
def test_dropout_keep_rate_in_a_train_mode_forward(which, monkeypatch):
    """Dropout at rate 0.2 in a module forward with ``training=True``
    (the calls of ``F.dropout`` recorded): the keep share of its N inputs
    is 0.8 within 5 standard errors sqrt(0.8·0.2/N), the kept ones are
    scaled by 1/0.8 to 1e-6; with ``training=False`` it is the identity."""
    if which == "encoder_decoder":
        _, _, tm, x = _ed("dropout_eval_2d")
    else:
        cfg = get_configuration("residual")
        cfg.update(output_distribution=False, dropout_rate=0.2)
        tm = ResidualNetwork.from_config(cfg, in_channels=3,
                                         generator=torch.Generator().manual_seed(0))
        x = _uniform((4, 13, 13, 3), 1)
    calls = []
    dropout = torch.nn.functional.dropout

    def recorded(inp, p, training=False, **kw):
        out = dropout(inp, p, training=training, **kw)
        calls.append((inp, out, p, training))
        return out

    monkeypatch.setattr(torch.nn.functional, "dropout", recorded)
    torch.manual_seed(3)
    with torch.no_grad():
        tm(torch.from_numpy(x), training=False)
        n_eval = len(calls)
        tm(torch.from_numpy(x), training=True)
    # levels 1 and 4, in the encoder and in the decoder; one per block
    assert n_eval == len(calls) - n_eval == 4
    assert all(torch.equal(i, o) and not tr for i, o, _, tr in calls[:n_eval])
    inp = torch.cat([i.reshape(-1) for i, _, _, _ in calls[n_eval:]])
    out = torch.cat([o.reshape(-1) for _, o, _, _ in calls[n_eval:]])
    live = inp != 0
    kept = out[live] != 0
    n = int(live.sum())
    share = float(kept.float().mean())
    assert n > 5000 and all(p == 0.2 and tr for _, _, p, tr in calls[n_eval:])
    assert abs(share - 0.8) <= 5 * np.sqrt(0.8 * 0.2 / n), (share, n)
    np.testing.assert_allclose((out[live][kept] / inp[live][kept]).numpy(), 1 / 0.8, rtol=1e-6)


# ---------------------------------------------------------------------------
# residual net
# ---------------------------------------------------------------------------
RES_CASES = {
    "dense": (dict(network_type="dense"), (2, 7, 7, 5)),
    "distribution": (dict(output_distribution=True), (2, 9, 9, 5)),
    "distribution_temporal": (dict(output_distribution=True, temporal=True), (2, 1, 9, 9, 5)),
    "distribution_dense": (dict(output_distribution=True, network_type="dense"), (2, 7, 7, 5)),
    "distribution_cnn3d": (dict(output_distribution=True, network_type="cnn3d"),
                           (2, 3, 7, 7, 5)),
    "batch_norm_cnn": (dict(use_batch_norm=True), (2, 9, 9, 5)),
    "batch_norm_cnn3d": (dict(use_batch_norm=True, network_type="cnn3d"), (2, 3, 7, 7, 5)),
    "batch_norm_dense": (dict(use_batch_norm=True, network_type="dense"), (2, 7, 7, 5)),
    "dropout_eval": (dict(dropout_rate=0.2), (2, 9, 9, 5)),
    "dense_pad_ignored": (dict(network_type="dense", spatial_pad_to=12), (2, 7, 7, 5)),
}
RES_TRAINED = ("dense", "distribution", "distribution_temporal", "distribution_dense")


def _perturbed(variables, seed):
    """BatchNorm's scale, bias and running statistics away from their
    initial values, so that evaluation uses each of them."""
    rs = np.random.RandomState(seed)
    out = _np(variables)

    def walk(p, s):
        for k in p:
            if k.startswith("bn"):
                n = p[k]["scale"].shape
                p[k] = {"scale": rs.uniform(0.5, 1.5, n).astype(np.float32),
                        "bias": rs.uniform(-0.5, 0.5, n).astype(np.float32)}
                s[k] = {"mean": rs.uniform(-0.5, 0.5, n).astype(np.float32),
                        "var": rs.uniform(0.5, 2.0, n).astype(np.float32)}
            elif isinstance(p[k], dict):
                walk(p[k], s.setdefault(k, {}))

    out = {"params": copy.deepcopy(dict(out["params"])),
           "batch_stats": copy.deepcopy(dict(out.get("batch_stats", {})))}
    walk(out["params"], out["batch_stats"])
    return out


def _residual(case, seed=0, **extra):
    opts, shape = RES_CASES[case]
    cfgs = []
    for cfg in (jax_configuration("residual"), get_configuration("residual")):
        cfg["output_distribution"] = False
        cfg.update(opts, **extra)
        cfgs.append(cfg)
    jm = ResidualNetworkLayer.from_config(cfgs[0])
    x = _uniform(shape, 1)
    variables = _np(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x)))
    if "batch_stats" in variables:
        variables = _perturbed(variables, seed + 5)
    tm = ResidualNetwork.from_config(cfgs[1], in_channels=shape[-1],
                                     generator=torch.Generator().manual_seed(seed))
    load_flax_module(tm, variables)
    return jm, variables, tm, x


@pytest.mark.parametrize("case", list(RES_CASES))
def test_residual_option_matches_flax(case):
    jm, variables, tm, x = _residual(case)
    want = jm.apply(variables, jnp.asarray(x), training=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), training=False).numpy()
    _close(got, want)
    if RES_CASES[case][0].get("output_distribution"):
        assert got.shape[-3:-1] == (1, 1) and got.shape[-1] == 50
        np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("case", RES_TRAINED)
def test_residual_option_gradients_match_flax(case):
    jm, variables, tm, x = _residual(case)
    _grads_match(jm, variables, tm, x)


def test_batch_norm_under_bfloat16_follows_flax_dtypes():
    """Under ``compute_dtype`` bfloat16 flax's BatchNorm (``dtype=None``)
    computes in float32 from the bfloat16 convolution and its float32
    statistics: each BatchNorm returns float32 in both packages, the block
    convolutions bfloat16, and the outputs agree within 2e-2 of their
    scale (bfloat16 roundings placed alike, XLA's and oneDNN's sums)."""
    jm, variables, tm, x = _residual("batch_norm_cnn", compute_dtype="bfloat16")
    want, state = jm.apply(variables, jnp.asarray(x), training=False,
                           capture_intermediates=True)
    inter = state["intermediates"]["res_block_1"]
    assert inter["bn1"]["__call__"][0].dtype == jnp.float32
    assert inter["layer1"]["__call__"][0].dtype == jnp.bfloat16
    seen = []
    hook = tm.blocks[0].bn1.register_forward_hook(
        lambda m, i, o: seen.append((i[0].dtype, o.dtype)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), training=False)
    hook.remove()
    assert seen == [(torch.bfloat16, torch.float32)] and got.dtype == torch.float32
    want = np.asarray(want, np.float32)
    err = np.abs(got.numpy() - want).max()
    assert err <= 2e-2 * np.abs(want).max(), err


def test_batch_norm_train_mode_updates_its_statistics_as_flax():
    """A train-mode forward (``training=True``, the batch statistics and
    flax's running update, momentum 0.99) against flax's with a mutable
    ``batch_stats``: outputs and the updated statistics."""
    jm, variables, tm, x = _residual("batch_norm_cnn")
    want, state = jm.apply(variables, jnp.asarray(x), training=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = tm(torch.from_numpy(x), training=True).numpy()
    _close(got, want)
    bn = tm.blocks[1].bn2
    stats = state["batch_stats"]["res_block_2"]["bn2"]
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(stats["mean"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.var.numpy(), np.asarray(stats["var"]), rtol=1e-5, atol=1e-6)


def test_jax_package_cannot_train_dropout_or_batch_norm():
    """The JAX package's failure that the port's loss mirrors: a training
    forward with neither a dropout rng nor a mutable collection."""
    for case, err in (("dropout_eval", flax.errors.InvalidRngError),
                      ("batch_norm_cnn", flax.errors.ModifyScopeVariableError)):
        jm, variables, _, x = _residual(case)
        with pytest.raises(err):
            jm.apply(variables, jnp.asarray(x), training=True)
    jm, variables, _, x = _ed("dropout_eval_2d")
    with pytest.raises(flax.errors.InvalidRngError):
        jm.apply(variables, jnp.asarray(x), training=True)


def _vae(seed=0):
    kw = dict(num_blocks=2, filters=8, output_filters=1, latent_a=0.1, latent_b=10.0)
    jm = ResidualNetworkLayer(latent_output=True, **kw)
    x = _uniform((2, 7, 7, 3), 1)
    variables = jm.init({"params": jax.random.PRNGKey(seed), "sample": jax.random.PRNGKey(1)},
                        jnp.asarray(x))
    tm = ResidualNetwork(3, latent_output=True, temporal=False, **kw,
                         generator=torch.Generator().manual_seed(seed))
    load_flax_module(tm, _np(variables))
    return jm, variables, tm, x


def test_vae_head_mean_and_log_variance_with_eps_given():
    """With ε given, the port's head is (b − a)·σ(z_mean + exp(z_log_var/2)·ε)
    + a broadcast over the grid, z_mean and z_log_var being flax's (its
    Dense outputs, captured), within RTOL."""
    jm, variables, tm, x = _vae()
    _, state = jm.apply(variables, jnp.asarray(x), rngs={"sample": jax.random.PRNGKey(2)},
                        capture_intermediates=True)
    z_mean = np.asarray(state["intermediates"]["z_mean"]["__call__"][0])
    z_log_var = np.asarray(state["intermediates"]["z_log_var"]["__call__"][0])
    eps = _uniform(z_mean.shape, 4, -2.0, 2.0)
    z = z_mean + np.exp(0.5 * z_log_var) * eps
    want = np.broadcast_to((9.9 / (1.0 + np.exp(-z)) + 0.1)[:, None, None, :], (2, 7, 7, 1))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), eps=torch.from_numpy(eps)).numpy()
    _close(got, want)


def test_vae_head_bounds_from_a_generator():
    """Drawn from an explicit generator the head stays in [a, b] as the
    JAX package's does (tests/test_nn_variants.py), the same generator
    state gives the same output, and without ε or a generator it raises
    (as flax does without its "sample" rng)."""
    jm, variables, tm, x = _vae()
    want = np.asarray(jm.apply(variables, jnp.asarray(x), rngs={"sample": jax.random.PRNGKey(2)}))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        a = tm(xt, generator=torch.Generator().manual_seed(5)).numpy()
        b = tm(xt, generator=torch.Generator().manual_seed(5)).numpy()
    for out in (want, a):
        assert out.shape == (2, 7, 7, 1)
        assert 0.1 <= float(out.min()) and float(out.max()) <= 10.0
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="eps or a generator"):
        tm(xt)


def test_residual_without_output_layer_matches_flax():
    kw = dict(num_blocks=2, filters=8, include_output_layer=False)
    jm = ResidualNetworkLayer(**kw)
    x = _uniform((2, 7, 7, 3), 1)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = ResidualNetwork(3, temporal=False, **kw)
    load_flax_module(tm, _np(variables))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 7, 7, 8)
    _close(got, jm.apply(variables, jnp.asarray(x)))


# ---------------------------------------------------------------------------
# HardLayer, composition, PVT module
# ---------------------------------------------------------------------------
RECT = dict(rectifier=jax.nn.sigmoid, pdew=4048.4, pmin=1000.0)
HARD_CASES = {
    "rbf": (dict(use_rbf=True), 1),
    "rbf_two_property_channels": (dict(use_rbf=True), 2),
    "rectifier": (RECT, 1),
    "rbf_rectifier": (dict(use_rbf=True, **RECT), 1),
    "exponent_not_trainable": (dict(exponent_trainable=False), 1),
}


class _Hard(torch.nn.Module):
    """The HardLayer's forward as one module call, for _grads_match."""

    def __init__(self, hl, prop, p_net, rect):
        super().__init__()
        self.hl, self.prop, self.p_net, self.rect = hl, prop, p_net, rect

    def forward(self, t):
        return self.hl(t, self.prop, self.p_net, rect_input=self.rect)


def _port_rectifier(opts):
    if "rectifier" in opts:
        return dict(opts, rectifier=torch.sigmoid)
    return opts


@pytest.mark.parametrize("case", list(HARD_CASES))
def test_hard_layer_option_matches_flax(case):
    """Output and the gradients of ``kernel_exponent`` and ``rbf_kernel``
    (``exponent_trainable=False`` trains as the reference's does, C20)."""
    opts, nprop = HARD_CASES[case]
    shape = (2, 1, 5, 5)
    t = _uniform(shape + (1,), 1)
    t[0] = -1.0                                   # t0: output = init_value
    prop = _uniform(shape + (nprop,), 2)
    p_net = _uniform(shape + (1,), 3, 0.0, 200.0)
    rect = _uniform(shape + (1,), 4, 1000.0, 5000.0)
    jl = JaxHardLayer(init_value=5000.0, exponent_min=0.1, exponent_max=1.0, **opts)
    variables = jl.init(jax.random.PRNGKey(0), *map(jnp.asarray, (t, prop, p_net, rect)))
    tl = HardLayer(shape[1:] + (1,), init_value=5000.0, exponent_min=0.1, exponent_max=1.0,
                   prop_channels=nprop, **_port_rectifier(opts))
    kexp = _uniform(shape[1:] + (1,), 5, 0.2, 0.9)   # a per-cell exponent
    params = dict(_np(variables)["params"], kernel_exponent=kexp)
    variables = {"params": params}
    load_flax_module(tl, variables)
    args = [jnp.asarray(v) for v in (t, prop, p_net, rect)]
    want = jl.apply(variables, *args)
    with torch.no_grad():
        got = tl(*map(torch.from_numpy, (t, prop, p_net)), rect_input=torch.from_numpy(rect))
    _close(got.numpy(), want)
    assert np.all(got.numpy()[0] == 5000.0)
    c = _uniform(want.shape, 7)

    def fn(p):
        return jnp.sum(jl.apply({"params": p}, *args) * c)

    gj = _np(jax.grad(fn)(variables["params"]))
    out = tl(*map(torch.from_numpy, (t, prop, p_net)), rect_input=torch.from_numpy(rect))
    names = [n for n, _ in tl.named_parameters()]
    gt = torch.autograd.grad((out * torch.from_numpy(c)).sum(), list(tl.parameters()))
    assert sorted(names) == sorted(gj)
    # one property channel: w/|w| is ±1 and its gradient exactly 0 (the
    # reference's is float32 rounding there), so the bound is relative to
    # the largest gradient of the layer
    scale = max(np.abs(v).max() for v in gj.values())
    for n, g in zip(names, gt):
        np.testing.assert_allclose(g.numpy(), gj[n], rtol=GRAD_REL, atol=GRAD_REL * scale,
                                   err_msg=n)


def test_hard_enforcement_only_matches_flax():
    """The network bypassed: the HardLayer on the mean of the last two
    channels (tests/test_nn_variants.py's module), with a time ramp."""
    jl = JaxHardLayer(init_value=5000.0)
    jm = JaxComplete(network=None, hard_layer=jl, hard_enforcement_only=True)
    x = _uniform((2, 1, 7, 7, 5), 1)
    x[0, ..., 3] = -1.0
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = CompleteTrainableModule(None, HardLayer((1, 7, 7, 1), init_value=5000.0),
                                 hard_enforcement_only=True)
    load_flax_module(tm, _np(variables))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    _close(got, jm.apply(variables, jnp.asarray(x)))
    assert np.all(got[0] == 5000.0)


def test_complete_module_slices_and_rectifier_input_match_flax():
    """A residual backbone under an RBF + rectifier HardLayer with a time
    slice, a two-channel property slice and a rectifier input, through
    ``CompleteTrainableModule``; gradients too."""
    kw = dict(num_blocks=2, filters=8, temporal=True)
    jm = JaxComplete(network=ResidualNetworkLayer(**kw),
                     hard_layer=JaxHardLayer(init_value=5000.0, use_rbf=True, **RECT),
                     time_slice=(0, 1), property_slice=(1, 3))
    x = _uniform((2, 1, 7, 7, 4), 1)
    rect = _uniform((2, 1, 7, 7, 1), 2, 1000.0, 5000.0)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(rect))
    tm = CompleteTrainableModule(
        ResidualNetwork(4, **kw),
        HardLayer((1, 7, 7, 1), init_value=5000.0, use_rbf=True, prop_channels=2,
                  **_port_rectifier(RECT)),
        time_slice=(0, 1), property_slice=(1, 3))
    load_flax_module(tm, _np(variables))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(rect)).numpy()
    _close(got, jm.apply(variables, jnp.asarray(x), jnp.asarray(rect)))
    _grads_match(jm, variables, tm, x, rectifier_input=rect)


def test_pvt_module_with_hard_layer_matches_flax():
    """``PVTModuleWithHardLayer(use_hard_layer=True)``: the HardLayer on the
    whole input, then the polynomial PVT (values and d/dP)."""
    cfg = jax_configuration("pvt_layer", fluid_type="DG")
    jm = JaxPVTModule(pvt_layer=jax_make_pvt_layer(cfg), hard_layer=JaxHardLayer(
        init_value=5000.0), use_hard_layer=True)
    x = _uniform((2, 5, 5, 3), 1, -1.0, 1.0) * np.asarray([1.0, 300.0, 300.0], np.float32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = PVTModuleWithHardLayer(make_pvt_layer(get_configuration("pvt_layer", fluid_type="DG")),
                                HardLayer((5, 5, 1), init_value=5000.0), use_hard_layer=True)
    load_flax_module(tm, _np(variables))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    assert got.shape == want.shape == (2, 2, 2, 5, 5, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_batch_norm_defaults_are_flax_defaults():
    jm, variables, tm, _ = _residual("batch_norm_cnn")
    fresh = _np(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 9, 9, 5))))
    bn = [m for m in ResidualNetwork.from_config(
        dict(get_configuration("residual"), use_batch_norm=True, output_distribution=False),
        in_channels=5).modules() if isinstance(m, BatchNorm)]
    stats = fresh["batch_stats"]["res_block_1"]["bn1"]
    p = fresh["params"]["res_block_1"]["bn1"]
    for m in bn:
        assert m.momentum == 0.99 and m.epsilon == 1e-5
        assert torch.equal(m.scale, torch.ones_like(m.scale)) and not m.bias.any()
        assert not m.mean.any() and torch.equal(m.var, torch.ones_like(m.var))
    np.testing.assert_array_equal(p["scale"], 1.0)
    np.testing.assert_array_equal(stats["var"], 1.0)
    assert "bias" not in fresh["params"]["res_block_1"]["layer1"]
    assert tm.blocks[0].layer1.bias is None


# ---------------------------------------------------------------------------
# the loss refuses what the JAX package's loss cannot run (ROADMAP C19)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def dg9_port(tmp_path_factory):
    from srm_tpu_torch.examples.common import setup_case
    return setup_case("DG", base_dir=str(tmp_path_factory.mktemp("torch_dg9")), nx=9,
                      n_realizations=6, device="cpu")


def _refused_models(which, case):
    """A copy of the case's models with one network given dropout or
    BatchNorm, and the layer the refusal must name."""
    models = dict(case["models"])
    if which == "pressure_dropout":
        cfg = get_configuration("encoder_decoder")
        _ed_config(cfg, dropout=[1, 0, 0, 0], temporal=True)
        ed = EncoderDecoder.from_config(cfg, in_channels=5)
        models["pressure"] = CompleteTrainableModule(ed, case["models"]["pressure"].hard_layer)
        return models, "network (dropout 0.2)"
    cfg = get_configuration("residual")
    cfg.update(output_distribution=False, temporal=True)
    if which == "time_step_batch_norm":
        cfg["use_batch_norm"] = True
        layer = "network.blocks.0.bn1 (BatchNorm)"
    else:
        cfg["dropout_rate"] = 0.2
        layer = "network.blocks.0 (dropout 0.2)"
    models["time_step"] = CompleteTrainableModule(ResidualNetwork.from_config(cfg, 5))
    return models, layer


@pytest.mark.parametrize("which", ["pressure_dropout", "time_step_dropout",
                                   "time_step_batch_norm"])
def test_loss_refuses_dropout_and_batch_norm_in_training(dg9_port, which):
    """The loss's forward is a training forward, as the reference's
    ``_net`` (``training=True``) is, which fails for these layers
    (test_jax_package_cannot_train_dropout_or_batch_norm): the port's loss
    raises, naming the layer, for a loss evaluation and a gradient step;
    the modules themselves evaluate with ``training=False``."""
    from srm_tpu_torch.data.batching import collapse_groups
    lf = copy.copy(dg9_port["loss_fn"])
    lf.models, layer = _refused_models(which, dg9_port)
    x, y = collapse_groups(dg9_port["train_groups"])
    x, y = torch.from_numpy(x[:2]), {k: torch.from_numpy(v[:2]) for k, v in y.items()}
    with pytest.raises(ValueError, match=f"{which.split('_')[0]}.*{layer.split(' ')[0]}"):
        lf.loss_and_metrics(x, y)
    with pytest.raises(ValueError, match="ROADMAP C19"):
        lf.pinn_batch_sse_grad(x, y)
    name = "pressure" if which.startswith("pressure") else "time_step"
    with torch.no_grad():
        out = lf.models[name](x, training=False)
    assert torch.isfinite(out).all()
