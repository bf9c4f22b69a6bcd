"""The production profile of the port against the JAX package's, on the CPU:
bfloat16 networks (``compute_dtype``, ``precision_policy="mixed"``), the
strided Δt input (``dt_input_stride``), the production and drawdown
presets and their optimizer schedules (ROADMAP A10, C7), the trainer at
batch 128, the CLI's ``train --production`` and ``train/predict/export
--drawdown`` at 9×9, and bfloat16 networks through the predictor and the
serving bundle.

bfloat16 networks. Both packages keep float32 parameters and cast per
layer (flax's rule: a layer built with a dtype casts its input, kernel and
bias to it; one without computes in the promoted type). The port is held
to that rule exactly: every layer's input and output dtype equals the JAX
package's, recorded with flax's method interceptor and with the port's
``apply_layer``. The two libraries do not round alike, so each bfloat16
output and gradient is held to the JAX package's within twice the JAX
package's own bfloat16-to-float32 distance (relative L2), and its RMS
distance within BF16_SCALE of the JAX package's largest magnitude; the
port's bfloat16 output lies at least half that own distance from the
port's float32 network on the same weights (port to JAX f32, below, is
that distance to 2e-6). Measured on the CPU (relative L2; port to JAX
bf16 / JAX bf16 to JAX f32 / port to JAX f32):

  case                 output                      gradient
  pressure 9x9         9.45e-3 / 1.18e-2 / 1.06e-2 5.61e-2 / 5.51e-2 / 6.37e-3
  pressure 9x9 mixed   1.12e-2 / 1.01e-2 / 9.65e-3 6.59e-3 / 6.59e-3 / 9.28e-4
  pressure 9x9x9       1.17e-2 / 1.13e-2 / 1.06e-2 4.02e-2 / 4.01e-2 / 2.85e-3
  pressure 9x9x9 mixed 9.64e-3 / 1.07e-2 / 9.18e-3 1.02e-2 / 1.03e-2 / 4.82e-4
  time_step 13x13      4.91e-3 / 5.76e-3 / 4.59e-3 2.03e-2 / 1.65e-2 / 9.04e-3
  time_step 9x9x9      6.30e-3 / 5.73e-3 / 5.34e-3 3.36e-2 / 3.36e-2 / 5.89e-3

and RMS over scale 1.2e-3 to 3.8e-3 (outputs), 1.3e-5 to 1.6e-4
(gradients). The JAX package's all-bfloat16 gradient on the CPU lies
1.7e-2 to 5.5e-2 from its float32 one (6.6e-3 and 1.0e-2 with the mixed
policy), the port's 4.8e-4 to 9.0e-3: the port is held to twice the
former, and no tighter bound ties the two (ROADMAP C14).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srm_tpu.config as jcfg
import srm_tpu_torch.config as tcfg
from srm_tpu.nn import modules as jmod
from srm_tpu_torch.nn import convert
from srm_tpu_torch.nn import modules as tmod
from srm_tpu_torch.nn.encoder_decoder import EncoderDecoder

# a bf16 output's or gradient's RMS distance from the JAX package's, over
# the largest magnitude of the JAX package's (beside twice the JAX package's
# own bf16-to-f32 distance)
BF16_SCALE = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def _nets(name, nx, nz, f32_io, seed=0):
    """(flax network, its f32 twin, its params, the port's network with
    those weights) for Model 1's backbone ("pressure") or Model 2."""
    res = copy.deepcopy(jcfg.DEFAULT_RESERVOIR_CONFIG)
    res["Nx"] = res["Ny"] = nx
    res["Nz"] = nz
    g = copy.deepcopy(jcfg.DEFAULT_GENERAL_CONFIG)
    g["compute_dtype"] = "bfloat16"
    g["precision_policy"] = "mixed" if f32_io else None
    shape = (1, nz, nx, nx, 5) if nz > 1 else (1, nx, nx, 5)
    build = {"pressure": (jmod.build_pressure_model, tmod.build_pressure_model),
             "time_step": (jmod.build_time_step_model, tmod.build_time_step_model)}[name]
    jm = build[0](general_config=g, reservoir_config=res)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1,) + shape, jnp.float32))
    tm = (build[1](shape, g, res) if name == "pressure" else build[1](shape, g))
    convert.load_flax_params({name: tm}, {name: jax.tree_util.tree_map(np.asarray, params)})
    jnet = jm.network
    f32 = jnet.clone(compute_dtype=None, **({"f32_io": False} if name == "pressure" else {}))
    return jnet, f32, {"params": params["params"]["network"]}, tm.network


def _x(B, nx, nz, seed=1):
    shape = (B, 1, nz, nx, nx, 5) if nz > 1 else (B, 1, nx, nx, 5)
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


CASES = [("pressure", 9, 1, False), ("pressure", 9, 1, True), ("pressure", 9, 9, False),
         ("pressure", 9, 9, True), ("time_step", 13, 1, False), ("time_step", 9, 9, False)]
IDS = [f"{n}-{nx}x{nz}{'-mixed' if io else ''}" for n, nx, nz, io in CASES]


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def bf16_case(request):
    name, nx, nz, f32_io = request.param
    jnet, j32, p, tnet = _nets(name, nx, nz, f32_io)
    x = _x(2, nx, nz)
    c = np.random.RandomState(2).normal(size=np.asarray(j32.apply(p, jnp.asarray(x))).shape)
    c = c.astype(np.float32)

    def jax_grads(net):
        fn = lambda q: jnp.sum(net.apply(q, jnp.asarray(x)) * c)  # noqa: E731
        out = jax.jit(lambda q: net.apply(q, jnp.asarray(x)))(p)
        return np.asarray(out), jax.jit(jax.grad(fn))(p)["params"]

    out_bf, g_bf = jax_grads(jnet)
    out_32, g_32 = jax_grads(j32)
    xt = torch.from_numpy(x)
    out_t = tnet(xt)
    assert out_t.dtype == torch.float32
    params = list(tnet.parameters())
    grads_t = torch.autograd.grad((out_t * torch.from_numpy(c)).sum(), params)
    assert all(g.dtype == torch.float32 for g in grads_t)

    def layout(tree):
        holder = copy.deepcopy(tnet)
        load = (convert._load_encoder_decoder if name == "pressure"
                else convert._load_residual)
        load(holder, jax.tree_util.tree_map(np.asarray, tree))
        return [q.detach().numpy() for q in holder.parameters()]

    with torch.no_grad():
        out_t32 = _f32_twin(tnet)(xt)
    return dict(name=name, out=(out_t.detach().numpy(), out_bf, out_32),
                out_f32=out_t32.numpy(),
                grads=([g.numpy() for g in grads_t], layout(g_bf), layout(g_32)),
                layers=(_port_layers(tnet, xt), _jax_layers(jnet, p, x)))


def _f32_twin(net):
    """A copy of the port's network with every layer in float32."""
    net = copy.deepcopy(net)
    for m in net.modules():
        for attr in ("cdt", "cdt_io"):
            if hasattr(m, attr):
                setattr(m, attr, None)
    return net


def _jax_layers(net, params, x):
    """(kind, input dtype, output dtype) of every Conv, ConvTranspose and
    Dense call ("layer", "deconv") and every ResidualBlock ("block") of the
    JAX package's network on ``x``, in the order they return."""
    import flax.linen as fnn

    from srm_tpu.nn.residual import ResidualBlock
    seen = []

    def record(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        m = context.module
        if context.method_name == "__call__" and isinstance(
                m, (fnn.Conv, fnn.ConvTranspose, fnn.Dense, ResidualBlock)):
            kind = ("block" if isinstance(m, ResidualBlock) else
                    "deconv" if isinstance(m, fnn.ConvTranspose) else "layer")
            seen.append((kind, str(args[0].dtype), str(out.dtype)))
        return out

    with fnn.intercept_methods(record):
        net.apply(params, jnp.asarray(x))
    return seen


def _port_layers(net, x):
    """The same list for the port's network: every layer that
    ``apply_layer`` runs and every ResidualBlock, in the order they return."""
    from unittest import mock

    from srm_tpu_torch.nn import common, encoder_decoder, residual
    seen = []
    name = lambda t: str(t.dtype).replace("torch.", "")  # noqa: E731

    def apply_layer(layer, h, dtype=None):
        out = common.apply_layer(layer, h, dtype)
        kind = ("deconv" if isinstance(layer, (torch.nn.ConvTranspose2d,
                                               torch.nn.ConvTranspose3d)) else "layer")
        seen.append((kind, name(h), name(out)))
        return out

    hooks = [m.register_forward_hook(
        lambda m, args, out: seen.append(("block", name(args[0]), name(out))))
        for m in net.modules() if isinstance(m, residual.ResidualBlock)]
    try:
        with mock.patch.object(encoder_decoder, "apply_layer", apply_layer), \
                mock.patch.object(residual, "apply_layer", apply_layer), torch.no_grad():
            net(x)
    finally:
        for h in hooks:
            h.remove()
    return seen


def _scaled_rms(a, b):
    """The RMS of a - b over the largest magnitude of b (the scale)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.abs(b).max())


def test_bf16_network_layers_follow_the_reference(bf16_case):
    """Layer by layer, the port computes in the JAX package's dtypes: the
    same sequence of layers (convolutions, deconvolutions, dense layers,
    residual blocks), each with the same input and output dtype, so every
    bfloat16 layer, the float32 layers of the "mixed" policy, the Δt net's
    float32 head and each block's shortcut sum are held to flax's rule
    exactly. A port in float32 or under autocast fails here."""
    got, want = bf16_case["layers"]
    assert any(o == "bfloat16" for _, _, o in want)
    assert got == want


@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("projection", [False, True])
def test_bf16_residual_block_promotes_its_shortcut(nd, projection):
    """A residual block with ``compute_dtype="bfloat16"`` on a float32
    input: its convolutions compute in bfloat16; an identity shortcut (no
    projection, as where the input already has the block's width) keeps the
    float32 input, and the sum promotes to float32, in flax and in the port;
    a projected shortcut is bfloat16 and so is the sum. Layer dtypes and the
    output dtype against the JAX package's block."""
    from srm_tpu.nn.residual import ResidualBlock as JBlock
    from srm_tpu_torch.nn.residual import ResidualBlock
    c_in = 5 if projection else 8
    shape = (2,) + (5,) * nd + (c_in,)
    x = np.random.RandomState(3).uniform(-1, 1, shape).astype(np.float32)
    jblock = JBlock(filters=8, use_projection=projection, compute_dtype="bfloat16",
                    network_type="cnn3d" if nd == 3 else "cnn")
    params = jblock.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = _jax_layers(jblock, params, x)
    block = ResidualBlock(c_in, 8, use_projection=projection,
                          network_type="cnn3d" if nd == 3 else "cnn",
                          compute_dtype=torch.bfloat16)
    got = _port_layers(block, torch.from_numpy(x).movedim(-1, 1))
    assert got == want
    assert want[-1] == ("block", "float32", "bfloat16" if projection else "float32")


def test_bf16_network_output_matches_reference(bf16_case):
    got, want, f32 = bf16_case["out"]
    own = _rel(want, f32)
    assert own > 0, "the JAX package's bf16 output equals its f32 output"
    err = _rel(got, want)
    assert err <= 2.0 * own, f"port {err:.3e} from bf16, bf16 {own:.3e} from f32"
    assert _scaled_rms(got, want) <= BF16_SCALE
    # the port's bf16 network rounds as far from its own float32 twin as the
    # JAX package's does (0.80-0.96 of it measured), which a float32 port
    # (0) fails
    moved = _rel(got, bf16_case["out_f32"])
    assert moved >= 0.5 * own, f"port bf16 {moved:.3e} from port f32, JAX {own:.3e}"


def test_bf16_network_gradient_matches_reference(bf16_case):
    """The gradient of a fixed scalar of the output with respect to every
    parameter: as one vector, within twice the JAX package's own bf16
    distance from its f32 gradient and within BF16_SCALE of the gradient's
    scale; and per parameter tensor, within twice that tensor's own
    distance plus BF16_SCALE (a float32 layer under "mixed" has no bf16
    distance of its own, and a single bias's gradient, a sum over the
    output, moves with the bf16 rounding of every feature: Model 2's head
    bias at 13×13 is 1.45e-2 from the JAX package's, whose own distance is
    5.2e-3)."""
    got, want, f32 = bf16_case["grads"]
    flat = lambda gs: np.concatenate([g.ravel() for g in gs])  # noqa: E731
    own = _rel(flat(want), flat(f32))
    assert own > 0
    err = _rel(flat(got), flat(want))
    assert err <= 2.0 * own, f"port {err:.3e} from bf16, bf16 {own:.3e} from f32"
    assert _scaled_rms(flat(got), flat(want)) <= BF16_SCALE
    for i, (a, b, c) in enumerate(zip(got, want, f32)):
        assert _rel(a, b) <= 2.0 * _rel(b, c) + BF16_SCALE, f"parameter {i}"


def test_mixed_policy_is_closer_to_f32_than_all_bf16():
    """tests/test_nn_variants.py::test_mixed_precision_policy_f32_islands in
    the port: on a 39×39 input, Model 1's encoder–decoder with the float32
    input conv and output head ("mixed") tracks the float32 network more
    closely than the all-bfloat16 one, from the same weights."""
    x = torch.from_numpy(np.random.RandomState(1).uniform(-1, 1, (2, 1, 39, 39, 5))
                         .astype(np.float32))
    outs = {}
    for tag, (cdt, f32_io) in {"f32": (None, False), "bf16": ("bfloat16", False),
                               "mixed": ("bfloat16", True)}.items():
        g = dict(tcfg.DEFAULT_GENERAL_CONFIG, compute_dtype=cdt,
                 precision_policy="mixed" if f32_io else None)
        cfg = tmod._encoder_decoder_config(g, tcfg.DEFAULT_RESERVOIR_CONFIG)
        net = EncoderDecoder.from_config(cfg, in_channels=5,
                                         generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            out = net(x)
        assert out.dtype == torch.float32 and torch.isfinite(out).all()
        outs[tag] = out.double()
    err_bf16 = float((outs["bf16"] - outs["f32"]).abs().mean())
    err_mixed = float((outs["mixed"] - outs["f32"]).abs().mean())
    assert err_bf16 > 0
    assert err_mixed < err_bf16, (err_mixed, err_bf16)


# -- the CLI's presets -----------------------------------------------------------
def _capture_jax_train(monkeypatch, argv):
    """What the JAX package's ``cmd_train`` passes to its case builder and
    its trainer for ``argv`` (both replaced by recorders)."""
    import srm_tpu.__main__ as jmain
    import srm_tpu.examples.training_case_dry_gas as jdg
    import srm_tpu.examples.training_case_gas_condensate as jgc
    import srm_tpu.training.trainer as jtrainer
    seen = {}

    def setup(fluid):
        def build(**kw):
            seen.update(fluid=fluid, setup=kw)
            return {k: None for k in ("train_groups", "val_groups", "models", "params",
                                      "loss_fn")} | {"general_config": kw["general_config"]}
        return build

    def train(*a, **kw):
        seen["train"] = kw
        return None, {"total_train_loss": [0.0]}, None

    monkeypatch.setattr(jdg, "setup_dry_gas_case", setup("DG"))
    monkeypatch.setattr(jgc, "setup_gas_condensate_case", setup("GC"))
    monkeypatch.setattr(jtrainer, "train_combined_models_unified", train)
    assert jmain.main(["train", *argv]) == 0
    return seen


def _capture_port_train(monkeypatch, argv):
    import srm_tpu_torch.examples.common as tcommon
    import srm_tpu_torch.training.trainer as ttrainer
    from srm_tpu_torch.__main__ import main
    seen = {}

    def setup(fluid, **kw):
        seen.update(fluid=fluid, setup=kw)
        return {"device": torch.device("cpu"), "train_groups": None, "val_groups": None,
                "loss_fn": None, "general_config": kw["general_config"]}

    def train(*a, **kw):
        seen["train"] = kw
        return None, {"total_train_loss": [0.0]}, None

    monkeypatch.setattr(tcommon, "setup_case", setup)
    monkeypatch.setattr(ttrainer, "train_combined_models_unified", train)
    assert main(["train", *argv, "--device", "cpu"]) == 0
    return seen


PRESETS = [[], ["--production"], ["--production", "--batch-size", "64"], ["--drawdown"],
           ["--production", "--drawdown"], ["--fluid", "GC", "--production"]]


@pytest.mark.parametrize("argv", PRESETS, ids=["none", "production", "production-b64",
                                               "drawdown", "production-drawdown",
                                               "gc-production"])
def test_cli_presets_match_the_reference(monkeypatch, argv):
    """``train``'s presets give the case builder and the trainer what the
    JAX package's ``cmd_train`` gives them (srm_tpu/__main__.py:31-64): the
    fluid, the general config, the drawdown case's Pi and BHP floor, the
    batch and the optimizer configs. Two of the reference's behaviours are
    kept and pinned (ROADMAP C7): ``--production`` scales the decay to its
    batch (62 steps at 128, 125 at ``--batch-size 64``), and with
    ``--production --drawdown`` the drawdown schedule (250 steps) replaces
    the batch-scaled one, at batch 128 (ADVICE r5)."""
    want = _capture_jax_train(monkeypatch, argv)
    got = _capture_port_train(monkeypatch, argv)
    assert got["fluid"] == want["fluid"]
    assert got["setup"]["general_config"] == want["setup"]["general_config"]
    for k in ("pi", "min_bhp", "nx", "n_realizations", "base_dir"):
        assert got["setup"].get(k) == want["setup"].get(k), k
    for k in ("training_batch_size", "epochs", "checkpoint_dir", "resume"):
        assert got["train"][k] == want["train"][k], k
    assert got["train"]["optimizer_configs"] == want["train"]["optimizer_configs"]
    from test_torch_config import _decay_steps
    opt, g = got["train"]["optimizer_configs"], got["setup"]["general_config"]
    if argv == ["--production"]:
        assert _decay_steps(opt) == {62} and g["training_batch_size"] == 128
    if argv == ["--production", "--batch-size", "64"]:
        assert _decay_steps(opt) == {125}
    if argv == ["--production", "--drawdown"]:
        assert _decay_steps(opt) == {250} and g["training_batch_size"] == 128
        assert g["compute_dtype"] == "bfloat16" and g["physics_mode_fraction"] == 0.5


def test_cli_train_production_on_the_cpu(tmp_path, capsys):
    """``train --production`` at 9×9 for one epoch: batch 128, which
    ``Trainer.stage_dataset`` clamps to the 102-sample train split."""
    from srm_tpu_torch.__main__ import main
    assert main(["train", "--production", "--nx", "9", "--realizations", "6", "--epochs", "1",
                 "--device", "cpu", "--base-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "device: cpu" in out and "Epoch 1/1" in out
    loss = float(out.split("final total train loss:")[1].split()[0])
    assert np.isfinite(loss) and loss > 0


def test_cli_drawdown_train_predict_export_on_the_cpu(tmp_path, capsys):
    """``train --drawdown`` → ``predict --drawdown`` → ``export
    --drawdown`` → ``load_surrogate`` at 9×9: the predict and export
    commands rebuild the drawdown case (Pi 4300) from train's cache and
    restore its checkpoint, including the ``abs`` saturation head; the
    served bundle gives the predicted rollout."""
    from srm_tpu_torch.__main__ import main
    from srm_tpu_torch.eval import load_surrogate
    flags = ["--drawdown", "--nx", "9", "--realizations", "6", "--device", "cpu",
             "--base-dir", str(tmp_path / "data"), "--checkpoint-dir", str(tmp_path / "ckpt")]
    assert main(["train", *flags, "--epochs", "1"]) == 0
    npz = tmp_path / "rollout.npz"
    assert main(["predict", *flags, "--out", str(npz), "--times", "0,30,365",
                 "--max-realizations", "2"]) == 0
    assert main(["export", *flags, "--out-dir", str(tmp_path / "bundle"),
                 "--platforms", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("restored checkpoint step 1 (pressure, time_step, saturation_model)") == 2
    with np.load(npz) as z:
        p, sg = z["pressure"], z["saturation"]
    assert p.shape == sg.shape == (2, 3, 1, 9, 9)
    assert np.all(p[:, 0] == 4300.0) and np.allclose(sg[:, 0], 0.78)
    assert sg.max() <= 0.78 + 1e-6 and sg.min() >= 0.0
    from srm_tpu_torch.examples.common import setup_case
    case = setup_case("GC", base_dir=str(tmp_path / "data"), nx=9, n_realizations=6,
                      general_config=tcfg.apply_drawdown_overrides(tcfg.DEFAULT_GENERAL_CONFIG),
                      device="cpu", **tcfg.GC_DRAWDOWN_CASE)
    assert case["models"]["saturation_model"].hard_layer.input_activation is torch.abs
    permx = case["processor"].generate_kle_splits()["test"][:2]
    times = np.tile(np.array([0.0, 30.0, 365.0], np.float32), 2)
    srv = load_surrogate(str(tmp_path / "bundle"), device="cpu")
    for field, want in (("pressure", p), ("saturation", sg)):
        got = srv(field, np.repeat(permx, 3, axis=0), times).reshape(want.shape)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_bf16_networks_serve_on_the_cpu(tmp_path):
    """The predictor and the ``torch.export`` bundle take bfloat16-compute
    networks as they are: the bundle's program traces the per-layer casts,
    its output is float32 and within 1e-5 of the predictor's (the same
    operations; the bundle normalizes on the device, the predictor on the
    host); and the bfloat16 rollout lies within 5% of the drawdown from the
    float32 network's rollout on the same weights, not on it."""
    from srm_tpu_torch.eval import SRMPredictor, export_surrogate, load_surrogate
    from srm_tpu_torch.examples.common import setup_case
    g = tcfg.apply_production_overrides(tcfg.DEFAULT_GENERAL_CONFIG)
    case = setup_case("DG", base_dir=str(tmp_path), nx=9, n_realizations=6,
                      general_config=g, device="cpu")
    models = case["models"]
    assert models["pressure"].network.cdt == torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        # as tests/test_torch_predictor.py::perturbed: seeded noise on every
        # weight and the output projection times 1e4, so the rollout leaves Pi
        for q in models["pressure"].parameters():
            q.add_(0.02 * torch.randn(q.shape, generator=gen))
        head = models["pressure"].network.output_proj
        head.weight.mul_(1e4)
        head.bias.mul_(1e4)
    args = (case["data_summary"], g, case["processor"].reservoir_config)
    pred = SRMPredictor(models, *args, batch_size=8)
    permx = case["processor"].generate_kle_splits()["test"][:2]
    times = [0.0, 30.0, 180.0]
    p = pred.predict_pressure(permx, times)
    assert p.dtype == np.float32 and np.isfinite(p).all()
    export_surrogate(pred, str(tmp_path / "bundle"), platforms=("cpu",))
    srv = load_surrogate(str(tmp_path / "bundle"), device="cpu")
    served = srv("pressure", np.repeat(permx, 3, axis=0), np.tile(np.float32(times), 2))
    assert served.dtype == np.float32
    np.testing.assert_allclose(served.reshape(p.shape), p, rtol=1e-5, atol=0)
    f32 = copy.deepcopy(models["pressure"])
    f32.network.cdt = f32.network.cdt_io = None
    p32 = SRMPredictor({"pressure": f32}, *args, batch_size=8).predict_pressure(permx, times)
    drop = np.abs(p32 - 5000.0).max()
    assert drop > 1.0 and 0 < np.abs(p - p32).max() <= 0.05 * drop


@pytest.mark.parametrize("preset", ["production", "drawdown"])
@pytest.mark.parametrize("role", ["pressure", "time_step", "saturation"])
def test_preset_schedules_equal_optax(preset, role):
    """The trainer's optimizers need nothing new for the presets: built from
    ``production_optimizer_configs(batch_size=128)`` (62 decay steps) or
    ``drawdown_optimizer_configs()`` (250), their float32 device-tensor
    learning rate equals optax's ``exponential_decay`` of the same config
    bit for bit over 300 steps, as tests/test_torch_trainer.py holds the
    default schedules."""
    import optax

    from srm_tpu_torch.training.optimizers import build_optimizer_from_config
    cfgs = (tcfg.production_optimizer_configs(batch_size=128) if preset == "production"
            else tcfg.drawdown_optimizer_configs())
    cfg = cfgs[role]
    lr = cfg["exponential_decay"]["learning_rate"]
    assert lr["decay_steps"] == (62 if preset == "production" else 250)
    sched = jax.jit(optax.exponential_decay(cfg["learning_rate"], lr["decay_steps"],
                                            lr["decay_rate"],
                                            staircase=cfg["exponential_decay"].get("staircase",
                                                                                  False)))
    opt = build_optimizer_from_config([torch.zeros(3)], cfg)
    for k in range(301):
        opt.count.fill_(k)
        got = opt.schedules()["lr"].numpy()
        assert got.dtype == np.float32 and got == np.asarray(sched(jnp.asarray(k, jnp.int32))), k


def test_trainer_takes_batches_of_128(tmp_path):
    """At 20 realizations the 9×9 train split holds 306 samples: the trainer
    stages it as two batches of 128 (the ragged 50 dropped, a different
    subset each epoch) and trains the production case's bfloat16 networks
    on them."""
    from srm_tpu_torch.examples.common import setup_case
    from srm_tpu_torch.training.trainer import Trainer
    case = setup_case("DG", base_dir=str(tmp_path), nx=9, n_realizations=20, device="cpu",
                      general_config=tcfg.apply_production_overrides(tcfg.DEFAULT_GENERAL_CONFIG))
    trainer = Trainer(case["loss_fn"],
                      optimizer_configs=tcfg.production_optimizer_configs(batch_size=128))
    assert trainer.stage_dataset("train", case["train_groups"], 128) == (2, 306)
    before = [p.detach().clone() for p in case["models"]["pressure"].parameters()]
    m = trainer.train_epoch_resident("train")
    assert m["total"].shape == (2,) and np.isfinite(m["total"]).all()
    assert all(int(o.count) == 2 for o in trainer.optimizers.values())
    assert not all(torch.equal(a, b) for a, b in
                   zip(before, case["models"]["pressure"].parameters()))


def test_rmse_experiment_takes_the_ported_flags(tmp_path, capsys):
    """``rmse_experiment train`` accepts the reference's knob flags, builds
    the case with them (bf16 networks with the mixed policy, the strided Δt
    input, the mixed mode with every split labelled, the td scalings, the
    oil-phase td weight, the ``abs`` rectifier) and writes each under the
    reference's JSON key."""
    import json

    from srm_tpu_torch.tools import rmse_experiment
    rmse_experiment.main([
        "train", "--fluid", "GC", "--nx", "9", "--realizations", "6", "--epochs", "1",
        "--device", "cpu", "--base-dir", str(tmp_path), "--pi", "4300", "--min-bhp", "2000",
        "--bf16", "--precision", "mixed", "--dt-stride", "2", "--physics-fraction", "0.5",
        "--td-norm", "balance", "--sg-focus", "8", "--sg-td-weight", "2", "--sat-act", "abs"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {k: line[k] for k in ("bf16", "precision", "dt_stride", "physics_fraction", "td_norm",
                                 "sg_focus", "sg_td_weight", "sat_act", "width", "pad")} == {
        "bf16": True, "precision": "mixed", "dt_stride": 2, "physics_fraction": 0.5,
        "td_norm": "balance", "sg_focus": 8.0, "sg_td_weight": 2.0, "sat_act": "abs",
        "width": None, "pad": None}
    (rec,) = line["trajectory"]
    assert np.isfinite(rec["rmse_psia"]) and np.isfinite(rec["rmse_sg"])
    assert 0 < line["rmse_predict_sgi"] < 0.78
