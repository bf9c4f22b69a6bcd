"""The JAX package's last production knobs in the port (ROADMAP A10):
``spatial_pad_to``, ``network_width`` and ``remat_forwards``, against the
JAX package on the same weights and inputs, and ``rmse_experiment --width
--pad``.

* ``spatial_pad_to=48``: Model 1's encoder–decoder and Model 2's residual
  net, 2D (9×9) and 3D (9×9×9), padded to 48×48 in height and width: the
  outputs match flax's at the networks' tolerance (RTOL, as
  tests/test_torch_nn_3d.py) on the true grid.
* ``network_width=64``: Models 1 and 1S take 64 bottom channels (Model 2
  keeps its 32); the flax parameters load into the wider layers and the
  outputs match.
* ``remat_forwards``: on the CPU the port's loss and every model's
  gradient are bitwise the same with and without the recompute, in
  float32 and bfloat16, on DG 2D (9×9) and DG 3D (9×9×9); and they match
  the JAX package's remat run at the slices' tolerances (float32) or
  within twice the JAX package's own bfloat16 distance from its float32
  run (bfloat16, as tests/test_torch_production.py holds the bf16
  networks).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srm_tpu.config import DEFAULT_GENERAL_CONFIG, DEFAULT_RESERVOIR_CONFIG
from srm_tpu.examples.common import setup_case as jax_setup_case
from srm_tpu.nn import modules as jmod
from srm_tpu_torch.data.batching import collapse_groups
from srm_tpu_torch.examples.common import setup_case
from srm_tpu_torch.nn import modules as tmod
from srm_tpu_torch.nn.convert import load_flax_params
from test_torch_slice import _j, _rel, _t

# float32 convolutions in two libraries (XLA vs oneDNN) sum in another
# order: ~1e-6 relative through the networks (tests/test_torch_nn_3d.py)
RTOL = 1e-4
PAD = 48


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def _configs(nz, **knobs):
    res = copy.deepcopy(DEFAULT_RESERVOIR_CONFIG)
    res["Nx"] = res["Ny"] = 9
    res["Nz"] = nz
    g = copy.deepcopy(DEFAULT_GENERAL_CONFIG)
    g.update(knobs)
    return g, res


@functools.lru_cache(maxsize=None)
def _models(nz, knobs):
    """(flax models, their params, the port's models with those weights)
    for Models 1, 2 and 1S on a 9×9 (nz = 1) or 9×9×9 grid under the
    general-config ``knobs``; the tests only read them."""
    g, res = _configs(nz, **dict(knobs))
    shape = (1, nz, 9, 9, 5) if nz > 1 else (1, 9, 9, 5)
    sample = jnp.zeros((1,) + shape, jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    jm = {"pressure": jmod.build_pressure_model(general_config=g, reservoir_config=res),
          "time_step": jmod.build_time_step_model(general_config=g, reservoir_config=res),
          "saturation_model": jmod.build_saturation_model(general_config=g,
                                                          reservoir_config=res)}
    params = {k: m.init(key, sample) for (k, m), key in zip(jm.items(), keys)}
    tm = {"pressure": tmod.build_pressure_model(shape, g, res),
          "time_step": tmod.build_time_step_model(shape, g),
          "saturation_model": tmod.build_saturation_model(shape, g, res)}
    load_flax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


def _x(nz, B=2, seed=1):
    shape = (B, 1, nz, 9, 9, 5) if nz > 1 else (B, 1, 9, 9, 5)
    x = np.random.RandomState(seed).uniform(-1, 1, shape).astype(np.float32)
    x[0, ..., 3] = -1.0                                   # first sample at t0
    return x


def _assert_outputs_match(jm, params, tm, name, nz):
    x = _x(nz)
    want = np.asarray(jm[name].apply(params[name], jnp.asarray(x)))
    with torch.no_grad():
        got = tm[name](torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == x.shape[:-1] + (1,)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    if name != "time_step":
        # the backbone alone, not hidden behind the HardLayer's offset
        net = np.asarray(jm[name].network.apply(
            {"params": params[name]["params"]["network"]}, jnp.asarray(x)))
        with torch.no_grad():
            tnet = tm[name].network(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(tnet, net, rtol=RTOL, atol=RTOL * np.abs(net).max())


@pytest.mark.parametrize("nz", [1, 9], ids=["2d", "3d"])
@pytest.mark.parametrize("name", ["pressure", "time_step"])
def test_spatial_pad_matches_flax(name, nz):
    """Padded to 48×48 the networks compute another function than unpadded
    (the zeros enter every convolution's edge) and match flax's padded one;
    the port's network runs at 48×48 inside and returns the 9×9 grid."""
    from unittest import mock

    from srm_tpu_torch.nn import common, encoder_decoder, residual
    jm, params, tm = _models(nz, (("spatial_pad_to", PAD),))
    assert tm[name].network.spatial_pad_to == PAD
    seen = []

    def apply_layer(layer, h, dtype=None):
        seen.append(tuple(h.shape[-2:]))
        return common.apply_layer(layer, h, dtype)

    with mock.patch.object(encoder_decoder, "apply_layer", apply_layer), \
            mock.patch.object(residual, "apply_layer", apply_layer):
        _assert_outputs_match(jm, params, tm, name, nz)
    # the first layer runs on the padded grid, the head on the true one
    assert seen[0] == (PAD, PAD) and seen[-1] == (9, 9)
    _, _, plain = _models(nz, ())
    x = torch.from_numpy(_x(nz))
    with torch.no_grad():
        unpadded = copy.deepcopy(plain[name])
        unpadded.load_state_dict(tm[name].state_dict())
        assert not torch.allclose(unpadded.network(x), tm[name].network(x), rtol=1e-3)


@pytest.mark.parametrize("nz", [1, 9], ids=["2d", "3d"])
def test_network_width_sets_the_encoder_decoders(nz):
    """``network_width=64``: the bottom width of Models 1 and 1S (filters
    64, 96, 144, 216), not of Model 2; every parameter takes flax's shape
    and the outputs match."""
    jm, params, tm = _models(nz, (("network_width", 64),))
    for name in ("pressure", "saturation_model"):
        convs = tm[name].network.enc_convs
        assert [c.out_channels for c in convs] == [64, 96, 144, 216]
        flax_shapes = sorted(np.asarray(a).size for a in
                             jax.tree_util.tree_leaves(params[name]["params"]["network"]))
        assert sorted(p.numel() for p in tm[name].network.parameters()) == flax_shapes
        _assert_outputs_match(jm, params, tm, name, nz)
    assert tm["time_step"].network.blocks[0].layer1.out_channels == 32


REMAT = {"dg2d-f32": ({}, None), "dg3d-f32": (dict(nz=9, kle_method="uncorrelated"), None),
         "dg2d-bf16": ({}, "bfloat16"),
         "dg3d-bf16": (dict(nz=9, kle_method="uncorrelated"), "bfloat16")}


@functools.lru_cache(maxsize=None)
def _remat_case(name, tmp):
    """Both packages' DG case (9×9 or 9×9×9, 6 realizations, tde weight 0)
    with ``remat_forwards`` on, the port's models carrying the JAX
    package's weights; a batch away from t0; the JAX package's gradients
    of its remat run."""
    kw, dtype = REMAT[name]
    g = copy.deepcopy(DEFAULT_GENERAL_CONFIG)
    g["default_weights"]["gas"]["tde"] = 0.0
    g["remat_forwards"] = True
    g["compute_dtype"] = dtype
    kw = dict(nx=9, n_realizations=6, general_config=g, **kw)
    jcase = jax_setup_case("DG", base_dir=f"{tmp}/jax_{name}", **kw)
    tcase = setup_case("DG", base_dir=f"{tmp}/torch_{name}", device="cpu", **kw)
    load_flax_params(tcase["models"], jax.tree_util.tree_map(np.asarray, jcase["params"]))
    assert jcase["loss_fn"].remat_forwards and tcase["loss_fn"].remat_forwards
    x_all, y_all = collapse_groups(jcase["train_groups"])
    b = [5, 30, 64, 101]
    batch = (x_all[b], {k: v[b] for k, v in y_all.items()})
    aux_j, grads_j, total_j = jax.jit(jcase["loss_fn"].pinn_batch_sse_grad)(
        jcase["params"], *_j(batch))
    holder = {k: copy.deepcopy(tcase["models"][k]) for k in ("pressure", "time_step")}
    load_flax_params(holder, jax.tree_util.tree_map(np.asarray, grads_j))
    grads_j = {k: [p.detach() for p in m.parameters()] for k, m in holder.items()}
    terms_j = {t: float(v) for t, v in aux_j["gas"].items()}
    return tcase, batch, (float(total_j), terms_j, grads_j)


@pytest.fixture(scope="module")
def remat_tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("remat"))


def _port_run(lf, batch, remat):
    lf = copy.copy(lf)
    lf.remat_forwards = remat
    aux, grads, total = lf.pinn_batch_sse_grad(*_t(batch))
    return (total.detach(), {t: v.detach() for t, v in aux["gas"].items()},
            {k: [g.detach() for g in v] for k, v in grads.items()})


@pytest.mark.parametrize("name", list(REMAT))
def test_remat_is_bitwise_the_step_without_it(name, remat_tmp):
    """The recompute repeats the forward, its bfloat16 casts included, on
    the same values: the loss, every term and every gradient are the same
    bits with and without it; and with it the forwards do run again in the
    backward pass (each model's forward is seen twice per evaluation)."""
    tcase, batch, _ = _remat_case(name, remat_tmp)
    lf = tcase["loss_fn"]
    calls = []
    hooks = [lf.models[k].network.register_forward_pre_hook(lambda *a, k=k: calls.append(k))
             for k in ("pressure", "time_step")]
    try:
        on = _port_run(lf, batch, True)
        counted = list(calls)
        calls.clear()
        off = _port_run(lf, batch, False)
    finally:
        for h in hooks:
            h.remove()
    assert counted.count("pressure") == 2 * calls.count("pressure") == 2
    assert counted.count("time_step") == 2 * calls.count("time_step") == 4
    assert torch.equal(on[0], off[0])
    assert all(torch.equal(on[1][t], off[1][t]) for t in off[1])
    for k in off[2]:
        assert all(torch.equal(a, b) for a, b in zip(on[2][k], off[2][k])), k


@pytest.mark.parametrize("name", ["dg2d-f32", "dg3d-f32"])
def test_remat_matches_the_reference_in_float32(name, remat_tmp):
    """Against the JAX package's remat run, at the slices' tolerances: every
    term and the total at rtol 1e-3; Model 1's gradient within twice the
    reference's own distance from the port's float64 gradient plus 1e-3
    (tests/test_torch_slice_3d.py); Model 2's, float32 noise (ROADMAP C2),
    finite."""
    tcase, batch, (total_j, terms_j, grads_j) = _remat_case(name, remat_tmp)
    total, terms, grads = _port_run(tcase["loss_fn"], batch, True)
    for t, v in terms_j.items():
        np.testing.assert_allclose(float(terms[t]), v, rtol=1e-3, atol=1e-6 * total_j,
                                   err_msg=t)
    np.testing.assert_allclose(float(total), total_j, rtol=1e-3)
    lf64 = copy.copy(tcase["loss_fn"])
    lf64.models = {**lf64.models, **{k: copy.deepcopy(lf64.models[k]).double()
                                     for k in ("pressure", "time_step", "pvt_model")}}
    x, y = _t(batch)
    _, g64, _ = lf64.pinn_batch_sse_grad(x.double(), {k: v.double() for k, v in y.items()})
    ref_err = _rel(grads_j["pressure"], g64["pressure"])
    assert _rel(grads["pressure"], grads_j["pressure"]) <= 2 * ref_err + 1e-3
    assert all(torch.isfinite(g).all() for g in grads["time_step"])


@pytest.mark.parametrize("dim", ["dg2d", "dg3d"])
def test_remat_matches_the_reference_in_bfloat16(dim, remat_tmp):
    """Against the JAX package's bfloat16 remat run: the total at rtol 1e-3
    as in float32 (at these weights it is the well rates' and tank
    balances' sum, which the networks' precision does not reach), and
    Model 1's gradient within twice the JAX package's own distance between
    its bfloat16 and float32 runs plus 1e-3, as tests/test_torch_production.py
    holds the bf16 networks."""
    tcase, batch, (total_j, _, grads_j) = _remat_case(f"{dim}-bf16", remat_tmp)
    _, _, (_, _, grads_32) = _remat_case(f"{dim}-f32", remat_tmp)
    total, _, grads = _port_run(tcase["loss_fn"], batch, True)
    assert tcase["models"]["pressure"].network.cdt == torch.bfloat16
    np.testing.assert_allclose(float(total), total_j, rtol=1e-3)
    own = _rel(grads_j["pressure"], grads_32["pressure"])
    assert own > 0, "the JAX package's bf16 gradient equals its f32 gradient"
    err = _rel(grads["pressure"], grads_j["pressure"])
    assert err <= 2 * own + 1e-3, f"port {err:.3e} from bf16, bf16 {own:.3e} from f32"


def test_rmse_experiment_takes_width_and_pad(tmp_path, capsys):
    """``--width 64 --pad 48`` parse, reach the case's networks and the JSON
    line, as the reference's flags do (tools/rmse_experiment.py:84-86)."""
    import json

    from srm_tpu_torch.tools import rmse_experiment
    rmse_experiment.main(["train", "--fluid", "DG", "--nx", "9", "--realizations", "6",
                          "--epochs", "0", "--device", "cpu", "--width", "64", "--pad", "48",
                          "--base-dir", str(tmp_path)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (line["width"], line["pad"]) == (64, 48)
    case = rmse_experiment.build_case(nx=9, realizations=6, device="cpu",
                                      base_dir=str(tmp_path), width=64, pad=48)
    m = case["models"]
    assert m["pressure"].network.enc_convs[0].out_channels == 64
    assert m["time_step"].network.blocks[0].layer1.out_channels == 32
    assert {m[k].network.spatial_pad_to for k in ("pressure", "time_step")} == {48}
