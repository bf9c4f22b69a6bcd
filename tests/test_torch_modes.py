"""The loss's modes and knobs of the port against the JAX package's, on the
CPU: data mode (``physics_mode_fraction`` 0), the mixed mode (0.5), the
td error scalings (``td_loss_normalization`` "balance" and "label_std"),
the Sg dropout focus (``sg_td_focus``) and Model 2 on a strided input
(``dt_input_stride`` 2), in dry gas 2D (9×9), gas condensate (9×9) and dry
gas 3D (9×9×9); then the drawdown dataset (every split labelled by the
simulator; its config hash: tests/test_torch_config.py).

Both packages run the same weights (``load_flax_params``) on the same batch
and the same numpy labels, their knobs set on copies of the loss objects.
As in ``tests/test_torch_slice*.py`` the ``tde`` weight is 0 (its float32
noise dominates Model 2's gradient, ROADMAP C1, C2), and the tolerances are
theirs: every weighted term and the total within 1e-3 relative (atol 1e-6
of the total); in 2D every model's gradient within 1e-3 relative; in 3D
Model 1's within GRAD_3D (twice the reference's measured 1e-2 distance from
float64, plus 1e-3) and Model 2's within 5e-2 (its float32 gradient is
rounding noise that both packages round alike, C2).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srm_tpu.config as jcfg
import srm_tpu_torch.config as tcfg
from srm_tpu.examples.common import setup_case as jax_setup_case
from srm_tpu_torch.data.batching import collapse_groups
from srm_tpu_torch.examples.common import setup_case
from srm_tpu_torch.nn.convert import load_flax_params

BATCH = [0, 1, 40, 77]                 # t0 samples among others
GRAD_3D = 2 * 1e-2 + 1e-3
MODELS = {"pressure": "pressure", "time_step": "time_step", "saturation": "saturation_model"}

# each knob as the attributes it sets on both packages' loss objects
VARIANTS = {
    "stride": dict(dt_input_stride=2),
    "data": dict(physics_mode_fraction=0.0),
    "mixed": dict(physics_mode_fraction=0.5),
    "balance": dict(physics_mode_fraction=0.5, td_normalization="balance"),
    "label_std": dict(physics_mode_fraction=0.5, td_normalization="label_std"),
    "focus": dict(physics_mode_fraction=0.5, td_normalization="balance", sg_td_focus=8.0),
}
# "balance" and the focus act on a second label (Sg): gas condensate only
CASES = ([("DG", v) for v in ("stride", "data", "mixed", "label_std")]
         + [("GC", v) for v in VARIANTS] + [("DG3D", v) for v in ("stride", "mixed")])


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def _labels(y_like, fluid, seed=3):
    """Numpy labels shaped as the batch's: pressures 0–300 psia below Pi,
    and for gas condensate Sg up to 0.2 below Sgi with a third of the cells
    at Sgi (no dropout there, which the focus weights apart)."""
    rng = np.random.RandomState(seed)
    p = y_like["PRESSURE"]
    out = {"PRESSURE": (5000.0 - rng.uniform(0.0, 300.0, p.shape)).astype(np.float32)}
    if fluid == "GC":
        sg = 0.78 - rng.uniform(0.0, 0.2, p.shape)
        sg[rng.uniform(size=p.shape) < 1 / 3] = 0.78
        out["SGAS"] = sg.astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _built(fluid):
    """Both packages' case (DG 9×9, GC 9×9 or DG 9×9×9, 6 realizations,
    tde weight 0) with the same weights, one batch and its numpy labels."""
    import tempfile
    kw = dict(nx=9, n_realizations=6)
    if fluid == "DG3D":
        kw.update(nz=9, kle_method="uncorrelated")
    name = "GC" if fluid == "GC" else "DG"
    g = copy.deepcopy(jcfg.DEFAULT_GENERAL_CONFIG)
    for ph in ("gas", "oil"):
        g["default_weights"][ph]["tde"] = 0.0
    jcase = jax_setup_case(name, base_dir=tempfile.mkdtemp(prefix="jax_modes_"),
                           general_config=g, **kw)
    tcase = setup_case(name, base_dir=tempfile.mkdtemp(prefix="torch_modes_"),
                       general_config=g, device="cpu", **kw)
    load_flax_params(tcase["models"], jax.tree_util.tree_map(np.asarray, jcase["params"]))
    x_all, y_all = collapse_groups(jcase["train_groups"])
    x = x_all[BATCH]
    y = _labels({k: v[BATCH] for k, v in y_all.items()}, name)
    return dict(jcase=jcase, tcase=tcase, x=x, y=y)


def _losses(fluid, variant):
    """Copies of both packages' losses with the variant's knobs set."""
    b = _built(fluid)
    jlf, tlf = copy.copy(b["jcase"]["loss_fn"]), copy.copy(b["tcase"]["loss_fn"])
    for k, v in VARIANTS[variant].items():
        setattr(jlf, k, v)
        setattr(tlf, k, v)
    return jlf, tlf


@functools.lru_cache(maxsize=None)
def _results(fluid, variant):
    """(JAX aux, grads in the port's layout, total; the port's aux, grads,
    total) on the case's batch."""
    b = _built(fluid)
    jlf, tlf = _losses(fluid, variant)
    aux_j, grads_j, total_j = jax.jit(jlf.pinn_batch_sse_grad)(
        b["jcase"]["params"], jnp.asarray(b["x"]), {k: jnp.asarray(v) for k, v in b["y"].items()})
    aux_t, grads_t, total_t = tlf.pinn_batch_sse_grad(
        torch.from_numpy(b["x"]), {k: torch.from_numpy(v) for k, v in b["y"].items()})
    aux_t = {ph: {t: v.detach() for t, v in terms.items()} for ph, terms in aux_t.items()
             if ph != "outputs"}
    keys = [k for k in MODELS if k in grads_t]
    holder = {MODELS[k]: copy.deepcopy(b["tcase"]["models"][MODELS[k]]) for k in keys}
    load_flax_params(holder, {MODELS[k]: jax.tree_util.tree_map(np.asarray, grads_j[k])
                              for k in keys})
    grads_j = {k: [p.detach() for p in holder[MODELS[k]].parameters()] for k in keys}
    return (aux_j, grads_j, float(total_j)), (aux_t, grads_t, float(total_t.detach()))


def _rel(got, want):
    num = torch.sqrt(sum(((g.double() - w.double()) ** 2).sum() for g, w in zip(got, want)))
    den = torch.sqrt(sum((w.double() ** 2).sum() for w in want))
    return float(num / den)


@pytest.mark.parametrize("fluid,variant", CASES, ids=[f"{f}-{v}" for f, v in CASES])
def test_loss_terms_match(fluid, variant):
    (aux_j, _, total_j), (aux_t, _, total_t) = _results(fluid, variant)
    phases = [ph for ph in ("gas", "oil") if ph in aux_j]
    assert phases == [ph for ph in ("gas", "oil") if ph in aux_t]
    for ph in phases:
        assert set(aux_t[ph]) == set(aux_j[ph])
        for term, v in aux_j[ph].items():
            np.testing.assert_allclose(float(aux_t[ph][term]), float(v), rtol=1e-3,
                                       atol=1e-6 * total_j, err_msg=f"{ph}/{term}")
    np.testing.assert_allclose(total_t, total_j, rtol=1e-3)
    td = float(aux_t["gas"]["td"])
    assert (td > 0) == (variant != "stride"), f"td term {td} in {variant}"


@pytest.mark.parametrize("fluid,variant", CASES, ids=[f"{f}-{v}" for f, v in CASES])
def test_per_model_gradients_match(fluid, variant):
    (_, grads_j, _), (_, grads_t, _) = _results(fluid, variant)
    for key, gj in grads_j.items():
        gt = grads_t[key]
        assert all(torch.isfinite(g).all() for g in gt)
        if key == "time_step" and variant == "data":
            # data mode leaves Model 2 out of the loss: zero in both packages
            assert all(float(g.abs().max()) == 0 for g in gt + gj)
            continue
        bound = (1e-3 if fluid != "DG3D" else GRAD_3D if key == "pressure" else 5e-2)
        rel = _rel(gt, gj)
        assert rel <= bound, f"{key}: relative gradient error {rel:.2e} (bound {bound})"


@pytest.mark.parametrize("fluid", ["DG", "GC", "DG3D"])
def test_strided_time_step_means_match(fluid):
    """The per-sample Δt on x and on x1 (Model 2's spatial means) with
    ``dt_input_stride`` 2, as in tests/test_torch_nn.py within 1e-4."""
    b = _built(fluid)
    jlf, tlf = _losses(fluid, "stride")
    params, x = b["jcase"]["params"], jnp.asarray(b["x"])

    @jax.jit
    def jax_tsteps(params, x):
        # the reference's two evaluations (srm_tpu/losses/physics_loss.py:511-516)
        mean = lambda f: jnp.mean(f, axis=tuple(range(1, f.ndim - 1)), keepdims=True)  # noqa: E731
        t1 = mean(jlf._net("time_step", params, x))
        x1 = x.at[..., 3:4].add(jnp.broadcast_to(jlf._norm_dt(t1), x[..., 3:4].shape))
        return t1, mean(jlf._net("time_step", params, x1))

    want = jax_tsteps(params, x)
    with torch.no_grad():
        res_t = tlf.residuals(torch.from_numpy(b["x"]))
        unstrided = b["tcase"]["loss_fn"].residuals(torch.from_numpy(b["x"]))["outputs"]["tstep"]
    for k, w in zip(("tstep", "tstep2"), want):
        got, w = res_t["outputs"][k].numpy(), np.asarray(w)
        assert got.shape == w.shape == (len(BATCH),) + (1,) * (w.ndim - 1)
        np.testing.assert_allclose(got, w, rtol=1e-4, err_msg=k)
    assert not np.allclose(res_t["outputs"]["tstep"].numpy(), unstrided.numpy(), rtol=1e-6)


@pytest.mark.parametrize("fluid", ["DG", "DG3D"])
def test_stride_touches_height_and_width_only(fluid):
    """Model 2 sees ``x[..., ::2, ::2, :]`` of the channels-last input, on
    both of its evaluations: the height and width strided, never the depth,
    the time axis or the channels."""
    b = _built(fluid)
    _, tlf = _losses(fluid, "stride")
    seen = []
    net = tlf.models["time_step"]

    def spy(x):
        seen.append(x)
        return net(x)

    tlf.models = {**tlf.models, "time_step": spy}
    x = torch.from_numpy(b["x"])
    with torch.no_grad():
        tlf.residuals(x)
    assert len(seen) == 2
    assert torch.equal(seen[0], x[..., ::2, ::2, :])
    want = x.shape[:-3] + (5, 5) + x.shape[-1:]
    assert all(tuple(s.shape) == tuple(want) for s in seen)
    assert torch.equal(seen[1][..., :3], x[..., ::2, ::2, :3])     # only time moved


def test_label_std_is_ddof0():
    """``jnp.std`` is the population std (ddof 0); torch's default divides
    by N − 1. On this batch (4 × 81 cells per label) the two put the
    label_std td terms 1/N = 3.1e-3 apart, three times the 1e-3 tolerance
    within which the port matches the reference."""
    (aux_j, _, _), (aux_t, _, _) = _results("GC", "label_std")
    n = _built("GC")["y"]["PRESSURE"].size
    assert 1.0 / n > 3e-3
    for ph in ("gas", "oil"):
        np.testing.assert_allclose(float(aux_t[ph]["td"]), float(aux_j[ph]["td"]), rtol=1e-3)


@pytest.mark.parametrize("fluid", ["DG", "GC"])
def test_data_mode_defaults_the_td_weight_and_skips_the_residual(fluid, monkeypatch):
    """In data mode (f = 0) a td weight of 0 counts as 1, each td term is
    the plain mean square of its error, every physics term is 0, and no
    residual (and so no stencil) is evaluated; in the mixed mode (f = 0.5)
    the td weight, 0 taken as 1, is 1 − f."""
    b = _built(fluid)
    x = torch.from_numpy(b["x"])
    y = {k: torch.from_numpy(v) for k, v in b["y"].items()}
    _, tlf = _losses(fluid, "data")
    assert tlf.weights["gas"]["td"] == 0.0

    def refuse(*a):
        raise AssertionError("data mode evaluated the residual")

    monkeypatch.setattr(tlf, "residuals", refuse)
    with torch.no_grad():
        total, aux = tlf.loss_and_metrics(x, y)
        p0 = tlf.models["pressure"](x)
    want = float(torch.mean(torch.square(p0 - y["PRESSURE"].reshape(p0.shape))))
    np.testing.assert_allclose(float(aux["gas"]["td"]), want, rtol=1e-6)
    assert all(float(v) == 0.0 for t, v in aux["gas"].items() if t != "td")
    monkeypatch.undo()
    _, mixed = _losses(fluid, "mixed")
    with torch.no_grad():
        _, aux_m = mixed.loss_and_metrics(x, y)
    np.testing.assert_allclose(float(aux_m["gas"]["td"]), 0.5 * want, rtol=1e-5)


# -- the drawdown dataset ----------------------------------------------------------
@pytest.fixture(scope="module")
def drawdown_cases(tmp_path_factory):
    """Both packages' 9×9 drawdown case (the drawdown recipe's config at
    GC_DRAWDOWN_CASE, 6 realizations): mixed mode with simulator labels."""
    kw = dict(nx=9, n_realizations=6, **jcfg.GC_DRAWDOWN_CASE)
    jcase = jax_setup_case("GC", base_dir=str(tmp_path_factory.mktemp("jax_dd")),
                           general_config=jcfg.apply_drawdown_overrides(
                               jcfg.DEFAULT_GENERAL_CONFIG), **kw)
    tcase = setup_case("GC", base_dir=str(tmp_path_factory.mktemp("torch_dd")),
                       general_config=tcfg.apply_drawdown_overrides(tcfg.DEFAULT_GENERAL_CONFIG),
                       device="cpu", **kw)
    return jcase, tcase


@pytest.mark.parametrize("split", ["train", "test", "pred"])
def test_drawdown_dataset_labels_every_split(drawdown_cases, split):
    """In mixed mode the simulator labels every split (the reference's
    ``srm_tpu/data/dataset.py:217-243``), the train split included: the
    port's labels within tests/test_torch_sim_gc.py's bounds of the JAX
    package's (0.1 psia, Sg 1e-3), below the dew point (condensate drops
    out), and the label statistics come from them."""
    from test_torch_sim import PSIA_TOL
    from test_torch_sim_gc import SG_TOL
    jcase, tcase = drawdown_cases
    (jx, jy), = jcase[f"{split}_groups"]
    (tx, ty), = tcase[f"{split}_groups"]
    np.testing.assert_allclose(tx, jx, rtol=1e-6, atol=1e-6)
    p, sg = np.asarray(ty["PRESSURE"]), np.asarray(ty["SGAS"])
    assert p.shape[0] > 0 and p.min() > 1000.0 and p.max() <= 4300.0 + 1e-3
    assert sg.min() < 0.78 - 1e-2 and sg.max() <= 0.78 + 1e-5
    assert np.abs(p - np.asarray(jy["PRESSURE"])).max() < PSIA_TOL
    assert np.abs(sg - np.asarray(jy["SGAS"])).max() < SG_TOL
    if split == "train":
        stats = tcase["statistics"]["pressure"]
        np.testing.assert_allclose(stats["std"], float(p.std()), rtol=1e-6)
        assert stats["std"] > 1.0
