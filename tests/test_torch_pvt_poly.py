"""The trainable polynomial PVT (``pvt_fitting_method="polynomial"``) and its
``fluid_property`` optimizer, against the JAX package's ``PVTLayer`` and
``PhysicsLoss`` on numpy inputs and the same flax weights.

* The layer: values at rtol 1e-6 and d/dP at rtol 1e-5 of ``PVTLayer``'s,
  d/dP zero below ``min_input_threshold`` (14.7 psia) and above the upper
  one, half on a bound (JAX's jvp of ``clip``), for the dry-gas and the
  gas-condensate coefficients.
* dg9 (9×9, 6 realizations, the tde weight 0 as in
  ``tests/test_torch_slice.py``) with the flax weights perturbed as
  ``tests/test_torch_predictor.py`` perturbs them, so that the pressure
  field leaves Pi (the default coefficients are kept): the loss terms at
  rtol 1e-3, the per-model gradients, the coefficients' among them, at
  1e-3 of their norm (measured: 2e-5, 4e-4 and 1e-5), the
  ``test_polynomial_pvt_is_trainable`` checks on the port's Trainer, its
  AdamW step on the coefficients against optax's on the same gradient, and
  a checkpoint whose restore ``predict_rates`` then reads. At the initial
  flax weights the pressure field lies within ~1e-3 psia of Pi, a few
  float32 ulps at 5,000 psia, and with the default coefficients (1/Bg
  ~2.5e5) the dry-gas loss is float32 rounding noise in both packages,
  ~1e8–1e9 times its float64 value (ROADMAP C21): that is held as such.
* gc9, perturbed alike: the default gas-condensate coefficients take the
  loss to ~1e34 and the coefficients' gradients to within a factor 40 of
  float32's largest value in both packages (C21): the loss terms where
  the JAX package's are finite at rtol 1e-3 (non-finite where its are),
  the networks' gradients at 1e-3, and the coefficient gradients within
  1e-3 of the JAX package's finite entries, 0 where its are, and, where
  the JAX package's sum overflowed to ``inf``, ``inf`` or beyond 1e36
  (a sum of terms this close to the range's end overflows or not by its
  order of addition).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from srm_tpu.config import DEFAULT_GENERAL_CONFIG, get_configuration as jax_configuration
from srm_tpu.config import get_optimizer_config
from srm_tpu.examples.common import setup_case as jax_setup_case
from srm_tpu.physics.pvt import make_pvt_layer as jax_make_pvt_layer
from srm_tpu.training.optimizers import build_optimizer_from_config
from srm_tpu_torch.config import get_configuration
from srm_tpu_torch.data.batching import collapse_groups
from srm_tpu_torch.examples.common import setup_case
from srm_tpu_torch.nn.convert import load_flax_params
from srm_tpu_torch.physics.pvt import PolynomialPVT, make_pvt_layer
from srm_tpu_torch.training.optimizers import build_optimizer_from_config as build_port_optimizer
from srm_tpu_torch.training.trainer import Trainer
from test_torch_predictor import perturbed
from test_torch_slice import BATCHES, _j, _rel, _t

# values: the same Horner operations in float32; d/dP: the same tangent
# recurrence (``jax.jvp`` of Horner), rounded alike but for XLA's fusion
VALUE_RTOL, DERIV_RTOL = 1e-6, 1e-5
# the loss terms and gradients through the networks and the residual, as
# tests/test_torch_slice.py holds the spline path (rtol 1e-3)
LOSS_RTOL, GRAD_REL = 1e-3, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def _pressures():
    p = np.random.RandomState(0).uniform(0.0, 11000.0, (3, 1, 6, 6, 1)).astype(np.float32)
    flat = p.reshape(-1)
    flat[:8] = [5.0, 14.7, 100.0, 4500.0, 10000.0, 12000.0, 0.0, 14.69]
    return p


@pytest.mark.parametrize("fluid", ["DG", "GC"])
def test_polynomial_pvt_matches_pvt_layer(fluid):
    cfg = jax_configuration("pvt_layer", fluid_type=fluid)
    assert cfg["fitting_method"] == "polynomial"
    layer = jax_make_pvt_layer(cfg)
    p = _pressures()
    params = layer.init(jax.random.PRNGKey(0), jnp.asarray(p))
    want = np.asarray(layer.apply(params, jnp.asarray(p)))
    port = make_pvt_layer(get_configuration("pvt_layer", fluid_type=fluid))
    assert isinstance(port, PolynomialPVT)
    with torch.no_grad():
        got = port(torch.from_numpy(p)).numpy()
    assert got.shape == want.shape == (2, len(cfg["polynomial_config"])) + p.shape
    np.testing.assert_allclose(got[0], want[0], rtol=VALUE_RTOL)
    np.testing.assert_allclose(got[1], want[1], rtol=DERIV_RTOL)
    flat = p.reshape(-1)
    d = got[1].reshape(got.shape[1], -1)
    assert np.all(d[:, (flat < 14.7) | (flat > 10000.0)] == 0.0)
    assert np.all(d[:, flat == np.float32(14.7)] != 0.0)
    # tests/test_physics.py's case: invBg = 1 + 0.1p + 0.01p² = 111 at p = 100,
    # d/dp = 0.1 + 0.02p = 2.1; half of d/dp on a bound
    i = int(np.flatnonzero(flat == 100.0)[0])
    np.testing.assert_allclose(got[:, 0].reshape(2, -1)[:, i], [111.0, 2.1], rtol=1e-5)
    c = cfg["polynomial_config"]["invBg"]
    j = int(np.flatnonzero(flat == 10000.0)[0])
    np.testing.assert_allclose(d[0, j], 0.5 * (c[1] + 2 * c[2] * 10000.0), rtol=1e-6)


def test_coefficients_get_gradients_through_values_and_derivatives():
    """Autograd reaches every coefficient through the values and through
    d/dP, as ``jax.grad`` through the jvp does."""
    cfg = jax_configuration("pvt_layer", fluid_type="DG")
    layer = jax_make_pvt_layer(cfg)
    p = _pressures()
    w = np.random.RandomState(1).uniform(-1, 1, (2, 2) + p.shape).astype(np.float32)
    params = layer.init(jax.random.PRNGKey(0), jnp.asarray(p))
    gj = jax.grad(lambda q: jnp.sum(layer.apply(q, jnp.asarray(p)) * w))(params)
    port = make_pvt_layer(get_configuration("pvt_layer", fluid_type="DG"))
    (port(torch.from_numpy(p)) * torch.from_numpy(w)).sum().backward()
    for prop in ("invBg", "invug"):
        want = np.asarray(gj["params"][f"{prop}_coefficients"])
        got = port.coefficients(prop).grad.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert np.all(got != 0.0)


def _poly_config(fluid):
    g = copy.deepcopy(DEFAULT_GENERAL_CONFIG)
    g["pvt_fitting_method"] = "polynomial"
    for ph in ("gas", "oil"):
        g["default_weights"][ph]["tde"] = 0.0
    return g


def _build(fluid, tmp_path_factory, perturb=True):
    g = _poly_config(fluid)
    jcase = jax_setup_case(fluid, base_dir=str(tmp_path_factory.mktemp(f"jax_{fluid}9")), nx=9,
                           n_realizations=6, general_config=g)
    if perturb:                       # the networks only: the default coefficients stay
        params = jax.tree_util.tree_map(jnp.asarray, perturbed(jcase["params"]))
        params["pvt_model"] = jcase["params"]["pvt_model"]
        jcase["params"] = params
    tcase = setup_case(fluid, base_dir=str(tmp_path_factory.mktemp(f"torch_{fluid}9")), nx=9,
                       n_realizations=6, general_config=g, device="cpu")
    load_flax_params(tcase["models"], jax.tree_util.tree_map(np.asarray, jcase["params"]))
    x_all, y_all = collapse_groups(jcase["train_groups"])
    batches = [(x_all[b], {k: v[b] for k, v in y_all.items()}) for b in BATCHES[:2]]
    grad_fn = jax.jit(jcase["loss_fn"].pinn_batch_sse_grad)
    return dict(jcase=jcase, tcase=tcase, batches=batches, grad_fn=grad_fn)


@pytest.fixture(scope="module")
def dg9(tmp_path_factory):
    return _build("DG", tmp_path_factory)


@pytest.fixture(scope="module")
def gc9(tmp_path_factory):
    return _build("GC", tmp_path_factory)


def _layout(tcase, trees):
    """JAX param-shaped trees laid out as the port's parameters, by key."""
    lf = tcase["loss_fn"]
    holder = {lf.logical_name(k): copy.deepcopy(tcase["models"][lf.logical_name(k)])
              for k in trees}
    load_flax_params(holder, {lf.logical_name(k): jax.tree_util.tree_map(np.asarray, v)
                              for k, v in trees.items()})
    return {k: [p.detach() for p in holder[lf.logical_name(k)].parameters()] for k in trees}


def _both(case, b):
    aux_j, grads_j, total_j = case["grad_fn"](case["jcase"]["params"], *_j(case["batches"][b]))
    aux_t, grads_t, total_t = case["tcase"]["loss_fn"].pinn_batch_sse_grad(
        *_t(case["batches"][b]))
    aux_t = {ph: {k: v.detach() for k, v in terms.items()} if ph in ("gas", "oil") else terms
             for ph, terms in aux_t.items()}
    return (aux_j, grads_j, total_j), (aux_t, grads_t, total_t.detach())


@pytest.mark.parametrize("fluid", ["DG", "GC"])
def test_fluid_property_joins_the_trainable_set(fluid, dg9, gc9):
    """As the JAX package: three optimizers for dry gas, four for gas
    condensate, ``fluid_property`` among them although its optimizer
    config says ``"trainable": False`` (ignored by both; ROADMAP C20)."""
    case = dg9 if fluid == "DG" else gc9
    keys_j = case["jcase"]["loss_fn"].trainable_models_keys
    keys_t = case["tcase"]["loss_fn"].trainable_models_keys
    assert keys_t == keys_j and "fluid_property" in keys_t
    assert len(keys_t) == (3 if fluid == "DG" else 4)
    assert get_optimizer_config("fluid_property")["trainable"] is False
    trainer = Trainer(case["tcase"]["loss_fn"])
    assert trainer.optimizer_keys == keys_t
    assert isinstance(case["tcase"]["models"]["pvt_model"], PolynomialPVT)


@pytest.mark.parametrize("b", [0, 1])
def test_dg_loss_terms_and_gradients_match(dg9, b):
    (aux_j, grads_j, total_j), (aux_t, grads_t, total_t) = _both(dg9, b)
    assert np.isfinite(float(total_j)) and float(total_j) > 1e12
    for term, v in aux_j["gas"].items():
        np.testing.assert_allclose(float(aux_t["gas"][term]), float(v), rtol=LOSS_RTOL,
                                   atol=1e-6 * float(total_j), err_msg=term)
    np.testing.assert_allclose(float(total_t), float(total_j), rtol=LOSS_RTOL)
    want = _layout(dg9["tcase"], grads_j)
    for key in ("pressure", "time_step", "fluid_property"):
        assert all(torch.isfinite(g).all() for g in grads_t[key])
        rel = _rel(grads_t[key], want[key])
        assert rel <= GRAD_REL, f"{key}: relative gradient error {rel:.2e}"


def test_dg_fluid_property_step_matches_optax(dg9):
    """The port's AdamW (lr 5e-4, weight decay 5e-4) fed the JAX package's
    coefficient gradient lands on optax's coefficients (1e-6 of the step)."""
    _, grads_j, _ = dg9["grad_fn"](dg9["jcase"]["params"], *_j(dg9["batches"][0]))
    cfg = get_optimizer_config("fluid_property")
    opt_j = build_optimizer_from_config(cfg)
    start = dg9["jcase"]["params"]["pvt_model"]
    upd, _ = opt_j.update(grads_j["fluid_property"], opt_j.init(start), start)
    after = _layout(dg9["tcase"], {"fluid_property": optax.apply_updates(start, upd)})
    before = _layout(dg9["tcase"], {"fluid_property": start})["fluid_property"]
    params = [p.clone() for p in before]
    opt_t = build_port_optimizer(params, cfg)
    opt_t.step(_layout(dg9["tcase"], grads_j)["fluid_property"])
    rel = _rel([p - s for p, s in zip(params, before)],
               [w - s for w, s in zip(after["fluid_property"], before)])
    assert rel <= 1e-6, rel


def test_polynomial_pvt_is_trainable_in_the_port(dg9, tmp_path):
    """``tests/test_modes.py::test_polynomial_pvt_is_trainable`` in the port:
    a Trainer step on four samples moves the coefficients with a finite
    loss; then a checkpoint of the trained models, restored into a fresh
    case's, gives ``predict_rates`` the trained coefficients' rates, not
    the initial ones."""
    from srm_tpu_torch.eval.predictor import SRMPredictor
    from srm_tpu_torch.utils.checkpoint import CheckpointManager
    tcase = dg9["tcase"]
    lf = copy.copy(tcase["loss_fn"])
    lf.models = {**tcase["models"], **{k: copy.deepcopy(tcase["models"][k])
                                       for k in ("pressure", "time_step", "pvt_model")}}
    trainer = Trainer(lf)
    assert "fluid_property" in trainer.optimizer_keys
    before = [p.detach().clone() for p in lf.models["pvt_model"].parameters()]
    for batch in dg9["batches"]:
        metrics = trainer.train_step(*_t(batch))
        assert np.isfinite(float(metrics["total"]))
    after = [p.detach().clone() for p in lf.models["pvt_model"].parameters()]
    assert max(float((a - b).abs().max()) for a, b in zip(after, before)) > 0
    # the coefficients enter the well solver's PVT: the live module
    assert lf.models["well_rate_bhp_model"] is tcase["models"]["well_rate_bhp_model"]

    trained = trainer.trained_models()
    assert set(trained) == {"pressure", "time_step", "pvt_model"}
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save(1, trained, trainer.optimizers)
    fresh = setup_case("DG", base_dir=str(tmp_path / "fresh"), nx=9, n_realizations=6,
                       general_config=_poly_config("DG"), device="cpu")
    restored = {lf.logical_name(k): fresh["models"][lf.logical_name(k)]
                for k in fresh["loss_fn"].trainable_models_keys}
    assert ckpt.restore(params=restored) is not None
    for a, b in zip(fresh["models"]["pvt_model"].parameters(), after):
        assert torch.equal(a.detach(), b)

    def rates(models):
        pred = SRMPredictor(models, fresh["data_summary"],
                            general_config=fresh["general_config"],
                            reservoir_config=fresh["processor"].reservoir_config)
        permx = fresh["processor"].generate_kle_splits()["test"][:2]
        return pred.predict_rates(permx, [0.0, 30.0, 90.0])

    q_restored, pwf_restored = rates(fresh["models"])
    q_trained, pwf_trained = rates({**fresh["models"], **lf.models,
                                    "well_rate_bhp_model": fresh["models"]["well_rate_bhp_model"]})
    initial = setup_case("DG", base_dir=str(tmp_path / "initial"), nx=9, n_realizations=6,
                         general_config=_poly_config("DG"), device="cpu")
    q_init, _ = rates({**fresh["models"], "pvt_model": initial["models"]["pvt_model"]})
    np.testing.assert_array_equal(np.asarray(q_restored), np.asarray(q_trained))
    np.testing.assert_array_equal(np.asarray(pwf_restored), np.asarray(pwf_trained))
    assert not np.array_equal(np.asarray(q_restored), np.asarray(q_init))


def _float64_loss(tcase, batch):
    lf = copy.copy(tcase["loss_fn"])
    lf.models = {**lf.models, **{k: copy.deepcopy(lf.models[k]).double() for k in
                                 ("pressure", "time_step", "pvt_model", "saturation_model")
                                 if k in lf.models}}
    x, y = _t(batch)
    return lf.pinn_batch_sse_grad(x.double(), {k: v.double() for k, v in y.items()})


def test_dg_loss_at_the_initial_weights_is_rounding_noise(tmp_path_factory):
    """C21, dry gas: at the initial flax weights (the pressure field within
    ~1e-3 psia of Pi) the float32 dom term of both packages lies over 1e6
    times its float64 value (measured 5e8), finite; they agree on mbc."""
    case = _build("DG", tmp_path_factory, perturb=False)
    (aux_j, _, _), (aux_t, _, _) = _both(case, 0)
    aux_64, _, _ = _float64_loss(case["tcase"], case["batches"][0])
    exact = float(aux_64["gas"]["dom"].detach())
    for aux in (aux_j, aux_t):
        assert np.isfinite(float(aux["gas"]["dom"]))
        assert float(aux["gas"]["dom"]) >= 1e6 * exact
    np.testing.assert_allclose(float(aux_t["gas"]["mbc"]), float(aux_j["gas"]["mbc"]),
                               rtol=LOSS_RTOL)


def test_gc_loss_and_gradients_match_up_to_overflow(gc9):
    """C21, gas condensate: the loss terms, the networks' gradients and the
    coefficient gradients (finite entries, zeros, and the overflow), as
    the module docstring states; the largest coefficient gradient lies
    within a factor 40 of float32's largest value in both packages, so that
    AdamW's second moment (g²) overflows on the first step."""
    (aux_j, grads_j, total_j), (aux_t, grads_t, total_t) = _both(gc9, 0)
    for ph in ("gas", "oil"):
        for term, v in aux_j[ph].items():
            v, got = float(v), float(aux_t[ph][term])
            if np.isfinite(v):
                np.testing.assert_allclose(got, v, rtol=LOSS_RTOL, atol=1e-6 * float(total_j),
                                           err_msg=f"{ph}/{term}")
            else:
                assert not np.isfinite(got), f"{ph}/{term}: {got} where the reference has {v}"
    want = _layout(gc9["tcase"], grads_j)
    for key in ("pressure", "time_step", "saturation"):
        rel = _rel(grads_t[key], want[key])
        assert rel <= GRAD_REL, f"{key}: relative gradient error {rel:.2e}"
    got = [g.numpy() for g in grads_t["fluid_property"]]
    ref = [w.numpy() for w in want["fluid_property"]]
    for g, w in zip(got, ref):
        assert not np.isnan(g).any()
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], rtol=GRAD_REL)
        np.testing.assert_array_equal(g == 0, w == 0)
        assert np.all(np.isinf(g[~fin]) | (np.abs(g[~fin]) >= 1e36))
    for grads in (got, ref):
        top = np.max(np.abs(np.concatenate([g.ravel() for g in grads])))
        assert top >= np.finfo(np.float32).max / 40
        assert any((g == 0).all() for g in grads)          # Vro enters no term
