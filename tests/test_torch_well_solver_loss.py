"""The training loss of the port with the well solver's Newton BHP
(``well_solver_kwargs={"use_non_iterative": False}``) against the JAX
package's ``pinn_batch_sse_grad`` on the dg9 case (9×9, 6 realizations),
with the same weights and batches: every loss term, the total and the
per-model gradients, at the tolerances of ``test_torch_slice.py`` (its
``tde`` weight at 0 for the same reason: ROADMAP C1). The gas-condensate
loss with the blocking factor: ``test_torch_well_solver_loss_gc.py``."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srm_tpu.config import DEFAULT_GENERAL_CONFIG
from srm_tpu.examples.common import setup_case as jax_setup_case
from srm_tpu_torch.data.batching import collapse_groups
from srm_tpu_torch.examples.common import setup_case
from srm_tpu_torch.nn.convert import load_flax_params

# the slice tests' batches of the collapsed train samples (the first holds
# t0 samples)
BATCHES = [[0, 1, 40, 77], [5, 30, 64, 101]]
# a term, the total and a model's gradient, relative (test_torch_slice.py)
TERM_REL, GRAD_REL = 1e-3, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def loss_cases(tmp_path_factory, fluid, well_solver_kwargs):
    g = copy.deepcopy(DEFAULT_GENERAL_CONFIG)
    for ph in g["default_weights"]:
        g["default_weights"][ph]["tde"] = 0.0
    jcase = jax_setup_case(fluid, base_dir=str(tmp_path_factory.mktemp(f"jax_{fluid}")), nx=9,
                           n_realizations=6, general_config=g,
                           well_solver_kwargs=well_solver_kwargs)
    tcase = setup_case(fluid, base_dir=str(tmp_path_factory.mktemp(f"port_{fluid}")), nx=9,
                       n_realizations=6, general_config=g, device="cpu",
                       well_solver_kwargs=well_solver_kwargs)
    well = tcase["models"]["well_rate_bhp_model"]
    for k, v in well_solver_kwargs.items():
        assert getattr(well, k) == v
    load_flax_params(tcase["models"], jax.tree_util.tree_map(np.asarray, jcase["params"]))
    x_all, y_all = collapse_groups(jcase["train_groups"])
    batches = [(x_all[b], {k: v[b] for k, v in y_all.items()}) for b in BATCHES]
    grad_fn = jax.jit(jcase["loss_fn"].pinn_batch_sse_grad)
    return dict(jcase=jcase, tcase=tcase, batches=batches, grad_fn=grad_fn)


def _rel(got, want):
    num = torch.sqrt(sum(((g.double() - w.double()) ** 2).sum() for g, w in zip(got, want)))
    den = torch.sqrt(sum((w.double() ** 2).sum() for w in want))
    assert float(den) > 0
    return float(num / den)


def evaluate(cases, b, models):
    """(aux, per-model gradients, total) of both packages on batch ``b``,
    the JAX gradients laid out as the port's parameters."""
    x, y = cases["batches"][b]
    aux_j, grads_j, total_j = cases["grad_fn"](cases["jcase"]["params"], jnp.asarray(x),
                                               {k: jnp.asarray(v) for k, v in y.items()})
    aux_t, grads_t, total_t = cases["tcase"]["loss_fn"].pinn_batch_sse_grad(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in y.items()})
    holder = {models[k]: copy.deepcopy(cases["tcase"]["models"][models[k]]) for k in models}
    load_flax_params(holder, {models[k]: jax.tree_util.tree_map(np.asarray, v)
                              for k, v in grads_j.items() if k in models})
    grads_j = {k: [p.detach() for p in holder[models[k]].parameters()] for k in models}
    return (aux_t, grads_t, total_t), (aux_j, grads_j, total_j)


def check_terms(got, want):
    (aux_t, _, total_t), (aux_j, _, total_j) = got, want
    for ph in aux_j:
        if ph == "outputs" or not isinstance(aux_j[ph], dict):
            continue
        for term, v in aux_j[ph].items():
            np.testing.assert_allclose(float(aux_t[ph][term].detach()), float(v), rtol=TERM_REL,
                                       atol=1e-6 * float(total_j), err_msg=f"{ph} {term}")
    np.testing.assert_allclose(float(total_t.detach()), float(total_j), rtol=TERM_REL)
    assert np.isfinite(float(total_j))


MODELS = {"pressure": "pressure", "time_step": "time_step"}


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    return loss_cases(tmp_path_factory, "DG", {"use_non_iterative": False})


@pytest.fixture(scope="module")
def first(cases):
    return evaluate(cases, 0, MODELS)


def test_loss_terms_match(first):
    check_terms(*first)


@pytest.mark.parametrize("key", list(MODELS))
def test_per_model_gradients_match(first, key):
    (_, grads_t, _), (_, grads_j, _) = first
    rel = _rel(grads_t[key], grads_j[key])
    assert rel <= GRAD_REL, f"{key}: relative gradient error {rel:.2e}"


def test_time_step_gradient_on_a_later_batch(cases):
    (_, grads_t, _), (_, grads_j, _) = evaluate(cases, 1, MODELS)
    rel = _rel(grads_t["time_step"], grads_j["time_step"])
    assert rel <= GRAD_REL, f"time_step: relative gradient error {rel:.2e}"


def test_newton_bhp_differs_from_the_direct_solve(cases):
    """The Newton path is the one evaluated: its BHP is not the direct
    λ-scaling solve's on the same inputs."""
    tcase = cases["tcase"]
    well = copy.copy(tcase["models"]["well_rate_bhp_model"])
    x = torch.from_numpy(cases["batches"][1][0])
    with torch.no_grad():
        p = tcase["models"]["pressure"](x)
        _, newton = well.compute_rates_and_bhp(x, p, tcase["models"]["pvt_model"])
        well.use_non_iterative = True
        _, direct = well.compute_rates_and_bhp(x, p, tcase["models"]["pvt_model"])
    assert not torch.equal(newton, direct)
