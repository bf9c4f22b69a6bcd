"""The gas-condensate training loss of the port with the blocking factor
(``well_solver_kwargs={"use_blocking_factor": True}``: the trapezoid over
8 pressure steps with the saturation root by Newton in each) against the
JAX package's ``pinn_batch_sse_grad`` on the gc9 case (9×9, 6
realizations), with the same weights and batches: every loss term, the
total and the three per-model gradients, at the tolerances of
``test_torch_slice_gc.py``."""

import copy

import pytest
import torch

from test_torch_well_solver_loss import GRAD_REL, _rel, check_terms, evaluate, loss_cases

MODELS = {"pressure": "pressure", "time_step": "time_step", "saturation": "saturation_model"}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    return loss_cases(tmp_path_factory, "GC", {"use_blocking_factor": True})


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


def test_blocking_factor_changes_the_rates(cases):
    """The blocking path is the one evaluated: its rates are not those of
    the same well model without the factor."""
    tcase = cases["tcase"]
    m = tcase["models"]
    well = copy.copy(m["well_rate_bhp_model"])
    x = torch.from_numpy(cases["batches"][1][0])
    with torch.no_grad():
        p, sg = m["pressure"](x), m["saturation_model"](x)
        (with_blk, *_), _ = well.compute_rates_and_bhp(x, p, m["pvt_model"], Sg_n1=sg)
        well.use_blocking_factor = False
        (without, *_), _ = well.compute_rates_and_bhp(x, p, m["pvt_model"], Sg_n1=sg)
    assert not torch.equal(with_blk, without)
