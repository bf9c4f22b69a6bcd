"""Per-term gradient norms (ROADMAP C15): ``PhysicsLoss.per_term_grad_norms``
against the JAX package's (``srm_tpu/losses/physics_loss.py:1076-1107``) on
the dg9 and gc9 cases (9×9, 6 realizations) with the same weights and
batch, and the training driver's ``log_term_grad_norms`` at watched epochs
(``srm_tpu/training/trainer.py:376-386``). The JAX package's own test of
them (``tests/test_loss_training.py:245``) is marked slow; these are small.

The cases run with the ``tde`` weights at 0, as the slices' gradient tests
do: ``tde`` is float32 rounding noise (ROADMAP C1), and its gradient norms
would compare noise. The first batch holds t0 samples, where the packages'
per-model gradients agree to 1e-3 (tests/test_torch_slice_gc.py).
"""

import copy
import logging

import jax
import numpy as np
import pytest
import torch

from srm_tpu.config import DEFAULT_GENERAL_CONFIG
from srm_tpu.examples.common import setup_case as jax_setup_case
from srm_tpu_torch.data.batching import collapse_groups
from srm_tpu_torch.examples.common import setup_case
from srm_tpu_torch.losses.physics_loss import LOSS_TERMS
from srm_tpu_torch.nn.convert import load_flax_params
from srm_tpu_torch.training.trainer import train_combined_models_unified
from test_torch_slice import _j, _t

BATCH = [0, 1, 40, 77]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module", params=["DG", "GC"])
def case(request, tmp_path_factory):
    fluid = request.param
    g = copy.deepcopy(DEFAULT_GENERAL_CONFIG)
    for ph in ("gas", "oil"):
        g["default_weights"][ph]["tde"] = 0.0
    kw = dict(nx=9, n_realizations=6, general_config=g)
    jcase = jax_setup_case(fluid, base_dir=str(tmp_path_factory.mktemp(f"jax_{fluid}")), **kw)
    tcase = setup_case(fluid, base_dir=str(tmp_path_factory.mktemp(f"torch_{fluid}")),
                       device="cpu", **kw)
    load_flax_params(tcase["models"], jax.tree_util.tree_map(np.asarray, jcase["params"]))
    x_all, y_all = collapse_groups(jcase["train_groups"])
    batch = (x_all[BATCH], {k: v[BATCH] for k, v in y_all.items()})
    return dict(fluid=fluid, jcase=jcase, tcase=tcase, batch=batch)


def test_norms_match_the_reference(case):
    """Every (phase, term) row and model: equal keys; zero where the JAX
    package's is zero (the terms the weights switch off), and within rtol
    1e-3 of it elsewhere; the live physics terms are non-zero."""
    jacrev = jax.jacrev
    with pytest.MonkeyPatch.context() as mp:
        # the reference's jacobian, compiled rather than run op by op
        mp.setattr(jax, "jacrev", lambda f, *a, **kw: jax.jit(jacrev(f, *a, **kw)))
        want = case["jcase"]["loss_fn"].per_term_grad_norms(case["jcase"]["params"],
                                                            *_j(case["batch"]))
    got = case["tcase"]["loss_fn"].per_term_grad_norms(*_t(case["batch"]))
    phases = ("gas",) if case["fluid"] == "DG" else ("gas", "oil")
    assert set(got) == set(want) == {f"{ph}/{t}" for ph in phases for t in LOSS_TERMS}
    for term, row in want.items():
        assert set(got[term]) == set(row), term
        for model, v in row.items():
            if v == 0.0:
                assert got[term][model] == 0.0, (term, model)
            else:
                np.testing.assert_allclose(got[term][model], v, rtol=1e-3,
                                           err_msg=f"{term} {model}")
    for ph in phases:
        for t in ("dom", "ibc", "mbc"):
            assert got[f"{ph}/{t}"]["pressure"] > 0.0, (ph, t)
        assert got[f"{ph}/tde"] == {m: 0.0 for m in got[f"{ph}/tde"]}
    assert all(np.isfinite(v) for row in got.values() for v in row.values())


def test_driver_logs_the_norms_at_watched_epochs(case, caplog):
    """With ``log_term_grad_norms`` the driver logs one line per term at each
    watched epoch, the norms on the first training batch of the staged
    split, eager, outside the training step."""
    tcase = case["tcase"]
    loss_fn = copy.copy(tcase["loss_fn"])
    loss_fn.models = {**tcase["models"], **{k: copy.deepcopy(tcase["models"][k])
                                            for k in ("pressure", "time_step",
                                                      "saturation_model")
                                            if k in tcase["models"]}}
    g = dict(tcase["general_config"], log_term_grad_norms=True)
    with caplog.at_level(logging.INFO, logger="srm_tpu_torch.training.trainer"):
        trainer, _, _ = train_combined_models_unified(
            tcase["train_groups"], [], loss_fn, training_batch_size=32, epochs=2,
            general_config=g, verbose=0, log_epoch_percentage=0.5)
    lines = [r.getMessage() for r in caplog.records if r.getMessage().startswith("grad-norms")]
    n_terms = len(loss_fn.loss_keys) * len(LOSS_TERMS)
    # epoch 1 is not watched (the last half of 2 epochs is)
    assert len(lines) == n_terms and all(m.startswith("grad-norms epoch 2 ") for m in lines)
    # the last watched epoch's weights are the restored ones: the same norms
    x_all, y_all = trainer._resident["train"][:2]
    norms = loss_fn.per_term_grad_norms(x_all[:32], {k: v[:32] for k, v in y_all.items()})
    for term, row in norms.items():
        want = f"grad-norms epoch 2 {term}: " + str({m: f"{v:.3e}" for m, v in row.items()})
        assert want in lines, want
