"""The rates and BHP of the port's well solver against the JAX package's,
with their gradients with respect to the pressure: the Newton BHP solve
(``use_non_iterative=False``, 4 and 12 trips), the blocking factor, and
both together, for dry gas and gas condensate, on the 9×9 well layout of
``test_torch_physics.py``."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_well_solver import GRAD_REL, RATE_REL, _close, _solvers


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


WELL_CASES = {
    "newton_bhp_4": dict(use_non_iterative=False, max_iters=4),
    "newton_bhp_12": dict(use_non_iterative=False, max_iters=12),
    "blocking": dict(use_blocking_factor=True),
    "newton_bhp_blocking": dict(use_non_iterative=False, max_iters=4, use_blocking_factor=True),
}


@pytest.mark.parametrize("case", list(WELL_CASES))
@pytest.mark.parametrize("fluid", ["DG", "GC"])
def test_rates_and_bhp_match(fluid, case):
    """Rates and BHP within RATE_REL and the gradient of a weighted sum of
    them with respect to p within GRAD_REL of jax.grad. Where the JAX
    solve's ``|q − q_target| > tol`` mask differs from the port's on a
    lane, the test says so (a warning with the lanes) and holds the values
    all the same."""
    kw = WELL_CASES[case]
    jw, tw, jax_fn, pvt, x, p, sg = _solvers(fluid, **kw)
    wq = np.random.RandomState(7).uniform(0.5, 1.5, 5).astype(np.float32)

    def jloss(pp):
        q, pwf = jw.compute_rates_and_bhp(jnp.asarray(x), pp, None if sg is None else
                                          jnp.asarray(sg), model_PVT=jax_fn)
        q = q if isinstance(q, tuple) else (q,)
        return sum(jnp.sum(qi * w) for qi, w in zip(q, wq)) + jnp.sum(pwf * wq[4]), (q, pwf)

    (_, (qj, pwfj)), gj = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(p))
    pt = torch.from_numpy(p).requires_grad_(True)
    qt, pwft = tw.compute_rates_and_bhp(torch.from_numpy(x), pt, pvt,
                                        Sg_n1=None if sg is None else torch.from_numpy(sg))
    qt = qt if isinstance(qt, tuple) else (qt,)
    (sum((qi * float(w)).sum() for qi, w in zip(qt, wq)) + (pwft * float(wq[4])).sum()).backward()
    assert len(qt) == len(qj) == (4 if fluid == "GC" else 1)
    for i, (a, b) in enumerate(zip(qt, qj)):
        _close(f"q{i}", a.detach().numpy(), b, RATE_REL)
    _close("pwf", pwft.detach().numpy(), pwfj, RATE_REL)
    _close("d/dp", pt.grad.numpy(), gj, GRAD_REL)
    assert float(np.abs(np.asarray(qj[0])).max()) > 0
    # the converged-lane mask of the rate target, lane by lane
    q0 = tw.q0.numpy()
    active_j = np.abs(np.asarray(qj[0]) - q0) > jw.tol
    active_t = np.abs(qt[0].detach().numpy() - q0) > tw.tol
    differ = np.argwhere(active_j != active_t)
    if differ.size:
        warnings.warn(f"{fluid} {case}: the |q - q_target| > tol mask differs on lanes "
                      f"{differ.tolist()}")
