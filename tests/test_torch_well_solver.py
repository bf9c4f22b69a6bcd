"""The port's well solver against the JAX package's, on the same numpy
inputs: the three root solvers (values and gradients through their fixed
trip counts), the blocking-factor integral for dry gas and gas condensate,
and the ``log_iterations`` files. The rates and BHP of the Newton BHP solve
and of the blocking factor: ``test_torch_well_solver_rates.py``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srm_tpu.physics import well_solver as jws
from srm_tpu.physics.relperm import RelativePermeability as JaxRelperm
from srm_tpu_torch.physics import well_solver as tws
from test_torch_physics import _pvt_pair, _Summary, _well_case
from test_torch_physics_gc import SGI, _gc_pvt_pair

# root values: float32 iterates of the same algorithm in two libraries
ROOT_TOL = 1e-6
# their gradients with respect to a parameter of the cost, relative
ROOT_GRAD_REL = 1e-4
# rates and BHP, relative to each field's largest magnitude; and their
# gradients with respect to the pressure, relative to the largest gradient
RATE_REL, GRAD_REL = 1e-4, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


# the costs of tests/test_physics.py:269-305, each a function of the root
# parameter ``a`` (one lane per entry)
ROOTS = np.asarray([0.2, 0.41, 0.6234, 0.777], np.float32)
COSTS = {
    "sine": (ROOTS, lambda lib, a: lambda x: (x - a) * (1.0 + 0.5 * lib.sin(3.0 * x))),
    "no_bracket": (np.asarray([2.0, 2.5, 3.0], np.float32), lambda lib, a: lambda x: a - x),
    "square": (np.asarray([0.25, 0.04, 0.5], np.float32), lambda lib, a: lambda x: x**2 - a),
    # a root at the bracket end 0: jnp.sign and torch.sign are 0 there
    "zero_end": (np.asarray([0.3, 0.6, 0.9], np.float32), lambda lib, a: lambda x: x * (x - a)),
}
SOLVERS = {
    "newton": dict(max_iters=20, max_value=1.0),
    "bisection": dict(max_iters=10, max_value=1.0),
    "chandrupatla": dict(max_iters=10, tol=1e-12, max_value=1.0),
}


@pytest.mark.parametrize("cost", list(COSTS))
@pytest.mark.parametrize("solver", list(SOLVERS))
def test_root_solvers_match(solver, cost):
    a0, make = COSTS[cost]
    kw = SOLVERS[solver]

    def jroot(a):
        return getattr(jws, f"solve_{solver}")(make(jnp, a), jnp.zeros_like(a), **kw)

    want = np.asarray(jroot(jnp.asarray(a0)))
    want_grad = np.asarray(jax.grad(lambda a: jnp.sum(jroot(a) * jnp.arange(1.0, 1 + a.size)))(
        jnp.asarray(a0)))
    a = torch.from_numpy(a0).requires_grad_(True)
    got = getattr(tws, f"solve_{solver}")(make(torch, a), torch.zeros_like(a), **kw)
    # bisection's result selects among constants: no path to a, gradient 0
    grad = (torch.autograd.grad((got * torch.arange(1.0, 1 + a.numel())).sum(), a)[0]
            if got.requires_grad else torch.zeros_like(a)).numpy()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=ROOT_TOL)
    scale = max(float(np.abs(want_grad).max()), 1e-30)
    assert np.abs(grad - want_grad).max() <= ROOT_GRAD_REL * scale, (grad, want_grad)
    if cost == "sine" and solver == "chandrupatla":
        np.testing.assert_allclose(got.detach().numpy(), ROOTS, atol=1e-6)


def test_root_solve_without_grad_and_on_a_constant_cost():
    """Under no_grad the Newton slope is still taken (the eval step); a cost
    that does not depend on x has slope 0, and the step runs to the bound
    as JAX's does."""
    with torch.no_grad():
        r = tws.solve_newton(lambda x: x**2 - 0.25, torch.zeros(3), 20)
    np.testing.assert_allclose(r.numpy(), 0.5, atol=1e-6)
    assert not r.requires_grad
    for f in (1.0, -1.0):
        got = tws.solve_newton(lambda x: torch.full((3,), f), torch.zeros(3), 3, max_value=0.8)
        want = jws.solve_newton(lambda x: jnp.full((3,), f), jnp.zeros(3), 3, max_value=0.8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _solvers(fluid, **kw):
    g, res, wells, x, p = _well_case()
    g["fluid_type"] = fluid
    ds = _Summary()
    jax_fn, pvt = _gc_pvt_pair() if fluid == "GC" else _pvt_pair(1)
    jw = jws.WellRatesPressure(fluid_type=fluid, data_summary=ds.jax, pvt_fn=jax_fn,
                               general_config=g, reservoir_config=res, wells_config=wells, **kw)
    tw = tws.WellRatesPressure(ds.torch, torch.device("cpu"), fluid_type=fluid, general_config=g,
                               reservoir_config=res, wells_config=wells, **kw)
    sg = np.random.RandomState(6).uniform(0.3, SGI, p.shape).astype(np.float32)
    sg[0] = SGI                                            # the t0 sample
    return jw, tw, jax_fn, pvt, x, p, (sg if fluid == "GC" else None)


def _close(name, got, want, rel):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    scale = np.abs(want).max()
    assert err <= rel * max(scale, 1e-30), f"{name}: {err:.3e} of {scale:.3e}"


@pytest.mark.parametrize("solver", ["newton", "bisection", "chandrupatla"])
@pytest.mark.parametrize("fluid", ["DG", "GC"])
def test_blocking_integral_and_factor_match(fluid, solver):
    """(Ig, Io, blk_g, blk_o) from p down to a BHP below it, at 9×9."""
    jw, tw, jax_fn, pvt, _, p, sg = _solvers(fluid, use_blocking_factor=True, solver=solver)
    pwf = np.minimum(p, 4100.0).astype(np.float32) - 50.0
    want = jw.compute_blocking_integral_and_factor(
        jnp.asarray(p), jnp.asarray(SGI if sg is None else sg), JaxRelperm(), jax_fn,
        jnp.asarray(pwf))
    with torch.no_grad():
        got = tw.compute_blocking_integral_and_factor(
            torch.from_numpy(p), tw.sg_max_t if sg is None else torch.from_numpy(sg), pvt,
            torch.from_numpy(pwf))
    for name, a, b in zip(("Ig", "Io", "blk_g", "blk_o"), got, want):
        _close(name, a.numpy(), b, RATE_REL)
    blk = np.asarray(want[2])
    assert np.all(blk[np.asarray(want[0]) != 0] > 0)


def _log_lines(directory, prefix):
    (name,) = [f for f in os.listdir(directory) if f.startswith(prefix)]
    with open(os.path.join(directory, name)) as f:
        return f.read().splitlines()


def _numbers(line):
    return [float(v) for v in line.split('"')[1].split()] if '"' in line else []


@pytest.mark.parametrize("kw, prefix", [
    (dict(use_non_iterative=False, max_iters=6, tol=1e-3), "pwf_iterative"),
    (dict(), "lambda_non_iterative"),
])
def test_log_iterations_file_matches(tmp_path, kw, prefix):
    """The iteration history file of one call: the JAX package's lines
    (header, one ``iter i values:`` row per iteration, the final values),
    the numbers within 1e-5 relative."""
    jw, tw, jax_fn, pvt, x, p, _ = _solvers("DG", log_iterations=True,
                                            log_dir=str(tmp_path / "jax"), **kw)
    tw.log_dir = str(tmp_path / "port")
    jax.block_until_ready(jax.jit(lambda xx, pp: jw.compute_rates_and_bhp(
        xx, pp, None, model_PVT=jax_fn))(jnp.asarray(x), jnp.asarray(p)))
    tw.compute_rates_and_bhp(torch.from_numpy(x), torch.from_numpy(p), pvt)
    want, got = _log_lines(tmp_path / "jax", prefix), _log_lines(tmp_path / "port", prefix)
    assert len(got) == len(want) == (kw.get("max_iters", 1) + 2)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert g.split('"')[0] == w.split('"')[0]
        np.testing.assert_allclose(_numbers(g), _numbers(w), rtol=1e-5)
        assert _numbers(w)
    # a second call writes a second file; a flush with nothing new writes none
    tw.compute_rates_and_bhp(torch.from_numpy(x), torch.from_numpy(p), pvt)
    assert len(os.listdir(tmp_path / "port")) == 2
    assert tw.flush_iteration_logs() == 0
