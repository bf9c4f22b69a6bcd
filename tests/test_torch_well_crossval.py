"""The port's two well models against each other, and each against the JAX
package's, on the CPU: ``tests/test_well_crossval.py`` on the port.

The FV simulator (``srm_tpu_torch/sim/fv_simulator.py``, flat-index
geometry from ``build_problem``) and the training path's
``WellRatesPressure`` (``srm_tpu_torch/physics/well_solver.py``, the
non-iterative Peaceman solve on the scattered grid) both apply Peaceman
inflow with a min-BHP drawdown clip. On a BHP-limited state (uniform p =
4,110 psia just above the 4,100 psia floor, kx = 5 mD) the clip must bind,
and the two agree within ``rtol = 2e-3``, as the JAX package's test holds
its own pair. Each side is also held to the JAX package's on the same
state, within PARITY_RTOL (float32 evaluations of the same formulas).
"""

import copy

import numpy as np
import pytest
import torch

from srm_tpu_torch.config import (DEFAULT_GENERAL_CONFIG, DEFAULT_RESERVOIR_CONFIG,
                                  DEFAULT_SCAL_CONFIG, DEFAULT_WELLS_CONFIG)
from srm_tpu_torch.physics.relperm import RelativePermeability
from srm_tpu_torch.physics.well_solver import WellRatesPressure
from srm_tpu_torch.sim import build_problem
from srm_tpu_torch.utils.stats import DataSummary, normalize
from test_torch_sim import port_pvt
from test_well_crossval import STATS
from test_well_crossval import _case as jax_case
from test_well_crossval import _features as jax_features

P_VAL, KX_VALUE = 4110.0, 5.0
CROSS_RTOL = 2e-3
# port against the JAX package: the same float32 formulas on the same PVT
# spline and state; measured on the CPU at most 6.0e-7 apart (gas rates) and
# 1.4e-6 (oil rates), relative (the two port models 2.0e-7 apart)
PARITY_RTOL = 1e-5


def _case(fluid):
    ds = DataSummary([STATS])
    scal = DEFAULT_SCAL_CONFIG
    relperm = RelativePermeability.from_config(scal["end_points"], scal["corey_exponents"])
    g = copy.deepcopy(DEFAULT_GENERAL_CONFIG)
    g["fluid_type"] = fluid
    ws = WellRatesPressure(ds, torch.device("cpu"), fluid_type=fluid, general_config=g,
                           use_non_iterative=True)
    prob, _ = build_problem(DEFAULT_RESERVOIR_CONFIG, DEFAULT_WELLS_CONFIG, scal, g)
    return ds, port_pvt(fluid), relperm, ws, prob


def _features(ds, kx_value, shape=(1, 1, 39, 39, 5)):
    """Features whose permx channel denormalizes to ``kx_value`` and whose
    time channel is mid-horizon (no shut-in window open)."""
    norm = DEFAULT_GENERAL_CONFIG["data_normalization"]
    x = torch.zeros(shape)
    x[..., 4] = normalize(torch.tensor(kx_value), torch.from_numpy(ds.row("permx")),
                          method=norm["feature_normalization_method"],
                          limits=tuple(norm["normalization_limits"]), is_log=True)
    return x


def simulator_rates(fluid, pvt, relperm, prob, kx_value=KX_VALUE, p_val=P_VAL):
    """(qg, qo) at the wells by the simulator's well block on a uniform
    state, and whether the clip binds at every producer."""
    n = int(np.prod(prob.shape))
    kx = torch.full((n,), kx_value)
    p = torch.full((n,), p_val)
    vals = pvt(p)[0]
    if fluid == "DG":
        mg = prob.krgo * vals[0] * vals[1]
        mo = torch.zeros_like(mg)
    else:
        invBg, invBo, invug, invuo, Rs, Rv = (vals[i] for i in range(6))
        krog, krgo = relperm(torch.full((n,), prob.Sgi))
        mg = krgo * invBg * invug + krog * Rs * invBo * invuo
        mo = krog * invBo * invuo + krgo * Rv * invBg * invug
    wc = torch.from_numpy(prob.well_cells)
    q_t, pwf_min = torch.from_numpy(prob.q_target), torch.from_numpy(prob.pwf_min)
    ck = torch.from_numpy(prob.well_ck_geom) * kx[wc]
    qg_max = ck * mg[wc] * torch.clamp_min(p[wc] - pwf_min, 0.0)
    qg = torch.where(q_t >= 0, torch.minimum(q_t, qg_max), q_t)
    qo = qg * mo[wc] / (mg[wc] + 1e-30)
    binds = bool((qg[q_t > 0] < q_t[q_t > 0] - 1e-3).all())
    return qg.numpy(), qo.numpy(), binds


def solver_rates(fluid, ds, pvt, ws, prob):
    """(qg, qo) at the wells from ``WellRatesPressure`` on the same state."""
    x = _features(ds, KX_VALUE)
    p = torch.full((1, 1, 39, 39, 1), P_VAL)
    sg = None if fluid == "DG" else torch.full_like(p, prob.Sgi)
    with torch.no_grad():
        out, _ = ws.compute_rates_and_bhp(x, p, pvt, sg)
    k, j, i = (torch.as_tensor(np.asarray(ws.well_data["connection_index"])[:, a])
               for a in range(3))
    if fluid == "DG":
        return out[0, k, j, i, 0].numpy(), None
    qgg, qgo, qoo, qog = (a[0, k, j, i, 0].numpy() for a in out)
    return qgg + qgo, qoo + qog


def jax_rates(fluid):
    """The JAX package's simulator-side and solver-side rates on the same
    state, as ``tests/test_well_crossval.py`` computes them."""
    import jax.numpy as jnp
    ds, pvt_fn, relperm, ws, prob = jax_case(fluid)
    n = int(np.prod(prob.shape))
    p = np.full(n, P_VAL, np.float32)
    vals = np.asarray(pvt_fn(jnp.asarray(p))[0])
    if fluid == "DG":
        mg = prob.krgo * vals[0] * vals[1]
        mo = np.zeros_like(mg)
    else:
        invBg, invBo, invug, invuo, Rs, Rv = (vals[i] for i in range(6))
        krog, krgo = (np.asarray(a) for a in relperm(jnp.full(n, prob.Sgi, jnp.float32)))
        mg = krgo * invBg * invug + krog * Rs * invBo * invuo
        mo = krog * invBo * invuo + krgo * Rv * invBg * invug
    wc = prob.well_cells
    qg_max = prob.well_ck_geom * KX_VALUE * mg[wc] * np.maximum(p[wc] - prob.pwf_min, 0.0)
    qg = np.where(prob.q_target >= 0, np.minimum(prob.q_target, qg_max), prob.q_target)
    qo = qg * mo[wc] / (mg[wc] + 1e-30)
    p_grid = jnp.full((1, 1, 39, 39, 1), P_VAL, jnp.float32)
    out, _ = ws.compute_rates_and_bhp(jax_features(ds, KX_VALUE), p_grid,
                                      None if fluid == "DG" else jnp.full_like(p_grid, prob.Sgi))
    conn = np.asarray(ws.well_data["connection_index"])
    at = lambda a: np.asarray(a)[0, conn[:, 0], conn[:, 1], conn[:, 2], 0]  # noqa: E731
    if fluid == "DG":
        return (qg, qo), (at(out), None)
    qgg, qgo, qoo, qog = (at(a) for a in out)
    return (qg, qo), (qgg + qgo, qoo + qog)


@pytest.mark.parametrize("fluid", ["DG", "GC"])
def test_fv_wells_match_well_solver(fluid):
    ds, pvt, relperm, ws, prob = _case(fluid)
    qg_sim, qo_sim, binds = simulator_rates(fluid, pvt, relperm, prob)
    # the clip must bind at every producer, else the comparison is vacuous
    assert binds, "BHP clip did not bind; lower p/kx"
    qg_ws, qo_ws = solver_rates(fluid, ds, pvt, ws, prob)
    np.testing.assert_allclose(qg_ws, qg_sim, rtol=CROSS_RTOL)
    if fluid == "GC":
        # BHP-limited: the solver's Rv-capped oil rate is the simulator's
        # drawdown-consistent mobility split
        np.testing.assert_allclose(qo_ws, qo_sim, rtol=CROSS_RTOL)

    (jg_sim, jo_sim), (jg_ws, jo_ws) = jax_rates(fluid)
    np.testing.assert_allclose(qg_sim, jg_sim, rtol=PARITY_RTOL)
    np.testing.assert_allclose(qg_ws, jg_ws, rtol=PARITY_RTOL)
    if fluid == "GC":
        np.testing.assert_allclose(qo_sim, jo_sim, rtol=PARITY_RTOL)
        np.testing.assert_allclose(qo_ws, jo_ws, rtol=PARITY_RTOL)
