"""The gas-condensate physics of the port against the JAX package's, on the
same numpy inputs: relperm as a differentiated function of Sg, the
seven-property spline PVT, and the GC well rates with their condensate
split."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srm_tpu.config import get_configuration
from srm_tpu.physics.pvt import make_pvt_layer
from srm_tpu.physics.relperm import RelativePermeability as JaxRelperm
from srm_tpu.physics.well_solver import WellRatesPressure as JaxWells
from srm_tpu_torch.data.pvt_table import load_pvt_table
from srm_tpu_torch.physics.pvt import GC_PROPERTIES, make_spline_pvt
from srm_tpu_torch.physics.relperm import RelativePermeability
from srm_tpu_torch.physics.well_solver import WellRatesPressure
from test_torch_physics import _Summary, _well_case

SGI = np.float32(1.0 - 0.22)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


# a sweep of Sg plus the curves' kinks: Sgc (krgo's zero), 1 - Swmin - Sorg
# (krog's zero and krgo's switch to its end point) and Sgi itself, where the
# saturation model's HardLayer pins Sg at t0
SG = np.concatenate([np.linspace(0.0, 1.0, 97), [0.05, 0.58, SGI, SGI, 0.0, 1.0]]
                    ).astype(np.float32)


def test_relperm_values_and_gradients_match():
    """krog, krgo and d/dSg of a weighted sum of both, with JAX's gradient
    at every bound (``maximum``/``minimum`` split it 0.5/0.5 at a tie)."""
    wts = np.random.RandomState(0).uniform(0.5, 1.5, (2,) + SG.shape).astype(np.float32)

    def jloss(sg):
        krog, krgo = JaxRelperm()(sg)
        return jnp.sum(krog * wts[0]) + jnp.sum(krgo * wts[1]), (krog, krgo)

    (_, want), want_grad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(SG))
    sg = torch.from_numpy(SG).requires_grad_(True)
    got = RelativePermeability()(sg)
    (got[0] * torch.from_numpy(wts[0]) + got[1] * torch.from_numpy(wts[1])).sum().backward()
    # float32 pow in two libraries: an ulp or two of each curve
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(sg.grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-6)


def test_relperm_gradient_at_sgi_is_the_references():
    """At Sg = Sgi exactly both curves sit on a bound (krog at 0, krgo at its
    end point): the gradient there is JAX's, not torch.clamp's."""
    want = jax.grad(lambda s: jnp.sum(jnp.stack(JaxRelperm()(s))))(jnp.asarray(SGI))
    sg = torch.tensor(SGI, requires_grad=True)
    torch.stack(RelativePermeability()(sg)).sum().backward()
    assert float(sg.grad) == float(want)


def _gc_pvt_pair():
    cfg = get_configuration("pvt_layer", fluid_type="GC", fitting_method="spline")
    cfg["spline_order"] = 1                           # the model map's order
    layer = make_pvt_layer(cfg)
    return (lambda p: layer.apply({}, p)), make_spline_pvt(cfg, load_pvt_table(),
                                                           properties=GC_PROPERTIES)


PRESSURES = np.concatenate([
    np.random.RandomState(2).uniform(500.0, 9000.0, 40),
    [10.0, 14.7, 14.70001, 100.0, 5000.0, 9999.99, 10000.0, 12000.0],
]).astype(np.float32).reshape(2, 4, 6)


def test_seven_property_pvt_matches():
    """Values and d/dP of the seven GC properties (invBg, invBo, invug,
    invuo, Rs, Rv, Vro). Spline order 1 is well conditioned: the float32
    contractions of the two libraries agree to ~1e-6 of each property's
    scale, as for the two DG properties (test_torch_physics)."""
    jax_fn, pvt = _gc_pvt_pair()
    want = np.asarray(jax_fn(jnp.asarray(PRESSURES)))
    got = pvt(torch.from_numpy(PRESSURES)).numpy()
    assert got.shape == want.shape == (2, 7) + PRESSURES.shape
    for k in range(2):
        for prop in range(7):
            w, g = want[k, prop], got[k, prop]
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * np.abs(w).max(),
                                       err_msg=f"output {k} {GC_PROPERTIES[prop]}")


def test_seven_property_pvt_gradient_matches():
    jax_fn, pvt = _gc_pvt_pair()
    p = np.random.RandomState(3).uniform(1000.0, 8000.0, (3, 5)).astype(np.float32)
    wts = np.random.RandomState(4).uniform(0.5, 1.5, (2, 7, 3, 5)).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(jax_fn(v) * wts))(jnp.asarray(p))
    pt = torch.from_numpy(p).requires_grad_(True)
    (pvt(pt) * torch.from_numpy(wts)).sum().backward()
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-4 * np.abs(np.asarray(want)).max())


def test_gc_well_rates_split_and_bhp_match():
    """((qgg, qgo, qoo, qog), pwf) and the gradient of a weighted sum of
    them with respect to the pressure and the saturation, on the dg9 well
    layout with Sg spread over [0.3, Sgi] (Sgi itself in some cells)."""
    g, res, wells, x, p = _well_case()
    g["fluid_type"] = "GC"
    sg = np.random.RandomState(6).uniform(0.3, SGI, p.shape).astype(np.float32)
    sg[0] = SGI                                            # the t0 sample
    ds = _Summary()
    jax_fn, pvt = _gc_pvt_pair()
    jw = JaxWells(fluid_type="GC", data_summary=ds.jax, pvt_fn=jax_fn, general_config=g,
                  reservoir_config=res, wells_config=wells)
    tw = WellRatesPressure(ds.torch, torch.device("cpu"), fluid_type="GC", general_config=g,
                           reservoir_config=res, wells_config=wells)
    wq = np.random.RandomState(7).uniform(0.5, 1.5, 5).astype(np.float32)

    def jloss(pp, ss):
        q, pwf = jw.compute_rates_and_bhp(jnp.asarray(x), pp, ss, model_PVT=jax_fn)
        return sum(jnp.sum(qi * w) for qi, w in zip(q, wq)) + jnp.sum(pwf * wq[4]), (q, pwf)

    (_, (qj, pwfj)), (gpj, gsj) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(p), jnp.asarray(sg))
    pt = torch.from_numpy(p).requires_grad_(True)
    st = torch.from_numpy(sg).requires_grad_(True)
    qt, pwft = tw.compute_rates_and_bhp(torch.from_numpy(x), pt, pvt, Sg_n1=st)
    (sum((qi * float(w)).sum() for qi, w in zip(qt, wq)) + (pwft * float(wq[4])).sum()).backward()

    assert len(qt) == 4 and all(q.shape == p.shape for q in qt)
    assert all(int((q > 0).sum()) > 0 for q in qt)
    # rates: float32 Peaceman index, PVT and relperm products in another
    # rounding order (as the DG well test)
    for name, a, b in zip(("qgg", "qgo", "qoo", "qog"), qt, qj):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(np.asarray(b)).max()), err_msg=name)
    np.testing.assert_allclose(pwft.detach().numpy(), np.asarray(pwfj), rtol=1e-5, atol=1e-2)
    for name, a, b in (("d/dp", pt.grad, gpj), ("d/dSg", st.grad, gsj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3,
                                   atol=1e-5 * float(np.abs(np.asarray(b)).max()), err_msg=name)


def test_blocking_factor_is_refused():
    """The blocking-factor integral needs the root solvers, which are not
    ported: asking for it raises instead of running without it."""
    g, res, wells, _, _ = _well_case()
    with pytest.raises(NotImplementedError):
        WellRatesPressure(_Summary().torch, torch.device("cpu"), fluid_type="GC",
                          general_config=g, reservoir_config=res, wells_config=wells,
                          use_blocking_factor=True)
