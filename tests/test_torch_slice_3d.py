"""The dry-gas 3D training step of the port against the JAX package's, on a
9×9×9 case (``setup_case("DG", nx=9, nz=9, kle_method="uncorrelated")``,
6 realizations) with the same weights and fixed batches: residual fields,
every loss term, per-model gradients, well rates and BHP on a 3D pressure,
and the residual with a vertical anisotropy of 0.1.

Both packages run their unfused 7-point residual here (the reference's
inline branch of ``_residuals_dg_3d``, the port's
``dg3d_residual_from_fields``): the stencil switch is off anywhere but on
its accelerator, where the fused op runs (kernel B2 and its backward kernel
on a GPU). 9×9×9 is the smallest grid that the depth-4 encoder does not
collapse (ROADMAP C3).

As in 2D (tests/test_torch_slice.py), ``tde`` is float32 rounding noise
(ROADMAP C1), so the case runs with the ``tde`` weight at 0; the ``tde1``
tests run it at the default weight of 1.0 (ROADMAP C6).

This grid is harder on float32 than the 2D one: dz = 80/9 ft against
dx = 2900/9 ft, so the z faces carry ~1300× the weight of the x faces, and
``dom`` cancels terms ~1e7 times the size of the error it is left with.
Evaluated in float32 on the same float64 inputs, the 7-point stencil alone
lands ~2e-3 of ``dom``'s scale from its float64 value, and the reference's
float32 pressure gradient ~1e-3 to 2e-3 from a float64 evaluation. Where a
test compares float32 fields or gradients that carry this rounding, it
measures the rounding against the port's float64 evaluation of the same
function and states its bound from it.
"""

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
from srm_tpu_torch.kernels import stencil as st
from srm_tpu_torch.kernels.stencil import EPSILON, dg3d_stencil_residual_reference
from srm_tpu_torch.losses import physics_loss as tpl
from srm_tpu_torch.nn.convert import load_flax_params

# fixed batches of the 102 collapsed train samples (index k + K·t): the
# first holds t0 samples, where the HardLayer pins p to Pi
BATCHES = [[0, 1, 40, 77], [5, 30, 64, 101]]
FIELDS = ("dom", "ibc", "mbc", "p_n0", "p_n1", "tstep", "q", "pwf")
N = 9
# Model 2's float32 gradients at the default tde weight, both packages on
# their unfused residual: measured 2.7 and 4.1 of the reference's norm apart
# (test_per_model_gradients_at_the_default_tde_weight; ROADMAP C6)
TIME_STEP_GAP = 10.0


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    g = copy.deepcopy(DEFAULT_GENERAL_CONFIG)
    g["default_weights"]["gas"]["tde"] = 0.0
    kw = dict(nx=N, nz=N, kle_method="uncorrelated", n_realizations=6, general_config=g)
    jcase = jax_setup_case("DG", base_dir=str(tmp_path_factory.mktemp("jax_dg3d")), **kw)
    tcase = setup_case("DG", base_dir=str(tmp_path_factory.mktemp("torch_dg3d")),
                       device="cpu", **kw)
    load_flax_params(tcase["models"], jax.tree_util.tree_map(np.asarray, jcase["params"]))
    x_all, y_all = collapse_groups(jcase["train_groups"])
    batches = [(x_all[b], {k: v[b] for k, v in y_all.items()}) for b in BATCHES]
    res_j = jax.jit(jcase["loss_fn"].residuals)(jcase["params"], jnp.asarray(batches[0][0]))
    with torch.no_grad():
        res_t = tcase["loss_fn"].residuals(torch.from_numpy(batches[0][0]))
    return dict(jcase=jcase, tcase=tcase, batches=batches, res_j=res_j, res_t=res_t,
                grad_fn=jax.jit(jcase["loss_fn"].pinn_batch_sse_grad),
                loss64=_float64_loss(tcase["loss_fn"]))


def _float64_loss(loss_fn):
    """The port's loss with its networks and PVT in float64, through the
    unfused residual, which the loss selects on the CPU."""
    lf64 = copy.copy(loss_fn)
    lf64.models = {**loss_fn.models, **{k: copy.deepcopy(loss_fn.models[k]).double()
                                        for k in ("pressure", "time_step", "pvt_model")}}
    return lf64


@pytest.fixture(scope="module")
def stencil_rounding(cases):
    """The 7-point stencil's own float32 rounding on batch 0, per field: the
    largest distance between its float32 and float64 evaluations on the
    same (float64) inputs."""
    lf64 = cases["loss64"]
    with torch.no_grad():
        args, _ = lf64.stencil_inputs(torch.from_numpy(cases["batches"][0][0]).double())
        exact = dg3d_stencil_residual_reference(*args, lf64.stencil_cfg)
        f32 = dg3d_stencil_residual_reference(*[a.float() for a in args], lf64.stencil_cfg)
    return {name: float((a.double() - b).abs().max())
            for name, a, b in zip(("dom", "ibc"), f32, exact)}


def _t(batch):
    x, y = batch
    return torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in y.items()}


def _j(batch):
    x, y = batch
    return jnp.asarray(x), {k: jnp.asarray(v) for k, v in y.items()}


def _field(res, name):
    return res["gas"][name] if name in res["gas"] else res["outputs"][name]


def _assert_field_close(got, want, name, rounding=0.0):
    """Within 1e-3 of the field's scale, as in 2D (the networks agree to
    ~1e-6 relative, test_torch_nn_3d), plus, for the stencil's outputs,
    twice the stencil's own float32 rounding: two float32 evaluations of the
    same cancelling sum each lie within it of the exact value."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    bound = 1e-3 * scale + 2.0 * rounding
    assert err <= bound, f"{name}: max err {err:.3e} vs bound {bound:.3e} (scale {scale:.3e})"


def test_slice_is_3d_and_selects_the_fused_op(cases, monkeypatch):
    """Both switches are off on the CPU, so both packages run their unfused
    7-point residual (ROADMAP C6); with the switch on (on a GPU) the port
    runs the fused op B2 instead (here its plain version stands in for the
    kernel)."""
    from test_torch_slice import _selected
    jcase, tcase = cases["jcase"], cases["tcase"]
    lf = copy.copy(tcase["loss_fn"])
    assert lf.Nz == jcase["loss_fn"].Nz == N
    assert not lf.use_cuda_stencil and not jcase["loss_fn"].use_pallas_stencil
    x = torch.from_numpy(cases["batches"][0][0])
    args = (lf, x, monkeypatch, "dg3d_stencil_residual", "dg3d_residual_from_fields")
    assert _selected(*args) == ["unfused"]
    lf.use_cuda_stencil = True
    assert _selected(*args) == ["fused"]
    lf = tcase["loss_fn"]
    assert tuple(lf.q_well_idx.shape) == (N, N, N)
    np.testing.assert_array_equal(lf.q_well_idx.numpy(), jcase["loss_fn"].q_well_idx)
    x_j, _ = collapse_groups(jcase["train_groups"])
    x_t, _ = collapse_groups(tcase["train_groups"])
    assert x_t.shape[1:] == (1, N, N, N, 5)
    np.testing.assert_allclose(x_t, x_j, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("field", FIELDS)
def test_residual_fields_match(cases, stencil_rounding, field):
    _assert_field_close(_field(cases["res_t"], field).numpy(),
                        _field(cases["res_j"], field), field,
                        stencil_rounding.get(field, 0.0))


def test_stencil_rounding_is_what_the_bounds_assume(cases, stencil_rounding):
    """The rounding that widens the dom and ibc bounds is float32 noise, not
    a large error: under 5e-3 of the field's scale (measured ~2e-3)."""
    for name, r in stencil_rounding.items():
        assert r <= 5e-3 * float(np.abs(np.asarray(cases["res_j"]["gas"][name])).max()), name


def test_well_model_on_a_3d_pressure(cases):
    """Rates and BHP from the same (B, 1, D, H, W, 1) pressure and features:
    the well grids and the shut-in mask (time axis 1) are shape-generic."""
    jcase, tcase = cases["jcase"], cases["tcase"]
    x = cases["batches"][1][0]
    rng = np.random.RandomState(5)
    p = rng.uniform(4200.0, 5000.0, x.shape[:-1] + (1,)).astype(np.float32)
    jw, jm, jp = (jcase["models"]["well_rate_bhp_model"], jcase["models"]["pvt_model"],
                  jcase["params"]["pvt_model"])
    q_j, pwf_j = jw.compute_rates_and_bhp(
        jnp.asarray(x), jnp.asarray(p), None, relperm_model=jcase["loss_fn"].relperm,
        model_PVT=lambda v: jm.apply(jp, v))
    tm = tcase["models"]
    with torch.no_grad():
        q_t, pwf_t = tm["well_rate_bhp_model"].compute_rates_and_bhp(
            torch.from_numpy(x), torch.from_numpy(p), tm["pvt_model"])
    assert tuple(q_t.shape) == x.shape[:-1] + (1,)
    assert np.count_nonzero(np.asarray(q_j)) > 0
    # the same float32 formulas; the PVT spline is one matmul in each library
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(pwf_t.numpy(), np.asarray(pwf_j), rtol=1e-5, atol=1e-2)


class _Fake:
    """Stands in for a reference model: returns the given arrays."""

    def __init__(self, **out):
        self.__dict__.update(out)

    def apply(self, params, p):
        return self.pvt01

    def compute_rates_and_bhp(self, *a, **kw):
        return self.q1, self.pwf


def test_unfused_residual_matches_reference_branch(cases):
    """The port's dg3d_residual_from_fields against the reference's inline
    unfused branch of _residuals_dg_3d (its networks, PVT and wells replaced
    by numpy-seeded fields on the case's scales; Δt constant per sample, in
    values whose spatial mean is exact), with vertical anisotropy 0.1: the
    same float32 operations in the same order, so dom, ibc and mbc agree to
    1e-5 of their scale and tde to within its rounding bound (ROADMAP C1)."""
    jcase, tcase = cases["jcase"], cases["tcase"]
    x = cases["batches"][0][0]
    B = x.shape[0]
    rng = np.random.RandomState(6)
    vol = (1, N, N, N, 1)
    t1, t2 = np.array([1.5, 2.25, 3.0, 4.75], np.float32), np.array([2.5, 1.25, 6.0, 3.5],
                                                                     np.float32)
    dtf = [np.broadcast_to(t.reshape(B, 1, 1, 1, 1, 1), (B,) + vol).copy() for t in (t1, t2)]
    p01 = rng.uniform(4500.0, 5000.0, (2 * B,) + vol).astype(np.float32)
    p01[B:] -= rng.uniform(0.0, 50.0, (B,) + vol).astype(np.float32)
    pvt01 = np.stack([np.stack([rng.uniform(0.9, 1.2, p01.shape), rng.uniform(30, 40, p01.shape)]),
                      np.stack([rng.uniform(1e-4, 3e-4, p01.shape),
                                rng.uniform(-1e-3, 0, p01.shape)])]).astype(np.float32)
    q1 = np.zeros((B,) + vol, np.float32)
    q1[(slice(None), 0) + tuple(np.nonzero(tcase["loss_fn"].q_well_idx.numpy()))] = 500.0
    jlf = copy.copy(jcase["loss_fn"])
    jlf.kv_kh = 0.1
    calls = iter([dtf[0], dtf[1]])
    jlf._net = lambda name, params, x_, training=True: jnp.asarray(
        next(calls) if name == "time_step" else p01)
    jlf.models = {**jlf.models, "pvt_model": _Fake(pvt01=jnp.asarray(pvt01)),
                  "well_rate_bhp_model": _Fake(q1=jnp.asarray(q1), pwf=jnp.zeros_like(q1))}
    want = jlf._residuals_dg_3d(jcase["params"], jnp.asarray(x))["gas"]

    sq = lambda a: torch.from_numpy(np.ascontiguousarray(np.asarray(a)[:, 0, ..., 0]))  # noqa: E731
    kx = torch.from_numpy(np.array(jlf._denorm_permx(jnp.asarray(x)[..., 4]))[:, 0])
    lf = tcase["loss_fn"]
    krgo = lf.relperm(torch.tensor(lf.Sgi, dtype=torch.float32))[1]
    invBg1, invug1 = sq(pvt01[0, 0, B:]), sq(pvt01[0, 1, B:])
    got = tpl.dg3d_residual_from_fields(
        sq(p01[:B]), sq(p01[B:]), sq(pvt01[0, 0, :B]), invBg1, invBg1 * invug1,
        sq(pvt01[1, 0, :B]), sq(q1), lf.q_well_idx, kx, 0.1 * kx, torch.full_like(kx, lf.phi0),
        torch.from_numpy(t1).reshape(B, 1, 1, 1), torch.from_numpy(t2).reshape(B, 1, 1, 1),
        krgo, lf.C, lf.D, lf.dx, lf.dy, lf.dz, lf.Sgi)
    for name, g in zip(("dom", "ibc", "mbc"), got):
        w = np.asarray(want[name], np.float64).reshape(tuple(g.shape))
        err, scale = np.abs(g.numpy() - w).max(), np.abs(w).max()
        assert err <= 1e-5 * scale, f"{name}: {err:.3e} of scale {scale:.3e}"
    p0, p1 = (sq(p01[s_]).double() for s_ in (slice(None, B), slice(B, None)))
    T1, T2 = (torch.from_numpy(t).double().reshape(B, 1, 1, 1) for t in (t1, t2))
    p2 = (p1 - p0) * (1.0 + T2 / T1) + p0
    terms = (T2 * p0).abs() + (T1 * p2).abs() + ((T1 + T2) * p1).abs()
    cp1 = lf.Sgi * lf.phi0 * (sq(pvt01[1, 0, :B]).double() + st.rock_compressibility(lf.phi0)
                              * sq(pvt01[0, 0, :B]).double())
    coef = (lf.dx * lf.dy * lf.dz / lf.D) * cp1
    exact = coef * (2.0 * EPSILON / T1)
    bound = coef.abs() * 16 * np.finfo(np.float32).eps * terms / (T1 * T2 + T2 * T2)
    for tde in (got[3].double(), torch.from_numpy(np.asarray(want["tde"], np.float64)
                                                  .reshape(tuple(got[3].shape)))):
        assert bool(((tde - exact).abs() <= bound + 1e-6 * exact.abs()).all())


@pytest.fixture(scope="module")
def tde1(cases):
    """Both loss functions at the default ``tde`` weight of 1.0."""
    jlf, tlf = copy.copy(cases["jcase"]["loss_fn"]), copy.copy(cases["tcase"]["loss_fn"])
    w = DEFAULT_GENERAL_CONFIG["default_weights"]["gas"]["tde"]
    assert w == 1.0
    for lf in (jlf, tlf):
        lf.weights = copy.deepcopy(lf.weights)
        lf.weights["gas"]["tde"] = w
    lf64 = copy.copy(cases["loss64"])
    lf64.weights = tlf.weights
    return dict(tlf=tlf, lf64=lf64, grad_fn=jax.jit(jlf.pinn_batch_sse_grad))


def test_loss_terms_match_at_the_default_tde_weight(cases, tde1):
    """Every weighted term, tde's included, within 1e-3 as at weight 0."""
    aux_j, _, total_j = tde1["grad_fn"](cases["jcase"]["params"], *_j(cases["batches"][0]))
    with torch.no_grad():
        total_t, aux_t = tde1["tlf"].loss_and_metrics(*_t(cases["batches"][0]))
    assert float(aux_j["gas"]["tde"]) > 0
    for term, v in aux_j["gas"].items():
        np.testing.assert_allclose(float(aux_t["gas"][term]), float(v), rtol=1e-3,
                                   atol=1e-6 * float(total_j), err_msg=term)
    np.testing.assert_allclose(float(total_t), float(total_j), rtol=1e-3)


@pytest.mark.parametrize("b", [0, 1])
def test_per_model_gradients_at_the_default_tde_weight(cases, tde1, b):
    """At the default ``tde`` weight both packages run the same unfused
    7-point residual on the CPU (ROADMAP C6). Model 1's gradient is held as
    at weight 0 (test_pressure_gradient_matches; measured 1.2e-3 and
    3.2e-3 apart on batches 0 and 1, the reference 1.3e-3 and 2.3e-3 from
    float64). Model 2's is tde's float32 noise (C1, C2): both packages'
    float32 gradients are 1.9e3x to 2.1e5x the norm of the float64 one,
    measured 2.7 and 4.1 of the reference's norm apart, held to
    TIME_STEP_GAP, each at least 100x its float64 value."""
    tcase, batch = cases["tcase"], cases["batches"][b]
    _, grads_j, _ = tde1["grad_fn"](cases["jcase"]["params"], *_j(batch))
    _, grads_t, _ = tde1["tlf"].pinn_batch_sse_grad(*_t(batch))
    x, y = _t(batch)
    _, g64, _ = tde1["lf64"].pinn_batch_sse_grad(x.double(),
                                                 {k: v.double() for k, v in y.items()})
    holder = {k: copy.deepcopy(tcase["models"][k]) for k in ("pressure", "time_step")}
    load_flax_params(holder, jax.tree_util.tree_map(np.asarray, grads_j))
    grads_j = {k: [p.detach() for p in m.parameters()] for k, m in holder.items()}
    ref_err = _rel(grads_j["pressure"], g64["pressure"])
    port_err = _rel(grads_t["pressure"], g64["pressure"])
    rel = _rel(grads_t["pressure"], grads_j["pressure"])
    gap = _rel(grads_t["time_step"], grads_j["time_step"])
    assert ref_err <= 1e-2, f"reference {ref_err:.2e} from the port's float64 gradient"
    assert port_err <= ref_err + 1e-3, f"port {port_err:.2e} from float64, reference {ref_err:.2e}"
    assert rel <= 2 * ref_err + 1e-3, f"relative error {rel:.2e}, reference's own {ref_err:.2e}"
    assert gap <= TIME_STEP_GAP, f"time_step: the packages' gradients {gap:.2e} apart"
    for grads in (grads_t, grads_j):
        assert all(torch.isfinite(g).all() for g in grads["time_step"])
        assert _rel(grads["time_step"], g64["time_step"]) >= 100.0


def test_loss_terms_match(cases):
    aux_j, _, total_j = cases["grad_fn"](cases["jcase"]["params"], *_j(cases["batches"][0]))
    with torch.no_grad():
        total_t, aux_t = cases["tcase"]["loss_fn"].loss_and_metrics(*_t(cases["batches"][0]))
    assert set(aux_t["gas"]) == set(aux_j["gas"])
    for term, v in aux_j["gas"].items():
        np.testing.assert_allclose(float(aux_t["gas"][term]), float(v), rtol=1e-3,
                                   atol=1e-6 * float(total_j), err_msg=term)
    np.testing.assert_allclose(float(total_t), float(total_j), rtol=1e-3)


def _rel(got, want):
    num = torch.sqrt(sum(((g.double() - w.double()) ** 2).sum() for g, w in zip(got, want)))
    den = torch.sqrt(sum((w.double() ** 2).sum() for w in want))
    assert float(den) > 0
    return float(num / den)


def _grads(cases, b):
    """Per-model gradients on batch ``b``: the port's float32, the
    reference's float32 (in the port's layout) and the port's float64."""
    tcase, batch = cases["tcase"], cases["batches"][b]
    _, grads_j, _ = cases["grad_fn"](cases["jcase"]["params"], *_j(batch))
    _, grads_t, _ = tcase["loss_fn"].pinn_batch_sse_grad(*_t(batch))
    x, y = _t(batch)
    _, grads_64, _ = cases["loss64"].pinn_batch_sse_grad(
        x.double(), {k: v.double() for k, v in y.items()})
    holder = {k: copy.deepcopy(tcase["models"][k]) for k in ("pressure", "time_step")}
    load_flax_params(holder, jax.tree_util.tree_map(np.asarray, grads_j))
    return grads_t, {k: [p.detach() for p in m.parameters()] for k, m in holder.items()}, grads_64


@pytest.mark.parametrize("b", [0, 1])
def test_pressure_gradient_matches(cases, b):
    """Model 1's gradient. The reference's float32 gradient lies within
    1e-2 of the port's float64 one (the same function; measured 1.3e-3 and
    2.3e-3, the stencil's rounding). The port's float32 gradient is no
    further from it than the reference's, plus 1e-3, as slice 1 holds
    Model 1 (tests/test_torch_slice.py); and the two float32 gradients, each
    carrying that rounding, are within twice the reference's share of it
    plus 1e-3 of each other (measured 1.4e-3 and 3.2e-3)."""
    grads_t, grads_j, grads_64 = _grads(cases, b)
    ref_err = _rel(grads_j["pressure"], grads_64["pressure"])
    port_err = _rel(grads_t["pressure"], grads_64["pressure"])
    rel = _rel(grads_t["pressure"], grads_j["pressure"])
    assert ref_err <= 1e-2, f"reference {ref_err:.2e} from the port's float64 gradient"
    assert port_err <= ref_err + 1e-3, f"port {port_err:.2e} from float64, reference {ref_err:.2e}"
    assert rel <= 2 * ref_err + 1e-3, f"relative error {rel:.2e}, reference's own {ref_err:.2e}"


@pytest.mark.parametrize("b", [0, 1])
def test_time_step_gradient_matches(cases, b):
    """Model 2's gradient on its initial weights (ROADMAP C2): in float32
    it is rounding noise in both packages, here 0.5x (batch 0) and 2.0x
    (batch 1) its norm away from the float64 gradient. Both packages round
    the same chain of operations, so their noise agrees closely (measured
    1.8e-3 and 1.9e-2 of its norm); a fault in the port's Δt network, its
    Δt chain or the stencil's t1/t2 terms would put them O(1) apart. Held
    to 5e-2, and the port's float64 gradient is finite and non-zero."""
    grads_t, grads_j, grads_64 = _grads(cases, b)
    rel = _rel(grads_t["time_step"], grads_j["time_step"])
    assert rel <= 5e-2, f"time_step: relative gradient error {rel:.2e}"
    assert all(torch.isfinite(g).all() for g in grads_64["time_step"])
    assert sum(float(g.abs().sum()) for g in grads_64["time_step"]) > 0


def test_vertical_anisotropy(cases):
    """kv/kh = 0.1 on both sides: the residual changes (the z faces carry
    the scaled kz) and the port still matches the reference."""
    jlf = copy.copy(cases["jcase"]["loss_fn"])
    tlf = copy.copy(cases["tcase"]["loss_fn"])
    jlf.kv_kh = tlf.kv_kh = 0.1
    x = cases["batches"][0][0]
    res_j = jax.jit(jlf.residuals)(cases["jcase"]["params"], jnp.asarray(x))
    with torch.no_grad():
        res_t = tlf.residuals(torch.from_numpy(x))
    for name in ("dom", "ibc", "mbc"):
        _assert_field_close(res_t["gas"][name].numpy(), res_j["gas"][name], name)
    dom_iso = cases["res_t"]["gas"]["dom"]
    assert not torch.allclose(res_t["gas"]["dom"], dom_iso, rtol=1e-3)


def test_trainer_runs_epochs_on_3d_samples(cases):
    """The Trainer stages (K, T, 1, D, H, W, 5) groups and runs its epoch
    loop on them unchanged: finite losses, both models move."""
    from srm_tpu_torch.training.trainer import train_combined_models_unified
    tcase = cases["tcase"]
    loss_fn = copy.copy(tcase["loss_fn"])
    loss_fn.models = {**tcase["models"], **{k: copy.deepcopy(tcase["models"][k])
                                            for k in ("pressure", "time_step")}}
    before = {k: [p.detach().clone() for p in loss_fn.models[k].parameters()]
              for k in ("pressure", "time_step")}
    trainer, history = train_combined_models_unified(
        tcase["train_groups"], tcase["val_groups"], loss_fn, training_batch_size=32,
        epochs=2, general_config=tcase["general_config"], verbose=0)
    x, _, nb, bs = trainer._resident["train"]
    assert tuple(x.shape[1:]) == (1, N, N, N, 5) and (nb, bs) == (3, 32)
    assert len(history["step_total_loss"]) == 2 * nb
    assert np.all(np.isfinite(history["step_total_loss"]))
    assert np.all(np.isfinite(history["total_val_loss"]))
    for k, ps in before.items():
        assert not all(torch.equal(a, b) for a, b in zip(ps, loss_fn.models[k].parameters())), k
