"""The port's gas-condensate stencil (kernel B3) against the JAX package's.

On the CPU the port's wrapper takes the plain PyTorch version; it is held
against the reference's jnp twin (``_gc_jnp_forward``) and its Pallas
kernel in interpret mode on the same numpy inputs, as
``test_torch_kernels`` holds B1. The CUDA kernel itself is checked on a GPU
only (``test_torch_cuda``).

The reference's own tests never run its GC kernel. Run here, its fused
twin and its unfused ``gc_residual_from_fields`` (the path its PhysicsLoss
takes off the TPU) agree up to the order of the tank-balance sums
(``test_reference_fused_and_unfused_paths_agree``).

The truncation errors trn_g and trn_o are float32 rounding noise: their
numerator ``t2·m0 + t1·m2 − (t1+t2)·m1`` is zero in exact arithmetic (m2
is extrapolated with the same ratio), so they are held to their rounding
bound around the exact value ``(dv/D)·(ε/4)/t1``, as
``tests/test_tf_golden.py`` holds the reference's, not elementwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srm_tpu.kernels import stencil_pallas as ref
from srm_tpu.losses.physics_loss import gc_residual_from_fields
from srm_tpu_torch.kernels import stencil as st
from test_torch_cuda import gc_inputs

# the reference's own kernel-vs-twin tolerance (tests/test_pallas_kernels.py)
# relative; the divergences cancel terms ~1e4 larger than their result, so
# the absolute part is 1e-5 of each output's largest value
RTOL, ATOL_REL = 5e-3, 1e-5
OUTPUTS = ("dom_g", "dom_o", "ibc", "trn_g", "trn_o", "mbc_g", "mbc_o")
NOISY = ("trn_g", "trn_o")
SHAPES = [(3, 13, 13), (2, 9, 14)]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def _torch(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


def _jax(args):
    return tuple(jnp.asarray(a) for a in args[:25]), jnp.asarray(args[25]), jnp.asarray(args[26])


def _trn_bound(args, cfg):
    """(exact value, float32 rounding bound) of trn_g + trn_o: the bound of
    tests/test_tf_golden.py, 8 float32 ulps of (t1 + t2)·(|m_g| + |m_o|)
    over the denominator, per cell."""
    f = dict(zip(st.GC_ARGS, args))
    c = lambda a: a[:, 1:-1, 1:-1].astype(np.float64)  # noqa: E731
    t = args[26].astype(np.float64)
    t1, t2 = t[:, 0, None, None], t[:, 1, None, None]
    dv_D = cfg["dx"] * cfg["dy"] * cfg["dz"] / cfg["D"]
    so_max = 1.0 - cfg["Swmin"]
    m = [cfg["phi"] * (np.abs(f["invBg0"] * f["Sg0"]) + np.abs(f["Rs0"] * f["invBo0"]) * so_max
                       + np.abs(f["invBo0"]) * so_max + np.abs(f["Rv0"] * f["invBg0"] * f["Sg0"])),
         cfg["phi"] * (np.abs(c(f["invBg1p"]) * f["Sg1"]) + np.abs(c(f["Rs1p"]) * c(f["invBo1p"]))
                       * so_max + np.abs(c(f["invBo1p"])) * so_max
                       + np.abs(c(f["Rv1p"]) * c(f["invBg1p"]) * f["Sg1"]))]
    bound = (8 * np.finfo(np.float32).eps * dv_D * (t1 + t2) * np.maximum(m[0], m[1])
             / (t1 * t2 + t2 * t2))
    return 2 * dv_D * (ref.EPSILON * 0.25) / t1, bound


def _check(got, want, args, cfg):
    exact, bound = _trn_bound(args, cfg)
    for name, g, w in zip(OUTPUTS, got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, name
        if name not in NOISY:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL_REL * np.abs(w).max(),
                                       err_msg=name)
    for label, out in (("port", got), ("reference", want)):
        trn = np.asarray(out[3], np.float64) + np.asarray(out[4], np.float64)
        assert np.all(np.abs(trn - exact) <= bound), label


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("jax_fn", ["jnp_twin", "pallas_interpret"])
def test_plain_stencil_matches_reference(shape, jax_fn):
    args, cfg = gc_inputs(*shape)
    jfn = ref._gc_jnp_forward if jax_fn == "jnp_twin" else ref.gc_stencil_residual
    want = jfn(*_jax(args), ref.GCStencilConfig(**cfg))
    got = st.gc_stencil_residual(*_torch(args), st.GCStencilConfig(**cfg))
    _check([g.numpy() for g in got], want, args, cfg)


def test_reference_fused_and_unfused_paths_agree():
    """The reference's fused twin against its unfused gc_residual_from_fields
    on the same fields: equal but for the order of the mbc sums (a few
    float32 ulps of their size)."""
    args, cfg = gc_inputs(3, 13, 13)
    f = dict(zip(st.GC_ARGS, args))
    c = lambda a: a[:, 1:-1, 1:-1]  # noqa: E731
    t = args[26]
    unfused = gc_residual_from_fields(
        *(jnp.asarray(a) for a in (
            f["p0"], c(f["p1p"]), f["Sg0"], f["Sg1"], f["invBg0"], f["invBo0"], f["Rs0"],
            f["Rv0"], c(f["invBg1p"]), c(f["invBo1p"]), c(f["invug1p"]), c(f["invuo1p"]),
            c(f["Rs1p"]), c(f["Rv1p"]), f["dinvBg0"], f["dinvBo0"], f["dRs0"], f["dRv0"],
            c(f["krgo1p"]), c(f["krog1p"]), f["qfg"], f["qdg"], f["qfo"], f["qvo"], args[25],
            c(f["kxp"]), np.full_like(f["p0"], cfg["phi"]), t[:, :1, None], t[:, 1:, None])),
        C=cfg["C"], D=cfg["D"], dx=cfg["dx"], dy=cfg["dy"], dz=cfg["dz"], Swmin=cfg["Swmin"])
    dom_g, dom_o, ibc, mbc_g, mbc_o, trn_g, trn_o = unfused
    fused = ref._gc_jnp_forward(*_jax(args), ref.GCStencilConfig(**cfg))
    for name, a, b in zip(OUTPUTS, fused, (dom_g, dom_o, ibc, trn_g, trn_o, mbc_g, mbc_o)):
        a, b = np.asarray(a), np.asarray(b)
        if name.startswith("mbc"):
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_wrapper_on_cpu_is_the_plain_version():
    args, cfg = gc_inputs(2, 7, 8)
    cfg = st.GCStencilConfig(**cfg)
    before = st.launches_gc
    got = st.gc_stencil_residual(*_torch(args), cfg)
    want = st.gc_stencil_residual_reference(*_torch(args), cfg)
    assert len(got) == 7
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert st.launches_gc == before           # the plain version never counts


WRT = {"p1p": 1, "Sg1": 4, "krgo1p": 5, "invBg1p": 15, "tsteps": 26}


@pytest.mark.parametrize("wrt", list(WRT))
def test_gradient_matches_reference_custom_vjp(wrt):
    """GCStencilResidualFn's backward vs jax.grad through the Pallas kernel's
    custom vjp, for a loss of every output but the noisy trn fields."""
    args, cfg = gc_inputs(2, 9, 9)
    i = WRT[wrt]

    def loss_jax(v):
        a = [jnp.asarray(x) for x in args]
        a[i] = v
        out = ref.gc_stencil_residual(tuple(a[:25]), a[25], a[26], ref.GCStencilConfig(**cfg))
        return sum(jnp.sum(o**2) for k, o in zip(OUTPUTS, out) if k not in NOISY)

    want = np.asarray(jax.grad(loss_jax)(jnp.asarray(args[i])))
    a = _torch(args)
    a[i] = a[i].clone().requires_grad_(True)
    out = st.gc_stencil_residual(*a, st.GCStencilConfig(**cfg))
    sum((o**2).sum() for k, o in zip(OUTPUTS, out) if k not in NOISY).backward()
    # the reference test's gradient tolerance (tests/test_pallas_kernels.py:66),
    # its absolute part relative to the gradient's scale
    np.testing.assert_allclose(a[i].grad.numpy(), want, rtol=5e-3,
                               atol=5e-3 * np.abs(want).max())


def test_function_gradient_equals_plain_autograd():
    """On the CPU the Function's backward is autograd through the plain
    version, so every input's gradient equals the plain path's — and none
    is NaN where dp = 0 (the first row), thanks to the safe_dp form."""
    args, cfg = gc_inputs(2, 7, 8)
    cfg = st.GCStencilConfig(**cfg)
    grads = []
    for fn in (st.gc_stencil_residual, st.gc_stencil_residual_reference):
        a = [t.requires_grad_(i != 25) for i, t in enumerate(_torch(args))]
        sum((o**2).sum() for o in fn(*a, cfg)).backward()
        grads.append([t.grad for i, t in enumerate(a) if i != 25])
    for g, w in zip(*grads):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["dtype", "padded_shape", "centred_shape", "contiguity",
                                  "qwell", "count", "config"])
def test_wrapper_rejects_bad_inputs(case):
    args, cfg = gc_inputs(2, 5, 6)
    a = _torch(args)
    cfg = st.GCStencilConfig(**cfg)
    if case == "dtype":
        a[7] = a[7].double()
    elif case == "padded_shape":
        a[1] = a[1][:, 1:]
    elif case == "centred_shape":
        a[0] = torch.nn.functional.pad(a[0], (1, 1, 1, 1))    # p0 is centred, unlike B1's
    elif case == "contiguity":
        a[3] = torch.empty(2, 6, 5).transpose(1, 2)          # (2, 5, 6), strided
    elif case == "qwell":
        a[25] = a[25][None]
    elif case == "count":
        a = a[:-1]
    else:
        cfg = st.StencilConfig(C=0.001127, D=5.6145833334, dx=1.0, dy=1.0, dz=1.0, Sgi=0.78,
                               krgo=0.9, phi=0.2)
    with pytest.raises((TypeError, ValueError)):
        st.gc_stencil_residual(*a, cfg)
