"""The port's DG stencil (kernel B1) against the JAX package's.

On the CPU the port's wrapper takes the plain PyTorch version; it is held
against the reference's jnp twin and its Pallas kernel in interpret mode on
the same numpy inputs. The CUDA kernel itself is checked on a GPU only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srm_tpu.kernels import stencil_pallas as ref
from srm_tpu_torch.kernels import build
from srm_tpu_torch.kernels import stencil as st

# the reference's own kernel-vs-twin tolerance (tests/test_pallas_kernels.py):
# op-by-op float32 evaluation in two frameworks rounds differently, and the
# divergence is a cancellation of terms ~1e4 larger than its result
RTOL, ATOL = 5e-3, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def _make_inputs(B=3, H=13, W=13, seed=0):
    """Numpy inputs of tests/test_pallas_kernels.py:13-34."""
    rng = np.random.RandomState(seed)
    pad = lambda a: np.pad(a, [(0, 0), (1, 1), (1, 1)], mode="symmetric")  # noqa: E731
    p0 = rng.uniform(4500, 5000, (B, H, W)).astype(np.float32)
    p1 = p0 - rng.uniform(0, 50, (B, H, W)).astype(np.float32)
    kx = rng.uniform(0.5, 10.0, (B, H, W)).astype(np.float32)
    invBg = rng.uniform(0.9, 1.2, (B, H, W)).astype(np.float32)
    invug = rng.uniform(30, 40, (B, H, W)).astype(np.float32)
    invBg1 = invBg * 0.99
    dinvBg = rng.uniform(1e-4, 3e-4, (B, H, W)).astype(np.float32)
    q = np.zeros((B, H, W), np.float32)
    q[:, H // 2, W // 2] = 500.0
    qwell = np.zeros((H, W), np.float32)
    qwell[H // 2, W // 2] = 1.0
    tsteps = rng.uniform(1.0, 9.0, (B, 2)).astype(np.float32)
    args = [pad(p0), pad(p1), pad(kx), pad(invBg * invug), invBg, invBg1, dinvBg, q,
            qwell, tsteps]
    cfg = dict(C=0.001127, D=5.6145833334, dx=74.36, dy=74.36, dz=80.0, Sgi=0.78,
               krgo=0.8, phi=0.2)
    return args, cfg


def _torch(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


SHAPES = [(3, 13, 13), (2, 9, 14)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("jax_fn", ["jnp_twin", "pallas_interpret"])
def test_plain_stencil_matches_reference(shape, jax_fn):
    args, cfg = _make_inputs(*shape)
    jfn = ref._jnp_forward if jax_fn == "jnp_twin" else ref.dg_stencil_residual
    want = jfn(*[jnp.asarray(a) for a in args], ref.StencilConfig(**cfg))
    got = st.dg_stencil_residual(*_torch(args), st.StencilConfig(**cfg))
    for name, g, w in zip(("dom", "ibc", "tde", "mbc"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def test_wrapper_on_cpu_is_the_plain_version():
    args, cfg = _make_inputs()
    cfg = st.StencilConfig(**cfg)
    before = st.launches
    got = st.dg_stencil_residual(*_torch(args), cfg)
    want = st.dg_stencil_residual_reference(*_torch(args), cfg)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert st.launches == before          # the plain version never counts


@pytest.mark.parametrize("wrt", [1, 9])   # p1p, tsteps
def test_gradient_matches_reference_custom_vjp(wrt):
    """DGStencilResidualFn's backward vs jax.grad through the Pallas
    kernel's custom vjp (loss of tests/test_pallas_kernels.py:54-64)."""
    args, cfg = _make_inputs(B=2, H=9, W=9)

    def loss_jax(v):
        a = [jnp.asarray(x) for x in args]
        a[wrt] = v
        dom, ibc, tde, mbc = ref.dg_stencil_residual(*a, ref.StencilConfig(**cfg))
        return jnp.sum(dom**2) + jnp.sum(ibc**2) + jnp.sum(mbc**2)

    want = jax.grad(loss_jax)(jnp.asarray(args[wrt]))
    a = _torch(args)
    a[wrt] = a[wrt].clone().requires_grad_(True)
    dom, ibc, tde, mbc = st.dg_stencil_residual(*a, st.StencilConfig(**cfg))
    ((dom**2).sum() + (ibc**2).sum() + (mbc**2).sum()).backward()
    # the reference test's gradient tolerance (tests/test_pallas_kernels.py:66)
    np.testing.assert_allclose(a[wrt].grad.numpy(), np.asarray(want), rtol=5e-3, atol=5e-3)


def test_function_gradient_equals_plain_autograd():
    """On the CPU the Function's backward is autograd through the plain
    version, so every input's gradient equals the plain path's."""
    args, cfg = _make_inputs(B=2, H=7, W=8)
    cfg = st.StencilConfig(**cfg)
    grads = []
    for fn in (st.dg_stencil_residual, st.dg_stencil_residual_reference):
        a = [t.requires_grad_(i != 8) for i, t in enumerate(_torch(args))]
        dom, ibc, tde, mbc = fn(*a, cfg)
        ((dom**2).sum() + (ibc**2).sum() + (tde**2).sum() + (mbc**2).sum()).backward()
        grads.append([t.grad for i, t in enumerate(a) if i != 8])
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity", "qwell"])
def test_wrapper_rejects_bad_inputs(case):
    args, cfg = _make_inputs(B=2, H=5, W=6)
    a = _torch(args)
    if case == "dtype":
        a[3] = a[3].double()
    elif case == "shape":
        a[0] = a[0][:, 1:]
    elif case == "contiguity":
        a[4] = torch.empty(2, 6, 5).transpose(1, 2)          # (2, 5, 6), strided
    else:
        a[8] = a[8][None]
    with pytest.raises((TypeError, ValueError)):
        st.dg_stencil_residual(*a, st.StencilConfig(**cfg))


def test_build_needs_nvcc_only_when_called(monkeypatch):
    """Importing the kernel module builds nothing; a build without nvcc
    raises instead of falling back."""
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.find_nvcc()
