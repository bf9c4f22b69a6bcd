"""The port's 3D DG stencil (kernel B2) and 3D stencil helpers against the
JAX package's.

On the CPU the port's wrapper takes the plain PyTorch version; it is held
against the reference's jnp twin and its Pallas kernel in interpret mode on
the same numpy inputs, with kz ≠ kx so that a mix-up of the horizontal and
vertical permeability shows. The CUDA kernel itself is checked on a GPU
only (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srm_tpu.kernels import stencil_pallas as ref
from srm_tpu.ops import stencil as jops
from srm_tpu_torch.kernels import stencil as st
from srm_tpu_torch.ops import stencil as tops

# the reference's own kernel-vs-twin tolerance (tests/test_pallas_kernels.py:
# 44-47): op-by-op float32 evaluation in two frameworks rounds differently,
# and the divergence cancels terms ~1e4 larger than its result; with
# dz = 8 ft against dx ≈ 74 ft the z faces carry ~86x the weight of the x
# faces, so the cancelled terms are larger still than in 2D
RTOL, ATOL = 5e-3, 1e-3
CFG = dict(C=0.001127, D=5.6145833334, dx=2900.0 / 39, dy=2900.0 / 39, dz=8.0, Sgi=0.78,
           krgo=0.8, phi=0.2)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def _make_inputs(B, D, H, W, kv_kh=0.1, seed=0):
    """Physically scaled numpy inputs (as tests/test_pallas_kernels.py makes
    them), padded as the loss pads them; kz = kv_kh · kx."""
    rng = np.random.RandomState(seed)
    pad = lambda a: np.pad(a, [(0, 0), (1, 1), (1, 1), (1, 1)], mode="symmetric")  # noqa: E731
    shp = (B, D, H, W)
    p0 = rng.uniform(4500, 5000, shp).astype(np.float32)
    p1 = p0 - rng.uniform(0, 50, shp).astype(np.float32)
    kx = rng.uniform(0.5, 10.0, shp).astype(np.float32)
    invBg = rng.uniform(0.9, 1.2, shp).astype(np.float32)
    invug = rng.uniform(30, 40, shp).astype(np.float32)
    dinvBg = rng.uniform(1e-4, 3e-4, shp).astype(np.float32)
    q = np.zeros(shp, np.float32)
    q[:, D // 2, H // 2, W // 2] = 500.0
    qwell = np.zeros((D, H, W), np.float32)
    qwell[D // 2, H // 2, W // 2] = 1.0
    tsteps = rng.uniform(1.0, 9.0, (B, 2)).astype(np.float32)
    args = [pad(p0), pad(p1), pad(kx), pad(np.float32(kv_kh) * kx), pad(invBg * invug),
            invBg, invBg * np.float32(0.99), dinvBg, q, qwell, tsteps]
    return args


def _torch(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


SHAPES = [(2, 3, 9, 9), (3, 4, 7, 11)]


@pytest.mark.parametrize("shape", SHAPES, ids=["2x3x9x9", "3x4x7x11"])
@pytest.mark.parametrize("jax_fn", ["jnp_twin", "pallas_interpret"])
def test_plain_stencil_matches_reference(shape, jax_fn):
    args = _make_inputs(*shape)
    jfn = ref._jnp_forward_3d if jax_fn == "jnp_twin" else ref.dg3d_stencil_residual
    want = jfn(*[jnp.asarray(a) for a in args], ref.StencilConfig(**CFG))
    got = st.dg3d_stencil_residual(*_torch(args), st.StencilConfig(**CFG))
    for name, g, w in zip(("dom", "ibc", "tde", "mbc"), got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def test_kz_enters_the_z_faces_only():
    """With kz scaled, only the z-face transmissibilities change: the
    residual differs from the isotropic one, and a kz that equals kx gives
    the isotropic result exactly."""
    iso = _make_inputs(2, 3, 5, 6, kv_kh=1.0)
    aniso = _make_inputs(2, 3, 5, 6, kv_kh=0.1)
    cfg = st.StencilConfig(**CFG)
    d_iso = st.dg3d_stencil_residual(*_torch(iso), cfg)[0]
    d_an = st.dg3d_stencil_residual(*_torch(aniso), cfg)[0]
    assert not torch.allclose(d_iso, d_an, rtol=1e-3)
    same = _torch(aniso)
    same[3] = same[2].clone()                          # kz := kx
    torch.testing.assert_close(st.dg3d_stencil_residual(*same, cfg)[0], d_iso, rtol=0, atol=0)


def test_wrapper_on_cpu_is_the_plain_version():
    args = _torch(_make_inputs(2, 3, 5, 6))
    cfg = st.StencilConfig(**CFG)
    before, before_2d = st.launches_3d, st.launches
    got = st.dg3d_stencil_residual(*args, cfg)
    want = st.dg3d_stencil_residual_reference(*args, cfg)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (st.launches_3d, st.launches) == (before, before_2d)   # the plain version never counts


@pytest.mark.parametrize("wrt", [1, 2, 3, 10], ids=["p1p", "kxp", "kzp", "tsteps"])
def test_gradient_matches_reference_custom_vjp(wrt):
    """DG3DStencilResidualFn's backward vs jax.grad through the reference's
    custom vjp (the Pallas kernel forward, its jnp twin's VJP backward)."""
    args = _make_inputs(2, 3, 6, 7)

    def loss_jax(v):
        a = [jnp.asarray(x) for x in args]
        a[wrt] = v
        dom, ibc, tde, mbc = ref.dg3d_stencil_residual(*a, ref.StencilConfig(**CFG))
        return jnp.sum(dom**2) + jnp.sum(ibc**2) + jnp.sum(mbc**2)

    want = np.asarray(jax.grad(loss_jax)(jnp.asarray(args[wrt])))
    a = _torch(args)
    a[wrt] = a[wrt].clone().requires_grad_(True)
    dom, ibc, tde, mbc = st.dg3d_stencil_residual(*a, st.StencilConfig(**CFG))
    ((dom**2).sum() + (ibc**2).sum() + (mbc**2).sum()).backward()
    # the reference's gradient tolerance (tests/test_pallas_kernels.py:66)
    np.testing.assert_allclose(a[wrt].grad.numpy(), want, rtol=5e-3, atol=5e-3)


def test_function_gradient_equals_plain_autograd():
    """On the CPU the Function's backward is autograd through the plain
    version, so every input's gradient equals the plain path's."""
    args = _make_inputs(2, 3, 5, 6)
    cfg = st.StencilConfig(**CFG)
    grads = []
    for fn in (st.dg3d_stencil_residual, st.dg3d_stencil_residual_reference):
        a = [t.requires_grad_(i != 9) for i, t in enumerate(_torch(args))]
        dom, ibc, tde, mbc = fn(*a, cfg)
        ((dom**2).sum() + (ibc**2).sum() + (tde**2).sum() + (mbc**2).sum()).backward()
        grads.append([t.grad for i, t in enumerate(a) if i != 9])
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity", "qwell", "rank"])
def test_wrapper_rejects_bad_inputs(case):
    a = _torch(_make_inputs(2, 3, 5, 6))
    if case == "dtype":
        a[4] = a[4].double()
    elif case == "shape":
        a[3] = a[3][:, 1:]
    elif case == "contiguity":
        a[5] = torch.empty(2, 3, 6, 5).transpose(2, 3)       # (2, 3, 5, 6), strided
    elif case == "qwell":
        a[9] = a[9][None]
    else:
        a = [t[:, 0] if t.dim() == 4 else t for t in a]      # 2D fields to the 3D op
    with pytest.raises((TypeError, ValueError)):
        st.dg3d_stencil_residual(*a, st.StencilConfig(**CFG))


# ---------------------------------------------------------------------------
# ops/stencil.py 3D helpers (the cases of tests/test_3d.py:19-31, and random
# fields through every helper)
# ---------------------------------------------------------------------------
def test_seven_point_uniform_pressure():
    p = tops.neighbors_3d(tops.pad_symmetric_3d(torch.full((1, 3, 4, 4), 5000.0)))
    a = torch.full((1, 3, 4, 4), 0.2)
    q = torch.zeros(1, 3, 4, 4)
    q[0, 1, 2, 2] = 77.0
    out = tops.seven_point_divergence(a, a, a, a, a, a, p, q / 3.0, 3.0)
    np.testing.assert_allclose(out.numpy(), q.numpy(), atol=1e-2)


def test_harmonic_faces_3d_constant():
    k = tops.neighbors_3d(tops.pad_symmetric_3d(torch.full((1, 3, 4, 4), 5.0)))
    for f in tops.harmonic_faces_3d(k, k):
        np.testing.assert_allclose(f.numpy(), 5.0, rtol=1e-6)


@pytest.mark.parametrize("lead", [(), (2,), (2, 1)], ids=["volume", "batch", "batch_time"])
def test_helpers_match_reference(lead):
    rng = np.random.RandomState(3)
    shp = lead + (3, 4, 5)
    kx, kz, f, p = (rng.uniform(0.5, 10.0, shp).astype(np.float32) for _ in range(4))
    a = [rng.uniform(0.1, 1.0, shp).astype(np.float32) for _ in range(6)]
    q = rng.uniform(-5, 5, shp).astype(np.float32)

    def run(ops, conv):
        pad, nb = ops.pad_symmetric_3d, ops.neighbors_3d
        padded = pad(conv(p))
        pn = nb(padded)
        return ([padded] + list(ops.harmonic_faces_3d(nb(pad(conv(kx))), nb(pad(conv(kz)))))
                + list(ops.average_faces_3d(nb(pad(conv(f)))))
                + [ops.seven_point_divergence(*map(conv, a), pn, conv(q), 80.0)])

    want = run(jops, jnp.asarray)
    got = run(tops, torch.from_numpy)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-3)
