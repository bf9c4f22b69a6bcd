"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Without a card every test here skips: a CUDA kernel has no CPU mode.
"""

import numpy as np
import pytest
import torch

from srm_tpu_torch.kernels import stencil as st

# the kernel keeps the plain version's operation order and is built without
# multiply-add contraction; they differ where PyTorch rounds otherwise (a
# division by a scalar as a reciprocal multiply, the order of the mbc sum):
# a few float32 ulps of each output's largest value
RTOL, ATOL_REL = 1e-4, 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, H, W, device, seed=0):
    """Physically scaled stencil inputs (as tests/test_pallas_kernels.py
    makes them), padded with replicate as the loss pads them."""
    rng = np.random.RandomState(seed)
    pad = lambda a: np.pad(a, [(0, 0), (1, 1), (1, 1)], mode="symmetric")  # noqa: E731
    p0 = rng.uniform(4500, 5000, (B, H, W)).astype(np.float32)
    p1 = p0 - rng.uniform(0, 50, (B, H, W)).astype(np.float32)
    kx = rng.uniform(0.5, 10.0, (B, H, W)).astype(np.float32)
    invBg = rng.uniform(0.9, 1.2, (B, H, W)).astype(np.float32)
    invug = rng.uniform(30, 40, (B, H, W)).astype(np.float32)
    dinvBg = rng.uniform(1e-4, 3e-4, (B, H, W)).astype(np.float32)
    q = np.zeros((B, H, W), np.float32)
    q[:, H // 2, W // 2] = 500.0
    qwell = np.zeros((H, W), np.float32)
    qwell[H // 2, W // 2] = 1.0
    tsteps = rng.uniform(1.0, 9.0, (B, 2)).astype(np.float32)
    args = [pad(p0), pad(p1), pad(kx), pad(invBg * invug), invBg, invBg * 0.99, dinvBg, q,
            qwell, tsteps]
    cfg = st.StencilConfig(C=0.001127, D=5.6145833334, dx=74.36, dy=74.36, dz=80.0,
                           Sgi=0.78, krgo=0.8, phi=0.2)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in args], cfg


def _close(got, want):
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL_REL * float(want.abs().max()))


# p0's gradient in B3 is a difference of large terms (the chord slopes and
# the accumulation), so the backward kernel, which rounds it in the explicit
# adjoint's order, and autograd, which rounds it in its own, differ by more
# than the forward's tolerance. The explicit adjoint in float32 (the
# kernel's order) differs from autograd by 1.9e-4 of the gradient's largest
# magnitude on these inputs at (32, 39, 39), where it sits 2.4e-4 and
# autograd 1.4e-4 from the float64 gradient (on the CPU; up to 3.6e-4 apart
# on chip_smoke.py's inputs over three seeds). Every other input holds to
# the forward's tolerance. The bound for p0 is 1e-3 of that magnitude.
CANCELLING_TOL = 1e-3


def _square_loss_grads(fn, args, cfg, skip):
    """Gradients of Σ (output²) with respect to every argument but ``skip``."""
    a = [t.clone().requires_grad_(i != skip) for i, t in enumerate(args)]
    sum((o**2).sum() for o in fn(*a, cfg)).backward()
    return [t.grad for i, t in enumerate(a) if i != skip]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 39, 39), (3, 13, 17), (1, 1, 300)])
def test_dg_stencil_kernel_matches_plain_version(cuda, shape):
    args, cfg = _inputs(*shape, cuda)
    before = st.launches
    got = st.dg_stencil_residual(*args, cfg)
    want = st.dg_stencil_residual_reference(*args, cfg)
    torch.cuda.synchronize()
    assert st.launches == before + 1
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.cuda
def test_dg_stencil_kernel_gradient_matches_plain_autograd(cuda):
    args, cfg = _inputs(32, 39, 39, cuda)
    got = _square_loss_grads(st.dg_stencil_residual, args, cfg, 8)
    want = _square_loss_grads(st.dg_stencil_residual_reference, args, cfg, 8)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.cuda
def test_dg_stencil_kernel_is_deterministic(cuda):
    args, cfg = _inputs(32, 39, 39, cuda)
    first = st.dg_stencil_residual(*args, cfg)
    for _ in range(3):
        for a, b in zip(first, st.dg_stencil_residual(*args, cfg)):
            assert torch.equal(a, b)


def _inputs_3d(B, D, H, W, device, kv_kh=0.1, seed=0):
    """3D stencil inputs on the main path's scales (dz = 80/10 ft), with
    kz = kv_kh · kx ≠ kx so that a mix-up of the two shows."""
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
    q[:, 0, H // 2, W // 2] = 500.0
    qwell = np.zeros((D, H, W), np.float32)
    qwell[0, H // 2, W // 2] = 1.0
    tsteps = rng.uniform(1.0, 9.0, (B, 2)).astype(np.float32)
    args = [pad(p0), pad(p1), pad(kx), pad(np.float32(kv_kh) * kx), pad(invBg * invug), invBg,
            invBg * np.float32(0.99), dinvBg, q, qwell, tsteps]
    cfg = st.StencilConfig(C=0.001127, D=5.6145833334, dx=2900.0 / 39, dy=2900.0 / 39,
                           dz=80.0 / D, Sgi=0.78, krgo=0.8, phi=0.2)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in args], cfg


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 10, 39, 39), (3, 5, 13, 17), (1, 1, 1, 300)])
def test_dg3d_stencil_kernel_matches_plain_version(cuda, shape):
    args, cfg = _inputs_3d(*shape, cuda)
    before, before_2d = st.launches_3d, st.launches
    got = st.dg3d_stencil_residual(*args, cfg)
    want = st.dg3d_stencil_residual_reference(*args, cfg)
    torch.cuda.synchronize()
    assert (st.launches_3d, st.launches) == (before + 1, before_2d)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.cuda
def test_dg3d_stencil_kernel_gradient_matches_plain_autograd(cuda):
    args, cfg = _inputs_3d(32, 10, 39, 39, cuda)
    grads = []
    for fn in (st.dg3d_stencil_residual, st.dg3d_stencil_residual_reference):
        a = [t.clone().requires_grad_(i != 9) for i, t in enumerate(args)]
        dom, ibc, tde, mbc = fn(*a, cfg)
        ((dom**2).sum() + (ibc**2).sum() + (tde**2).sum() + (mbc**2).sum()).backward()
        grads.append([t.grad for i, t in enumerate(a) if i != 9])
    for g, w in zip(*grads):
        _close(g, w)


@pytest.mark.cuda
def test_dg3d_stencil_kernel_is_deterministic(cuda):
    args, cfg = _inputs_3d(32, 10, 39, 39, cuda)
    first = st.dg3d_stencil_residual(*args, cfg)
    for _ in range(3):
        for a, b in zip(first, st.dg3d_stencil_residual(*args, cfg)):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_dg3d_stencil_refuses_a_mixed_device_call(cuda):
    """A CUDA call goes to the kernel or raises: no fallback."""
    args, cfg = _inputs_3d(2, 3, 5, 6, cuda)
    args[9] = args[9].cpu()
    with pytest.raises(ValueError):
        st.dg3d_stencil_residual(*args, cfg)


def gc_inputs(B, H, W, seed=0):
    """Numpy inputs of B3 on the scales of the gas-condensate case (the PVT
    table's values between 3500 and 5000 psia, two-phase saturations, rates
    in the well cell only), in GC_ARGS order, then qwell and tsteps, and
    the GCStencilConfig's fields. p1 equals p0 on the first row, where the
    chord slope is masked to 0."""
    rng = np.random.RandomState(seed)
    shp = (B, H, W)

    def u(lo, hi):
        return rng.uniform(lo, hi, shp).astype(np.float32)

    pad = lambda a: np.pad(a, [(0, 0), (1, 1), (1, 1)], mode="symmetric")  # noqa: E731
    p0 = u(4500.0, 5000.0)
    p1 = p0 - u(0.0, 50.0)
    p1[:, 0, :] = p0[:, 0, :]
    Sg0 = u(0.6, 0.78)
    Sg1 = Sg0 - u(0.0, 0.01)
    q = {k: np.zeros(shp, np.float32) for k in ("qfg", "qdg", "qfo", "qvo")}
    for k, v in zip(q, (1000.0, 500.0, 50.0, 300.0)):
        q[k][:, H // 2, W // 2] = v
    qwell = np.zeros((H, W), np.float32)
    qwell[H // 2, W // 2] = 1.0
    fields = dict(
        p0=p0, p1p=pad(p1), kxp=pad(u(0.5, 10.0)), Sg0=Sg0, Sg1=Sg1,
        krgo1p=pad(u(0.3, 0.9)), krog1p=pad(u(0.0, 0.05)),
        invBg0=u(1.85, 1.95), invBo0=u(0.30, 0.43), Rs0=u(3.3, 6.1), Rv0=u(0.045, 0.095),
        dinvBg0=u(0.5e-4, 1.5e-4), dinvBo0=u(-1e-4, 0.0), dRs0=u(2e-4, 6e-4),
        dRv0=u(0.0, 2e-5), invBg1p=pad(u(1.85, 1.95)), invBo1p=pad(u(0.30, 0.43)),
        invug1p=pad(u(14.0, 25.0)), invuo1p=pad(u(4.6, 9.1)), Rs1p=pad(u(3.3, 6.1)),
        Rv1p=pad(u(0.045, 0.095)), **q)
    tsteps = rng.uniform(1.0, 9.0, (B, 2)).astype(np.float32)
    args = [fields[name] for name in st.GC_ARGS] + [qwell, tsteps]
    cfg = dict(C=0.001127, D=5.6145833334, dx=2900.0 / 39, dy=2900.0 / 39, dz=80.0,
               Swmin=0.22, phi=0.2)
    return args, cfg


def _gc_on(device, B, H, W):
    args, cfg = gc_inputs(B, H, W)
    return ([torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in args],
            st.GCStencilConfig(**cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 39, 39), (3, 13, 17), (1, 1, 300)])
def test_gc_stencil_kernel_matches_plain_version(cuda, shape):
    args, cfg = _gc_on(cuda, *shape)
    before = (st.launches_gc, st.launches, st.launches_3d)
    got = st.gc_stencil_residual(*args, cfg)
    want = st.gc_stencil_residual_reference(*args, cfg)
    torch.cuda.synchronize()
    assert (st.launches_gc, st.launches, st.launches_3d) == (before[0] + 1,) + before[1:]
    assert len(got) == 7
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 39, 39), (3, 13, 17)])
def test_gc_stencil_kernel_gradient_matches_plain_autograd(cuda, shape):
    args, cfg = _gc_on(cuda, *shape)
    got = _square_loss_grads(st.gc_stencil_residual, args, cfg, 25)
    want = _square_loss_grads(st.gc_stencil_residual_reference, args, cfg, 25)
    for i, (g, w) in enumerate(zip(got, want)):
        if i == st.GC_ARGS.index("p0"):
            assert torch.isfinite(g).all()
            assert float((g - w).abs().max()) <= CANCELLING_TOL * float(w.abs().max())
        else:
            _close(g, w)


@pytest.mark.cuda
def test_gc_stencil_kernel_is_deterministic(cuda):
    """mbc_g and mbc_o (and every field) are bitwise the same run to run."""
    args, cfg = _gc_on(cuda, 32, 39, 39)
    first = st.gc_stencil_residual(*args, cfg)
    for _ in range(3):
        for a, b in zip(first, st.gc_stencil_residual(*args, cfg)):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_gc_stencil_refuses_rather_than_reroutes(cuda, monkeypatch):
    """A CUDA call whose library does not load raises; it is not sent to the
    plain version."""
    args, cfg = _gc_on(cuda, 2, 5, 6)

    def broken():
        raise OSError("the kernel library failed to load")

    monkeypatch.setattr(st, "_library_gc", broken)
    before = st.launches_gc
    with pytest.raises(OSError):
        st.gc_stencil_residual(*args, cfg)
    assert st.launches_gc == before


# ---------------------------------------------------------------------------
# backward kernels of B1 and B3
# ---------------------------------------------------------------------------
def _cotangents(outs, seed=1):
    """Cotangents of a stencil's outputs on their scale (the loss's are
    2·w·output), from numpy, so that every term of the adjoint counts."""
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.standard_normal(tuple(o.shape)).astype(np.float32)).to(o.device)
            * o.abs().max() for o in outs]


def _as_3d(shape):
    """The 3D case of a 2D test shape: the main path's depth of 10 for
    (32, 39, 39), else a few layers (one for a single row)."""
    B, H, W = shape
    return (B, 10 if shape == (32, 39, 39) else 1 if H == 1 else 3, H, W)


BACKWARD = {
    "dg": (lambda shape, dev: _inputs(*shape, dev), "dg_stencil_residual", 8, "launches_bwd"),
    "gc": (lambda shape, dev: _gc_on(dev, *shape), "gc_stencil_residual", 25, "launches_gc_bwd"),
    "dg3d": (lambda shape, dev: _inputs_3d(*_as_3d(shape), dev), "dg3d_stencil_residual", 9,
             "launches_3d_bwd"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 39, 39), (3, 13, 17), (1, 1, 300)])
@pytest.mark.parametrize("kind", list(BACKWARD))
def test_backward_kernel_matches_plain_adjoint(cuda, kind, shape):
    make, name, qwell, counter = BACKWARD[kind]
    args, cfg = make(shape, cuda)
    with torch.no_grad():
        cots = _cotangents(getattr(st, f"{name}_reference")(*args, cfg))
    before = getattr(st, counter)
    got = getattr(st, f"{name}_backward")(*args, *cots, cfg)
    want = getattr(st, f"{name}_backward_reference")(*args, *cots, cfg)
    torch.cuda.synchronize()
    assert getattr(st, counter) == before + 1
    assert got[qwell] is None
    for i, (g, w) in enumerate(zip(got, want)):
        if i != qwell:
            _close(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(BACKWARD))
def test_backward_kernel_is_deterministic(cuda, kind):
    make, name, qwell, _ = BACKWARD[kind]
    args, cfg = make((32, 39, 39), cuda)
    with torch.no_grad():
        cots = _cotangents(getattr(st, f"{name}_reference")(*args, cfg))
    bwd = getattr(st, f"{name}_backward")
    first = bwd(*args, *cots, cfg)
    for _ in range(3):
        for i, (a, b) in enumerate(zip(first, bwd(*args, *cots, cfg))):
            assert (a is None and i == qwell) or torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(BACKWARD))
def test_function_backward_launches_the_kernel_once(cuda, kind):
    """One backward launch per loss evaluation, none of the plain
    recompute, and only the asked-for gradients."""
    make, name, qwell, counter = BACKWARD[kind]
    args, cfg = make((3, 13, 17), cuda)
    a = [t.clone().requires_grad_(i in (1, len(args) - 1)) for i, t in enumerate(args)]
    before = getattr(st, counter)
    outs = getattr(st, name)(*a, cfg)
    sum((o**2).sum() for o in outs).backward()
    torch.cuda.synchronize()
    assert getattr(st, counter) == before + 1
    assert all((t.grad is not None) == t.requires_grad for t in a)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(BACKWARD))
def test_backward_kernel_refuses_qwell(cuda, kind):
    make, name, qwell, counter = BACKWARD[kind]
    args, cfg = make((2, 5, 6), cuda)
    args[qwell] = args[qwell].clone().requires_grad_(True)
    outs = getattr(st, name)(*args, cfg)
    before = getattr(st, counter)
    with pytest.raises(NotImplementedError):
        sum((o**2).sum() for o in outs).backward()
    assert getattr(st, counter) == before


@pytest.mark.cuda
@pytest.mark.parametrize("wrt", [0, 1, 2, 3, 4, 5, 6, 7, 8, 10],
                         ids=[n for n in st.DG3D_ARGS if n != "qwell"])
def test_dg3d_backward_kernel_one_input(cuda, wrt):
    """B2's backward kernel asked for one input's gradient alone: one launch,
    that gradient as the explicit adjoint gives it, no other."""
    args, cfg = _inputs_3d(3, 5, 13, 17, cuda)
    a = [t.clone().requires_grad_(i == wrt) for i, t in enumerate(args)]
    outs = st.dg3d_stencil_residual(*a, cfg)
    cots = _cotangents([o.detach() for o in outs])
    before = st.launches_3d_bwd
    (got,) = torch.autograd.grad(outs, [a[wrt]], cots)
    torch.cuda.synchronize()
    assert st.launches_3d_bwd == before + 1
    _close(got, st.dg3d_stencil_residual_backward_reference(*args, *cots, cfg)[wrt])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 10, 39, 39), (3, 1, 4, 6), (2, 2, 9, 9)])
def test_dg3d_backward_kernel_writes_zero_off_the_stencil(cuda, shape):
    """Every position of every padded gradient is written (the buffers come
    from torch.empty): exact zeros on the edge and corner halo lines, which
    the 7-point stencil never reads, and on p0p's whole halo."""
    args, cfg = _inputs_3d(*shape, cuda)
    with torch.no_grad():
        cots = _cotangents(st.dg3d_stencil_residual_reference(*args, cfg))
    got = st.dg3d_stencil_residual_backward(*args, *cots, cfg)
    B, D, H, W = shape
    halo = [torch.zeros(n + 2, dtype=torch.int64, device=cuda) for n in (D, H, W)]
    for h in halo:
        h[0] = h[-1] = 1
    count = halo[0][:, None, None] + halo[1][None, :, None] + halo[2][None, None, :]
    for g in got[:5]:
        assert torch.isfinite(g).all()
        assert torch.all(g[:, count >= 2] == 0)
    assert torch.all(got[0][:, count >= 1] == 0)
