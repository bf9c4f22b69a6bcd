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
# On a 117×117 grid both float32 orders lie farther than CANCELLING_TOL from
# the float64 gradient (ROADMAP C17): the float32 p0 gradient is conditioned
# by its cancelling sum, not wrong. Distances from the float64 gradient (the
# explicit adjoint in float64, which float64 autograd matches to 2e-12 of
# the scale), over the largest float64 magnitude, on gc_inputs with the loss
# Σ output², on the CPU:
#   (B, H, W), seed      explicit adjoint f32   autograd f32
#   (8, 117, 117), 0     8.8e-4                 5.9e-4
#   (8, 117, 117), 1     1.47e-3                2.11e-3
#   (32, 117, 117), 0-2  1.0e-3 - 3.2e-3        1.0e-3 - 3.2e-3
#   (128, 117, 117), 0   3.78e-3                3.10e-3
# The largest grows with the cells it is taken over. At 117×117 the p0
# gradient is held to the float64 gradient within P0_FROM_F64_TOL, about
# 2.6x the largest above, whichever float32 order computes it.
P0_FROM_F64_TOL = 1e-2


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


FORWARD = {
    "dg": (lambda shape, dev: _inputs(*shape, dev), "dg_stencil_residual", "launches",
           "dg_stencil_fwd"),
    "gc": (lambda shape, dev: _gc_on(dev, *shape), "gc_stencil_residual", "launches_gc",
           "gc_stencil_fwd"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kind, shape", [
    (kind, shape) for kind in FORWARD
    for shape in ((32, 39, 39), (128, 39, 39), (3, 13, 17), (1, 1, 300))]
    + [("gc", (4, 60, 60)), ("gc", (128, 117, 117))])
def test_forward_kernel_is_one_launch_bitwise_run_to_run(cuda, kind, shape):
    """B1's and B3's forward: one device launch per call, the balances
    summed in it (no second kernel), every output the same bits from call
    to call and within the tolerance of the plain version."""
    from torch.profiler import ProfilerActivity, profile
    make, name, counter, device_name = FORWARD[kind]
    args, cfg = make(shape, cuda)
    fused = getattr(st, name)
    with torch.no_grad():
        first = fused(*args, cfg)
        torch.cuda.synchronize()
        before = getattr(st, counter)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            runs = [fused(*args, cfg) for _ in range(5)]
            torch.cuda.synchronize()
        want = getattr(st, f"{name}_reference")(*args, cfg)
    assert getattr(st, counter) == before + 5
    # CUPTI may miss a window's first kernels: at most one per call, all the kernel
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert 1 <= len(kernels) <= 5 and all(device_name + "(" in k for k in kernels), kernels
    for run in runs:
        assert all(torch.equal(a, b) for a, b in zip(first, run))
    for g, w in zip(first, want):
        _close(g, w)


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
    (B, 39, 39), else a few layers (one for a single row)."""
    B, H, W = shape
    return (B, 10 if (H, W) == (39, 39) else 1 if H == 1 else 3, H, W)


BACKWARD = {
    "dg": (lambda shape, dev: _inputs(*shape, dev), "dg_stencil_residual", 8, "launches_bwd"),
    "gc": (lambda shape, dev: _gc_on(dev, *shape), "gc_stencil_residual", 25, "launches_gc_bwd"),
    "dg3d": (lambda shape, dev: _inputs_3d(*_as_3d(shape), dev), "dg3d_stencil_residual", 9,
             "launches_3d_bwd"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 39, 39), (3, 13, 17), (1, 1, 300), (128, 39, 39),
                                   (128, 117, 117), (4, 60, 60)])
@pytest.mark.parametrize("kind", list(BACKWARD))
def test_backward_kernel_matches_plain_adjoint(cuda, kind, shape):
    """Against the explicit adjoint, and the same bits on a second call.
    (4, 60, 60): B3's tiles narrowed to fit the device's shared memory."""
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
    again = getattr(st, f"{name}_backward")(*args, *cots, cfg)
    assert all(a is None or torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dg", "gc"])
def test_backward_shared_budget_is_an_h100s(cuda, kind):
    """The shared memory the tile plan is sized to on this device is at
    least what the CPU tests of the plan assume for an H100."""
    assert st._shared_budget(kind, "bwd", torch.device(cuda)) >= 227 * 1024 - 128


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dg", "gc"])
def test_forward_shared_budget_is_an_h100s(cuda, kind):
    """Likewise for the forward kernels' tile plan."""
    assert st._shared_budget(kind, "fwd", torch.device(cuda)) >= 227 * 1024 - 128


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
    from torch.profiler import ProfilerActivity, profile
    make, name, qwell, counter = BACKWARD[kind]
    args, cfg = make((3, 13, 17), cuda)
    a = [t.clone().requires_grad_(i in (1, len(args) - 1)) for i, t in enumerate(args)]
    before = getattr(st, counter)
    outs = getattr(st, name)(*a, cfg)
    loss = sum((o**2).sum() for o in outs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        loss.backward()
        torch.cuda.synchronize()
    assert getattr(st, counter) == before + 1
    assert all((t.grad is not None) == t.requires_grad for t in a)
    # one device launch: the backward kernel, no second (gather) kernel
    stencil = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and "stencil" in e.name]
    device_name = {"dg": "dg_stencil_bwd", "gc": "gc_stencil_bwd", "dg3d": "dg3d_stencil_bwd"}
    assert len(stencil) == 1 and device_name[kind] + "(" in stencil[0], stencil


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


# -- the trainer's CUDA graphs ----------------------------------------------
def test_cuda_graph_on_the_cpu_raises(tmp_path):
    """A graph needs the models on a CUDA device: asked for one on the CPU,
    the trainer refuses rather than running eagerly."""
    from srm_tpu_torch.examples.common import setup_case
    from srm_tpu_torch.training.trainer import Trainer
    case = setup_case("DG", base_dir=str(tmp_path), nx=9, n_realizations=6, device="cpu")
    with pytest.raises(ValueError, match="cuda_graph"):
        Trainer(case["loss_fn"], cuda_graph=True)
    assert not Trainer(case["loss_fn"]).cuda_graph


@pytest.fixture(scope="module")
def small_cases(tmp_path_factory):
    """The dg9 and gc9 cases on the card (9×9, 6 realizations: 3 batches of
    32 per epoch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from srm_tpu_torch.examples.common import setup_case
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {f: setup_case(f, base_dir=str(tmp_path_factory.mktemp(f)), nx=9, n_realizations=6,
                          device="cuda") for f in ("DG", "GC")}


def _trainer(case, **kw):
    """A Trainer on copies of the case's trained models, with the train
    split staged at batch 32 (the cases have no val split)."""
    import copy

    from srm_tpu_torch.training.trainer import Trainer
    loss_fn = copy.copy(case["loss_fn"])
    loss_fn.models = {**case["models"], **{n: copy.deepcopy(case["models"][n]) for n in
                                           ("pressure", "time_step", "saturation_model")
                                           if n in case["models"]}}
    trainer = Trainer(loss_fn, **kw)
    trainer.stage_dataset("train", case["train_groups"], 32)
    return trainer


@pytest.mark.cuda
@pytest.mark.parametrize("fluid", ["DG", "GC"])
def test_graph_replay_matches_the_eager_step(small_cases, fluid, monkeypatch):
    """From the same weights on the same batches, the graphed trainer (its
    eager warm-up steps, then replays) and the eager one give the same step
    losses up to the first replayed step (1e-3) and Model 1 update over two
    epochs (1e-2 of its size), as chip_smoke.py holds them: where kernels
    are not deterministic two eager runs differ by up to 3.4e-5 and 9e-4 at
    39×39, since Adam magnifies an ulp where a gradient is near zero. Each
    replay runs the step's kernels on the step's buffers, and its counters
    count launches per replay."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    eager = _trainer(small_cases[fluid], cuda_graph=False)
    for c in st.COUNTERS:
        monkeypatch.setattr(st, c, 0)
    graphed = _trainer(small_cases[fluid])
    losses = {}
    for name, t in (("graphed", graphed), ("eager", eager)):
        losses[name] = np.concatenate([t.train_epoch_resident("train")["total"]
                                       for _ in range(2)])
        if name == "graphed":
            counts = {c: getattr(st, c) for c in st.COUNTERS}
    nb, warm = graphed._resident["train"][2], graphed.warmup_steps
    assert graphed.replays["train"] == 2 * nb - warm
    fwd, bwd = (("launches", "launches_bwd") if fluid == "DG"
                else ("launches_gc", "launches_gc_bwd"))
    assert counts[fwd] == counts[bwd] == 2 * nb, counts
    # up to the first replayed step; later the weights' rounding spreads
    np.testing.assert_allclose(losses["graphed"][:warm + 1], losses["eager"][:warm + 1], rtol=1e-3)
    assert np.all(np.isfinite(losses["graphed"]))
    for key in graphed.optimizer_keys:
        assert int(graphed.optimizers[key].count) == int(eager.optimizers[key].count) == 2 * nb
    # Model 1's update over the 2 epochs; Model 2's float32 gradient is
    # rounding noise once the weights move (ROADMAP C2)
    key = graphed.optimizer_keys[0]
    start = [p.detach() for p in small_cases[fluid]["models"][key].parameters()]
    with torch.no_grad():
        got = [p - s for p, s in zip(graphed.optimizers[key].params, start)]
        want = [p - s for p, s in zip(eager.optimizers[key].params, start)]
        rel = torch.sqrt(sum(((g - w).double() ** 2).sum() for g, w in zip(got, want))
                         / sum((w.double() ** 2).sum() for w in want))
    assert float(rel) <= 1e-2, float(rel)


@pytest.mark.cuda
def test_restore_is_seen_by_the_next_replay(small_cases):
    """A best-epoch restore writes the live parameters in place: the next
    replayed eval step computes with the restored weights, as an eager
    eval step on them does."""
    graphed = _trainer(small_cases["DG"])
    snap = graphed.snapshot()
    for _ in range(2):
        graphed.train_epoch_resident("train")
        graphed.eval_epoch_resident("train")
    trained = graphed.eval_epoch_resident("train")["total"]
    replays = graphed.replays["eval"]
    graphed.load_snapshot(snap)
    restored = graphed.eval_epoch_resident("train")["total"]
    assert graphed.replays["eval"] == replays + len(restored)
    eager = _trainer(small_cases["DG"], cuda_graph=False)
    want = eager.eval_epoch_resident("train")["total"]
    assert not np.allclose(trained, want)
    np.testing.assert_allclose(restored, want, rtol=1e-6)


# -- the predictor's CUDA graphs and the serving bundle -----------------------
@pytest.mark.cuda
@pytest.mark.parametrize("fluid", ["DG", "GC"])
def test_predictor_graph_matches_eager_and_the_bundle(small_cases, fluid, tmp_path,
                                                      monkeypatch):
    """The predictor's graphed rollout (batch 4, the last batch padded) is
    bitwise its eager rollout with cuDNN deterministic, one replay per batch
    and model; a bundle exported for "cuda" serves the same fields within
    1e-5 of their scale, and t = 0 gives Pi."""
    from srm_tpu_torch.eval import SRMPredictor, export_surrogate, load_surrogate
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    case = small_cases[fluid]
    proc = case["processor"]
    args = (case["data_summary"], case["general_config"], proc.reservoir_config)
    permx = proc.generate_kle_splits()["test"]
    times = [0.0, 10.0, 50.0]
    fields = ("pressure", "saturation") if fluid == "GC" else ("pressure",)
    names = {"pressure": "pressure", "saturation": "saturation_model"}
    graphed = SRMPredictor(case["models"], *args, batch_size=4)
    eager = SRMPredictor(case["models"], *args, batch_size=4, cuda_graph=False)
    assert graphed.cuda_graph and not eager.cuda_graph
    live = {f: getattr(graphed, f"predict_{f}")(permx, times) for f in fields}
    for f in fields:
        np.testing.assert_array_equal(live[f], getattr(eager, f"predict_{f}")(permx, times))
    n = permx.shape[0] * len(times)
    assert graphed.replays == {names[f]: -(-n // 4) for f in fields}

    export_surrogate(graphed, str(tmp_path), fields=fields, platforms=("cuda",))
    srv = load_surrogate(str(tmp_path))
    px = np.repeat(permx, len(times), axis=0)
    t = np.tile(np.asarray(times, np.float32), permx.shape[0])
    for f in fields:
        got = srv(f, px, t).reshape(live[f].shape)
        np.testing.assert_allclose(got, live[f], rtol=0, atol=1e-5 * np.abs(live[f]).max())
    Pi = float(proc.reservoir_config["initialization"]["Pi"])
    assert np.all(srv("pressure", permx, np.zeros(permx.shape[0], np.float32)) == Pi)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(BACKWARD))
def test_kernels_at_the_production_batch(cuda, kind):
    """B1, B2 and B3 at batch 128 (the production profile's; the main paths
    before ran batch 32 only): the forward kernel against its plain version,
    the backward kernel against the explicit adjoint, and the gradient
    through the autograd Function against autograd through the plain
    version (B3's p0 gradient, a difference of large terms, within
    CANCELLING_TOL of its scale)."""
    _check_kernels_at(kind, (128, 39, 39), cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("kind, shape", [("dg", (128, 117, 117)), ("dg3d", (256, 39, 39)),
                                         ("gc", (128, 117, 117))],
                         ids=["dg2d_large", "dg3d_b256", "gc2d_117"])
def test_kernels_at_the_last_configurations_shapes(cuda, kind, shape):
    """B1 on bench.py's dg2d_large grid (117×117 at batch 128, its first grid
    other than 39×39) and B2 at batch 256 (dg3d_production_b256, 39×39×10),
    held as at the production batch; B3 on the 117×117 grid likewise, but
    its p0 gradient held to the float64 explicit adjoint within
    P0_FROM_F64_TOL (ROADMAP C17), not to float32 autograd."""
    _check_kernels_at(kind, shape, cuda, p0_from_f64=kind == "gc")


def _check_kernels_at(kind, shape, cuda, p0_from_f64=False):
    make, name, qwell, counter = BACKWARD[kind]
    args, cfg = make(shape, cuda)
    fused, plain = getattr(st, name), getattr(st, f"{name}_reference")
    with torch.no_grad():
        got, want = fused(*args, cfg), plain(*args, cfg)
        cots = _cotangents(want)
    assert got[0].shape[0] == shape[0]
    for g, w in zip(got, want):
        _close(g, w)
    before = getattr(st, counter)
    got = getattr(st, f"{name}_backward")(*args, *cots, cfg)
    want = getattr(st, f"{name}_backward_reference")(*args, *cots, cfg)
    torch.cuda.synchronize()
    assert getattr(st, counter) == before + 1
    for i, (g, w) in enumerate(zip(got, want)):
        if i != qwell:
            _close(g, w)
    again = getattr(st, f"{name}_backward")(*args, *cots, cfg)
    assert all(a is None or torch.equal(a, b) for a, b in zip(got, again))
    got = _square_loss_grads(fused, args, cfg, qwell)
    want = _square_loss_grads(plain, args, cfg, qwell)
    p0 = st.GC_ARGS.index("p0") if kind == "gc" else None
    if p0_from_f64:
        x = [a.double() for a in args]
        with torch.no_grad():
            exact = getattr(st, f"{name}_backward_reference")(
                *x, *(2.0 * o for o in plain(*x, cfg)), cfg)[p0]
    for i, (g, w) in enumerate(zip(got, want)):
        if i == p0:
            assert torch.isfinite(g).all()
            if p0_from_f64:
                err = float((g.double() - exact).abs().max())
                assert err <= P0_FROM_F64_TOL * float(exact.abs().max())
            else:
                assert float((g - w).abs().max()) <= CANCELLING_TOL * float(w.abs().max())
        else:
            _close(g, w)


# -- the last configurations on the card ----------------------------------------
@pytest.fixture(scope="module")
def gc3d_case(tmp_path_factory):
    """Gas condensate 9×9×9 on the card (6 realizations, zero labels)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA graph has no CPU mode")
    from srm_tpu_torch.config import DEFAULT_GENERAL_CONFIG
    from srm_tpu_torch.examples.common import setup_case
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = dict(DEFAULT_GENERAL_CONFIG, label_source="files")
    return setup_case("GC", base_dir=str(tmp_path_factory.mktemp("gc3d")), nx=9, nz=9,
                      kle_method="uncorrelated", n_realizations=6, general_config=g,
                      device="cuda")


def _updates_apart(a, b, key, start):
    with torch.no_grad():
        got = [p - s for p, s in zip(a.optimizers[key].params, start)]
        want = [p - s for p, s in zip(b.optimizers[key].params, start)]
        return float(torch.sqrt(sum(((g - w).double() ** 2).sum() for g, w in zip(got, want))
                                / sum((w.double() ** 2).sum() for w in want)))


@pytest.mark.cuda
def test_gc3d_graph_replay_matches_the_eager_step(gc3d_case, monkeypatch):
    """GC 3D (no stencil kernel: the unfused 7-point residual inside the
    graph) replayed against the eager step from the same weights: no kernel
    launches, the step losses up to the first replayed step within 1e-3,
    and Model 1's update over two epochs within 0.1: this path's backward
    is not deterministic on the card (the replicate pads' and the resize's
    backward add with atomics), and Adam turns the ulps into updates where
    GC 3D's float32 gradients are noise (its float32 three-step update lies
    0.27 from float64, tests/test_torch_slice_gc3d.py). Measured on the
    card after 6 steps: a second eager run 1.3e-2 from the first, the
    replay 3.0e-2 and 3.8e-2; a replay that dropped or repeated an update
    would be O(0.5) apart."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    assert not gc3d_case["loss_fn"].use_cuda_stencil
    for c in st.COUNTERS:
        monkeypatch.setattr(st, c, 0)
    runs = {"graphed": _trainer(gc3d_case), "eager": _trainer(gc3d_case, cuda_graph=False)}
    losses = {name: np.concatenate([t.train_epoch_resident("train")["total"] for _ in range(2)])
              for name, t in runs.items()}
    graphed, eager = runs["graphed"], runs["eager"]
    nb, warm = graphed._resident["train"][2], graphed.warmup_steps
    assert graphed.replays["train"] == 2 * nb - warm
    assert all(getattr(st, c) == 0 for c in st.COUNTERS)
    np.testing.assert_allclose(losses["graphed"][:warm + 1], losses["eager"][:warm + 1], rtol=1e-3)
    assert np.all(np.isfinite(losses["graphed"]))
    key = graphed.optimizer_keys[0]
    start = [p.detach() for p in gc3d_case["models"][key].parameters()]
    assert _updates_apart(graphed, eager, key, start) <= 0.1


@pytest.mark.cuda
def test_remat_graph_replay_matches_the_step_without_it(small_cases, monkeypatch):
    """``remat_forwards`` inside the captured step: the replayed remat step
    and the replayed plain one give the same step losses up to the first
    replayed step (1e-3) and Model 1 update (1e-2) from the same weights, and B1 and its backward kernel
    count one launch per step under the recompute."""
    import copy
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    case = small_cases["DG"]
    remat = dict(case, loss_fn=copy.copy(case["loss_fn"]))
    remat["loss_fn"].remat_forwards = True
    plain = _trainer(case)
    for c in st.COUNTERS:
        monkeypatch.setattr(st, c, 0)
    graphed = _trainer(remat)
    losses = {name: np.concatenate([t.train_epoch_resident("train")["total"] for _ in range(2)])
              for name, t in (("remat", graphed), ("plain", plain))}
    nb, warm = graphed._resident["train"][2], graphed.warmup_steps
    assert graphed.replays["train"] == plain.replays["train"] == 2 * nb - warm
    assert st.launches_bwd == 4 * nb and st.launches == 4 * nb   # both trainers
    np.testing.assert_allclose(losses["remat"][:warm + 1], losses["plain"][:warm + 1], rtol=1e-3)
    assert np.all(np.isfinite(losses["remat"]))
    key = graphed.optimizer_keys[0]
    start = [p.detach() for p in case["models"][key].parameters()]
    assert _updates_apart(graphed, plain, key, start) <= 1e-2
