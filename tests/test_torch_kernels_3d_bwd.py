"""B2's explicit adjoint (the plain version of its backward kernel) against
autograd of its plain forward, on the CPU.

``dg3d_stencil_residual_backward_reference`` is derived by hand, in the
face-by-face (pull) form that the backward kernel computes; here it is held,
input by input, to ``torch.autograd.grad`` through
``dg3d_stencil_residual_reference`` for the same random cotangents: to 1e-10
of each gradient's largest magnitude in float64, and in float32 to the
tolerance that holds B2 to its plain version on the card (rtol 1e-4 plus
1e-5 of the largest magnitude; the two round the same products in another
order, and the face form sums a face's two cells' terms as one product).
The inputs hit the corner cases the adjoint must keep: a sample whose Δt1
lies below the 1e-12 clamp (float64 only: 1/Δt1² overflows float32 there),
a row where p1 is the same in every cell (dp = 0 across its x faces), a
layer where kx is the same in every cell (equal permeabilities on its
faces), and depths of 1 and 2, where the k±1 neighbours are all halo. The
backward kernel itself runs on a GPU only (``test_torch_cuda``).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from srm_tpu_torch.kernels import stencil as st

NAMES = st.DG3D_ARGS
TOL = {torch.float64: (0.0, 1e-10), torch.float32: (1e-4, 1e-5)}     # (rtol, atol of max)
SHAPES = [(2, 3, 5, 7), (3, 1, 4, 6), (2, 2, 9, 9)]
IDS = ["2x3x5x7", "3x1x4x6", "2x2x9x9"]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def _inputs(dtype, B, D, H, W, seed=0):
    """Physically scaled 3D stencil inputs (as tests/test_torch_kernels_3d.py
    makes them; kz = 0.1·kx, dz = 80/D ft) with the corner cases above."""
    rng = np.random.RandomState(seed)
    shp = (B, D, H, W)
    pad = lambda a: np.pad(a, [(0, 0), (1, 1), (1, 1), (1, 1)], mode="symmetric")  # noqa: E731
    p0 = rng.uniform(4500, 5000, shp).astype(np.float32)
    p1 = p0 - rng.uniform(0, 50, shp).astype(np.float32)
    p1[:, 0, 0, :] = p1[:, 0, 0, :1]                            # dp = 0 across the x faces
    kx = rng.uniform(0.5, 10.0, shp).astype(np.float32)
    kx[:, -1] = 3.0                                             # equal permeabilities
    invBg = rng.uniform(0.9, 1.2, shp).astype(np.float32)
    invug = rng.uniform(30, 40, shp).astype(np.float32)
    dinvBg = rng.uniform(1e-4, 3e-4, shp).astype(np.float32)
    q = np.zeros(shp, np.float32)
    q[:, D // 2, H // 2, W // 2] = 500.0
    qwell = np.zeros((D, H, W), np.float32)
    qwell[D // 2, H // 2, W // 2] = 1.0
    tsteps = rng.uniform(1.0, 9.0, (B, 2))
    if dtype == torch.float64:
        tsteps[1, 0] = 1e-13                                    # below the clamp
    args = [pad(p0), pad(p1), pad(kx), pad(np.float32(0.1) * kx), pad(invBg * invug), invBg,
            invBg * np.float32(0.99), dinvBg, q, qwell, tsteps]
    cfg = st.StencilConfig(C=0.001127, D=5.6145833334, dx=2900.0 / 39, dy=2900.0 / 39,
                           dz=80.0 / D, Sgi=0.78, krgo=0.8, phi=0.2)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dtype) for a in args], cfg


def _cotangents(outs, seed=1):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.standard_normal(tuple(o.shape))).to(o.dtype) for o in outs]


_CACHE = {}


def _gradients(dtype, shape):
    """(explicit adjoint, autograd) gradients of every input, once per case."""
    if (dtype, shape) not in _CACHE:
        args, cfg = _inputs(dtype, *shape)
        a = [t.clone().requires_grad_(True) for t in args]
        outs = st.dg3d_stencil_residual_reference(*a, cfg)
        cots = _cotangents(outs)
        want = torch.autograd.grad(outs, a, cots)
        got = st.dg3d_stencil_residual_backward_reference(*args, *cots, cfg)
        _CACHE[dtype, shape] = got, want
    return _CACHE[dtype, shape]


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", NAMES)
def test_adjoint_matches_autograd(name, dtype, shape):
    got, want = _gradients(dtype, shape)
    i = NAMES.index(name)
    g, w = got[i], want[i]
    assert g.shape == w.shape and g.dtype == dtype and torch.isfinite(g).all()
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(g, w, rtol=rtol, atol=atol * float(w.abs().max()))


def _edges(shape):
    """The (B, D+2, H+2, W+2) mask of the edge and corner halo lines: the
    positions with two or more coordinates on the halo."""
    B, D, H, W = shape
    halo = [torch.zeros(n + 2, dtype=torch.int64) for n in (D, H, W)]
    for h in halo:
        h[0] = h[-1] = 1
    count = halo[0][:, None, None] + halo[1][None, :, None] + halo[2][None, None, :]
    return (count >= 2).expand(B, D + 2, H + 2, W + 2)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_padded_gradients_are_zero_off_the_stencil(shape):
    """No face with a cell beside it reaches an edge or corner halo line,
    so every padded gradient is exactly 0 there; p0p's gradient lives at
    the cells only; the face halos of p1p do receive their cells' terms."""
    got, _ = _gradients(torch.float64, shape)
    edges = _edges(shape)
    for name in ("p0p", "p1p", "kxp", "kzp", "bgugp"):
        g = got[NAMES.index(name)]
        assert torch.all(g[edges] == 0), name
    g_p0p = got[0]
    interior = torch.zeros_like(g_p0p, dtype=torch.bool)
    interior[:, 1:-1, 1:-1, 1:-1] = True
    assert torch.all(g_p0p[~interior] == 0)
    assert float(got[1][:, 1:-1, 1:-1, 0].abs().min()) > 0     # the x = -1 face halo
    assert float(got[1][:, 0, 1:-1, 1:-1].abs().min()) > 0     # the k = -1 face halo


@pytest.mark.parametrize("wrt", list(range(len(NAMES))), ids=NAMES)
def test_function_gradient_of_one_input_is_the_adjoints(wrt):
    """Each input asked for alone, then all but qwell together, through
    DG3DStencilResidualFn (autograd of the plain version on the CPU): the
    explicit adjoint's gradient of that input."""
    args, cfg = _inputs(torch.float64, 2, 2, 5, 6)
    with torch.no_grad():
        cots = _cotangents(st.dg3d_stencil_residual_reference(*args, cfg))
    want = st.dg3d_stencil_residual_backward_reference(*args, *cots, cfg)
    wanted = [wrt] if wrt != NAMES.index("qwell") else [i for i in range(len(NAMES))
                                                       if NAMES[i] != "qwell"]
    a = [t.clone().requires_grad_(i in wanted) for i, t in enumerate(args)]
    outs = st.DG3DStencilResidualFn.apply(*a, cfg)      # the Function itself: float64 is fine
    got = torch.autograd.grad(outs, [a[i] for i in wanted], cots)
    for i, g in zip(wanted, got):
        torch.testing.assert_close(g, want[i], rtol=0, atol=1e-10 * float(want[i].abs().max()))


def test_backward_wrapper_on_cpu_is_the_plain_adjoint():
    args, cfg = _inputs(torch.float32, 2, 3, 5, 7)
    cots = _cotangents(st.dg3d_stencil_residual_reference(*args, cfg))
    before = st.launches_3d_bwd
    got = st.dg3d_stencil_residual_backward(*args, *cots, cfg)
    want = st.dg3d_stencil_residual_backward_reference(*args, *cots, cfg)
    assert st.launches_3d_bwd == before              # the plain version never counts
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_function_refuses_a_qwell_gradient_on_cuda(monkeypatch):
    """A CUDA call that asks for qwell's gradient raises; it is not sent to
    the plain version (CUDA is faked here: the refusal comes before any
    launch)."""
    args, cfg = _inputs(torch.float32, 2, 2, 5, 6)
    cots = _cotangents(st.dg3d_stencil_residual_reference(*args, cfg))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(st, "_library_3d", lambda: pytest.fail("the kernel library was loaded"))
    monkeypatch.setattr(st, "_plain_backward", lambda *a: pytest.fail("rerouted to plain"))
    ctx = SimpleNamespace(saved_tensors=tuple(args), cfg=cfg,
                          needs_input_grad=(True,) * len(args) + (False,))
    before = st.launches_3d_bwd
    with pytest.raises(NotImplementedError, match="qwell"):
        st.DG3DStencilResidualFn.backward(ctx, *cots)
    assert st.launches_3d_bwd == before
