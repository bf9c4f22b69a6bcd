"""B3's explicit adjoint (the plain version of its backward kernel) against
autograd of its plain forward, on the CPU.

``gc_stencil_residual_backward_reference`` is derived by hand; here it is
held, input by input, to ``torch.autograd.grad`` through
``gc_stencil_residual_reference`` for the same random cotangents: to 1e-10
of each gradient's largest magnitude in float64, and in float32 to the
tolerance that holds B3 to its plain version on the card (rtol 1e-4 plus
1e-5 of the largest magnitude; the two round the same products in another
order). The inputs hit every branch the adjoint must keep:

* dp = 0 on the first row (the chord slopes pass no gradient there, and
  none is NaN);
* upstream ties: a row where p1 is constant (every i face a tie, so the
  centre takes the relperm's gradient), besides the boundary faces, which
  the edge-replicating pad makes ties;
* Sg at its bound: cells where Sg0 = Sg1 = Sgi = 1 − Swmin (So = 0);
* a sample whose Δt1 lies below the 1e-12 clamp (float64 only: 1/Δt1²
  overflows float32 there).

The backward kernel itself runs on a GPU only (``test_torch_cuda``).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from srm_tpu_torch.kernels import stencil as st
from test_torch_cuda import P0_FROM_F64_TOL, gc_inputs

NAMES = st.GC_ARGS + ("qwell", "tsteps")
TOL = {torch.float64: (0.0, 1e-10), torch.float32: (1e-4, 1e-5)}     # (rtol, atol of max)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def _inputs(dtype, B=3, H=7, W=8):
    args, cfg = gc_inputs(B, H, W)
    f = dict(zip(NAMES, args))
    pad = lambda a: np.pad(a, [(0, 0), (1, 1), (1, 1)], mode="symmetric")  # noqa: E731
    p1 = f["p1p"][:, 1:-1, 1:-1].copy()
    p1[:, 2, :] = p1[:, 2, :1]                                  # ties along row 2
    f["p1p"] = pad(p1)
    sgi = np.float32(1.0 - cfg["Swmin"])
    for k in ("Sg0", "Sg1"):
        f[k] = f[k].copy()
        f[k][:, 3, 1:4] = sgi                                   # Sg at its bound, So = 0
    if dtype == torch.float64:
        f["tsteps"] = f["tsteps"].astype(np.float64)
        f["tsteps"][1, 0] = 1e-13                               # below the clamp
    t = [torch.from_numpy(np.ascontiguousarray(f[n])).to(dtype) for n in NAMES]
    return t, st.GCStencilConfig(**cfg)


def _cotangents(outs, seed=1):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.standard_normal(tuple(o.shape))).to(o.dtype) for o in outs]


_CACHE = {}


def _gradients(dtype):
    """(explicit adjoint, autograd) gradients of every input, once per dtype."""
    if dtype not in _CACHE:
        args, cfg = _inputs(dtype)
        a = [t.clone().requires_grad_(True) for t in args]
        outs = st.gc_stencil_residual_reference(*a, cfg)
        cots = _cotangents(outs)
        want = torch.autograd.grad(outs, a, cots)
        got = st.gc_stencil_residual_backward_reference(*args, *cots, cfg)
        _CACHE[dtype] = got, want
    return _CACHE[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", NAMES)
def test_adjoint_matches_autograd(name, dtype):
    got, want = _gradients(dtype)
    i = NAMES.index(name)
    g, w = got[i], want[i]
    assert g.shape == w.shape and g.dtype == dtype and torch.isfinite(g).all()
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(g, w, rtol=rtol, atol=atol * float(w.abs().max()))


def test_inputs_hit_the_branches():
    """The cases of the module docstring are present in the inputs."""
    args, cfg = _inputs(torch.float64)
    f = dict(zip(NAMES, args))
    p1 = f["p1p"][:, 1:-1, 1:-1]
    assert torch.all(p1[:, 0] == f["p0"][:, 0])
    assert torch.all(p1[:, 2, 1:] == p1[:, 2, :-1])
    assert torch.all(f["Sg1"][:, 3, 1:4] == float(np.float32(1.0 - cfg.Swmin)))
    assert float(f["tsteps"][:, 0].min()) < 1e-12


def test_backward_wrapper_on_cpu_is_the_plain_adjoint():
    args, cfg = _inputs(torch.float32)
    cots = _cotangents(st.gc_stencil_residual_reference(*args, cfg))
    before = st.launches_gc_bwd
    got = st.gc_stencil_residual_backward(*args, *cots, cfg)
    want = st.gc_stencil_residual_backward_reference(*args, *cots, cfg)
    assert st.launches_gc_bwd == before              # the plain version never counts
    assert len(got) == len(NAMES)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_function_refuses_a_qwell_gradient_on_cuda(monkeypatch):
    """A CUDA call that asks for qwell's gradient raises; it is not sent to
    the plain version (CUDA is faked here: the refusal comes before any
    launch), as test_torch_cuda's test_gc_stencil_refuses_rather_than_reroutes
    checks a failed library load."""
    args, cfg = _inputs(torch.float32, B=2, H=5, W=6)
    cots = _cotangents(st.gc_stencil_residual_reference(*args, cfg))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(st, "_library_gc", lambda: pytest.fail("the kernel library was loaded"))
    monkeypatch.setattr(st, "_plain_backward", lambda *a: pytest.fail("rerouted to plain"))
    ctx = SimpleNamespace(saved_tensors=tuple(args), cfg=cfg,
                          needs_input_grad=(True,) * len(args) + (False,))
    before = st.launches_gc_bwd
    with pytest.raises(NotImplementedError, match="qwell"):
        st.GCStencilResidualFn.backward(ctx, *cots)
    assert st.launches_gc_bwd == before


def test_function_backward_on_cpu_is_autograd_of_the_plain_version():
    """For CPU tensors the Function's backward stays autograd through the
    recomputed plain version, the reference's own semantics (bit for bit
    the plain path's gradient, test_torch_kernels_gc); it agrees with the
    explicit adjoint within the float32 tolerance."""
    args, cfg = _inputs(torch.float32)
    cots = _cotangents(st.gc_stencil_residual_reference(*args, cfg))
    a = [t.clone().requires_grad_(i != 25) for i, t in enumerate(args)]
    got = torch.autograd.grad(st.gc_stencil_residual(*a, cfg), [t for t in a if t.requires_grad],
                              cots)
    adjoint = [g for i, g in enumerate(st.gc_stencil_residual_backward_reference(*args, *cots, cfg))
               if i != 25]
    for g, w in zip(got, adjoint):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5 * float(w.abs().max()))


# -- ROADMAP C17: B3's p0 gradient on a 117×117 grid ---------------------------
_C17 = {}


def _c17_gradients(seed):
    """B3's p0 gradient of Σ output² on gc_inputs(8, 117, 117, seed): the
    explicit adjoint and autograd through the plain forward, each in float64
    and in float32 (every input's gradient in float64)."""
    if seed not in _C17:
        args, cfg = gc_inputs(8, 117, 117, seed)
        cfg = st.GCStencilConfig(**cfg)
        got = {}
        for dtype in (torch.float64, torch.float32):
            x = [torch.from_numpy(np.ascontiguousarray(a)).to(dtype) for a in args]
            with torch.no_grad():
                cots = [2.0 * o for o in st.gc_stencil_residual_reference(*x, cfg)]
                got["adjoint", dtype] = st.gc_stencil_residual_backward_reference(*x, *cots, cfg)
            a = [t.clone().requires_grad_(i != 25) for i, t in enumerate(x)]
            sum((o**2).sum() for o in st.gc_stencil_residual_reference(*a, cfg)).backward()
            got["autograd", dtype] = [t.grad for t in a]
        _C17[seed] = got
    return _C17[seed]


@pytest.mark.parametrize("seed", [0, 1])
def test_adjoint_is_exact_in_float64_at_117x117(seed):
    """In float64 the explicit adjoint is autograd's gradient, every input's
    to 1e-10 of its scale (p0's lies ~2e-12 from it): the adjoint that the
    backward kernel rounds is the exact gradient."""
    got = _c17_gradients(seed)
    for i, (g, w) in enumerate(zip(got["adjoint", torch.float64], got["autograd", torch.float64])):
        if i != 25:
            torch.testing.assert_close(g, w, rtol=0.0, atol=1e-10 * float(w.abs().max()))


@pytest.mark.parametrize("order", ["adjoint", "autograd"])
@pytest.mark.parametrize("seed", [0, 1])
def test_p0_gradient_in_float32_is_conditioned_at_117x117(seed, order):
    """ROADMAP C17: at 117×117 the float32 p0 gradient lies up to 2.1e-3 of
    its scale from the float64 gradient, beyond CANCELLING_TOL, in the
    explicit adjoint's order (the backward kernel's) and in autograd's alike;
    both are held to P0_FROM_F64_TOL of it, a property of the float32 sum
    and not of either order. Every other input's float32 gradient stays
    within the card's tolerance of its float64 gradient."""
    got = _c17_gradients(seed)
    exact = got["adjoint", torch.float64]
    g = got[order, torch.float32]
    scale = float(exact[0].abs().max())
    assert torch.isfinite(g[0]).all()
    assert float((g[0].double() - exact[0]).abs().max()) <= P0_FROM_F64_TOL * scale
    for i in range(1, 27):
        if i != 25:
            torch.testing.assert_close(g[i].double(), exact[i], rtol=1e-4,
                                       atol=1e-5 * float(exact[i].abs().max()))
