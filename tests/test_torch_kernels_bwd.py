"""B1's explicit adjoint (the plain version of its backward kernel) against
autograd of its plain forward, on the CPU.

``dg_stencil_residual_backward_reference`` is derived by hand; here it is
held, input by input, to ``torch.autograd.grad`` through
``dg_stencil_residual_reference`` for the same random cotangents: to 1e-10
of each gradient's largest magnitude in float64, and in float32 to the
tolerance that holds B1 to its plain version on the card (rtol 1e-4 plus
1e-5 of the largest magnitude; the two round the same products in another
order). The inputs hit the chord-free cases the adjoint must keep: a row
where p1 = p0, and a sample whose Δt1 lies below the 1e-12 clamp (float64
only: 1/Δt1² overflows float32 there). The backward kernel itself runs on a
GPU only (``test_torch_cuda``).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from srm_tpu_torch.kernels import stencil as st
from test_torch_kernels import _make_inputs

NAMES = st.DG_ARGS
TOL = {torch.float64: (0.0, 1e-10), torch.float32: (1e-4, 1e-5)}     # (rtol, atol of max)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def _inputs(dtype, B=3, H=7, W=8):
    args, cfg = _make_inputs(B=B, H=H, W=W)
    pad = lambda a: np.pad(a, [(0, 0), (1, 1), (1, 1)], mode="symmetric")  # noqa: E731
    p0 = args[0][:, 1:-1, 1:-1]
    p1 = args[1][:, 1:-1, 1:-1].copy()
    p1[:, 0, :] = p0[:, 0, :]                                    # dp = 0 on the first row
    args[1] = pad(p1)
    if dtype == torch.float64:
        args[9] = args[9].astype(np.float64)
        args[9][1, 0] = 1e-13                                    # below the clamp
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dtype) for a in args]
    return t, st.StencilConfig(**cfg)


def _cotangents(outs, seed=1):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.standard_normal(tuple(o.shape))).to(o.dtype) for o in outs]


_CACHE = {}


def _gradients(dtype):
    """(explicit adjoint, autograd) gradients of every input, once per dtype."""
    if dtype not in _CACHE:
        args, cfg = _inputs(dtype)
        a = [t.clone().requires_grad_(True) for t in args]
        outs = st.dg_stencil_residual_reference(*a, cfg)
        cots = _cotangents(outs)
        want = torch.autograd.grad(outs, a, cots)
        got = st.dg_stencil_residual_backward_reference(*args, *cots, cfg)
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


def test_adjoint_semantics_at_the_edges():
    """p0p's gradient lives at the centres only, and no padded gradient
    reaches a corner (a 5-point stencil never reads one)."""
    got, _ = _gradients(torch.float64)
    g_p0p = got[0]
    assert torch.all(g_p0p[:, 0, :] == 0) and torch.all(g_p0p[:, -1, :] == 0)
    assert torch.all(g_p0p[:, :, 0] == 0) and torch.all(g_p0p[:, :, -1] == 0)
    for g in got[1:4]:
        assert torch.all(g[:, [0, 0, -1, -1], [0, -1, 0, -1]] == 0)
    # the boundary cells read p1p's halo (kxp's and bgugp's reads there are
    # multiplied by a pressure drop that the edge-replicating pad makes 0)
    assert float(got[1][:, 0, 1:-1].abs().min()) > 0


def test_backward_wrapper_on_cpu_is_the_plain_adjoint():
    args, cfg = _inputs(torch.float32)
    cots = _cotangents(st.dg_stencil_residual_reference(*args, cfg))
    before = st.launches_bwd
    got = st.dg_stencil_residual_backward(*args, *cots, cfg)
    want = st.dg_stencil_residual_backward_reference(*args, *cots, cfg)
    assert st.launches_bwd == before                 # the plain version never counts
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_function_refuses_a_qwell_gradient_on_cuda(monkeypatch):
    """A CUDA call that asks for qwell's gradient raises; it is not sent to
    the plain version (CUDA is faked here: the refusal comes before any
    launch)."""
    args, cfg = _inputs(torch.float32, B=2, H=5, W=6)
    cots = _cotangents(st.dg_stencil_residual_reference(*args, cfg))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(st, "_library", lambda: pytest.fail("the kernel library was loaded"))
    monkeypatch.setattr(st, "_plain_backward", lambda *a: pytest.fail("rerouted to plain"))
    ctx = SimpleNamespace(saved_tensors=tuple(args), cfg=cfg,
                          needs_input_grad=(True,) * len(args) + (False,))
    before = st.launches_bwd
    with pytest.raises(NotImplementedError, match="qwell"):
        st.DGStencilResidualFn.backward(ctx, *cots)
    assert st.launches_bwd == before
