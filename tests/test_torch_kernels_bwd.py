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


# -- the tile plan of B1's and B3's backward kernels ----------------------------
def _tiled_gather(c: st.Neighbors, plan: st.TilePlan) -> np.ndarray:
    """What the backward kernels make of the per-cell contributions ``c``
    (csrc/stencil_adjoint.cuh, step for step, in numpy float32): each tile
    puts the contributions of its own cells and of its ring (the strips
    below, above, left and right of it, no ring corner) that land in the
    tile into five slot arrays, then sums its positions' slots in _gather5's
    order where the cell a slot comes from exists. Slots start as NaN, so a
    contribution from a cell the tile did not compute would show; every
    padded position starts as NaN, and is counted as it is written."""
    cs = [x.numpy() for x in c]
    B, H, W = cs[0].shape
    out = np.full((B, H + 2, W + 2), np.nan, np.float32)
    writes = np.zeros((H + 2, W + 2), int)
    tw, tj = plan.tw, plan.tj

    def is_cell(j, i):
        return 0 <= j < H and 0 <= i < W

    for tile in range(plan.n_ti * plan.n_tj):
        r0, c0 = (tile // plan.n_ti) * tj, (tile % plan.n_ti) * tw
        slots = np.full((5, tj, tw, B), np.nan, np.float32)
        places = [(lj, li) for lj in range(tj) for li in range(tw)]
        places += ([(-1, r) for r in range(tw)] + [(tj, r) for r in range(tw)]
                   + [(r, -1) for r in range(tj)] + [(r, tw) for r in range(tj)])
        for lj, li in places:
            j, i = r0 + lj - 1, c0 + li - 1
            if not is_cell(j, i):
                continue
            row, col = 0 <= lj < tj, 0 <= li < tw
            for s, (dj, di), ok in ((0, (0, 0), row and col), (1, (0, 1), row and li + 1 < tw),
                                    (2, (0, -1), row and li >= 1), (3, (1, 0), col and lj + 1 < tj),
                                    (4, (-1, 0), col and lj >= 1)):
                if ok:
                    slots[s, lj + dj, li + di] = cs[s][:, j, i]
        for lj in range(tj):
            for li in range(tw):
                jp, ip = r0 + lj, c0 + li
                if jp >= H + 2 or ip >= W + 2:
                    continue
                j, i = jp - 1, ip - 1
                v = np.zeros(B, np.float32)
                for s, (dj, di) in enumerate(((0, 0), (0, -1), (0, 1), (-1, 0), (1, 0))):
                    if is_cell(j + dj, i + di):
                        v = v + slots[s, lj, li]
                out[:, jp, ip] = v
                writes[jp, ip] += 1
    assert (writes == 1).all(), "a padded position is written by no tile, or by more than one"
    return out


#: an H100's dynamic shared memory for a block of the backward kernels: its
#: per-block opt-in limit (227 KB) less the kernels' static shared memory
#: (their warp sums and flag, under 128 bytes)
H100_SHARED = 227 * 1024 - 128


@pytest.mark.parametrize("shape", [(3, 13, 17), (32, 39, 39), (128, 117, 117), (2, 30, 30),
                                   (2, 60, 60), (2, 92, 92)])
@pytest.mark.parametrize("kind", ["dg", "gc"])
def test_backward_tile_plan_owns_each_padded_position_once(kind, shape):
    """The plan the wrappers size B1's and B3's backward launches with: its
    tiles are at most the kernels' 1024 positions, their shared memory fits
    an H100's (GC grids of 28-30, 58-62 or 88-94 cells a side give 31- or
    32-wide tiles of 241-257 KB at the largest tile), and they cover each
    padded position of the sample exactly once; the kernels' tile-by-tile
    gather (its own cells and its ring) is _gather5 bit for bit, with each
    sample's four halo corners written 0. The plan does not depend on the
    batch, so two samples stand for it."""
    B, H, W = shape
    plan = st.bwd_tile_plan(H, W, st.BWD_INPUTS[kind], H100_SHARED)
    assert plan.tw * plan.tj <= 1024
    assert st.bwd_tile_shared_bytes(plan.tw, plan.tj, *st.BWD_INPUTS[kind]) <= H100_SHARED
    assert plan.n_ti * plan.tw >= W + 2 > (plan.n_ti - 1) * plan.tw
    assert plan.n_tj * plan.tj >= H + 2 > (plan.n_tj - 1) * plan.tj
    rng = np.random.RandomState(0)
    c = st.Neighbors(*(torch.from_numpy(rng.standard_normal((2, H, W)).astype(np.float32))
                       for _ in range(5)))
    got = _tiled_gather(c, plan)
    assert np.array_equal(got, st._gather5(c).numpy())
    assert np.all(got[:, [0, 0, -1, -1], [0, -1, 0, -1]] == 0)
