"""The tile plan of B1's and B3's forward kernels, on the CPU.

The forward kernels (csrc/dg_stencil.cu, csrc/gc_stencil.cu) cut each
sample's padded (H+2, W+2) plane into the tiles of
``stencil.fwd_tile_plan``, one block each. A block stages the padded inputs
that it reads at five points over its tile and a one-position ring into
shared memory (csrc/stencil_adjoint.cuh's ``stage_inputs`` and
``Staged``), computes its tile's cells, one or two positions a thread
(``stencil.fwd_passes``, ``stencil_adjoint::forward_threads``), and sums their balance terms with
``block_partial`` and ``sample_sum`` (each thread's cells in turn, a
shuffle tree in each warp, the warps in order, the tiles in order). Here
that is done step for step in numpy: every cell is computed by exactly one
tile from a staged neighbourhood equal to the padded input's, the staged
inputs fit an H100's shared memory, the blocks per call are those the plan states (PERF.md), and B1's mbc summed in
the kernel's order holds to the plain version's at the card's tolerance.
The kernels themselves run on a GPU only (``test_torch_cuda``).
"""

import numpy as np
import pytest
import torch

from srm_tpu_torch.kernels import stencil as st
from test_torch_cuda import ATOL_REL, RTOL, _inputs

SHAPES = [(39, 39), (117, 117), (13, 17), (1, 300), (60, 60), (9, 9)]


#: the H100's streaming multiprocessors
SMS = 132
#: an H100's dynamic shared memory for a block of the forward kernels: its
#: per-block opt-in limit (227 KB) less the kernels' static shared memory
#: (64 and 128 bytes)
H100_SHARED = 227 * 1024 - 128
#: the forward kernels' threads per block, at most (stencil_adjoint::kFwdThreads)
FWD_THREADS = 512


def _threads(plan, passes):
    """A forward block's threads (stencil_adjoint::forward_threads)."""
    per_pass = -(-(plan.tw * plan.tj) // passes)
    return min(-(-per_pass // 32) * 32, FWD_THREADS)


def _tiles(plan):
    """Each tile's first padded row and column, in block order."""
    for tile in range(plan.n_ti * plan.n_tj):
        yield (tile // plan.n_ti) * plan.tj, (tile % plan.n_ti) * plan.tw


def _tile_cells(plan, r0, c0, H, W):
    """The tile's positions that are cells, in position order: (position,
    cell row, cell column)."""
    for n in range(plan.tw * plan.tj):
        lj, li = divmod(n, plan.tw)
        j, i = r0 + lj - 1, c0 + li - 1
        if 0 <= j < H and 0 <= i < W:
            yield n, j, i


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", ["dg", "gc"])
def test_forward_tile_plan_computes_each_cell_once(kind, shape):
    """Every cell of the sample is computed by one tile, from the staged
    copy of its tile (the padded positions over the tile and a one-position
    ring, those inside the plane; NaN elsewhere), whose five-point
    neighbourhood at the kernel's staged index is the padded input's; the
    tile is at most 1024 positions and its staged inputs fit an H100's
    shared memory."""
    H, W = shape
    plan = st.fwd_tile_plan(H, W, kind, H100_SHARED)
    assert plan.tw * plan.tj <= 1024
    assert st.fwd_tile_shared_bytes(plan.tw, plan.tj, st.FWD_STAGED[kind]) <= H100_SHARED
    assert plan.n_ti * plan.tw >= W + 2 > (plan.n_ti - 1) * plan.tw
    assert plan.n_tj * plan.tj >= H + 2 > (plan.n_tj - 1) * plan.tj
    padded = np.random.RandomState(0).standard_normal((H + 2, W + 2)).astype(np.float32)
    computed = np.zeros((H, W), int)
    sw, sh = plan.tw + 2, plan.tj + 2
    for r0, c0 in _tiles(plan):
        staged = np.full(sh * sw, np.nan, np.float32)
        for e in range(sh * sw):
            jp, ip = r0 - 1 + e // sw, c0 - 1 + e % sw
            if 0 <= jp < H + 2 and 0 <= ip < W + 2:
                staged[e] = padded[jp, ip]
        for n, j, i in _tile_cells(plan, r0, c0, H, W):
            lj, li = divmod(n, plan.tw)
            e = (lj + 1) * sw + li + 1
            got = staged[[e, e + 1, e - 1, e + sw, e - sw]]
            want = padded[[j + 1, j + 1, j + 1, j + 2, j], [i + 1, i + 2, i, i + 1, i + 1]]
            assert np.array_equal(got, want)
            computed[j, i] += 1
    assert (computed == 1).all()


@pytest.mark.parametrize("shape, tiles, passes, threads", [
    ((32, 39, 39), 4, 1, 448), ((128, 39, 39), 4, 2, 224), ((128, 117, 117), 16, 2, 480),
    ((3, 13, 17), 1, 1, 288), ((1, 1, 300), 10, 1, 96), ((4, 117, 117), 16, 1, 512)])
@pytest.mark.parametrize("kind", ["dg", "gc"])
def test_forward_blocks_per_call(kind, shape, tiles, passes, threads):
    """The tiles per sample and threads per block that PERF.md and the
    kernels' headers state on an H100: 21×21 tiles at 39×39, a thread per
    position at the main path's B = 32 (128 blocks, under the 132 SMs) and
    a thread per two at B = 128 (512 blocks); 30×30 tiles at 117×117 (2,048
    blocks of 480 threads at B = 128; at B = 4, 64 blocks, one pass asked for,
    but 900 positions take two of 512 threads). Every block covers its tile
    in at most two passes."""
    B, H, W = shape
    plan = st.fwd_tile_plan(H, W, kind, H100_SHARED)
    T = _threads(plan, st.fwd_passes(plan, B, SMS))
    assert (plan.n_ti * plan.n_tj, st.fwd_passes(plan, B, SMS), T) == (tiles, passes, threads)
    assert T % 32 == 0 and 2 * T >= plan.tw * plan.tj


def _kernel_order_mbc(terms: np.ndarray, plan) -> np.ndarray:
    """−Σ of each sample's (B, H, W) float32 balance terms in
    sum_per_sample's order, with the H100's threads per block."""
    B, H, W = terms.shape
    T = _threads(plan, st.fwd_passes(plan, B, SMS))
    total = np.zeros(B, np.float32)
    for r0, c0 in _tiles(plan):
        v = np.zeros((T, B), np.float32)
        for n, j, i in _tile_cells(plan, r0, c0, H, W):
            v[n % T] = v[n % T] + terms[:, j, i]
        block = np.zeros(B, np.float32)
        for w in range(T // 32):
            lane = v[32 * w:32 * (w + 1)].copy()
            for off in (16, 8, 4, 2, 1):
                lane[:32 - off] = lane[:32 - off] + lane[off:]
            block = block + lane[0]
        total = total + block
    return -total


@pytest.mark.parametrize("shape", [(32, 39, 39), (160, 39, 39), (4, 117, 117), (3, 13, 17),
                                   (1, 1, 300)])
def test_forward_mbc_in_the_kernels_order(shape):
    """B1's per-cell balance terms, rounded as the kernel rounds them (the
    scalar folded in double, then float32 operations in its order), summed
    in the kernel's order: the plain version's mbc at the card's tolerance."""
    args, cfg = _inputs(*shape, "cpu")
    s = st._pack(st._Scalars, cfg)
    f32 = np.float32
    invBg0, invBg1, q, tsteps = (args[k].numpy() for k in (4, 5, 7, 9))
    t1 = tsteps[:, 0].reshape(-1, 1, 1)
    terms = q + (f32(s.dv_Sgi_phi) * (invBg1 - invBg0)) / (f32(s.D) * t1)
    assert terms.dtype == np.float32
    got = _kernel_order_mbc(terms, st.fwd_tile_plan(*shape[1:], "dg", H100_SHARED))
    want = st.dg_stencil_residual_reference(*args, cfg)[3]
    torch.testing.assert_close(torch.from_numpy(got), want, rtol=RTOL,
                               atol=ATOL_REL * float(want.abs().max()))
