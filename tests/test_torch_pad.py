"""The port's ghost-cell pad and its fixed-order backward, on the CPU.

``pad_symmetric`` and ``pad_symmetric_3d`` (``srm_tpu_torch/ops/stencil.py``)
pad with ``F.pad(mode="replicate")`` and fold the halo's cotangent back into
the edge cells with slicing adds in a fixed order, where ``F.pad``'s CUDA
backward adds with atomics whose order changes from run to run. Held here:
the forward equals ``F.pad``'s bit for bit, and the backward equals
autograd through ``F.pad`` in float64 (to 1e-12 of the cotangent's largest
magnitude: the two sum a corner's up to eight values in other orders) and
``jax.vjp`` of the reference's ``jnp.pad(mode="symmetric")`` (width 1) in
float32 (to 1e-6 of that magnitude), on numpy-seeded inputs. Fields of one
cell along an axis fold both halos into that cell.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from srm_tpu_torch.ops.stencil import pad_symmetric, pad_symmetric_3d

CASES = {(3, 13, 17): 2, (2, 5, 13, 17): 3, (2, 1, 300): 2, (2, 3, 1, 1, 5): 3}


def _pads(dims):
    return pad_symmetric if dims == 2 else pad_symmetric_3d


def _replicate(x, dims):
    """F.pad(mode="replicate") of the last ``dims`` axes, with autograd."""
    lead = x.shape[:-dims]
    out = F.pad(x.reshape((-1, 1) + tuple(x.shape[-dims:])), (1, 1) * dims, mode="replicate")
    return out.reshape(tuple(lead) + tuple(out.shape[2:]))


@pytest.mark.parametrize("shape", list(CASES), ids=lambda s: "x".join(map(str, s)))
def test_pad_matches_replicate_and_its_autograd(shape):
    dims = CASES[shape]
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.standard_normal(shape)).requires_grad_(True)
    x_ref = x.detach().clone().requires_grad_(True)
    got, want = _pads(dims)(x), _replicate(x_ref, dims)
    assert torch.equal(got, want)
    g = torch.from_numpy(rng.standard_normal(tuple(got.shape)))
    (gx,) = torch.autograd.grad(got, x, g)
    (gx_ref,) = torch.autograd.grad(want, x_ref, g)
    torch.testing.assert_close(gx, gx_ref, rtol=0, atol=1e-12 * float(g.abs().max()))


@pytest.mark.parametrize("shape", list(CASES), ids=lambda s: "x".join(map(str, s)))
def test_pad_backward_matches_the_jax_vjp(shape):
    """The VJP of the JAX package's pad (``jnp.pad(mode="symmetric")``,
    width 1, on the last two or three axes) for the same float32 field and
    cotangent."""
    dims = CASES[shape]
    rng = np.random.RandomState(1)
    x = rng.standard_normal(shape).astype(np.float32)
    width = [(0, 0)] * (len(shape) - dims) + [(1, 1)] * dims
    out, vjp = jax.vjp(lambda f: jnp.pad(f, width, mode="symmetric"), jnp.asarray(x))
    g = rng.standard_normal(out.shape).astype(np.float32)
    (want,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = _pads(dims)(xt)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    (gx,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    np.testing.assert_allclose(gx.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6 * float(np.abs(g).max()))


def test_pad_backward_is_one_fixed_order():
    """A corner cell's gradient: its own cotangent plus its two edges' and
    its corner's, summed axis by axis. Rows first: the corner's 1e8 meets
    the left edge's -1e8 (0.0) and the bottom edge's 1.0 meets the cell's
    3.0 (4.0); then the columns, 4.0 + 0.0. Another order (the cell's 3.0
    with 1e8 first) loses the 3.0 and the 1.0 in float32. The same bits on
    every call."""
    g = torch.zeros(1, 5, 6, dtype=torch.float32)
    g[0, :2, :2] = torch.tensor([[1e8, 1.0], [-1e8, 3.0]])
    x = torch.zeros(1, 3, 4, requires_grad=True)
    (gx,) = torch.autograd.grad(pad_symmetric(x), x, g)
    assert float(gx[0, 0, 0]) == (3.0 + 1.0) + (-1e8 + 1e8)
    for _ in range(3):
        (again,) = torch.autograd.grad(pad_symmetric(x), x, g)
        assert torch.equal(again, gx)
