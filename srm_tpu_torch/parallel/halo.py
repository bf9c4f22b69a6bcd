"""Row blocks of H over a mesh's space axis, and the exchanges between them.

The JAX package has no module for this: on its ``('data', 'space')`` mesh
XLA SPMD turns the stencil's and the convolutions' shifted reads into halo
exchanges. Here a rank holds the rows ``[lo, hi)`` of H (the second-to-last
axis of a channels-first ``(N, C, [D,] H, W)`` activation or a ``(B, [D,]
H, W)`` stencil field; ``dim`` says otherwise) and fetches the rows it
needs from the ranks that hold them.

* :class:`Rows` names a layout: the global row count and each space
  index's block. A layout is a partition of H (``Rows.split``, the
  ``np.array_split`` blocks of ``Mesh.row_blocks``, or any other
  partition, such as the strided Δt input's), or whole on every rank
  (``Rows.whole``: a level too thin to split, or one that needs all of H).
* :func:`take_rows` is the one primitive: each space index names the window
  ``[a, b)`` of global rows that it wants (:func:`conv_windows` and
  :func:`deconv_windows` derive a layer's from its output block); a row it
  holds is copied, a row held elsewhere is received from its owner, and a
  row outside ``[0, n)`` is zero (a convolution's zero padding). Its
  backward sends the cotangent of every received row back to its owner,
  which adds the returned cotangents into its block in a fixed order
  (space index by space index, its own among them): two runs give the same
  bits. :func:`exchange_rows` (a block with ``before``/``after`` rows of its
  neighbours), :func:`gather_rows` (the whole H; its backward sums the
  cotangents over the space group, then keeps this rank's rows) and
  :func:`own_rows` (a whole tensor's rows of this rank, copied, so that
  autograd does not keep the whole alive) are windows of it.
* :func:`sum_over_space` all-reduces a partial sum over the space group;
  its backward all-reduces the cotangent. :func:`broadcast_over_space`
  gives every rank of the space group its first rank's tensor (noise that
  the group shares; no gradient).

Each primitive is the identity without a space axis. The route of the
point-to-point messages names the backend: NCCL sends device tensors with
``dist.batch_isend_irecv``; gloo sends CPU tensors, and a CUDA tensor over
gloo (two ranks on one card, where NCCL refuses a second rank) is staged
through the host. A failed send or receive raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from srm_tpu_torch.parallel.mesh import Mesh

Window = Tuple[int, int]


@dataclass(frozen=True)
class Rows:
    """A layout of an H of ``n`` rows over ``mesh``'s space axis: each space
    index's block ``[lo, hi)``."""

    mesh: Mesh
    n: int
    blocks: Tuple[Window, ...]

    @classmethod
    def split(cls, mesh: Mesh, n: int) -> "Rows":
        """``np.array_split``'s blocks (``Mesh.row_blocks``)."""
        return cls(mesh, int(n), tuple(mesh.row_blocks(n)))

    @classmethod
    def whole(cls, mesh: Mesh, n: int) -> "Rows":
        """All ``n`` rows on every space index."""
        return cls(mesh, int(n), ((0, int(n)),) * mesh.space_size)

    @classmethod
    def level(cls, mesh: Mesh, n: int) -> "Rows":
        """A network level's layout: split, or whole where some space index
        would hold no row (fewer rows than ranks)."""
        return cls.split(mesh, n) if n >= mesh.space_size else cls.whole(mesh, n)

    @property
    def lo(self) -> int:
        return self.blocks[self.mesh.space_rank][0]

    @property
    def hi(self) -> int:
        return self.blocks[self.mesh.space_rank][1]

    @property
    def count(self) -> int:
        return self.hi - self.lo

    @property
    def is_whole(self) -> bool:
        return all(b == (0, self.n) for b in self.blocks)

    def strided(self, s: int) -> Tuple["Rows", int]:
        """The layout of every ``s``-th row (the global rows ``0, s, 2s,
        ...``) and the local index of this rank's first such row: a block
        that starts at an odd global row starts its stride-2 rows at 1."""
        def up(r):
            return -(-r // s)

        blocks = tuple((up(lo), up(hi)) for lo, hi in self.blocks)
        return Rows(self.mesh, up(self.n), blocks), up(self.lo) * s - self.lo


def conv_windows(out: Rows, kernel: int, stride: int = 1, pad_lo: int = 0) -> List[Window]:
    """Each space index's input rows for its output block of a convolution
    (``kernel``, ``stride``, ``pad_lo`` zero rows before row 0): output row
    o reads the rows ``[o·stride − pad_lo, o·stride − pad_lo + kernel)``."""
    return [(a * stride - pad_lo, (b - 1) * stride - pad_lo + kernel) if b > a
            else (a * stride - pad_lo, a * stride - pad_lo) for a, b in out.blocks]


def deconv_windows(out: Rows, kernel: int, stride: int) -> List[Window]:
    """Each space index's input rows for its output block of a transposed
    convolution (VALID): output row o gathers the inputs i with
    ``0 <= o − stride·i < kernel``. The window's own output starts at row
    ``stride·a'`` of the window's first row a'."""
    return [((a - kernel) // stride + 1, (b - 1) // stride + 1) for a, b in out.blocks]


# -- the messages --------------------------------------------------------------

def _transport(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor of a dtype that every backend sends (16-bit
    floats as int16 bits)."""
    t = t.contiguous()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.view(torch.int16)
    return t


def _exchange(mesh: Mesh, sends: Sequence[Tuple[int, torch.Tensor]],
              recvs: Sequence[Tuple[int, Tuple[int, ...]]], like: torch.Tensor
              ) -> List[torch.Tensor]:
    """Send each ``(space index, tensor)`` of ``sends`` and receive each
    ``(space index, shape)`` of ``recvs`` (``like``'s dtype and device), all
    at once; the received tensors in ``recvs``' order."""
    if not sends and not recvs:
        return []
    staged = mesh.backend != "nccl" and like.device.type != "cpu"
    where = torch.device("cpu") if staged else like.device
    out_bufs = [_transport(t).to(where) for _, t in sends]
    in_bufs = [_transport(torch.empty(shape, dtype=like.dtype, device=where))
               for _, shape in recvs]
    peers_out = [mesh.space_peer(q) for q, _ in sends]
    peers_in = [mesh.space_peer(q) for q, _ in recvs]
    if mesh.backend == "nccl":
        ops = ([dist.P2POp(dist.isend, t, p) for t, p in zip(out_bufs, peers_out)]
               + [dist.P2POp(dist.irecv, t, p) for t, p in zip(in_bufs, peers_in)])
        reqs = dist.batch_isend_irecv(ops)
    else:
        reqs = ([dist.isend(t, p) for t, p in zip(out_bufs, peers_out)]
                + [dist.irecv(t, p) for t, p in zip(in_bufs, peers_in)])
    for r in reqs:
        r.wait()
    return [b.view(like.dtype).to(like.device) if b.dtype != like.dtype else b.to(like.device)
            for b in in_bufs]


def _plan(rows: Rows, windows: Sequence[Window]):
    """What this rank copies, receives and sends for ``windows``: pieces of
    its window in row order, as ("zero" | "local" | space index, global
    [a, b)); and its sends, as (space index, global [a, b))."""
    me = rows.mesh.space_rank
    whole = rows.is_whole

    def owners(a, b, holder):
        """[a, b) cut into (source, [a', b')) in row order."""
        out = []
        r = a
        while r < b:
            if r < 0 or r >= rows.n:
                end = min(b, 0) if r < 0 else b
                out.append(("zero", (r, end)))
                r = end
                continue
            lo, hi = rows.blocks[holder]
            if whole or lo <= r < hi:
                end = min(b, hi if not whole else rows.n)
                out.append((holder, (r, end)))
                r = end
                continue
            q = next(q for q, (l2, h2) in enumerate(rows.blocks) if l2 <= r < h2)
            end = min(b, rows.blocks[q][1])
            out.append((q, (r, end)))
            r = end
        return out

    pieces = [("local" if src == me else src, span)
              for src, span in owners(*windows[me], me)]
    sends = []
    if not whole:
        for q in range(rows.mesh.space_size):
            if q != me:
                sends += [(q, span) for src, span in owners(*windows[q], q) if src == me]
    return pieces, sends


def _rows_of(t: torch.Tensor, dim: int, a: int, b: int) -> torch.Tensor:
    return t.narrow(dim, a, b - a)


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rows: Rows, windows: Tuple[Window, ...], dim: int):
        pieces, sends = _plan(rows, windows)
        lo = rows.lo
        recvs = [(src, span) for src, span in pieces if src not in ("local", "zero")]

        def shape(n):
            s = list(x.shape)
            s[dim] = n
            return tuple(s)

        got = iter(_exchange(rows.mesh,
                             [(q, _rows_of(x, dim, a - lo, b - lo)) for q, (a, b) in sends],
                             [(q, shape(b - a)) for q, (a, b) in recvs], x))
        parts = []
        for src, (a, b) in pieces:
            if src == "zero":
                parts.append(x.new_zeros(shape(b - a)))
            elif src == "local":
                parts.append(_rows_of(x, dim, a - lo, b - lo))
            else:
                parts.append(next(got))
        ctx.plan = (rows, pieces, sends, dim, tuple(x.shape))
        if not parts:
            return x.new_zeros(shape(0))
        out = torch.cat(parts, dim=dim) if len(parts) > 1 else parts[0].clone()
        return out.contiguous()

    @staticmethod
    def backward(ctx, g):
        rows, pieces, sends, dim, x_shape = ctx.plan
        lo = rows.lo
        w0 = pieces[0][1][0] if pieces else 0
        back = [(src, _rows_of(g, dim, a - w0, b - w0)) for src, (a, b) in pieces
                if src not in ("local", "zero")]

        def shape(n):
            s = list(x_shape)
            s[dim] = n
            return tuple(s)

        got = _exchange(rows.mesh, back, [(q, shape(b - a)) for q, (a, b) in sends], g)
        # every contribution to this rank's block, added space index by
        # space index (this rank's own in its place), each in row order
        me = rows.mesh.space_rank
        parts = [(me, a, _rows_of(g, dim, a - w0, b - w0)) for src, (a, b) in pieces
                 if src == "local"]
        parts += [(q, a, t) for (q, (a, _)), t in zip(sends, got)]
        parts.sort(key=lambda p: p[0])
        grad = g.new_zeros(x_shape)
        for _, a, t in parts:
            _rows_of(grad, dim, a - lo, a - lo + t.shape[dim]).add_(t)
        return grad, None, None, None


def take_rows(x: torch.Tensor, rows: Rows, windows: Sequence[Window], dim: int = -2
              ) -> torch.Tensor:
    """This rank's window ``windows[space_rank]`` of the global rows of a
    tensor laid out as ``rows``; every space index passes every index's
    window (the messages are derived from them). Rows outside ``[0, n)``
    are zero. Where the window is this rank's own block, ``x`` itself."""
    windows = tuple((int(a), int(b)) for a, b in windows)
    if windows[rows.mesh.space_rank] == (rows.lo, rows.hi) and (
            rows.is_whole or all(w == b for w, b in zip(windows, rows.blocks))):
        return x
    return _TakeRows.apply(x, rows, windows, dim % x.dim())


def exchange_rows(x: torch.Tensor, rows: Rows, before: int, after: int, dim: int = -2
                  ) -> torch.Tensor:
    """This block with ``before`` rows of the rows above it and ``after``
    of those below it (zeros beyond the domain's first and last rows)."""
    return take_rows(x, rows, [(lo - before, hi + after) for lo, hi in rows.blocks], dim)


def gather_rows(x: torch.Tensor, rows: Rows, dim: int = -2) -> torch.Tensor:
    """The whole H on every rank (laid out as ``Rows.whole``)."""
    return take_rows(x, rows, [(0, rows.n)] * len(rows.blocks), dim)


def own_rows(x: torch.Tensor, out: Rows, dim: int = -2) -> torch.Tensor:
    """This rank's block of ``out`` from a whole tensor, copied."""
    if out.is_whole:
        return x
    return take_rows(x, Rows.whole(out.mesh, out.n), out.blocks, dim)


class _SumOverSpace(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh: Mesh):
        ctx.mesh = mesh
        y = x.clone()
        dist.all_reduce(y, group=mesh.space_group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.mesh.space_group)
        return g, None


def sum_over_space(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over ``mesh``'s space group (each rank's partial sum
    of its rows); ``x`` itself without a space axis."""
    if mesh is None or mesh.space_size <= 1:
        return x
    return _SumOverSpace.apply(x, mesh)


@torch.no_grad()
def broadcast_over_space(x: torch.Tensor, mesh) -> torch.Tensor:
    """The space group's first rank's ``x`` on every rank of the group (a
    new tensor; ``x`` itself without a space axis). A CUDA tensor over
    gloo is staged through the host, as :func:`take_rows`' messages are."""
    if mesh is None or mesh.space_size <= 1:
        return x
    staged = mesh.backend != "nccl" and x.device.type != "cpu"
    buf = _transport(x.detach().to("cpu") if staged else x.detach().clone())
    dist.broadcast(buf, src=mesh.space_peer(0), group=mesh.space_group)
    return (buf.view(x.dtype) if buf.dtype != x.dtype else buf).to(x.device)
