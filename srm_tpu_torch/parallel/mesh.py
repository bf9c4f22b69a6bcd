"""Data- and space-parallel meshes over a ``torch.distributed`` process group.

Port of ``srm_tpu/parallel/mesh.py``. There, a ``Mesh(('data',))`` over the
devices of a host shards the batch axis, a ``Mesh(('data', 'space'))`` of
``(n/k, k)`` devices also shards H, and XLA inserts the gradient
all-reduces and the halo exchanges into the jitted step. Here a rank is a
process with one device, the mesh is the default process group (started by
``torchrun`` and :func:`process_group_from_env`), and the trainer makes the
reductions itself (``training/trainer.py``): one ``all_reduce`` (SUM) a step
over a flat buffer of every gradient and the step's metrics, over every
rank of data × space, captured in the step's CUDA graph on NCCL. The halo
exchanges of the space axis are ``parallel/halo.py``'s.

* :func:`make_mesh` returns this rank's :class:`Mesh`: the world size, its
  rank, the group (None without an initialised group: world 1, no
  collective) and its device (``cuda:LOCAL_RANK``). With ``spatial=k`` the
  ranks form the JAX package's ``reshape(n // k, k)``: rank r is at data
  index ``r // k`` and space index ``r % k``, so the k ranks of one space
  group are neighbours on a host; each space group and each data group is
  a subgroup (``dist.new_group``, made by every rank in the same order).
* :func:`shard_batch` gives this rank its contiguous block of the batch
  axis over the data axis, as ``NamedSharding`` on ``'data'`` lays a batch
  out over devices, and on a space axis its block of H (axis
  ``batch_axis + 2`` of an array of rank ``batch_axis + 4`` or more, as
  ``_spec_for_rank`` places it, or the axis given). An uneven batch or H is
  split in blocks whose sizes differ by at most one (``np.array_split``'s
  rule: 39 rows over 2 ranks are 20 and 19), where the JAX package
  replicates such an array: the loss is a sum over the batch and the cells,
  so the blocks' sums add up to the whole's either way.
* :func:`replicate` broadcasts tensors from rank 0, in place.
* ``batch_sharding`` and ``replicated`` have no counterpart: they name XLA
  shardings, and a process holds plain tensors (its block, or a whole
  copy). :func:`pad_to_multiple` is the same helper.
* ``activation_mesh_scope``, ``constrain_spatial`` and
  ``constrain_replicated`` anchor XLA's sharding propagation on the space
  axis. Their work here is explicit: every network layer computes its own
  rows from the rows it fetches (``nn/encoder_decoder.py``, ``halo.py``),
  and the weights are replicated tensors.

Under a group, :func:`rank_device` makes ``"cuda"`` mean ``cuda:LOCAL_RANK``
and :func:`rank_zero_first` lets rank 0 build what the others then read
(the dataset cache and its simulator labels, ``examples/common.py``).
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os
from dataclasses import dataclass
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

#: the process group's timeout when :func:`process_group_from_env` starts
#: it: the other ranks wait at a barrier while rank 0 simulates the
#: labels (678 s for the drawdown case on an H100)
GROUP_TIMEOUT = datetime.timedelta(hours=2)


def split_sizes(n: int, parts: int) -> List[int]:
    """``n`` in ``parts`` blocks whose sizes differ by at most one, the
    larger first (``np.array_split``'s rule)."""
    base, extra = divmod(int(n), int(parts))
    return [base + (r < extra) for r in range(parts)]


def split_blocks(n: int, parts: int) -> List[Tuple[int, int]]:
    """The ``[lo, hi)`` of each of :func:`split_sizes`'s blocks."""
    out, lo = [], 0
    for size in split_sizes(n, parts):
        out.append((lo, lo + size))
        lo += size
    return out


@dataclass(frozen=True)
class Mesh:
    """One rank's view of a ``('data',)`` mesh of ``size`` ranks, or of a
    ``('data', 'space')`` mesh of ``size // space_size`` × ``space_size``.
    ``group`` is every rank's (the gradient all-reduce's);
    ``space_group`` the ranks of this rank's space group (those that hold
    the other rows of its batch block) and ``data_group`` those of its data
    group (the other batch blocks of its rows); both None without a space
    axis."""

    size: int = 1
    rank: int = 0
    group: Optional[Any] = None       # None: no process group, no collective
    device: torch.device = torch.device("cpu")
    axis_name: str = "data"
    space_size: int = 1
    space_group: Optional[Any] = None
    data_group: Optional[Any] = None

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else str(dist.get_backend(self.group))

    @property
    def data_size(self) -> int:
        return self.size // self.space_size

    @property
    def data_rank(self) -> int:
        return self.rank // self.space_size

    @property
    def space_rank(self) -> int:
        return self.rank % self.space_size

    def space_peer(self, space_rank: int) -> int:
        """The global rank at ``space_rank`` of this rank's space group."""
        return self.data_rank * self.space_size + int(space_rank)

    def block_sizes(self, n: int) -> List[int]:
        """The rows of a batch of ``n`` on each data index (``np.array_split``'s rule)."""
        return split_sizes(n, self.data_size)

    def block(self, n: int) -> Tuple[int, int]:
        """This rank's rows ``[lo, hi)`` of a batch of ``n`` (its data
        index's block); raises where a block would be empty."""
        sizes = self.block_sizes(n)
        if min(sizes) == 0:
            raise ValueError(f"a batch of {n} rows leaves ranks of a {self.data_size}-rank "
                             f"data axis without a row")
        lo = sum(sizes[:self.data_rank])
        return lo, lo + sizes[self.data_rank]

    def row_blocks(self, h: int) -> List[Tuple[int, int]]:
        """Each space index's rows ``[lo, hi)`` of an H of ``h`` rows."""
        return split_blocks(h, self.space_size)

    def rows(self, h: int) -> Tuple[int, int]:
        """This rank's rows ``[lo, hi)`` of an H of ``h`` rows; raises where
        a block would be empty."""
        if h < self.space_size:
            raise ValueError(f"an H of {h} rows leaves ranks of a {self.space_size}-rank "
                             f"space axis without a row")
        return self.row_blocks(h)[self.space_rank]


def rank_device(device=None) -> torch.device:
    """``device`` (None: ``"cuda"``) for this process: under an initialised
    process group a ``"cuda"`` without an index is ``cuda:LOCAL_RANK``
    (torchrun's variable; the rank modulo the visible cards without it);
    any other device is itself."""
    device = torch.device(device if device is not None else "cuda")
    if device.type != "cuda" or device.index is not None or not dist.is_initialized():
        return device
    count = max(torch.cuda.device_count(), 1)
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", dist.get_rank() % count)))


#: the subgroups of each space-axis size, per default group: made once, as
#: ``dist.new_group`` must be called by every rank in the same order
_SUBGROUPS: dict = {}


def _subgroups(world: int, spatial: int, rank: int):
    """(space group, data group) of ``rank``: every rank makes every
    group, the space groups (data index by data index) first."""
    default = dist.group.WORLD
    key = (id(default), world, spatial)
    if key not in _SUBGROUPS:
        space = [dist.new_group(list(range(d * spatial, (d + 1) * spatial)))
                 for d in range(world // spatial)]
        data = [dist.new_group(list(range(s, world, spatial))) for s in range(spatial)]
        _SUBGROUPS[key] = (default, space, data)
    _, space, data = _SUBGROUPS[key]
    return space[rank // spatial], data[rank % spatial]


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data",
              spatial: int = 1) -> Mesh:
    """This rank's mesh over the default process group: its world size
    (``n_devices``, when given, must equal it), or world 1 without a group.
    ``spatial=k`` > 1 splits the ranks as ``(n/k, k)`` ``('data',
    'space')``; ``n`` not a multiple of ``k`` raises ``ValueError``, as in
    the JAX package (``mesh.py:39-40``)."""
    spatial = int(spatial)
    if spatial > 1 and n_devices is not None and n_devices % spatial:
        raise ValueError(f"{n_devices} devices not divisible by spatial={spatial}")
    device = rank_device("cuda") if torch.cuda.is_available() else torch.device("cpu")
    if not dist.is_initialized():
        n = n_devices if n_devices is not None else (spatial if spatial > 1 else None)
        if n not in (None, 1):
            raise ValueError(f"a mesh of {n} ranks needs a process group: launch with "
                             f"torchrun --nproc-per-node={n}")
        return Mesh(1, 0, None, device, axis_name)
    world = dist.get_world_size()
    if n_devices not in (None, world):
        raise ValueError(f"n_devices={n_devices}, but the process group has {world} ranks")
    rank = dist.get_rank()
    if spatial <= 1:
        return Mesh(world, rank, dist.group.WORLD, device, axis_name)
    if world % spatial:
        raise ValueError(f"{world} devices not divisible by spatial={spatial}")
    space_group, data_group = _subgroups(world, spatial, rank)
    return Mesh(world, rank, dist.group.WORLD, device, axis_name, spatial, space_group,
                data_group)


@contextlib.contextmanager
def process_group_from_env(device=None) -> Iterator[Mesh]:
    """Yield :func:`make_mesh`'s mesh, inside a default process group
    started from torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT``) and destroyed at the exit:
    NCCL for a CUDA ``device`` (after ``torch.cuda.set_device(LOCAL_RANK)``),
    gloo for the CPU. Without those variables, or with a group already
    initialised, it starts nothing (world 1 without a group, as a single
    process)."""
    start = "WORLD_SIZE" in os.environ and not dist.is_initialized()
    if start:
        cuda = torch.device(device if device is not None else "cuda").type == "cuda"
        if cuda:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if cuda else "gloo", timeout=GROUP_TIMEOUT)
    try:
        yield make_mesh()
    finally:
        if start:
            dist.destroy_process_group()


def barrier(mesh: Mesh) -> None:
    """Wait for every rank of ``mesh`` (nothing without a group)."""
    if mesh.group is None:
        return
    if mesh.backend == "nccl":
        dist.barrier(group=mesh.group, device_ids=[mesh.device.index or 0])
    else:
        dist.barrier(group=mesh.group)


@contextlib.contextmanager
def rank_zero_first(mesh: Optional[Mesh] = None) -> Iterator[None]:
    """Run the body on rank 0 first and on the other ranks after it: they
    wait at a barrier, then find what rank 0 wrote (a cache). Rank 0 enters
    the barrier even when its body raised, so that no rank waits for ever."""
    mesh = mesh if mesh is not None else make_mesh()
    if mesh.rank != 0:
        barrier(mesh)
    try:
        yield
    finally:
        if mesh.rank == 0:
            barrier(mesh)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(x, mesh: Mesh, batch_axis: int = 0):
    """This rank's block of every array (numpy or torch) of the pytree ``x``
    along ``batch_axis`` (views); arrays with no such axis are kept whole,
    as the JAX package replicates them. An uneven batch is logged. On a
    space axis an array of rank ``batch_axis + 4`` or more also gives its
    rows of H: axis ``batch_axis + 2`` (``_spec_for_rank``'s, H of the
    ``(B, T, H, W[, C])`` layout)."""
    def take(a):
        ndim = getattr(a, "ndim", 0)
        if ndim <= batch_axis:
            return a
        n = a.shape[batch_axis]
        lo, hi = mesh.block(n)
        if n % mesh.data_size:
            log.warning("shard_batch: a batch of %d rows over %d ranks gives blocks of %s rows: "
                        "the ranks with fewer rows idle part of each step; make the batch a "
                        "multiple of the data-axis size", n, mesh.data_size,
                        mesh.block_sizes(n))
        a = a[(slice(None),) * batch_axis + (slice(lo, hi),)]
        if mesh.space_size > 1 and ndim - batch_axis >= 4:
            ax = batch_axis + 2
            r0, r1 = mesh.rows(a.shape[ax])
            a = a[(slice(None),) * ax + (slice(r0, r1),)]
        return a

    return _map(take, x)


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


@torch.no_grad()
def replicate(tree, mesh: Mesh):
    """Broadcast every tensor of ``tree`` (tensors, modules, nested lists and
    dicts of them) from rank 0 into each rank's tensors, in place; returns
    ``tree``."""
    if mesh.group is not None:
        for t in _tensors(tree):
            dist.broadcast(t.data, src=0, group=mesh.group)
    return tree


def mean_over(tensors: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """Each tensor's mean over its elements on every rank: one all-reduce
    (SUM) of the local sums and element counts (float32, exact up to 2^24
    elements). Makes nothing on the host, so a CUDA graph captures it."""
    if not tensors:
        return []
    k = len(tensors)
    sums = [t.sum().float() for t in tensors]
    counts = [torch.full((), float(t.numel()), dtype=torch.float32, device=t.device)
              for t in tensors]
    buf = torch.stack(sums + counts)
    if mesh.group is not None:
        dist.all_reduce(buf, group=mesh.group)
    return list((buf[:k] / buf[k:]).unbind())


def gather_rows(arrays: Sequence[np.ndarray], mesh: Mesh, axes: Sequence[int],
                h_axes: Optional[Sequence[int]] = None) -> Optional[List[np.ndarray]]:
    """Host arrays concatenated over the ranks along ``axes`` (rank order)
    on rank 0, None on the others: the whole batch that this rank holds a
    block of. On a space axis each data index's blocks are first
    concatenated along ``h_axes`` (space index order: the whole H), then
    the data indices along ``axes``."""
    if mesh.group is None:
        return list(arrays)
    got: List[Any] = [None] * mesh.size
    dist.all_gather_object(got, list(arrays), group=mesh.group)
    if mesh.rank != 0:
        return None
    k = mesh.space_size
    if k > 1:
        if h_axes is None:
            raise ValueError("gather_rows on a space axis needs the arrays' H axes (h_axes=)")
        got = [[np.concatenate([g[i] for g in got[d:d + k]], axis=h_axes[i])
                for i in range(len(arrays))] for d in range(0, mesh.size, k)]
    return [np.concatenate([g[i] for g in got], axis=ax) for i, ax in enumerate(axes)]


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
