"""Multi-model training loop.

Port of ``srm_tpu/training/trainer.py``: a :class:`Trainer` that owns one
optimizer per trainable model, the device-resident datasets and the train
and eval steps, and :func:`train_combined_models_unified`, the training
driver (epochs, the train and val history, watched-epoch snapshots, the
min–max best-epoch restore, checkpoint and resume).

A dataset is staged once: its (K, T) axes are collapsed first-axis-fastest,
the groups concatenated and the result copied to the device. Each training
epoch draws a fresh permutation from the trainer's ``torch.Generator`` and
runs ``N // B`` full batches; the ragged tail is dropped, a different subset
each epoch, as the reference drops it (``trainer.py:200-229``).

**One step function, eager or replayed.** The reference jits the whole
step (loss, gradients, every optimizer update) and scans it over an epoch
(``trainer.py:82-92``, ``:168-183``). Here the step reads its batch from
static buffers: before each step one copy puts the batch's rows of the
epoch's permutation into a static index buffer, and the step gathers the
batch from the resident dataset itself (under a graph, into the same
addresses of its pool at every replay), computes the loss and
``torch.autograd.grad``, runs every optimizer update (whose schedules are
device tensors, ``optimizers.py``) and writes its scalar metrics into a
``(num_batches, n_metrics)`` device buffer at the row of a device-side step
index. The epoch then makes one host copy of that buffer.

On a CUDA device (``cuda_graph``, on by default there) the step is captured
as one CUDA graph per step kind and dataset, and every later step is one
replay of it. The first ``Trainer.warmup_steps`` (3) steps of a kind run
eagerly on a side stream, as PyTorch requires before a capture; they are
real steps, each on its own batch, so every epoch makes exactly
``num_batches`` updates. The eval step is captured the same way under
``no_grad`` and shares the train graph's memory pool: no tensor allocated
during a capture outlives it, and the graphs never run at once. A graph holds the addresses of the
tensors it captured: whatever writes the weights, the optimizer state or the
datasets afterwards (the best-epoch restore, a resume) copies into them in
place. A capture that fails raises; nothing falls back to the eager step.
On the CPU, where there are no graphs, the same step function runs eagerly.

The kernels' launch counters (``kernels/stencil.py``) count Python calls; the
trainer takes back what a capture moved them by and adds that at every
replay, so they go on counting launches on the card.

**Data parallel.** As the JAX trainer runs on ``make_mesh()`` (every device
of the host, the batch axis sharded), this one runs on
``parallel/mesh.py::make_mesh()``: the default process group when one is
initialised (``torchrun``), else this process alone, exactly as before.
Under a group each rank takes its block of every batch and the step sums
the gradients and the metrics' sums over the ranks in one all-reduce,
inside the step's graph on NCCL (:class:`Trainer`); ``train_epoch`` and
``eval_epoch`` are the JAX trainer's host-batched epochs, sharding batch
axis 1.

**Space axis.** On ``make_mesh(n, spatial=k)`` (the JAX trainer's
``Trainer(mesh=make_mesh(n, spatial=k))``) each rank also holds only its
rows of H of every staged dataset and batch (axis 2 of a 2D sample
``(B, 1, H, W[, C])``, 3 of a 3D one ``(B, 1, D, H, W[, C])``, in
``np.array_split``'s blocks) and the loss evaluates them with
halo exchanges (``losses/physics_loss.py``, ``parallel/halo.py``). The
step's one all-reduce still runs over every rank of data × space, so the
gradients are the whole grid's and the whole batch's. On NCCL the halo
exchanges are captured in the train and eval graphs with the all-reduce;
a gloo group with a graph raises, as without a space axis.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from srm_tpu_torch.config import DEFAULT_GENERAL_CONFIG, get_optimizer_config
from srm_tpu_torch.data.batching import collapse_groups
from srm_tpu_torch.kernels import stencil as st
from srm_tpu_torch.parallel.mesh import Mesh, make_mesh, replicate
from srm_tpu_torch.training.optimizers import build_optimizer_from_config

log = logging.getLogger(__name__)


def validate_loss_keys(labels, loss_keys, general_config) -> None:
    """In data (non-physics) mode, assert that the label dict covers the
    training-data terms (ref training.py:367-409). No-op in physics mode."""
    if general_config.get("physics_mode_fraction", 1.0) != 0:
        return
    n_td_terms = sum(1 for keys in loss_keys.values() for k in keys
                     if k.split("_")[0] == "td")
    n_labels = len(labels) if isinstance(labels, dict) else 1
    assert n_labels >= min(n_td_terms, 2) and n_labels > 0, (
        f"non-physics mode needs labels for the td terms: have {n_labels} "
        f"label keys for {n_td_terms} td terms")


class _StepState:
    """The static buffers of one step kind over one source dataset: the
    index of this rank's rows of the batch, the per-step metrics and the
    device-side step index; and, on the card, its graph. ``batch`` is the
    batch's rows over every rank of the mesh, ``rows`` this rank's."""

    def __init__(self, x_all, y_all, batch: int, rows: int, num_batches: int, n_metrics: int):
        device = x_all.device
        self.x_all, self.y_all = x_all, y_all
        self.batch, self.rows = batch, rows
        self.idx = torch.arange(rows, device=device)
        self.metrics = torch.zeros((num_batches, n_metrics), dtype=torch.float32, device=device)
        self.row = torch.zeros(1, dtype=torch.long, device=device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.warm = 0                       # eager warm-up steps taken
        self.counts: Dict[str, int] = {}    # launch-counter moves per replay


class Trainer:
    """Owns the optimizers, the resident datasets and the train/eval steps.

    ``cuda_graph``: None means a graph exactly when the models are on a CUDA
    device; True on the CPU raises. False on the card runs the eager step,
    the replay's reference for the checks.

    ``mesh`` (``parallel/mesh.py``; None: :func:`make_mesh`, the default
    process group if one is initialised, else this process alone): under a
    process group every rank holds the whole dataset and the same
    generator, and each step takes this rank's block of the global batch.
    The step writes every trainable gradient into one flat buffer followed
    by the step's weighted SSE sums, its total and its share of the Δt mean,
    and the optimizers read views of it. The loss is a sum of weighted SSE
    over the batch, so under a group the gradients are summed over the
    ranks, never averaged: one ``all_reduce`` (SUM) a step over that buffer
    (without a group, none). Each term's metric is its summed SSE over the
    whole batch's element count (static: every rank knows every rank's
    rows), so the division is the one a single process makes. The eval step
    reduces its metrics the same way. On the card the collective is
    captured in the step's graph; that needs NCCL (a gloo group with a
    graph raises), and the eager warm-up steps run it first. Weights and
    optimizer state are broadcast from rank 0 once, here. On a space axis
    (``make_mesh(n, spatial=k)``) each rank holds and steps on its rows of
    H as well; the metrics' counts are the whole grid's, and the Δt mean,
    equal on every rank of a space group, enters the buffer once per
    group."""

    #: eager steps of each kind before its capture (PyTorch's recipe: a few
    #: on a side stream, so that autograd, cuBLAS and cuDNN set up outside it)
    warmup_steps = 3

    def __init__(self, loss_fn, optimizer_configs: Optional[Dict[str, Dict]] = None,
                 seed: int = 0, cuda_graph: Optional[bool] = None, mesh: Optional[Mesh] = None):
        self.loss_fn = loss_fn
        self.models = loss_fn.models
        self.device = loss_fn.device
        self.mesh = mesh if mesh is not None else make_mesh()
        on_cuda = self.device.type == "cuda"
        if cuda_graph and not on_cuda:
            raise ValueError(f"cuda_graph=True needs the models on a CUDA device, they are on "
                             f"{self.device}")
        self.cuda_graph = on_cuda if cuda_graph is None else bool(cuda_graph)
        distributed = self.mesh.group is not None
        if self.cuda_graph and distributed and self.mesh.backend != "nccl":
            raise ValueError(f"a CUDA graph captures the gradient all-reduce and the halo "
                             f"exchanges on NCCL only (gloo stages them through the host), "
                             f"the mesh's group is {self.mesh.backend}: pass cuda_graph=False")
        self.generator = torch.Generator().manual_seed(int(seed))
        self.optimizer_keys = list(loss_fn.trainable_models_keys)
        self.optimizers = {}
        for key in self.optimizer_keys:
            cfg = (optimizer_configs or {}).get(key) or get_optimizer_config(key)
            params = list(self.models[loss_fn.logical_name(key)].parameters())
            self.optimizers[key] = build_optimizer_from_config(params, cfg)
        # the step's scalar metrics, in the order of its metrics row
        self._terms = [(ph, k.rsplit("_", 1)[0]) for ph, keys in loss_fn.loss_keys.items()
                       for k in keys]
        self.metric_names = [f"{ph}/{t}" for ph, t in self._terms] + ["total", "tstep_mean"]
        loss_fn.set_mesh(self.mesh)
        # the flat buffers of each step kind's one all-reduce (train: every
        # gradient, then the metrics' sums; eval: the sums), summed over the
        # ranks under a process group and used as they are without one
        if distributed:
            replicate([self.trained_models(), [o.state() for o in self.optimizers.values()]],
                      self.mesh)
        n_stats = len(self._terms) + 2
        params = [p for k in self.optimizer_keys for p in self.optimizers[k].params]
        dtype = params[0].dtype             # float32 (a float64 copy in the tests)
        if any(p.dtype != dtype for p in params):
            raise ValueError("the trained parameters must share one dtype")
        size = sum(p.numel() for p in params)
        self._train_buf = torch.zeros(size + n_stats, dtype=dtype, device=self.device)
        self._eval_buf = torch.zeros(n_stats, dtype=dtype, device=self.device)
        self._grad_views: Dict[str, List[torch.Tensor]] = {}
        offset = 0
        for k in self.optimizer_keys:
            self._grad_views[k] = []
            for p in self.optimizers[k].params:
                self._grad_views[k].append(self._train_buf[offset:offset + p.numel()].view_as(p))
                offset += p.numel()
        self._resident: Dict[str, Any] = {}
        self._states: Dict[tuple, _StepState] = {}
        self._pool = torch.cuda.graph_pool_handle() if self.cuda_graph else None
        self._side_stream = None
        self.replays = {"train": 0, "eval": 0}
        #: host seconds of each kind's captures (graph recorded and instantiated)
        self.capture_seconds = {"train": 0.0, "eval": 0.0}

    # -- the step function (eager on the CPU, captured on the card) ---------
    @staticmethod
    def _gather(s: _StepState):
        """The batch that ``s.idx`` names. Under a graph it lands at the same
        address of the graph's pool at every replay. (Gathered into
        preallocated buffers instead, with ``index_select(out=)``, the DG 3D
        step's convolutions took slower cuDNN plans on the H100; PERF.md.)"""
        return s.x_all[s.idx], {k: v[s.idx] for k, v in s.y_all.items()}

    def _record(self, s: _StepState, vals: List[torch.Tensor]) -> None:
        row = torch.stack([v.detach().reshape(()) for v in vals]).to(s.metrics.dtype)
        s.metrics.index_copy_(0, s.row, row[None])
        s.row.add_(1)

    def _reduced_metrics(self, buf: torch.Tensor, s: _StepState, total, wsse, counts,
                         outs) -> List[torch.Tensor]:
        """Write this rank's sums behind whatever ``buf`` already holds, sum
        ``buf`` over the ranks (the step's one collective; none without a
        process group) and return the metrics row of the whole batch: each
        term's summed SSE over the whole batch's element count (its error's
        per-sample count times the batch; a 0-dim zero term's metric is 0
        whatever its count), the summed total, and the Δt mean as the sum of
        each rank's mean times its share of the rows (times 1.0 on one rank:
        bitwise the mean)."""
        # Δt is equal on every rank of a space group: its share once per group
        share = s.rows / s.batch if self.mesh.space_rank == 0 else 0.0
        sums = [wsse[ph][t] for ph, t in self._terms] + [total, outs["tstep"].mean() * share]
        stats = buf[buf.numel() - len(sums):]
        stats.copy_(torch.stack([v.detach().reshape(()) for v in sums]))
        if self.mesh.group is not None:
            dist.all_reduce(buf, group=self.mesh.group)
        vals = [stats[i] / max(float(counts[ph][t] * s.batch // s.rows), 1.0)
                for i, (ph, t) in enumerate(self._terms)]
        return vals + [stats[-2], stats[-1]]

    def _train_body(self, s: _StepState) -> None:
        x, y = self._gather(s)
        total, wsse, counts, outs = self.loss_fn.weighted_sse(x, y)
        local = self.loss_fn.gradients(total)
        with torch.no_grad():
            torch._foreach_copy_([g for k in self.optimizer_keys for g in self._grad_views[k]],
                                 [g for k in self.optimizer_keys for g in local[k]])
            vals = self._reduced_metrics(self._train_buf, s, total, wsse, counts, outs)
        for key in self.optimizer_keys:
            self.optimizers[key].step(self._grad_views[key])
        self._record(s, vals)

    @torch.no_grad()
    def _eval_body(self, s: _StepState) -> None:
        x, y = self._gather(s)
        self._record(s, self._reduced_metrics(self._eval_buf, s, *self.loss_fn.weighted_sse(x, y)))

    def _run(self, kind: str, s: _StepState) -> None:
        """One step of ``kind`` on the batch that ``s.idx`` names."""
        body = self._train_body if kind == "train" else self._eval_body
        if not self.cuda_graph:
            body(s)
            return
        if s.graph is None and s.warm < self.warmup_steps:
            # one side stream for every warm-up step: the caching allocator
            # keeps a stream's freed blocks for that stream
            if self._side_stream is None:
                self._side_stream = torch.cuda.Stream(self.device)
            stream = self._side_stream
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                body(s)
            torch.cuda.current_stream(self.device).wait_stream(stream)
            s.warm += 1
            return
        if s.graph is None:
            before = {c: getattr(st, c) for c in st.COUNTERS}
            t0 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            # under a process group, the NCCL watchdog thread may query the
            # warm-up steps' events while this thread captures: a capture
            # that forbids only its own thread's unsafe calls lets it
            mode = "thread_local" if self.mesh.group is not None else "global"
            with torch.cuda.graph(graph, pool=self._pool, capture_error_mode=mode):
                body(s)
            self.capture_seconds[kind] += time.perf_counter() - t0
            # the capture launched nothing: take its counts back, add them per replay
            s.counts = {c: getattr(st, c) - before[c] for c in st.COUNTERS}
            for c in st.COUNTERS:
                setattr(st, c, before[c])
            s.graph = graph
        s.graph.replay()
        for c, n in s.counts.items():
            setattr(st, c, getattr(st, c) + n)
        self.replays[kind] += 1
        # a replayed well solve keeps its iteration logs in device buffers
        # (an eager one writes them itself): written here, one
        # synchronisation per replay, only with log_iterations on
        well = self.models.get("well_rate_bhp_model")
        if getattr(well, "log_iterations", False):
            well.flush_iteration_logs()

    def _state(self, kind: str, source: str, x_all, y_all, bs: int, nb: int) -> _StepState:
        """The state of ``kind`` over the dataset ``source``, whose batches
        of ``bs`` rows ``x_all`` holds whole."""
        key = (kind, source, bs)
        if key not in self._states:
            lo, hi = self._block(bs)
            self._states[key] = _StepState(x_all, y_all, bs, hi - lo, nb, len(self.metric_names))
        return self._states[key]

    def _block(self, bs: int):
        """This rank's rows [lo, hi) of a batch of ``bs``, logged once per
        batch size where the split is uneven."""
        if bs % self.mesh.data_size:
            log.warning("a batch of %d rows over %d ranks gives blocks of %s rows: the ranks "
                        "with fewer rows idle part of each step; make the batch a multiple of "
                        "the data-axis size", bs, self.mesh.data_size, self.mesh.block_sizes(bs))
        return self.mesh.block(bs)

    @property
    def _h_axis(self) -> int:
        """H's axis in a batch of samples: (B, 1, H, W[, C]) in 2D,
        (B, 1, D, H, W[, C]) in 3D."""
        return 3 if self.loss_fn.Nz > 1 else 2

    def _own_rows(self, a, lead: int = 0):
        """This rank's rows of H of a batch of samples (features or
        labels; ``lead`` axes before the batch axis), the whole without a
        space axis: the one place where the trainer splits H."""
        ax = self._h_axis + lead
        if self.mesh.space_size <= 1 or a.ndim < ax + 2:
            return a
        lo, hi = self.mesh.rows(a.shape[ax])
        return a[(slice(None),) * ax + (slice(lo, hi),)]

    def _host_metrics(self, s: _StepState, n: int) -> Dict[str, np.ndarray]:
        """The first n rows of the per-step metrics → host arrays, one copy
        (on the CPU too: the next epoch writes the same buffer)."""
        m = s.metrics[:n].to("cpu", copy=True).numpy()
        return {name: m[:, j] for j, name in enumerate(self.metric_names)}

    # -- batches given by the caller ----------------------------------------
    def _direct(self, kind: str, x: torch.Tensor, y) -> Dict[str, torch.Tensor]:
        bs = x.shape[0]
        key = (kind, "_direct", bs)
        s = self._states.get(key)
        lo, hi = self.mesh.block(bs) if s is not None else self._block(bs)
        x = self._own_rows(x[lo:hi])
        y = {k: self._own_rows(v[lo:hi]) for k, v in y.items()}
        if s is None:
            src_x = torch.empty_like(x, device=self.device)
            src_y = {k: torch.empty_like(v, device=self.device) for k, v in y.items()}
            s = self._states[key] = _StepState(src_x, src_y, bs, hi - lo, 1,
                                               len(self.metric_names))
        s.x_all.copy_(x)
        for k, v in y.items():
            s.y_all[k].copy_(v)
        s.row.zero_()
        self._run(kind, s)
        return dict(zip(self.metric_names, s.metrics[0].clone().unbind()))

    def train_step(self, x: torch.Tensor, y) -> Dict[str, torch.Tensor]:
        """One training step on the batch (x, y) (under a mesh the global
        batch, of which this rank takes its block, as ``shard_batch`` lays it
        out): copied into the static buffers, then the step (on the card, a
        graph replay)."""
        return self._direct("train", x, y)

    def eval_step(self, x: torch.Tensor, y) -> Dict[str, torch.Tensor]:
        return self._direct("eval", x, y)

    def _epoch(self, kind: str, x_batches, y_batches) -> Dict[str, np.ndarray]:
        """Every batch of ``(num_batches, B, ...)`` host arrays: this rank's
        block of batch axis 1 (as ``shard_batch`` lays it out) and its rows
        of H copied to the device once, then one step per batch; the
        per-step metrics on the host."""
        bs = np.shape(x_batches)[1]
        lo, hi = self._block(bs)
        xs = self._own_rows(torch.as_tensor(np.asarray(x_batches))[:, lo:hi], lead=1)
        ys = {k: self._own_rows(torch.as_tensor(np.asarray(v))[:, lo:hi], lead=1)
              for k, v in y_batches.items()}
        nb, rows = xs.shape[0], hi - lo
        x = xs.reshape((nb * rows,) + tuple(xs.shape[2:])).to(self.device)
        y = {k: v.reshape((nb * rows,) + tuple(v.shape[2:])).to(self.device)
             for k, v in ys.items()}
        key = (kind, "_epoch", bs, nb)
        s = self._states.get(key)
        if s is None:
            s = self._states[key] = _StepState(x, y, bs, rows, nb, len(self.metric_names))
        else:
            s.x_all.copy_(x)
            for k, v in y.items():
                s.y_all[k].copy_(v)
        positions = torch.arange(nb * rows, device=self.device)
        s.row.zero_()
        for i in range(nb):
            s.idx.copy_(positions[i * rows:(i + 1) * rows])
            self._run(kind, s)
        return self._host_metrics(s, nb)

    def train_epoch(self, x_batches, y_batches) -> Dict[str, np.ndarray]:
        """One training step on each of the ``(num_batches, B, ...)``
        batches, in order (the JAX trainer's host-batched epoch,
        ``trainer.py:255-268``); returns the per-step metrics."""
        return self._epoch("train", x_batches, y_batches)

    def eval_epoch(self, x_batches, y_batches) -> Dict[str, np.ndarray]:
        return self._epoch("eval", x_batches, y_batches)

    # -- device-resident datasets -------------------------------------------
    def stage_dataset(self, name: str, groups, batch_size: int):
        """Collapse (K, T) groups and copy them to the device once (on a
        space axis, this rank's rows of H of them). Returns (num_batches,
        num_samples)."""
        self._states = {k: v for k, v in self._states.items() if k[1] != name}
        if not groups or groups[0][0].shape[0] == 0:
            self._resident[name] = None
            return 0, 0
        x_np, y_np = collapse_groups(groups)
        n = x_np.shape[0]
        if n == 0:
            self._resident[name] = None
            return 0, 0
        if batch_size > n:
            log.warning("stage_dataset[%s]: batch %d > N=%d — clamping the batch to the "
                        "dataset size", name, batch_size, n)
            batch_size = n
        x = torch.from_numpy(np.ascontiguousarray(self._own_rows(x_np))).to(self.device)
        y = {k: torch.from_numpy(np.ascontiguousarray(self._own_rows(v))).to(self.device)
             for k, v in y_np.items()}
        nb = n // batch_size
        if n - nb * batch_size:
            log.info("stage_dataset[%s]: N=%d is not divisible by B=%d — %d samples per "
                     "epoch are dropped (shuffled each epoch for training, fixed for eval)",
                     name, n, batch_size, n - nb * batch_size)
        self._resident[name] = (x, y, nb, batch_size)
        return nb, n

    def train_epoch_resident(self, name: str, steps: Optional[int] = None
                             ) -> Dict[str, np.ndarray]:
        """One epoch (or its first ``steps`` steps) over the staged dataset
        ``name``, in a fresh permutation; the per-step metrics on the host."""
        x, y, nb, bs = self._resident[name]
        s = self._state("train", name, x, y, bs, nb)
        lo, hi = self.mesh.block(bs)
        perm = torch.randperm(x.shape[0], generator=self.generator)[: nb * bs].to(self.device)
        n = nb if steps is None else min(int(steps), nb)
        s.row.zero_()
        for i in range(n):
            s.idx.copy_(perm[i * bs + lo:i * bs + hi])
            self._run("train", s)
        return self._host_metrics(s, n)

    def eval_epoch_resident(self, name: str) -> Dict[str, np.ndarray]:
        x, y, nb, bs = self._resident[name]
        s = self._state("eval", name, x, y, bs, nb)
        lo, hi = self.mesh.block(bs)
        rows = torch.arange(nb * bs, device=self.device)
        s.row.zero_()
        for i in range(nb):
            s.idx.copy_(rows[i * bs + lo:i * bs + hi])
            self._run("eval", s)
        return self._host_metrics(s, nb)

    def release_graphs(self) -> None:
        """Drop every captured graph: the next step of each kind warms up
        and captures anew. Under a process group this comes before the
        group's end, since NCCL does not end a communicator while a graph
        that holds its kernels lives (the end hangs)."""
        for s in self._states.values():
            if s.graph is not None:
                s.graph.reset()
            s.graph, s.warm = None, 0
        if self.cuda_graph:
            torch.cuda.synchronize(self.device)

    # -- weights, in place --------------------------------------------------
    def trained_models(self) -> Dict[str, torch.nn.Module]:
        """The trained models by logical name."""
        return {self.loss_fn.logical_name(k): self.models[self.loss_fn.logical_name(k)]
                for k in self.optimizer_keys}

    def snapshot(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """A host copy of each trained model's parameters, by optimizer key."""
        return {key: {n: p.detach().cpu().clone() for n, p in
                      self.models[self.loss_fn.logical_name(key)].named_parameters()}
                for key in self.optimizer_keys}

    @torch.no_grad()
    def load_snapshot(self, snap: Dict[str, Dict[str, torch.Tensor]]) -> None:
        """Write a :meth:`snapshot` into the live parameters in place (the
        graphs hold their addresses)."""
        for key, params in snap.items():
            live = dict(self.models[self.loss_fn.logical_name(key)].named_parameters())
            for n, v in params.items():
                live[n].copy_(v)


def _select_best(records, loss_min_max, loss_keys) -> tuple:
    """The min–max-normalized summed loss of each watched epoch and the
    index of the least (ref training.py:833-866)."""
    normalized = []
    for record in records:
        tot = 0.0
        for ph in loss_keys:
            for key in loss_keys[ph]:
                v = record["losses"][ph][key]
                mm = loss_min_max[ph][key]
                if mm["max"] > mm["min"]:
                    tot += (v - mm["min"]) / (mm["max"] - mm["min"])
                else:
                    tot += 0.0 if v == mm["min"] else 1.0
        normalized.append(tot)
    return int(np.argmin(normalized)), normalized


def train_combined_models_unified(train_groups, val_groups, loss_fn,
                                  training_batch_size: Optional[int] = None,
                                  testing_batch_size: Optional[int] = None,
                                  epochs: int = 5, callbacks=None, verbose: int = 1,
                                  general_config: Optional[Dict] = None,
                                  log_variables_callback: Optional[Callable] = None,
                                  log_epoch_percentage: float = 0.2, seed: int = 0,
                                  checkpoint_dir: Optional[str] = None,
                                  checkpoint_every: int = 1, resume: bool = False,
                                  optimizer_configs: Optional[Dict[str, Dict]] = None,
                                  mesh: Optional[Mesh] = None):
    """Train for ``epochs``; returns (trainer, history, best_model_variables).

    History layout follows the reference: per-phase per-key train/val
    series, ``epoch_times`` (ms), ``total_train_loss``, ``total_val_loss``
    and ``tstep_mean``, plus ``step_total_loss`` (every step's total
    weighted SSE). An empty split is skipped; a non-finite epoch loss stops
    training. Over the last ``log_epoch_percentage`` of the epochs each
    epoch's parameters are snapshot to the host (``log_variables_callback``
    sees each); at the end the snapshot with the least min–max-normalized
    summed loss is written back into the live parameters and returned as
    ``best_model_variables`` (None without a watched epoch). With
    ``general_config["log_term_grad_norms"]`` each watched epoch also logs
    every loss term's gradient norm per model on the first training batch
    of the staged split (``PhysicsLoss.per_term_grad_norms``). With
    ``checkpoint_dir`` the training state is saved every
    ``checkpoint_every`` epochs and after the restore; ``resume`` continues
    from the latest checkpoint there. Unlike the reference, whose resumed
    run draws its permutations anew from the seed (``trainer.py:306``,
    ``:343``), the trainer's generator is saved and restored, so a resumed
    run trains on the batches an uninterrupted one would.

    ``mesh`` (None: :func:`make_mesh`) trains data-parallel over its
    process group (:class:`Trainer`): rank 0 alone prints, calls
    ``log_variables_callback``, logs the gradient norms and writes the
    checkpoints; every rank returns the same losses and restores the same
    best epoch, since the metrics it selects on are the whole batch's. The
    trainer's graphs are then released (``Trainer.release_graphs``), also
    when an error leaves the loop, so that the group can end."""
    g = general_config or DEFAULT_GENERAL_CONFIG
    training_batch_size = training_batch_size or g["training_batch_size"]
    testing_batch_size = testing_batch_size or g["testing_batch_size"]
    if train_groups:
        validate_loss_keys(train_groups[0][1], loss_fn.loss_keys, g)

    mesh = mesh if mesh is not None else make_mesh()
    lead = mesh.rank == 0
    trainer = Trainer(loss_fn, optimizer_configs=optimizer_configs, seed=seed, mesh=mesh)
    try:
        n_train, _ = trainer.stage_dataset("train", train_groups, training_batch_size)
        n_val, _ = trainer.stage_dataset("val", val_groups, testing_batch_size)
        loss_keys = loss_fn.loss_keys

        def averages(metrics):
            return {ph: {key: float(np.mean(metrics[f"{ph}/{key.rsplit('_', 1)[0]}"]))
                         for key in keys} for ph, keys in loss_keys.items()}

        history = {
            "train": {ph: {key: [] for key in keys} for ph, keys in loss_keys.items()},
            "val": {ph: {key: [] for key in keys} for ph, keys in loss_keys.items()},
            "epoch_times": [], "total_train_loss": [], "total_val_loss": [],
            "tstep_mean": [], "step_total_loss": [],
        }
        model_variables_history: List[Dict] = []
        loss_min_max = {ph: {key: {"min": float("inf"), "max": float("-inf")}
                             for key in keys} for ph, keys in loss_keys.items()}
        log_start_epoch = max(0, int(epochs * (1.0 - log_epoch_percentage)))
        physics = loss_fn.physics_mode_fraction >= 1.0
        t_total = time.time()

        ckpt = None
        start_epoch = 0
        if checkpoint_dir is not None:
            from srm_tpu_torch.utils.checkpoint import CheckpointManager
            ckpt = CheckpointManager(checkpoint_dir, mesh=mesh)
            if resume:
                restored = ckpt.restore(params=trainer.trained_models(),
                                        opt_state=trainer.optimizers, generator=trainer.generator)
                if restored is not None:
                    start_epoch = int(restored[3]) + 1
                    log.info("Resumed from checkpoint at epoch %d", start_epoch)

        for epoch in range(start_epoch, epochs):
            if n_train == 0:
                continue
            t0 = time.time()
            metrics = trainer.train_epoch_resident("train")      # one host copy per epoch
            epoch_ms = (time.time() - t0) * 1000.0
            avg = averages(metrics)
            total_train = sum(sum(v.values()) for v in avg.values())
            history["epoch_times"].append(epoch_ms)
            for ph in loss_keys:
                for key in loss_keys[ph]:
                    history["train"][ph][key].append(avg[ph][key])
            history["total_train_loss"].append(total_train)
            history["tstep_mean"].append(float(np.mean(metrics["tstep_mean"])))
            history["step_total_loss"].extend(float(v) for v in metrics["total"])
            if not np.isfinite(total_train):
                log.error("Non-finite training loss at epoch %d — stopping. "
                          "Check Δt bounds, PVT clamps and input normalization.", epoch + 1)
                break
            if total_train == 0.0 and physics:
                log.warning("All physics losses are zero at epoch %d — the residual "
                            "is likely disconnected from the models.", epoch + 1)
            if verbose and lead:
                print(f"Epoch {epoch + 1}/{epochs} - loss {total_train:.4f} - {epoch_ms:.0f} ms "
                      f"({n_train / max(epoch_ms / 1000.0, 1e-9):.2f} steps/s)")

            # watched-epoch snapshots (ref :708-718)
            if epoch >= log_start_epoch:
                snap = trainer.snapshot()
                if g.get("log_term_grad_norms"):
                    # per-term gradient norms on one fixed batch, eager, outside
                    # the graph (a diagnostic; ref :376-386); under a mesh every
                    # rank computes them on the whole batch (its label statistics
                    # are collectives)
                    x_all, y_all = trainer._resident["train"][:2]
                    norms = loss_fn.per_term_grad_norms(
                        x_all[:training_batch_size],
                        {k: v[:training_batch_size] for k, v in y_all.items()})
                    for term, row in norms.items() if lead else ():
                        log.info("grad-norms epoch %d %s: %s", epoch + 1, term,
                                 {m: f"{v:.3e}" for m, v in row.items()})
                if log_variables_callback is not None and lead:
                    log_variables_callback(epoch, snap, total_train)
                for ph in loss_keys:
                    for key in loss_keys[ph]:
                        mm = loss_min_max[ph][key]
                        mm["min"] = min(mm["min"], avg[ph][key])
                        mm["max"] = max(mm["max"], avg[ph][key])
                model_variables_history.append(
                    {"epoch": epoch + 1, "variables": snap,
                     "losses": {ph: dict(avg[ph]) for ph in loss_keys}})

            if n_val > 0:
                vavg = averages(trainer.eval_epoch_resident("val"))
                for ph in loss_keys:
                    for key in loss_keys[ph]:
                        history["val"][ph][key].append(vavg[ph][key])
                history["total_val_loss"].append(sum(sum(v.values()) for v in vavg.values()))
            if ckpt is not None and ((epoch + 1) % checkpoint_every == 0 or epoch == epochs - 1):
                ckpt.save(epoch, trainer.trained_models(), trainer.optimizers, history=history,
                          rng_state=trainer.generator.get_state())

            for cbk in callbacks or []:
                cbk(epoch)

        # best-epoch selection by min–max-normalized summed losses (ref :833-866)
        best_model_variables = None
        if model_variables_history:
            best, normalized = _select_best(model_variables_history, loss_min_max, loss_keys)
            best_model_variables = model_variables_history[best]["variables"]
            trainer.load_snapshot(best_model_variables)
            log.info("Restored variables from epoch %d (normalized loss %.4f)",
                     model_variables_history[best]["epoch"], normalized[best])
            if ckpt is not None:
                # persist the restored weights: the last periodic save predates the restore
                ckpt.save(epochs, trainer.trained_models(), trainer.optimizers, history=history,
                          rng_state=trainer.generator.get_state())

        if verbose and lead:
            print(f"Total training time: {time.time() - t_total:.2f}s")
        if ckpt is not None:
            ckpt.wait_until_finished()
            ckpt.close()
    finally:
        if mesh.group is not None:
            # the group may end once training has, or once an error leaves
            # it: no graph may hold its kernels then
            trainer.release_graphs()
    return trainer, history, best_model_variables
