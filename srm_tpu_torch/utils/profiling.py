"""Tracing and profiling utilities.

Port of ``srm_tpu/utils/profiling.py``:

* :func:`trace` — a context manager around ``torch.profiler.profile`` that
  writes a Chrome/TensorBoard trace of the enclosed work into a directory
  (the JAX package's wraps ``jax.profiler``);
* :class:`EpochTimer` — wall-clock and steps/s bookkeeping, with the JAX
  class's API and ``summary()`` keys;
* :func:`log_tensor_to_file` — the well solver's iteration-history logs, in
  the JAX package's file format: a ``# name, shape [...]`` header, one
  ``iter i values: "..."`` row per iteration (the first ``values_per_line``
  values, only the non-zero ones when ``well_specific``) and a ``final
  values:`` row. The JAX package calls it from inside ``jit`` through
  ``jax.debug.callback``; the port calls it on host arrays after the step
  that computed them (``physics/well_solver.py``).
"""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import time
import uuid
from typing import Iterator, List, Optional

import numpy as np

log = logging.getLogger(__name__)

#: where the logs go unless the caller names a directory
DEFAULT_LOG_DIR = os.path.join(tempfile.gettempdir(), "srm_tpu_logs")
#: where traces go unless the caller names a directory
DEFAULT_TRACE_DIR = os.path.join(tempfile.gettempdir(), "srm_tpu_trace")


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, device: str = "cuda") -> Iterator[str]:
    """Profile the enclosed work with ``torch.profiler`` (host and CUDA
    activities; the host only with ``device="cpu"``) and write its trace to
    ``log_dir/trace_<pid>_<id>.json``, which Chrome's tracing view, Perfetto
    and TensorBoard's profiler read. Yields ``log_dir``. On ``"cuda"``
    without a usable CUDA device it raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError('no usable CUDA device to trace; pass device="cpu" to trace the '
                           "host only")
    log_dir = log_dir or DEFAULT_TRACE_DIR
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        yield log_dir
        if cuda:
            torch.cuda.synchronize()
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{uuid.uuid4().hex[:8]}.json")
    prof.export_chrome_trace(path)
    log.info("Profiler trace written to %s", path)


class EpochTimer:
    """Per-epoch wall-clock and throughput accounting (ms, as the
    reference's ``history['epoch_times']``). The caller synchronises the
    device before ``stop`` where the epoch's work is asynchronous."""

    def __init__(self):
        self.epoch_times_ms: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, steps: int = 0) -> float:
        ms = (time.perf_counter() - self._t0) * 1000.0
        self.epoch_times_ms.append(ms)
        if steps:
            log.info("epoch: %.0f ms (%.2f steps/s)", ms, steps / (ms / 1000.0))
        return ms

    def summary(self) -> dict:
        arr = np.asarray(self.epoch_times_ms)
        return {"count": len(arr), "mean_ms": float(arr.mean()) if arr.size else 0.0,
                "total_s": float(arr.sum() / 1000.0)}


def log_tensor_to_file(tensor, it_final=None, final_tensor=None,
                       tensor_name: str = "tensor", file_prefix: str = "tensor_log",
                       values_per_line: int = 10, directory: Optional[str] = None,
                       well_specific: bool = False) -> str:
    """Write an iteration-history array (iterations first) to a uniquely
    named text file in ``directory``; returns its path. ``it_final`` is
    accepted for the JAX package's signature and not written, as there."""
    directory = directory or DEFAULT_LOG_DIR
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{file_prefix}_{uuid.uuid4().hex[:8]}.txt")
    arr = np.asarray(tensor)
    with open(path, "w") as f:
        f.write(f"# {tensor_name}, shape {list(arr.shape)}\n")
        it_rows = arr.reshape(arr.shape[0], -1) if arr.ndim > 1 else arr.reshape(1, -1)
        for i, row in enumerate(it_rows):
            nz = row[np.nonzero(row)] if well_specific else row
            vals = " ".join(f"{v:.6g}" for v in nz[:values_per_line])
            f.write(f'iter {i} values: "{vals}"\n')
        if final_tensor is not None:
            fin = np.asarray(final_tensor).reshape(-1)
            fin = fin[np.nonzero(fin)] if well_specific else fin
            f.write(f'final values: "{" ".join(f"{v:.6g}" for v in fin[:values_per_line])}"\n')
    log.debug("tensor log written: %s", path)
    return path
