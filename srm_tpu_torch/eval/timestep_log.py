"""Adaptive-time-step diagnostics.

Port of ``srm_tpu/eval/timestep_log.py``: :class:`TimestepRecorder` records
the predicted PDE time step (``outputs['tstep']``, a tensor on any device or
an array) per training step, :func:`parse_timestep_log` extracts the
``values: "..."`` rows of a ``tensor_log.txt``-style dump, and
:func:`plot_timesteps` boxplots the per-step Δt distributions over either.
matplotlib is imported only when a plot is drawn.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

import numpy as np
import torch

_VALUES_RE = re.compile(r'values:\s*"([^"]*)"')
_NUM_RE = re.compile(r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?")


class TimestepRecorder:
    """Accumulates per-step batch time-step statistics during training."""

    def __init__(self):
        self.steps: List[int] = []
        self.means: List[float] = []
        self.mins: List[float] = []
        self.maxs: List[float] = []

    def record(self, step: int, tstep_batch) -> None:
        if isinstance(tstep_batch, torch.Tensor):
            tstep_batch = tstep_batch.detach().cpu().numpy()
        arr = np.asarray(tstep_batch).reshape(-1)
        self.steps.append(step)
        self.means.append(float(arr.mean()))
        self.mins.append(float(arr.min()))
        self.maxs.append(float(arr.max()))

    def summary(self) -> Dict[str, float]:
        m = np.asarray(self.means)
        return {"min": float(m.min()), "mean": float(m.mean()), "max": float(m.max()),
                "steps": len(self.steps)}


def parse_timestep_log(path: str) -> List[np.ndarray]:
    """Extract the per-step value arrays from a tensor_log.txt-style dump."""
    rows: List[np.ndarray] = []
    with open(path) as f:
        for line in f:
            m = _VALUES_RE.search(line)
            if m:
                nums = [float(x) for x in _NUM_RE.findall(m.group(1))]
                if nums:
                    rows.append(np.asarray(nums))
    return rows


def plot_timesteps(source, save_path: Optional[str] = None, window: int = 10):
    """Boxplot of per-step Δt distributions + moving-average overlay.

    ``source`` is a TimestepRecorder, a list of arrays, or a log-file path.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if isinstance(source, TimestepRecorder):
        series = [np.asarray([m]) for m in source.means]
    elif isinstance(source, str):
        series = parse_timestep_log(source)
    else:
        series = [np.asarray(s).reshape(-1) for s in source]
    if not series:
        raise ValueError("no time-step data to plot")

    means = np.asarray([s.mean() for s in series])
    mov = np.convolve(means, np.ones(min(window, len(means))) / min(window, len(means)),
                      mode="valid")

    fig, ax = plt.subplots(figsize=(10, 4))
    step_stride = max(1, len(series) // 50)
    ax.boxplot(series[::step_stride], positions=range(0, len(series), step_stride),
               widths=step_stride * 0.6, manage_ticks=False, showfliers=False)
    ax.plot(means, lw=0.8, alpha=0.6, label="per-step mean")
    ax.plot(range(len(means) - len(mov), len(means)), mov, lw=2.0,
            label=f"moving avg ({window})")
    ax.set_xlabel("training step")
    ax.set_ylabel("PDE time step (days)")
    ax.set_title(f"adaptive Δt — min {means.min():.3f} / mean {means.mean():.3f} / "
                 f"max {means.max():.3f}")
    ax.legend()
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return fig
