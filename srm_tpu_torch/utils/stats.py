"""Normalization transforms and the named statistics table.

Port of ``srm_tpu/utils/stats.py``: ``normalize``, ``denormalize``,
``normalize_diff``, :class:`DataSummary` and :func:`compute_statistics`.
The transforms act on tensors with one statistics row
``[min, max, mean, std, count]``; ``is_log`` is a Python bool here, so only
the selected branch is evaluated (the reference evaluates both and selects,
which gives the same values). Non-finite results are replaced with zeros,
as in the reference.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Mapping, Sequence

import numpy as np
import torch

#: column indices into a statistics row
MIN, MAX, MEAN, STD, COUNT = 0, 1, 2, 3, 4


def _scrub(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def normalize(x: torch.Tensor, row: torch.Tensor, *, method: str = "lnk-linear-scaling",
              limits=(-1.0, 1.0), is_log: bool = False) -> torch.Tensor:
    """Normalize ``x`` with one stats row (srm_tpu/utils/stats.py:60-77)."""
    a, b = limits
    lo, hi, mu, sd = row[MIN], row[MAX], row[MEAN], row[STD]
    if method == "z-score":
        out = (x - mu) / sd
    elif method == "lnk-linear-scaling" and is_log:
        out = (torch.log(x / lo) / torch.log(hi / lo)) * (b - a) + a
    else:
        out = ((x - lo) / (hi - lo)) * (b - a) + a
    return _scrub(out)


def denormalize(x: torch.Tensor, row: torch.Tensor, *, method: str = "lnk-linear-scaling",
                limits=(-1.0, 1.0), is_log: bool = False) -> torch.Tensor:
    """Inverse of :func:`normalize` (srm_tpu/utils/stats.py:80-93)."""
    a, b = limits
    lo, hi, mu, sd = row[MIN], row[MAX], row[MEAN], row[STD]
    if method == "z-score":
        out = x * sd + mu
    elif method == "lnk-linear-scaling" and is_log:
        out = torch.exp(torch.log(hi / lo) * ((x - a) / (b - a)) + torch.log(lo))
    else:
        out = (hi - lo) * ((x - a) / (b - a)) + lo
    return _scrub(out)


def normalize_diff(d: torch.Tensor, row: torch.Tensor, *, method: str = "lnk-linear-scaling",
                   limits=(-1.0, 1.0), is_log: bool = False, x0: float = 3.0) -> torch.Tensor:
    """Normalize a difference, e.g. the predicted time step added to the
    normalized time channel (srm_tpu/utils/stats.py:96-112)."""
    a, b = limits
    lo, hi, mu, sd = row[MIN], row[MAX], row[MEAN], row[STD]
    if method == "z-score":
        out = d / sd
    elif method == "lnk-linear-scaling" and is_log:
        out = (b - a) / torch.log(hi / lo) * torch.log((x0 + d) / x0)
    else:
        out = (b - a) / (hi - lo) * d
    return _scrub(out)


class DataSummary:
    """Named statistics table (srm_tpu/utils/stats.py:133).

    Built from dicts of ``row name → {min, max, mean, std[, shape, count]}``
    or from JSON files holding such a dict. Rows whose names contain
    ``perm`` are log rows under ``lnk-linear-scaling``.
    """

    def __init__(self, data_list: Sequence[Any], dtype=np.float32):
        rows: List[List[float]] = []
        names: List[str] = []
        for item in data_list:
            if isinstance(item, str):
                with open(item) as f:
                    item = json.load(f)
            if not isinstance(item, Mapping):
                raise TypeError(f"Unsupported DataSummary input: {type(item)}")
            for name, stats in item.items():
                shape = stats.get("shape")
                count = stats.get("count", float(np.prod(shape)) if shape else 0.0)
                rows.append([stats.get("min", 0.0), stats.get("max", 0.0),
                             stats.get("mean", 0.0), stats.get("std", 0.0), count])
                names.append(str(name).lower())
        self.names = names
        self.table_np = np.asarray(rows, dtype=dtype).reshape(-1, 5)
        self._index = {n: i for i, n in enumerate(names)}
        self.is_log_np = np.array(["perm" in n for n in names], dtype=bool)

    def get_key_index(self, key: str) -> int:
        return self._index[key.lower()]

    def row(self, key: str) -> np.ndarray:
        return self.table_np[self.get_key_index(key)]

    def is_log(self, key: str) -> bool:
        return bool(self.is_log_np[self.get_key_index(key)])


def compute_statistics(features: np.ndarray, keys: Sequence[str]) -> Dict[str, Dict[str, Any]]:
    """Per-channel [min, max, mean, std, shape] of a woven feature tensor
    ``[..., C]`` (srm_tpu/utils/stats.py:296-308)."""
    stats: Dict[str, Dict[str, Any]] = {}
    f = np.asarray(features)
    for i, key in enumerate(keys):
        ch = f[..., i]
        stats[key] = {
            "min": float(ch.min()), "max": float(ch.max()),
            "mean": float(ch.mean()), "std": float(ch.std()),
            "shape": list(ch.shape),
        }
    return stats


def normalize_channels(features: np.ndarray, summary: DataSummary,
                       norm_config: Mapping[str, Any]) -> np.ndarray:
    """Normalize channel ``c`` of a ``[..., C]`` host array with stats row
    ``c`` — the reference's ``DataSummary.normalize`` with the identity
    channel→row map (srm_tpu/utils/stats.py:250-283), in float32 on the host."""
    method = norm_config.get("feature_normalization_method", "lnk-linear-scaling")
    limits = tuple(float(v) for v in norm_config.get("normalization_limits", (-1.0, 1.0)))
    if features.size == 0:           # an empty split (numpy may give it negative strides)
        return np.zeros(features.shape, np.float32)
    x = torch.from_numpy(np.ascontiguousarray(features, dtype=np.float32))
    table = torch.from_numpy(summary.table_np)
    chans = [normalize(x[..., c], table[c], method=method, limits=limits,
                       is_log=bool(summary.is_log_np[c]))
             for c in range(x.shape[-1])]
    return torch.stack(chans, dim=-1).numpy()
