"""Well data: dense per-well arrays, grid scatter and shut-in masks.

Port of ``srm_tpu/physics/wells.py``: :class:`WellDataProcessor` (the well
list as dense numpy arrays), :func:`scatter_to_grid` (host numpy) and
:func:`conn_shutins_mask` (tensor).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

CONTROL_MODES = ("ORAT", "GRAT", "WRAT", "BHP", "LRAT")


class WellDataProcessor:
    """Well list → dense arrays (srm_tpu/physics/wells.py:29-82)."""

    def __init__(self, well_list: List[Dict[str, Any]], mode_order=("k", "j", "i"),
                 control_modes: Sequence[str] = CONTROL_MODES, dtype=np.float32):
        self.mode_keys = [m.upper() for m in control_modes]
        self.bhp_idx = self.mode_keys.index("BHP") if "BHP" in self.mode_keys else None
        self.perm = [{"i": 0, "j": 1, "k": 2}[d] for d in mode_order]
        self.dtype = dtype
        self.well_list = [dict(w) for w in well_list]

    def get_well_data(self) -> Dict[str, Any]:
        """Signed control values (producers +, injectors −, BHP always +)."""
        coords = np.array([[w["i"], w["j"], w["k"]] for w in self.well_list], np.int32)
        ctrl, signs, rw, cr, bhp, shut = [], [], [], [], [], []
        max_windows = max(len(w.get("shutin_days") or [[0.0, 0.0]]) for w in self.well_list)
        for w in self.well_list:
            mode = str(w.get("control", "")).upper()
            val = float(w.get("value", 0.0))
            ctrl.append([val if m == mode else 0.0 for m in self.mode_keys])
            signs.append(1.0 if str(w.get("type", "")).lower() == "producer" else -1.0)
            rw.append(float(w.get("wellbore_radius", 0.0)))
            cr.append(float(w.get("completion_ratio", 0.0)))
            bhp.append(float(w.get("minimum_bhp", 0.0)))
            wins = [[float(a), float(b)] for a, b in (w.get("shutin_days") or [[0.0, 0.0]])]
            wins += [[1.0, 0.0]] * (max_windows - len(wins))   # never-true windows
            shut.append(wins)
        control = np.asarray(ctrl, self.dtype)
        signed = control * np.asarray(signs, self.dtype)[:, None]
        if self.bhp_idx is not None:
            signed[:, self.bhp_idx] = np.abs(control[:, self.bhp_idx])
        return {
            "connection_index": coords[:, self.perm],           # (N, 3) in (k, j, i)
            "control_mode_value": signed.sum(axis=1).astype(self.dtype),
            "names": [w.get("name", "") for w in self.well_list],
            "wellbore_radius": np.asarray(rw, self.dtype),
            "completion_ratio": np.asarray(cr, self.dtype),
            "minimum_bhp": np.asarray(bhp, self.dtype),
            "shutin_days": np.asarray(shut, self.dtype),        # (N, S, 2)
        }


def scatter_to_grid(target_shape: Sequence[int], index_list, y, start_dim: int = 1) -> np.ndarray:
    """zeros(target_shape) with ``y[n]`` at each well's index triplet, which
    addresses dims ``[start_dim, start_dim + len(triplet))``."""
    idx = np.asarray(index_list, np.int64)
    yv = np.asarray(y, np.float32).reshape(-1)
    if yv.size == 1:
        yv = np.full((idx.shape[0],), yv[0], np.float32)
    grid = np.zeros(tuple(int(s) for s in target_shape), np.float32)
    for n in range(idx.shape[0]):
        sl = ((slice(None),) * start_dim + tuple(int(i) for i in idx[n])
              + (slice(None),) * (grid.ndim - start_dim - idx.shape[1]))
        grid[sl] = yv[n]
    return grid


def conn_shutins_mask(time_tensor: torch.Tensor, index_list, range_conditions,
                      time_axis: int = 0) -> torch.Tensor:
    """Open/shut mask over the grid for every sample
    (srm_tpu/physics/wells.py:134-179): non-well cells are 0; a well cell is
    1 unless its time falls in one of its [start, stop] shut-in windows
    (windows with start > stop never fire)."""
    t = time_tensor
    idx = np.asarray(index_list, np.int64)                   # (N, 3) in (k, j, i)
    windows = torch.as_tensor(range_conditions, dtype=t.dtype, device=t.device)  # (N, S, 2)
    nd = t.ndim
    s0 = time_axis + 1

    def cell(n):
        sl = [slice(None)] * nd
        for d in range(3):
            if s0 + d < nd:
                sl[s0 + d] = int(idx[n, d])
        return sl

    gathered = []
    for n in range(idx.shape[0]):
        sl = cell(n)
        for d in range(s0 + 3, nd):
            sl[d] = 0
        gathered.append(t[tuple(sl)])
    tw = torch.stack(gathered, dim=-1)                       # (*outer, N)
    inside = (tw[..., None] >= windows[:, :, 0]) & (tw[..., None] <= windows[:, :, 1])
    open_flag = torch.logical_not(torch.any(inside, dim=-1)).to(t.dtype)

    out = torch.zeros_like(t)
    extra = max(nd - (s0 + 3), 0)
    for n in range(idx.shape[0]):
        sl = tuple(cell(n))
        val = open_flag[..., n].reshape(open_flag.shape[:-1] + (1,) * extra)
        out[sl] = val.expand_as(out[sl])
    return out
