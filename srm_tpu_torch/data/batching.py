"""Collapse of the (realization × time) sample axes.

Port of ``collapse_axes_fortran`` (``srm_tpu/data/batching.py:29``) plus
:func:`collapse_groups`, the part of the reference ``BatchGenerator`` that
the trainer's resident dataset uses: every (features, labels) group has its
(K, T) axes collapsed first-axis-fastest and the groups are concatenated.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def collapse_axes_fortran(arr: np.ndarray, axes: Sequence[int] = (0, 1),
                          order: str = "F") -> np.ndarray:
    """Collapse ``axes`` into one leading axis; ``order='F'`` is
    first-axis-fastest, ``'C'`` last-axis-fastest."""
    if not axes:
        return arr
    axes = sorted(a if a >= 0 else arr.ndim + a for a in axes)
    other = [i for i in range(arr.ndim) if i not in axes]
    perm = other + list(axes)
    moved = np.transpose(arr, perm)
    new_shape = [arr.shape[i] for i in other] + [int(np.prod([arr.shape[a] for a in axes]))]
    flat = np.reshape(moved, new_shape, order=order)
    return np.moveaxis(flat, -1, axes[0])


def collapse_groups(groups: List[Tuple[np.ndarray, Dict[str, np.ndarray]]]
                    ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """(features, label dict) groups → one ``(N, ...)`` feature array and a
    dict of ``(N, ...)`` label arrays, in the reference's sample order."""
    x = np.concatenate([collapse_axes_fortran(np.asarray(f)) for f, _ in groups], axis=0)
    keys = list(groups[0][1].keys())
    y = {k: np.concatenate([collapse_axes_fortran(np.asarray(lab[k])) for _, lab in groups],
                           axis=0)
         for k in keys}
    return x, y
