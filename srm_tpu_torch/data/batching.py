"""Collapse of the (realization × time) sample axes, and the host batcher.

Port of ``srm_tpu/data/batching.py``: ``collapse_axes_fortran`` (``:29``),
``lhs_shuffle_indices`` (``:45-51``) and :class:`BatchGenerator`
(``:54-130``), plus :func:`collapse_groups`, the part of the batcher that
the trainer's resident dataset uses: every (features, labels) group has its
(K, T) axes collapsed first-axis-fastest and the groups are concatenated.
The batcher is host numpy, as the JAX package's: the same groups, batch
size and seed give the same batches bit for bit (its ``RandomState``
shuffles and the ``default_rng`` strata of the LHS shuffle are the same
draws); the trainer's resident epochs do not use it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

Labels = Union[np.ndarray, Dict[str, np.ndarray]]


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


def lhs_shuffle_indices(n: int, seed: int = 42) -> np.ndarray:
    """Latin-hypercube stratified shuffle: one index drawn in each of ``n``
    unit strata, then shuffled (``default_rng(seed)``)."""
    rng = np.random.default_rng(seed)
    bins = np.linspace(0, n, n + 1, dtype=int)
    idx = np.array([rng.integers(bins[i], bins[i + 1]) for i in range(n)], dtype=int)
    rng.shuffle(idx)
    return idx


class BatchGenerator:
    """Host batcher over a list of (features, labels) groups: their
    ``collapse_axes`` collapsed in ``collapse_order`` and concatenated,
    batches of ``batch_size`` in the order of ``indices`` (the samples in
    order, or :func:`lhs_shuffle_indices`' with ``lhs_shuffle``; shuffled
    by ``RandomState(seed)`` with ``shuffle``, and again at every
    :meth:`on_epoch_end`); the last short batch dropped with
    ``drop_remainder``; dict labels stacked on a new leading axis with
    ``stack_labels``."""

    def __init__(self, pairs: List[Tuple[np.ndarray, Labels]], batch_size: int,
                 collapse_axes: Optional[Sequence[int]] = (0, 1), shuffle: bool = True,
                 stack_labels: bool = False, drop_remainder: bool = True,
                 seed: int = 0, lhs_shuffle: bool = False, collapse_order: str = "F"):
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.stack_labels = stack_labels
        self.drop_remainder = drop_remainder
        self._rng = np.random.RandomState(seed)
        if not isinstance(pairs, list):
            raise ValueError("pairs must be a list of (features, labels) tuples")
        if not pairs:
            self.x_all = np.zeros((0,), np.float32)
            self.y_all: Labels = np.zeros((0,), np.float32)
            self.is_dict = False
            self.label_keys: List[str] = []
            self.N = 0
            self.indices = np.zeros((0,), int)
            return
        if collapse_order not in ("F", "C"):
            raise ValueError(f"collapse_order must be 'F' or 'C', got {collapse_order!r}")
        cax = list(collapse_axes) if collapse_axes else []

        def flat(a):
            a = np.asarray(a)
            return collapse_axes_fortran(a, cax, collapse_order) if cax else a

        self.is_dict = isinstance(pairs[0][1], dict)
        self.x_all = np.concatenate([flat(f) for f, _ in pairs], axis=0)
        if self.is_dict:
            self.label_keys = list(pairs[0][1].keys())
            self.y_all = {k: np.concatenate([flat(lab[k]) for _, lab in pairs], axis=0)
                          for k in self.label_keys}
        else:
            self.label_keys = []
            self.y_all = np.concatenate([flat(lab) for _, lab in pairs], axis=0)
        self.N = self.x_all.shape[0]
        self.indices = lhs_shuffle_indices(self.N) if lhs_shuffle else np.arange(self.N)
        if self.shuffle:
            self._rng.shuffle(self.indices)

    def __len__(self) -> int:
        if self.N == 0:
            return 0
        if self.drop_remainder:
            return self.N // self.batch_size
        return -(-self.N // self.batch_size)

    def _labels(self, take):
        if not self.is_dict:
            return self.y_all[take]
        y = {k: self.y_all[k][take] for k in self.label_keys}
        return np.stack([y[k] for k in self.label_keys], axis=0) if self.stack_labels else y

    def __getitem__(self, idx: int):
        take = self.indices[idx * self.batch_size: (idx + 1) * self.batch_size]
        return self.x_all[take], self._labels(take)

    def on_epoch_end(self) -> None:
        if self.shuffle and self.N > 0:
            self._rng.shuffle(self.indices)

    def epoch_batches(self):
        """All of this epoch's batches as one ``(num_batches, B, ...)``
        gather; without ``drop_remainder`` a short last batch cannot be laid
        out so, and the reshape raises, as in the JAX package."""
        nb = len(self)
        take = self.indices[: nb * self.batch_size].reshape(nb, self.batch_size)
        return self.x_all[take], self._labels(take)
