"""Feature weaving, positional grids and sequence splitting (host, numpy).

Port of ``srm_tpu/data/weave.py`` (``weave_tensors``,
``create_positional_grids``, ``split_tensor_sequence``,
``align_and_trim_pair_lists``), carried over unchanged: the woven tensor
has channels ``(z, y, x, time, permx)``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def _collapse_runs_of_ones(shape: Sequence[int]) -> Tuple[int, ...]:
    out, prev_one = [], False
    for d in shape:
        if d == 1:
            if not prev_one:
                out.append(1)
            prev_one = True
        else:
            out.append(d)
            prev_one = False
    return tuple(out)


def weave_tensors(tensor_list: Sequence[np.ndarray], target_trailing_shape=None,
                  flip_innermost_index: bool = True, flatten_first_axes: bool = False,
                  merge_consecutive_singleton_dims: bool = True) -> np.ndarray:
    """Weave N tensors ``(N_i, *tail_i)`` into ``(N_1..N_d, *trailing, d)``.

    Leading axes are placed on distinct new axes and broadcast against each
    other (an outer product over leading sizes); trailing dims broadcast to
    ``target_trailing_shape``. With ``flip_innermost_index`` the list
    [permx, time, x, y, z] gives channels [z, y, x, time, permx].
    """
    d = len(tensor_list)
    if d == 0:
        raise ValueError("tensor_list must contain at least one tensor.")
    if target_trailing_shape is None:
        target_trailing_shape = tensor_list[0].shape[1:]
    target_trailing_shape = tuple(target_trailing_shape)
    leading = [t.shape[0] for t in tensor_list]

    processed = []
    for i, t in enumerate(tensor_list):
        t = np.asarray(t)
        tail = t.shape[1:]
        if len(tail) < len(target_trailing_shape):
            tail = (1,) * (len(target_trailing_shape) - len(tail)) + tail
            t = t.reshape((t.shape[0],) + tail)
        for j, (s, tgt) in enumerate(zip(tail, target_trailing_shape)):
            if s not in (tgt, 1):
                raise ValueError(f"Tensor {i} trailing dim {j} ({s}) cannot broadcast to {tgt}.")
        new_shape = (1,) * i + (leading[i],) + (1,) * (d - i - 1) + tail
        t = t.reshape(new_shape)
        full = tuple(leading) + target_trailing_shape
        processed.append(np.broadcast_to(t, full))

    woven = np.stack(processed, axis=-1)
    if flatten_first_axes:
        woven = woven.reshape((int(np.prod(leading)),) + woven.shape[d:])
    if merge_consecutive_singleton_dims:
        woven = woven.reshape(_collapse_runs_of_ones(woven.shape))
    if flip_innermost_index:
        woven = woven[..., ::-1]
    return np.ascontiguousarray(woven)


def create_positional_grids(D: Sequence[float], N: Sequence[int], indexing="ij",
                            transpose_order=None) -> List[np.ndarray]:
    """Cell-midpoint coordinate grids for lengths ``D`` and counts ``N``."""
    axes = [(np.arange(n, dtype=np.float32) + 0.5) * (dd / n) for dd, n in zip(D, N)]
    grids = np.meshgrid(*axes, indexing=indexing)
    if transpose_order is not None:
        grids = [np.transpose(g, transpose_order) for g in grids]
    return grids


def sequential_split_indices(n: int, ratios: Sequence[float]) -> List[Tuple[int, int]]:
    ends = [int(n * sum(ratios[: i + 1])) for i in range(len(ratios))]
    starts = [0] + ends[:-1]
    ends[-1] = max(ends[-1], n) if abs(sum(ratios) - 1.0) < 1e-6 else ends[-1]
    return list(zip(starts, ends))


def split_tensor_sequence(tensors, split_ratio: Dict[int, Sequence[float]],
                          split_axis: Sequence[int]):
    """Sequentially slice each tensor (or dict of tensors) along the given
    axes with per-axis (train, val, test) ratios; returns (train, val, test)
    lists mirroring the input list."""
    def slice_one(arr):
        per_split = []
        for si in range(3):
            out = np.asarray(arr)
            for ax in split_axis:
                if ax >= out.ndim:
                    continue
                s, e = sequential_split_indices(np.shape(arr)[ax], split_ratio[ax])[si]
                sl = [slice(None)] * out.ndim
                sl[ax] = slice(s, e)
                out = out[tuple(sl)]
            per_split.append(out)
        return per_split

    results: Tuple[list, list, list] = ([], [], [])
    for t in tensors:
        if isinstance(t, dict):
            parts = {k: slice_one(v) for k, v in t.items()}
            for si in range(3):
                results[si].append({k: v[si] for k, v in parts.items()})
        else:
            for si, part in enumerate(slice_one(t)):
                results[si].append(part)
    return results


def align_and_trim_pair_lists(a, b, dims=(0, 1), trim_target: str = "b"):
    """Trim ``a`` and ``b`` (arrays, dicts of arrays or lists of either) so
    that their given leading dims match (srm_tpu/data/weave.py:153)."""
    def leading(x):
        if isinstance(x, dict):
            x = next(iter(x.values()))
        return [np.shape(x)[d] for d in dims]

    def trim(x, sizes):
        def t_one(arr):
            sl = [slice(None)] * np.ndim(arr)
            for d, s in zip(dims, sizes):
                if d < np.ndim(arr):
                    sl[d] = slice(0, s)
            return np.asarray(arr)[tuple(sl)]
        if isinstance(x, dict):
            return {k: t_one(v) for k, v in x.items()}
        if isinstance(x, list):
            return [trim(v, sizes) for v in x]
        return t_one(x)

    la = leading(a[0] if isinstance(a, list) else a)
    lb = leading(b[0] if isinstance(b, list) else b)
    target = [min(x, y) for x, y in zip(la, lb)]
    if trim_target in ("a", "both"):
        a = trim(a, target)
    if trim_target in ("b", "both"):
        b = trim(b, target)
    if trim_target == "b" and la != target:
        a = trim(a, target)
    if trim_target == "a" and lb != target:
        b = trim(b, target)
    return a, b
