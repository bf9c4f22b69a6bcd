"""Small numeric helpers.

Port of ``srm_tpu/utils/numerics.py`` on tensors:

* :func:`finite_difference_derivative` — the finite-difference derivative
  of a callable, non-finite entries replaced by zeros. The PVT
  differentiates analytically, so no training path needs it; it checks
  analytic derivatives.
* :func:`l1_normalize_excluding_index` — L1-normalize along one axis while
  one index keeps its values.
"""

from __future__ import annotations

from typing import Callable

import torch


def _stack(out) -> torch.Tensor:
    if isinstance(out, (tuple, list)):
        return torch.stack([torch.as_tensor(o) for o in out], dim=0)
    return torch.as_tensor(out)


def finite_difference_derivative(x: torch.Tensor, func: Callable,
                                 diff_type: str = "central_difference",
                                 grid_spacing: float = 0.01) -> torch.Tensor:
    """Finite-difference derivative of ``func`` at ``x``: central, or
    forward for any other ``diff_type``. ``func`` may return a tensor or a
    sequence of tensors, stacked on a new leading axis; non-finite entries
    become zeros."""
    if diff_type == "central_difference":
        d = (_stack(func(x + grid_spacing)) - _stack(func(x - grid_spacing))) \
            / (2.0 * grid_spacing)
    else:
        d = (_stack(func(x + grid_spacing)) - _stack(func(x))) / grid_spacing
    return torch.where(torch.isfinite(d), d, torch.zeros_like(d))


def l1_normalize_excluding_index(tensor, axis: int, exclude_index: int) -> torch.Tensor:
    """``tensor`` L1-normalized along ``axis`` over every index but
    ``exclude_index``, which keeps its values and adds nothing to the norm;
    a zero norm gives zeros."""
    tensor = torch.as_tensor(tensor)
    axis = axis % tensor.dim()
    n = tensor.shape[axis]
    shape = [1] * tensor.dim()
    shape[axis] = n
    mask = (torch.arange(n, device=tensor.device) != exclude_index).reshape(shape)
    masked = torch.where(mask, tensor, torch.zeros_like(tensor))
    norms = masked.abs().sum(dim=axis, keepdim=True)
    safe = torch.where(norms > 0, norms, torch.ones_like(norms))
    normalized = torch.where(norms > 0, masked / safe, torch.zeros_like(masked))
    return torch.where(mask, normalized, tensor)
