"""HardLayer: exact initial-condition enforcement.

Port of ``srm_tpu/nn/hard_layer.py``:

    alpha_t = (t_norm - a) / (b - a)          # normalized-time ramp in [0, 1]
    alpha   = alpha_p * alpha_t ** clip(kernel_exponent, min, max) [* rbf]
    output  = init_value - alpha * act(p_net)

so the output equals ``init_value`` exactly at the normalized start time:
Pi for the pressure model, Sgi for the gas-condensate saturation model,
whose ``act`` is softplus or abs.
``kernel_exponent`` is a trainable per-pixel field of shape
``(*spatial, 1)``, clipped in the forward pass with JAX's bound gradient.
On a mesh's space axis (``forward(..., rows=)``) each rank uses its rows
of it (H, axis -3); the parameter stays whole and replicated, and its
gradient is whole after the trainer's sum over the ranks.

Options (the reference's ``:89-103``):

* the rectifier, for gas condensate above the dew point:
  ``alpha_p = rectifier((rect_input − pdew)/(pmin − pdew))``, only where
  both a ``rectifier`` and a ``rect_input`` are given (else 1);
* the RBF modulation (``use_rbf``): a ``(C_prop, 1)`` ``rbf_kernel``
  (glorot normal, always) normalised to unit length per column, then
  ``alpha *= rbf_activation(prop @ w)``.

``exponent_trainable=False`` is accepted and changes nothing, as in the
reference, whose comment says the optimizer map zeroes the gradient while
no code does (ROADMAP C20): the exponent still trains. The config's
``regularization`` is read by neither package's forward.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from srm_tpu_torch.nn.common import get_activation, init_weight_, safe_pow


class HardLayer(nn.Module):
    def __init__(self, exp_shape: Sequence[int], norm_limits: Tuple[float, float] = (-1.0, 1.0),
                 init_value: float = 1.0, exponent_init: float = 0.5,
                 exponent_min: float = 0.1, exponent_max: float = 0.99,
                 kernel_activation: Any = None, input_activation: Any = None,
                 exponent_trainable: bool = True, use_rbf: bool = False,
                 rbf_activation: Any = "sigmoid", prop_channels: int = 1,
                 rectifier: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                 pdew: Optional[float] = None, pmin: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm_limits = tuple(norm_limits)
        self.init_value = float(init_value)
        self.exponent_min = float(exponent_min)
        self.exponent_max = float(exponent_max)
        self.kernel_activation = get_activation(kernel_activation)
        self.input_activation = get_activation(input_activation)
        self.rectifier = None if rectifier is None else get_activation(rectifier)
        self.pdew, self.pmin = pdew, pmin
        self.kernel_exponent = nn.Parameter(
            torch.full(tuple(exp_shape), float(exponent_init), dtype=torch.float32))
        self.use_rbf = bool(use_rbf)
        self.rbf_activation = get_activation(rbf_activation)
        self.rbf_kernel = None
        if self.use_rbf:
            self.rbf_kernel = nn.Parameter(torch.empty(int(prop_channels), 1))
            init_weight_(self.rbf_kernel, int(prop_channels), 1, "glorot_normal", generator)

    @classmethod
    def from_config(cls, config: Dict[str, Any], exp_shape: Sequence[int],
                    pdew: Optional[float] = None, pmin: Optional[float] = None,
                    prop_channels: int = 1,
                    generator: Optional[torch.Generator] = None) -> "HardLayer":
        ke = config.get("kernel_exponent_config", {}) or {}
        init_v = ke.get("initial_value", 0.5)
        if isinstance(init_v, (tuple, list)):
            init_v = init_v[0]
        return cls(exp_shape, norm_limits=tuple(config.get("norm_limits", (-1.0, 1.0))),
                   init_value=config.get("init_value", 1.0), exponent_init=float(init_v),
                   exponent_min=ke.get("min_value", 0.01), exponent_max=ke.get("max_value", 0.99),
                   exponent_trainable=ke.get("trainable", True),
                   kernel_activation=config.get("kernel_activation"),
                   input_activation=config.get("input_activation"),
                   use_rbf=config.get("use_rbf", False), prop_channels=prop_channels,
                   rectifier=config.get("rectifier"), pdew=pdew, pmin=pmin, generator=generator)

    def forward(self, time: torch.Tensor, prop: torch.Tensor, p_net: torch.Tensor,
                rect_input: Optional[torch.Tensor] = None, rows=None) -> torch.Tensor:
        a, b = self.norm_limits
        k = self.kernel_exponent
        if rows is not None and k.dim() >= 3 and k.shape[-3] == rows.n:
            k = k[..., rows.lo:rows.hi, :, :]
        kexp = torch.minimum(torch.maximum(k, k.new_full((), self.exponent_min)),
                             k.new_full((), self.exponent_max))
        kexp = self.kernel_activation(kexp)
        alpha = safe_pow((time - a) / (b - a), kexp)
        if self.rectifier is not None and rect_input is not None:
            alpha = self.rectifier((rect_input - self.pdew) / (self.pmin - self.pdew)) * alpha
        if self.use_rbf:
            w = self.rbf_kernel
            w = w / (torch.linalg.vector_norm(w, dim=0, keepdim=True) + 1e-12)
            alpha = alpha * self.rbf_activation(prop @ w)
        return self.init_value - alpha * self.input_activation(p_net)
