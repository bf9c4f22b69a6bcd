"""HardLayer: exact initial-condition enforcement.

Port of ``srm_tpu/nn/hard_layer.py`` without the RBF modulation and the
rectifier (neither is on a ported path):

    alpha_t = (t_norm - a) / (b - a)          # normalized-time ramp in [0, 1]
    alpha   = alpha_t ** clip(kernel_exponent, min, max)
    output  = init_value - alpha * act(p_net)

so the output equals ``init_value`` exactly at the normalized start time:
Pi for the pressure model, Sgi for the gas-condensate saturation model,
whose ``act`` is softplus or abs.
``kernel_exponent`` is a trainable per-pixel field of shape
``(*spatial, 1)``, clipped in the forward pass with JAX's bound gradient.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch
from torch import nn

from srm_tpu_torch.nn.common import get_activation, safe_pow


class HardLayer(nn.Module):
    def __init__(self, exp_shape: Sequence[int], norm_limits: Tuple[float, float] = (-1.0, 1.0),
                 init_value: float = 1.0, exponent_init: float = 0.5,
                 exponent_min: float = 0.1, exponent_max: float = 0.99,
                 kernel_activation: Any = None, input_activation: Any = None):
        super().__init__()
        self.norm_limits = tuple(norm_limits)
        self.init_value = float(init_value)
        self.exponent_min = float(exponent_min)
        self.exponent_max = float(exponent_max)
        self.kernel_activation = get_activation(kernel_activation)
        self.input_activation = get_activation(input_activation)
        self.kernel_exponent = nn.Parameter(
            torch.full(tuple(exp_shape), float(exponent_init), dtype=torch.float32))

    @classmethod
    def from_config(cls, config: Dict[str, Any], exp_shape: Sequence[int]) -> "HardLayer":
        if config.get("use_rbf") or config.get("rectifier") is not None:
            raise NotImplementedError("the RBF and rectifier HardLayer options are not ported")
        ke = config.get("kernel_exponent_config", {}) or {}
        init_v = ke.get("initial_value", 0.5)
        if isinstance(init_v, (tuple, list)):
            init_v = init_v[0]
        return cls(exp_shape, norm_limits=tuple(config.get("norm_limits", (-1.0, 1.0))),
                   init_value=config.get("init_value", 1.0), exponent_init=float(init_v),
                   exponent_min=ke.get("min_value", 0.01), exponent_max=ke.get("max_value", 0.99),
                   kernel_activation=config.get("kernel_activation"),
                   input_activation=config.get("input_activation"))

    def forward(self, time: torch.Tensor, p_net: torch.Tensor) -> torch.Tensor:
        a, b = self.norm_limits
        k = self.kernel_exponent
        kexp = torch.minimum(torch.maximum(k, k.new_full((), self.exponent_min)),
                             k.new_full((), self.exponent_max))
        kexp = self.kernel_activation(kexp)
        alpha = safe_pow((time - a) / (b - a), kexp)
        return self.init_value - alpha * self.input_activation(p_net)
