"""Shared network utilities: activations, initialization, time folding.

Port of ``srm_tpu/nn/common.py``. flax's ``swish`` is SiLU. The
initializer is flax's ``glorot_normal`` (variance scaling over fan_avg with
a normal truncated at ±2σ), drawn from an explicit ``torch.Generator``; it
matches the reference in distribution only, since the random streams differ.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

_ACTIVATIONS = {
    "swish": F.silu, "silu": F.silu, "relu": F.relu, "tanh": torch.tanh,
    "sigmoid": torch.sigmoid, "softplus": F.softplus, "abs": torch.abs,
}


def get_activation(act: Union[None, str, Callable]) -> Callable[[torch.Tensor], torch.Tensor]:
    if act is None or act == "" or act == "linear":
        return lambda x: x
    if callable(act):
        return act
    if act.lower() not in _ACTIVATIONS:
        raise ValueError(f"Unknown activation: {act}")
    return _ACTIVATIONS[act.lower()]


def scaled_tanh_lisht(x: torch.Tensor, min_val: float = 0.1, max_val: float = 10.0,
                      steepness: float = 1.0) -> torch.Tensor:
    """x·tanh(x) squashed into (min_val, max_val] — the adaptive time-step
    output activation."""
    lisht = x * torch.tanh(x)
    return (max_val - min_val) * torch.tanh(steepness * lisht) + min_val


def fold_time(x: torch.Tensor):
    """(B, T, *S, C) → (B*T, *S, C); returns (folded, unfold)."""
    B, T = x.shape[0], x.shape[1]
    folded = x.reshape((B * T,) + tuple(x.shape[2:]))
    return folded, (lambda y: y.reshape((B, T) + tuple(y.shape[1:])))


def network_width_list(depth: int, width: int, ngens: int, growth_rate: float = 0.5) -> list:
    """Per-level filter counts: geometric growth rounded up to even
    (the reference's ``network_type='plain'``)."""
    ngens = ngens or 1
    per_gen, rem = depth // ngens, depth % ngens
    out: list = []
    for i in range(ngens):
        out += [growth_rate**i] * (per_gen + (rem if i == ngens - 1 else 0))
    return [int(np.ceil(width * x / 2.0) * 2) for x in out]


def safe_pow(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """x**e with a zero (not NaN) gradient where x <= 0.

    At t0 the HardLayer's time ramp is exactly 0 and the exponent is below
    1, where the gradient of ``torch.pow`` is infinite; the guard keeps it
    at zero, as in the reference."""
    pos = x > 0
    log_x = torch.where(pos, torch.log(torch.maximum(x, x.new_full((), 1e-30))),
                        torch.zeros_like(x))
    return torch.where(pos, torch.exp(e * log_x), torch.zeros_like(x * e))


def glorot_normal_(weight: torch.Tensor, fan_in: int, fan_out: int,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax ``glorot_normal``: truncated normal with variance 2/(fan_in+fan_out)."""
    # 0.8796… is the std of a unit normal truncated to [-2, 2]
    std = np.sqrt(2.0 / (fan_in + fan_out)) / 0.87962566103423978
    with torch.no_grad():
        return torch.nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                           generator=generator)


def init_conv_(conv: torch.nn.Module, generator: Optional[torch.Generator] = None):
    """Glorot-normal weights and zero bias for a 2D or 3D convolution or
    transposed convolution, with flax's fans: (receptive field)·in and
    (receptive field)·out."""
    w = conv.weight
    rf = int(np.prod(w.shape[2:]))
    transposed = isinstance(conv, (torch.nn.ConvTranspose2d, torch.nn.ConvTranspose3d))
    c_in, c_out = (w.shape[0], w.shape[1]) if transposed else (w.shape[1], w.shape[0])
    glorot_normal_(w, rf * c_in, rf * c_out, generator)
    if conv.bias is not None:
        with torch.no_grad():
            conv.bias.zero_()
