"""Shared network utilities: activations, initialization, time folding,
per-layer compute dtypes.

Port of ``srm_tpu/nn/common.py``. flax's ``swish`` is SiLU. The
initializers are ``get_initializer``'s table (the reference's ``:36-46``):
flax's variance-scaling ``glorot_normal``, ``glorot_uniform``,
``he_normal`` and ``he_uniform`` (a normal truncated at ±2σ, or a uniform),
``None`` giving glorot uniform and any other name glorot normal, plus
``lecun_normal``, flax's default for a ``Dense`` given no initializer. Each
is drawn from an explicit ``torch.Generator``: it matches the reference in
distribution only, since the random streams differ.

:func:`apply_layer` runs a convolution under flax's rule for a layer's
``dtype`` (the reference's ``compute_dtype``): parameters stay float32 and
each layer casts what it computes with, which ``torch.autocast``'s per-op
policy does not reproduce.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from srm_tpu_torch.parallel.halo import conv_windows, take_rows

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


def resolve_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """The torch dtype named by a config's ``compute_dtype`` ("bfloat16",
    "float16", ...), or None for none."""
    if not name:
        return None
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"compute_dtype {name!r} is not a floating-point dtype")
    return dtype


def apply_layer(layer: torch.nn.Module, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None, padding=None) -> torch.Tensor:
    """A 2D or 3D (transposed) convolution, or a ``Linear`` (flax's
    ``Dense``) on the channel axis 1 of ``x``, under flax's per-layer dtype rule:
    with ``dtype`` its input, kernel and bias are cast to ``dtype`` and so is
    its result; with None it computes in the promoted type of its input and
    its parameters (float32 for float32 parameters, whatever the input).
    The parameters themselves stay as they are, so their gradients keep
    their dtype. ``padding`` (a convolution's, per axis) replaces the
    layer's own."""
    dt = dtype if dtype is not None else torch.promote_types(x.dtype, layer.weight.dtype)
    w = layer.weight.to(dt)
    b = layer.bias.to(dt) if layer.bias is not None else None
    x = x.to(dt)
    if isinstance(layer, torch.nn.Linear):
        return F.linear(x.movedim(1, -1), w, b).movedim(-1, 1)
    if isinstance(layer, torch.nn.ConvTranspose2d):
        return F.conv_transpose2d(x, w, b, layer.stride, layer.padding, layer.output_padding,
                                  layer.groups, layer.dilation)
    if isinstance(layer, torch.nn.ConvTranspose3d):
        return F.conv_transpose3d(x, w, b, layer.stride, layer.padding, layer.output_padding,
                                  layer.groups, layer.dilation)
    if padding is not None:
        conv = F.conv2d if isinstance(layer, torch.nn.Conv2d) else F.conv3d
        return conv(x, w, b, layer.stride, padding, layer.dilation, layer.groups)
    return layer._conv_forward(x, w, b)


def conv_rows(layer: torch.nn.Module, x: torch.Tensor, rows, out, dtype=None,
              pad_lo: Optional[int] = None) -> torch.Tensor:
    """``layer`` (a convolution, or a ``Linear``) on a space axis: this
    rank's block of the output layout ``out`` (``parallel/halo.py``'s
    :class:`Rows`) from ``x``, laid out as ``rows``. The input rows that the
    block reads (``conv_windows``: the kernel, the stride and ``pad_lo``
    zero rows before row 0, by default the layer's own padding) are fetched
    from their owners, rows past either end of H are zero, and the layer
    runs without padding along H (its other axes keep theirs)."""
    if isinstance(layer, torch.nn.Linear):
        return apply_layer(layer, take_rows(x, rows, out.blocks), dtype)
    pad_lo = layer.padding[-2] if pad_lo is None else pad_lo
    windows = conv_windows(out, layer.kernel_size[-2], layer.stride[-2], pad_lo)
    padding = list(layer.padding)
    padding[-2] = 0
    return apply_layer(layer, take_rows(x, rows, windows), dtype, tuple(padding))


def pad_height_width(x: torch.Tensor, size: Optional[int]) -> torch.Tensor:
    """A channels-first (N, C, [D,] H, W) tensor with zeros appended to its
    height and width up to ``size`` (the reference's ``spatial_pad_to``;
    an axis already that large is left as it is); ``x`` itself without a
    size."""
    if not size:
        return x
    pad_h, pad_w = (max(int(size) - n, 0) for n in x.shape[-2:])
    return F.pad(x, (0, pad_w, 0, pad_h)) if pad_h or pad_w else x


def pad_width_rows(x: torch.Tensor, n: int, size: Optional[int]):
    """:func:`pad_height_width` on a space axis, where ``x`` holds some of
    the ``n`` rows of H: the width padded here, the height by raising the
    global row count, whose new rows past the last are read as zeros by
    the first layer's windows. Returns (x, the padded row count)."""
    if not size:
        return x, n
    return F.pad(x, (0, max(int(size) - x.shape[-1], 0))), max(int(size), n)


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


# name → (scale, fan, distribution) of flax's variance-scaling initializers
_INITIALIZERS = {
    "glorot_normal": (1.0, "fan_avg", "truncated_normal"),
    "glorot_uniform": (1.0, "fan_avg", "uniform"),
    "he_normal": (2.0, "fan_in", "truncated_normal"),
    "he_uniform": (2.0, "fan_in", "uniform"),
    "lecun_normal": (1.0, "fan_in", "truncated_normal"),
}
# the std of a unit normal truncated to [-2, 2]
_TRUNCATED_STD = 0.87962566103423978


def initializer_name(name: Optional[str]) -> str:
    """The initializer that ``get_initializer(name)`` selects in the
    reference: ``None`` → glorot uniform, one of the four names → itself,
    any other name → glorot normal."""
    if name is None:
        return "glorot_uniform"
    if not isinstance(name, str):
        raise TypeError(f"initializer {name!r}: the port takes an initializer's name")
    return name if name in _INITIALIZERS and name != "lecun_normal" else "glorot_normal"


def init_weight_(weight: torch.Tensor, fan_in: int, fan_out: int, name: str = "glorot_normal",
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Fill ``weight`` from flax's variance-scaling initializer ``name`` (a
    key of ``_INITIALIZERS``) at the fans given: variance scale/fan, a
    normal truncated at ±2σ rescaled to that variance, or a uniform of
    limit √(3·variance)."""
    scale, mode, distribution = _INITIALIZERS[name]
    fan = {"fan_in": fan_in, "fan_out": fan_out, "fan_avg": (fan_in + fan_out) / 2.0}[mode]
    variance = scale / fan
    with torch.no_grad():
        if distribution == "uniform":
            limit = float(np.sqrt(3.0 * variance))
            return weight.uniform_(-limit, limit, generator=generator)
        std = float(np.sqrt(variance)) / _TRUNCATED_STD
        return torch.nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                           generator=generator)


def glorot_normal_(weight: torch.Tensor, fan_in: int, fan_out: int,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax ``glorot_normal``: truncated normal with variance 2/(fan_in+fan_out)."""
    return init_weight_(weight, fan_in, fan_out, "glorot_normal", generator)


def init_conv_(conv: torch.nn.Module, generator: Optional[torch.Generator] = None,
               name: str = "glorot_normal"):
    """Weights from the initializer ``name`` and zero bias for a 2D or 3D
    convolution or transposed convolution, with flax's fans: (receptive
    field)·in and (receptive field)·out; for a ``Linear`` (flax's
    ``Dense``), in and out."""
    w = conv.weight
    rf = int(np.prod(w.shape[2:]))
    transposed = isinstance(conv, (torch.nn.ConvTranspose2d, torch.nn.ConvTranspose3d))
    c_in, c_out = (w.shape[0], w.shape[1]) if transposed else (w.shape[1], w.shape[0])
    init_weight_(w, rf * c_in, rf * c_out, name, generator)
    if conv.bias is not None:
        with torch.no_grad():
            conv.bias.zero_()
