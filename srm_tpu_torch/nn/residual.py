"""Residual network (Model 2: the learned adaptive PDE time step).

Port of the ``cnn`` and ``cnn3d`` network types of ``srm_tpu/nn/residual.py``
with the plain 1×1 head (``output_distribution=False``, as the dry-gas
model map sets it): ``num_blocks`` residual blocks conv→act→conv +
shortcut→act (SAME padding), the first with a 1×1 projection shortcut,
then a 1×1 conv and the output activation. Input and output are
channels-last, ``(B, T, H, W, C)`` for ``cnn`` and ``(B, T, D, H, W, C)``
for ``cnn3d``; the convolutions run channels-first inside.

With ``compute_dtype`` (the reference's ``:48-60``, ``:185-193``) every
block convolution casts its input, kernel and bias to that dtype and
returns it; a shortcut sum promotes, so an identity shortcut of a float32
input keeps the sum float32, as in flax. The 1×1 head has no dtype of its
own: it computes in float32 on the block features, so the output is
float32 (the reference casts it, ``:192-193``).

``spatial_pad_to`` (the reference's ``:133-158``) zero-pads the height and
width at their ends up to that size before the blocks and crops the
padding off after them, before the head.

Batch norm, dropout, ``dense`` blocks and the distribution and VAE heads
wait for a later slice.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from srm_tpu_torch.nn.common import (apply_layer, fold_time, get_activation, init_conv_,
                                     pad_height_width, resolve_dtype)


_CONV = {"cnn": nn.Conv2d, "cnn3d": nn.Conv3d}


class ResidualBlock(nn.Module):
    def __init__(self, in_channels: int, filters: int, kernel_size: int = 3,
                 activation: Any = "swish", use_projection: bool = False,
                 network_type: str = "cnn", compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        conv = _CONV[network_type]
        pad = kernel_size // 2
        self.cdt = compute_dtype
        self.act = get_activation(activation)
        self.layer1 = conv(in_channels, filters, kernel_size, padding=pad)
        self.layer2 = conv(filters, filters, kernel_size, padding=pad)
        self.proj = (conv(in_channels, filters, 1)
                     if use_projection and in_channels != filters else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = apply_layer(self.layer2, self.act(apply_layer(self.layer1, x, self.cdt)), self.cdt)
        shortcut = apply_layer(self.proj, x, self.cdt) if self.proj is not None else x
        return self.act(y + shortcut)


class ResidualNetwork(nn.Module):
    def __init__(self, in_channels: int, num_blocks: int = 4, filters: int = 32,
                 kernel_size: int = 3, activation: Any = "swish",
                 output_activation: Optional[Callable] = None, output_filters: int = 1,
                 network_type: str = "cnn", compute_dtype: Optional[str] = None,
                 spatial_pad_to: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cdt = resolve_dtype(compute_dtype)
        self.spatial_pad_to = spatial_pad_to
        blocks = []
        c = in_channels
        for i in range(num_blocks):
            blocks.append(ResidualBlock(c, filters, kernel_size, activation,
                                        use_projection=(i == 0), network_type=network_type,
                                        compute_dtype=self.cdt))
            c = filters
        self.blocks = nn.ModuleList(blocks)
        self.output_layer = _CONV[network_type](filters, output_filters, 1)
        self.output_activation = get_activation(output_activation)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d)):
                init_conv_(m, generator)

    @classmethod
    def from_config(cls, config: Dict[str, Any], in_channels: int,
                    generator: Optional[torch.Generator] = None) -> "ResidualNetwork":
        network_type = config.get("network_type", "cnn")
        if (network_type not in _CONV or config.get("use_batch_norm")
                or config.get("dropout_rate") or config.get("output_distribution")):
            raise NotImplementedError(
                "only the plain 'cnn' and 'cnn3d' residual networks are ported")
        return cls(in_channels, num_blocks=config.get("num_blocks", 4),
                   filters=config.get("filters", 32), kernel_size=config.get("kernel_size", 3),
                   activation=config.get("hidden_activation", "swish"),
                   output_activation=config.get("output_activation"),
                   output_filters=config.get("output_filters", 1), network_type=network_type,
                   compute_dtype=config.get("compute_dtype"),
                   spatial_pad_to=config.get("spatial_pad_to"), generator=generator)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        x, unfold = fold_time(inputs)
        x = x.movedim(-1, 1)                            # channels-last → channels-first
        true_hw = tuple(x.shape[-2:])
        x = pad_height_width(x, self.spatial_pad_to)
        for block in self.blocks:
            x = block(x)
        if tuple(x.shape[-2:]) != true_hw:              # the alignment padding off
            x = x[..., :true_hw[0], :true_hw[1]]
        out = self.output_activation(apply_layer(self.output_layer, x))
        return unfold(out.movedim(1, -1))
