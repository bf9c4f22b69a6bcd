"""Convolutional encoder–decoder over 2D or 3D grids (the pressure network).

Port of ``srm_tpu/nn/encoder_decoder.py`` as the dry-gas model map
configures it (no skip connections, no dropout, no latent flatten), with
``spatial_dims`` 2 (Conv2d) or 3 (Conv3d over depth, height and width).
The geometry is the reference's (``:170-195``), which matters on
non-power-of-2 grids; per spatial axis:

encoder (depth 4, k 3):
  L1: Conv(k, s1, VALID)                       39 → 37     10 → 8
  L2: ZeroPad(1) → Conv(k+2, s2, VALID)        37 → 39 → 18 8 → 10 → 3
  L3: ZeroPad(1) → Conv(k+2, s2, VALID)        18 → 20 → 8  3 → 5 → 1
  L4: ZeroPad(1) → Conv(k,   s2, VALID)         8 → 10 → 4  1 → 3 → 1
  + 2 extra SAME convs, filters [32, 48, 72, 108]
latent: Dense on the channel axis (a 1×1 conv here)
decoder: act, then {ConvTranspose(k, s2, VALID) → act} × (depth − 1):
  4 → 9 → 19 → 39 (and 1 → 3 → 7 → 15); then, only where the shape still
  differs from the input's, the reference's resize (``:259-277``): in 2D a
  bilinear resize (antialiased, as ``jax.image.resize``); in 3D the same
  bilinear resize of height and width only, plane by plane, then a centred
  crop or zero pad of the depth (39×39×10: 15 → 10 from layer 2); 2 extra
  SAME convs; Dense → act; 1×1 conv to the input channels; 1×1
  projection to ``output_filters``.

Depth collapse: below a minimum size per axis (9 at depth 4) the strided
encoder reaches size 0. flax runs such zero-size convolutions, and the
reference's output then no longer depends on its input (ROADMAP C3);
torch refuses them. The forward pass raises a ``ValueError`` naming the
smallest valid size instead (:meth:`EncoderDecoder.check_spatial`).

Input and output are channels-last ``(B, T, *spatial, C)``; the layers run
channels-first inside.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from srm_tpu_torch.nn.common import fold_time, get_activation, init_conv_, network_width_list


class EncoderDecoder(nn.Module):
    def __init__(self, in_channels: int = 5, depth: int = 4, bottom_size: int = 32,
                 growth_rate: float = 1.5, output_filters: int = 1, kernel_size: int = 3,
                 activation: Any = "swish", out_activation: Any = None,
                 latent_depth: int = 1, latent_width: int = 128,
                 latent_activation: Any = None, extra_conv_layers: int = 2,
                 extra_dec_conv_layers: int = 2, decoder_filter_fac: float = 1.0,
                 spatial_dims: int = 2, generator: Optional[torch.Generator] = None):
        super().__init__()
        if spatial_dims not in (2, 3):
            raise ValueError(f"spatial_dims must be 2 or 3, got {spatial_dims}")
        Conv = nn.Conv2d if spatial_dims == 2 else nn.Conv3d
        ConvT = nn.ConvTranspose2d if spatial_dims == 2 else nn.ConvTranspose3d
        k = kernel_size
        self.depth = depth
        self.kernel_size = k
        self.spatial_dims = spatial_dims
        self.act = get_activation(activation)
        self.out_act = get_activation(out_activation)
        self.latent_act = get_activation(latent_activation)
        f = network_width_list(depth, bottom_size, ngens=depth, growth_rate=growth_rate)

        enc = [Conv(in_channels, f[0], k)]
        for i in range(1, depth):
            enc.append(Conv(f[i - 1], f[i], self._enc_kernel(i), stride=2))
        self.enc_convs = nn.ModuleList(enc)
        self.enc_extra = nn.ModuleList(
            Conv(f[-1], f[-1], k, padding=k // 2) for _ in range(extra_conv_layers))
        lat = []
        c = f[-1]
        for _ in range(latent_depth):
            lat.append(Conv(c, latent_width, 1))
            c = latent_width
        self.latent = nn.ModuleList(lat)
        dec = []
        for i in range(1, depth):
            out = int(f[depth - i - 1] * decoder_filter_fac)
            dec.append(ConvT(c, out, k, stride=2))
            c = out
        self.dec_deconvs = nn.ModuleList(dec)
        self.dec_extra = nn.ModuleList(
            Conv(c if j == 0 else f[0], f[0], k, padding=k // 2)
            for j in range(extra_dec_conv_layers))
        c = f[0] if extra_dec_conv_layers else c
        width0 = int(f[0] * decoder_filter_fac)
        self.dec_final_dense = Conv(c, width0, 1)
        self.dec_final_conv = Conv(width0, in_channels, 1)
        self.output_proj = (Conv(in_channels, output_filters, 1)
                            if in_channels != output_filters else None)
        for m in self.modules():
            if isinstance(m, (Conv, ConvT)):
                init_conv_(m, generator)

    def _enc_kernel(self, i: int) -> int:
        """Kernel size of encoder level ``i`` (k+2 on the inner strided levels)."""
        k = self.kernel_size
        return k if i == 0 or i == self.depth - 1 else k + 2

    def _encoded_size(self, n: int) -> int:
        """Size of one spatial axis after the encoder, or 0 once it collapses."""
        n = n - self.kernel_size + 1
        for i in range(1, self.depth):
            ks = self._enc_kernel(i)
            if n < 1 or n + 2 < ks:
                return 0
            n = (n + 2 - ks) // 2 + 1
        return max(n, 0)

    def check_spatial(self, spatial: Sequence[int]) -> None:
        """Raise ``ValueError`` if an axis of the grid collapses to size 0 in
        the encoder (ROADMAP C3): the reference runs zero-size convolutions
        there and its output stops depending on its input."""
        for axis, n in zip(("depth", "height", "width")[-len(spatial):], spatial):
            if self._encoded_size(n) < 1:
                smallest = next(m for m in range(1, 1 << 16) if self._encoded_size(m) >= 1)
                raise ValueError(
                    f"grid {tuple(spatial)}: the depth-{self.depth} encoder collapses the "
                    f"{axis} axis of size {n} to 0; it needs at least {smallest} cells "
                    f"on every axis")

    @classmethod
    def from_config(cls, config: Dict[str, Any], in_channels: int,
                    generator: Optional[torch.Generator] = None) -> "EncoderDecoder":
        rp = config.get("residual_params", {}) or {}
        w = config.get("width", {"Bottom_Size": 32, "Growth_Rate": 1.5})
        lat = rp.get("Latent_Layer", {}) or {}
        if ((rp.get("Skip_Connections") or {}).get("Add")
                or (rp.get("Dropout") or {}).get("Add") or lat.get("Flatten")
                or config.get("compute_dtype") or config.get("spatial_pad_to")):
            raise NotImplementedError(
                "only the float32 encoder-decoder without skips, dropout, "
                "latent flatten or spatial padding is ported")
        return cls(in_channels, depth=config.get("depth", 4), bottom_size=w["Bottom_Size"],
                   growth_rate=w["Growth_Rate"], output_filters=config.get("output_filters", 1),
                   kernel_size=rp.get("Kernel_Size", 3),
                   activation=rp.get("Activation_Func", "swish"),
                   out_activation=rp.get("Out_Activation_Func"),
                   latent_depth=lat.get("Depth", 1), latent_width=lat.get("Width", 128),
                   latent_activation=lat.get("Activation"),
                   extra_conv_layers=(rp.get("Extra_Conv_Layers") or {}).get("Count", 0),
                   extra_dec_conv_layers=(rp.get("Extra_Dec_Conv_Layers") or {}).get("Count", 0),
                   decoder_filter_fac=rp.get("Decoder_Filter_Fac", 1.0),
                   spatial_dims=config.get("spatial_dims", 2), generator=generator)

    def _resize(self, x: torch.Tensor, target) -> torch.Tensor:
        """The reference's resize back to the input grid (``:259-277``)."""
        if self.spatial_dims == 2:
            return F.interpolate(x, size=target, mode="bilinear", align_corners=False,
                                 antialias=True)
        N, C, Dc, H, W = x.shape
        d_t, h_t, w_t = target
        if (H, W) != (h_t, w_t):
            # height and width only, plane by plane (antialiased bilinear is
            # 4D-only in torch; trilinear would resample the depth as well)
            planes = x.transpose(1, 2).reshape(N * Dc, C, H, W)
            planes = F.interpolate(planes, size=(h_t, w_t), mode="bilinear",
                                   align_corners=False, antialias=True)
            x = planes.reshape(N, Dc, C, h_t, w_t).transpose(1, 2)
        if Dc > d_t:
            start = (Dc - d_t) // 2
            x = x[:, :, start:start + d_t]
        elif Dc < d_t:
            diff = d_t - Dc
            x = F.pad(x, (0, 0, 0, 0, diff // 2, diff - diff // 2))
        return x

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        act = self.act
        x, unfold = fold_time(inputs)
        x = x.movedim(-1, 1)                            # channels-last → channels-first
        target = tuple(x.shape[2:])
        self.check_spatial(target)
        for i, conv in enumerate(self.enc_convs):
            if i > 0:
                x = F.pad(x, (1, 1) * self.spatial_dims)
            x = act(conv(x))
        for conv in self.enc_extra:
            x = act(conv(x))
        for dense in self.latent:
            x = self.latent_act(dense(x))
        x = act(x)
        for deconv in self.dec_deconvs:
            x = act(deconv(x))
        if tuple(x.shape[2:]) != target:
            x = self._resize(x, target)
        for conv in self.dec_extra:
            x = act(conv(x))
        x = act(self.dec_final_dense(x))
        x = self.out_act(self.dec_final_conv(x))
        if self.output_proj is not None:
            x = self.output_proj(x)
        return unfold(x.movedim(1, -1))
