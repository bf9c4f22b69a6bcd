"""Convolutional encoder–decoder over 2D grids (the pressure network).

Port of the 2D path of ``srm_tpu/nn/encoder_decoder.py`` as the dry-gas
model map configures it (no skip connections, no dropout, no latent
flatten). The geometry is the reference's (``:170-195``), which matters on
non-power-of-2 grids:

encoder (depth 4, k 3):
  L1: Conv(k, s1, VALID)                       39 → 37
  L2: ZeroPad(1) → Conv(k+2, s2, VALID)        37 → 39 → 18
  L3: ZeroPad(1) → Conv(k+2, s2, VALID)        18 → 20 → 8
  L4: ZeroPad(1) → Conv(k,   s2, VALID)         8 → 10 → 4
  + 2 extra SAME convs, filters [32, 48, 72, 108]
latent: Dense on the channel axis (a 1×1 conv here)
decoder: act, then {ConvTranspose(k, s2, VALID) → act} × (depth − 1):
  4 → 9 → 19 → 39; bilinear resize (antialiased, as ``jax.image.resize``)
  only where the shape still differs (small test grids); 2 extra SAME
  convs; Dense → act; 1×1 conv to the input channels; 1×1 projection to
  ``output_filters``.

Input and output are channels-last ``(B, T, H, W, C)``; the layers run in
NCHW inside.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

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
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        k = kernel_size
        self.depth = depth
        self.kernel_size = k
        self.act = get_activation(activation)
        self.out_act = get_activation(out_activation)
        self.latent_act = get_activation(latent_activation)
        f = network_width_list(depth, bottom_size, ngens=depth, growth_rate=growth_rate)

        enc = [nn.Conv2d(in_channels, f[0], k)]
        for i in range(1, depth):
            enc.append(nn.Conv2d(f[i - 1], f[i], k + 2 if i < depth - 1 else k, stride=2))
        self.enc_convs = nn.ModuleList(enc)
        self.enc_extra = nn.ModuleList(
            nn.Conv2d(f[-1], f[-1], k, padding=k // 2) for _ in range(extra_conv_layers))
        lat = []
        c = f[-1]
        for _ in range(latent_depth):
            lat.append(nn.Conv2d(c, latent_width, 1))
            c = latent_width
        self.latent = nn.ModuleList(lat)
        dec = []
        for i in range(1, depth):
            out = int(f[depth - i - 1] * decoder_filter_fac)
            dec.append(nn.ConvTranspose2d(c, out, k, stride=2))
            c = out
        self.dec_deconvs = nn.ModuleList(dec)
        self.dec_extra = nn.ModuleList(
            nn.Conv2d(c if j == 0 else f[0], f[0], k, padding=k // 2)
            for j in range(extra_dec_conv_layers))
        c = f[0] if extra_dec_conv_layers else c
        width0 = int(f[0] * decoder_filter_fac)
        self.dec_final_dense = nn.Conv2d(c, width0, 1)
        self.dec_final_conv = nn.Conv2d(width0, in_channels, 1)
        self.output_proj = (nn.Conv2d(in_channels, output_filters, 1)
                            if in_channels != output_filters else None)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                init_conv_(m, generator)

    @classmethod
    def from_config(cls, config: Dict[str, Any], in_channels: int,
                    generator: Optional[torch.Generator] = None) -> "EncoderDecoder":
        rp = config.get("residual_params", {}) or {}
        w = config.get("width", {"Bottom_Size": 32, "Growth_Rate": 1.5})
        lat = rp.get("Latent_Layer", {}) or {}
        if (config.get("spatial_dims", 2) != 2 or (rp.get("Skip_Connections") or {}).get("Add")
                or (rp.get("Dropout") or {}).get("Add") or lat.get("Flatten")
                or config.get("compute_dtype") or config.get("spatial_pad_to")):
            raise NotImplementedError(
                "only the 2D float32 encoder-decoder without skips, dropout, "
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
                   decoder_filter_fac=rp.get("Decoder_Filter_Fac", 1.0), generator=generator)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        act = self.act
        x, unfold = fold_time(inputs)
        x = x.permute(0, 3, 1, 2)                       # NHWC → NCHW
        target = tuple(x.shape[-2:])
        for i, conv in enumerate(self.enc_convs):
            if i > 0:
                x = F.pad(x, (1, 1, 1, 1))
            x = act(conv(x))
        for conv in self.enc_extra:
            x = act(conv(x))
        for dense in self.latent:
            x = self.latent_act(dense(x))
        x = act(x)
        for deconv in self.dec_deconvs:
            x = act(deconv(x))
        if tuple(x.shape[-2:]) != target:
            x = F.interpolate(x, size=target, mode="bilinear", align_corners=False,
                              antialias=True)
        for conv in self.dec_extra:
            x = act(conv(x))
        x = act(self.dec_final_dense(x))
        x = self.out_act(self.dec_final_conv(x))
        if self.output_proj is not None:
            x = self.output_proj(x)
        return unfold(x.permute(0, 2, 3, 1))
