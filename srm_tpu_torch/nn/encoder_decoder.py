"""Convolutional encoder–decoder over 2D or 3D grids (the pressure network).

Port of ``srm_tpu/nn/encoder_decoder.py``, with ``spatial_dims`` 2
(Conv2d) or 3 (Conv3d over depth, height and width), and the options the
model map turns off (skip connections, dropout, ``latent_flatten``), which
a caller's own config reaches.
The geometry is the reference's (``:170-195``), which matters on
non-power-of-2 grids; per spatial axis:

encoder (depth 4, k 3):
  L1: Conv(k, s1, VALID)                       39 → 37     10 → 8
  L2: ZeroPad(1) → Conv(k+2, s2, VALID)        37 → 39 → 18 8 → 10 → 3
  L3: ZeroPad(1) → Conv(k+2, s2, VALID)        18 → 20 → 8  3 → 5 → 1
  L4: ZeroPad(1) → Conv(k,   s2, VALID)         8 → 10 → 4  1 → 3 → 1
  + 2 extra SAME convs, filters [32, 48, 72, 108]
latent: Dense on the channel axis (a 1×1 conv here), or with
  ``latent_flatten`` one Dense over the flattened channels-last features
  (``latent_dense``, an ``nn.Linear``) to ``channels·(cells)`` features,
  ``channels = max(Width, cells) // cells`` (the reference's ``:199-210``);
  the encoded grid is fixed at construction from ``grid``
decoder: [Dense to filters[-1] → act (``dec_dense_start``, when the
  innermost skip is on)], then {ConvTranspose(k, s2, VALID) [+ skip] → act
  [→ dropout]} × (depth − 1):
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

Precision (``compute_dtype``, ``f32_io``; the reference's ``:136-141``,
``:170-303``): parameters are float32. With ``compute_dtype="bfloat16"``
every layer built with that dtype in the reference (the strided and extra
convolutions, the latent and decoder layers, the deconvolutions) casts its
input, kernel and bias to bfloat16 and returns bfloat16; activations run in
the dtype of their input; the output is cast to float32. With ``f32_io``
(``precision_policy="mixed"``) the first convolution and the output chain
(``dec_final_dense``, ``dec_final_conv``, ``output_proj``) have no dtype
of their own and compute in float32, the promoted type of their input and
their float32 parameters (``nn.common.apply_layer``). The resize, where the
grid needs one, computes in float32 and rounds back to its input's dtype.

``spatial_pad_to`` (the reference's ``:84``, ``:153-166``, ``:285-291``)
zero-pads the height and width (never the depth) at their ends up to that
size before the first convolution; the decoder resizes to the padded grid,
and the padding is cropped off after the extra decoder convolutions, before
the output chain, so the output has the input's grid.

Skip connections (``Skip_Connections``, the reference's ``:184-185``,
``:231-254``): encoder level ``i`` with ``Layers[i]`` set keeps its
pre-activation output; the decoder step at that level zero-pads it,
centred, to its own grid, projects its channels with ``skip_proj_{level}``
(a Dense, where the channels differ) and adds it before the activation.
Dropout (``Dropout``, ``:189-191``, ``:256-258``) follows the activation of
encoder level ``i`` with ``Layer[i]`` set and of the decoder step at level
``i + 1``, only under the forward's explicit ``training`` flag (default
False, as the reference's). The initializer is ``Kernel_Init``
(``nn.common.initializer_name``: ``None`` gives glorot uniform).

Input and output are channels-last ``(B, [T,] *spatial, C)``; with
``temporal`` the leading (B, T) fold into one batch axis. The layers run
channels-first inside.

On a mesh's space axis (``forward(..., rows=)``, ``parallel/halo.py``) the
input holds this rank's rows of H and so does the output; depth and width
stay whole. The rule, once for every layer: each level's output is laid
out as ``Rows.level`` (``np.array_split``'s blocks, or whole on every rank
where H has fewer rows than the space axis has ranks), and a rank computes
its own block of it from the input rows that block reads, derived from the
block by the layer's kernel, stride and padding (``conv_windows``,
``deconv_windows``) and fetched from whichever ranks hold them, zeros past
either end of H. So a level's window is never the last level's cut reused:
the first VALID convolution (39 → 37), the pad-1 stride-2 ones
(37 → 18 → 8 → 4), the transposed ones (4 → 9 → 19 → 39, each output row
fed by two input rows) and the skips' centred zero pad (a re-cut of the
encoder's level) each derive their own. What needs all of H runs whole on
every rank, each keeping its own rows after: the resize, and a level
thinner than the space axis. ``spatial_pad_to`` pads the width locally and
the height as zero rows past the last one, which the first convolution's
window reads; the crop takes the input's rows back. ``latent_flatten``
(one Dense over the whole encoded grid) gathers the encoded level's rows on
every rank, applies the Dense in flax's flatten order there and keeps the
rank's rows of its output; the rows that other ranks keep carry no
cotangent here, so the Dense's gradients, summed over the space group,
count each output row once (a level thinner than the space axis is whole
on every rank already, and each rank's cotangent is then the part its own
rows below read).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from srm_tpu_torch.nn.common import (apply_layer, conv_rows, fold_time, get_activation,
                                     init_conv_, initializer_name, network_width_list,
                                     pad_height_width, pad_width_rows, resolve_dtype)
from srm_tpu_torch.parallel.halo import Rows, deconv_windows, gather_rows, own_rows, take_rows


def _skip_layers_list(residual_params: Dict) -> list:
    """The per-level skip flags of a config (the reference's ``:45-52``)."""
    sc = residual_params.get("Skip_Connections", {}) or {}
    if not sc.get("Add", False):
        return []
    layers = sc.get("Layers", [])
    if layers and isinstance(layers[0], (list, tuple)):
        layers = layers[0]
    return list(layers)


class EncoderDecoder(nn.Module):
    def __init__(self, in_channels: int = 5, depth: int = 4, bottom_size: int = 32,
                 growth_rate: float = 1.5, output_filters: int = 1, kernel_size: int = 3,
                 activation: Any = "swish", out_activation: Any = None,
                 latent_depth: int = 1, latent_width: int = 128,
                 latent_activation: Any = None, extra_conv_layers: int = 2,
                 extra_dec_conv_layers: int = 2, decoder_filter_fac: float = 1.0,
                 spatial_dims: int = 2, compute_dtype: Optional[str] = None,
                 f32_io: bool = False, spatial_pad_to: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 kernel_initializer: Optional[str] = "glorot_normal",
                 skip_layers: Sequence[int] = (), dropout_rate: float = 0.0,
                 dropout_layers: Sequence[int] = (), latent_flatten: bool = False,
                 grid: Optional[Sequence[int]] = None, temporal: bool = True):
        super().__init__()
        if spatial_dims not in (2, 3):
            raise ValueError(f"spatial_dims must be 2 or 3, got {spatial_dims}")
        Conv = nn.Conv2d if spatial_dims == 2 else nn.Conv3d
        ConvT = nn.ConvTranspose2d if spatial_dims == 2 else nn.ConvTranspose3d
        k = kernel_size
        self.depth = depth
        self.kernel_size = k
        self.spatial_dims = spatial_dims
        self.spatial_pad_to = spatial_pad_to
        self.temporal = temporal
        self.cdt = resolve_dtype(compute_dtype)
        self.cdt_io = None if f32_io else self.cdt
        self.act = get_activation(activation)
        self.out_act = get_activation(out_activation)
        self.latent_act = get_activation(latent_activation)
        self.skip_layers = tuple(skip_layers)
        self.dropout_rate = float(dropout_rate)
        self.dropout_layers = tuple(dropout_layers)
        f = network_width_list(depth, bottom_size, ngens=depth, growth_rate=growth_rate)

        enc = [Conv(in_channels, f[0], k)]
        for i in range(1, depth):
            enc.append(Conv(f[i - 1], f[i], self._enc_kernel(i), stride=2))
        self.enc_convs = nn.ModuleList(enc)
        self.enc_extra = nn.ModuleList(
            Conv(f[-1], f[-1], k, padding=k // 2) for _ in range(extra_conv_layers))
        lat = []
        c = f[-1]
        self.latent_dense, self.latent_grid = None, None
        if latent_flatten:
            if grid is None:
                raise ValueError("latent_flatten needs the input grid (grid=) to size its "
                                 "Dense layer")
            self.latent_grid = self._encoded_grid(grid)
            cells = int(np.prod(self.latent_grid))
            c = max(max(latent_width, cells) // cells, 1)
            self.latent_dense = nn.Linear(cells * f[-1], c * cells)
        else:
            for _ in range(latent_depth):
                lat.append(Conv(c, latent_width, 1))
                c = latent_width
        self.latent = nn.ModuleList(lat)
        self.dec_dense_start = None
        if self.skip_layers and self.skip_layers[-1] == 1:
            self.dec_dense_start = Conv(c, f[depth - 1], 1)
            c = f[depth - 1]
        dec, proj = [], {}
        for i in range(depth):
            if i > 0:
                out = int(f[depth - i - 1] * decoder_filter_fac)
                dec.append(ConvT(c, out, k, stride=2))
                c = out
            level = depth - i
            if self._use_skip(level - 1) and f[level - 1] != c:
                proj[str(level)] = Conv(f[level - 1], c, 1)
        self.dec_deconvs = nn.ModuleList(dec)
        self.skip_proj = nn.ModuleDict(proj)
        self.dec_extra = nn.ModuleList(
            Conv(c if j == 0 else f[0], f[0], k, padding=k // 2)
            for j in range(extra_dec_conv_layers))
        c = f[0] if extra_dec_conv_layers else c
        width0 = int(f[0] * decoder_filter_fac)
        self.dec_final_dense = Conv(c, width0, 1)
        self.dec_final_conv = Conv(width0, in_channels, 1)
        self.output_proj = (Conv(in_channels, output_filters, 1)
                            if in_channels != output_filters else None)
        init = initializer_name(kernel_initializer)
        for m in self.modules():
            if isinstance(m, (Conv, ConvT, nn.Linear)):
                init_conv_(m, generator, init)

    def _use_skip(self, level_i: int) -> bool:
        return (level_i < len(self.skip_layers)
                and self.skip_layers[level_i] not in (None, 0))

    def _use_dropout(self, level_i: int) -> bool:
        return (self.dropout_rate > 0 and level_i < len(self.dropout_layers)
                and self.dropout_layers[level_i] == 1)

    @property
    def has_dropout(self) -> bool:
        """Whether any level applies dropout (in a training forward)."""
        return any(self._use_dropout(i) for i in range(self.depth))

    def _encoded_grid(self, grid: Sequence[int]) -> tuple:
        """The encoder's output grid for an input grid (height and width
        padded to ``spatial_pad_to`` first)."""
        grid = list(grid)
        if self.spatial_pad_to:
            grid[-2:] = [max(int(self.spatial_pad_to), n) for n in grid[-2:]]
        self.check_spatial(grid)
        return tuple(self._encoded_size(n) for n in grid)

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
                    generator: Optional[torch.Generator] = None,
                    grid: Optional[Sequence[int]] = None) -> "EncoderDecoder":
        """``grid``: the input's spatial shape, needed with ``latent_flatten``."""
        rp = config.get("residual_params", {}) or {}
        w = config.get("width", {"Bottom_Size": 32, "Growth_Rate": 1.5})
        lat = rp.get("Latent_Layer", {}) or {}
        drop = rp.get("Dropout", {}) or {}
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
                   spatial_dims=config.get("spatial_dims", 2),
                   compute_dtype=config.get("compute_dtype"),
                   f32_io=bool(config.get("f32_io", False)),
                   spatial_pad_to=config.get("spatial_pad_to"), generator=generator,
                   kernel_initializer=rp.get("Kernel_Init", "glorot_normal"),
                   skip_layers=_skip_layers_list(rp),
                   dropout_rate=drop.get("Rate", 0.0) if drop.get("Add", False) else 0.0,
                   dropout_layers=tuple(drop.get("Layer", []) or ()),
                   latent_flatten=lat.get("Flatten", False), grid=grid,
                   temporal=config.get("temporal", False))

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

    def _dropout(self, x: torch.Tensor, level_i: int, training: bool) -> torch.Tensor:
        if not self._use_dropout(level_i):
            return x
        return F.dropout(x, self.dropout_rate, training=training)

    def _latent(self, x: torch.Tensor) -> torch.Tensor:
        if self.latent_dense is None:
            for dense in self.latent:
                x = self.latent_act(apply_layer(dense, x, self.cdt))
            return x
        if tuple(x.shape[2:]) != self.latent_grid:
            raise ValueError(f"latent_flatten was sized for an encoded grid {self.latent_grid}, "
                             f"got {tuple(x.shape[2:])}")
        n = x.shape[0]
        flat = x.movedim(1, -1).reshape(n, -1)          # channels-last, as flax flattens
        flat = self.latent_act(apply_layer(self.latent_dense, flat, self.cdt))
        return flat.reshape((n,) + self.latent_grid + (-1,)).movedim(-1, 1)

    def _add_skip(self, x: torch.Tensor, skip: torch.Tensor, level: int) -> torch.Tensor:
        """The encoder's level output zero-padded, centred, to ``x``'s grid
        and projected to its channels."""
        pads = []
        for s, t in reversed(list(zip(skip.shape[2:], x.shape[2:]))):
            pads += [(t - s) // 2, (t - s) - (t - s) // 2]
        skip = F.pad(skip, pads)
        if str(level) in self.skip_proj:
            skip = apply_layer(self.skip_proj[str(level)], skip, self.cdt)
        return x + skip

    def _add_skip_rows(self, x: torch.Tensor, cur: Rows, skip: torch.Tensor, srows: Rows,
                       level: int) -> torch.Tensor:
        """:meth:`_add_skip` on a space axis: the centred zero pad of H is a
        re-cut of the encoder's level (its rows shifted by the pad)."""
        off = (cur.n - srows.n) // 2
        skip = take_rows(skip, srows, [(a - off, b - off) for a, b in cur.blocks])
        pads = [0, 0] * (x.dim() - 2)
        for j, (s, t) in enumerate(reversed(list(zip(skip.shape[2:], x.shape[2:])))):
            if j != 1:                                  # H is cut, the others padded
                pads[2 * j:2 * j + 2] = [(t - s) // 2, (t - s) - (t - s) // 2]
        skip = F.pad(skip, pads)
        if str(level) in self.skip_proj:
            skip = apply_layer(self.skip_proj[str(level)], skip, self.cdt)
        return x + skip

    def _deconv_rows(self, layer, x: torch.Tensor, cur: Rows) -> Tuple[torch.Tensor, Rows]:
        """A transposed convolution (VALID) on a space axis: this rank's
        block of the output from the input rows that feed it."""
        k, s = layer.kernel_size[-2], layer.stride[-2]
        out = Rows.level(cur.mesh, (cur.n - 1) * s + k)
        windows = deconv_windows(out, k, s)
        y = apply_layer(layer, take_rows(x, cur, windows), self.cdt)
        a0 = s * windows[cur.mesh.space_rank][0]
        return y[..., out.lo - a0:out.hi - a0, :].contiguous(), out

    def _forward_rows(self, x: torch.Tensor, rows: Rows, training: bool) -> torch.Tensor:
        """The layers on this rank's rows ``rows`` of a channels-first input
        (the module docstring's rule); returns the same rows."""
        act, cdt, mesh = self.act, self.cdt, rows.mesh
        true_w = x.shape[-1]
        x, n = pad_width_rows(x, rows.n, self.spatial_pad_to)
        target = tuple(x.shape[2:-2]) + (n, x.shape[-1])
        self.check_spatial(target)
        skips, cur = {}, rows
        for i, conv in enumerate(self.enc_convs):
            k = self._enc_kernel(i)
            if i == 0:
                out = Rows.level(mesh, n - k + 1)
            else:
                x = F.pad(x, (1, 1, 0, 0) + (1, 1) * (self.spatial_dims - 2))
                out = Rows.level(mesh, (cur.n + 2 - k) // 2 + 1)
            x = conv_rows(conv, x, cur, out, self.cdt_io if i == 0 else cdt, 0 if i == 0 else 1)
            cur = out
            if self._use_skip(i):
                skips[i + 1] = (x, cur)                 # pre-activation
            x = self._dropout(act(x), i, training)
        for conv in self.enc_extra:
            x = act(conv_rows(conv, x, cur, cur, cdt))
        if self.latent_dense is None:
            x = self._latent(x)
        else:                                           # the Dense reads the whole grid
            x = own_rows(self._latent(gather_rows(x, cur)), cur)
        for i in range(self.depth):
            if i == 0:
                if self.dec_dense_start is not None:
                    x = act(apply_layer(self.dec_dense_start, x, cdt))
            else:
                x, cur = self._deconv_rows(self.dec_deconvs[i - 1], x, cur)
            level = self.depth - i
            if level in skips:
                x = self._add_skip_rows(x, cur, *skips[level], level)
            x = self._dropout(act(x), level - 1, training)
        if tuple(x.shape[2:-2]) + (cur.n, x.shape[-1]) != target:
            whole = self._resize(gather_rows(x, cur).float(), target).to(x.dtype)
            cur = Rows.level(mesh, target[-2])
            x = own_rows(whole, cur)
        for conv in self.dec_extra:
            x = act(conv_rows(conv, x, cur, cur, cdt))
        x = take_rows(x[..., :true_w], cur, rows.blocks)   # the input's rows, unpadded
        return x

    def forward(self, inputs: torch.Tensor, training: bool = False,
                rows: Optional[Rows] = None) -> torch.Tensor:
        """``rows``: on a mesh's space axis, the layout of the input's H
        (this rank's rows; the output has the same rows)."""
        act, cdt = self.act, self.cdt
        if self.temporal:
            x, unfold = fold_time(inputs)
        else:
            x, unfold = inputs, (lambda y: y)
        x = x.movedim(-1, 1)                            # channels-last → channels-first
        if rows is not None:
            x = self._forward_rows(x, rows, training)
            return unfold(self._output_chain(x).movedim(1, -1))
        true_hw = tuple(x.shape[-2:])
        x = pad_height_width(x, self.spatial_pad_to)
        target = tuple(x.shape[2:])
        self.check_spatial(target)
        skips = {}
        for i, conv in enumerate(self.enc_convs):
            if i > 0:
                x = F.pad(x, (1, 1) * self.spatial_dims)
            x = apply_layer(conv, x, self.cdt_io if i == 0 else cdt)
            if self._use_skip(i):
                skips[i + 1] = x                        # pre-activation
            x = self._dropout(act(x), i, training)
        for conv in self.enc_extra:
            x = act(apply_layer(conv, x, cdt))
        x = self._latent(x)
        for i in range(self.depth):
            if i == 0:
                if self.dec_dense_start is not None:
                    x = act(apply_layer(self.dec_dense_start, x, cdt))
            else:
                x = apply_layer(self.dec_deconvs[i - 1], x, cdt)
            level = self.depth - i
            if level in skips:
                x = self._add_skip(x, skips[level], level)
            x = self._dropout(act(x), level - 1, training)
        if tuple(x.shape[2:]) != target:
            x = self._resize(x.float(), target).to(x.dtype)
        for conv in self.dec_extra:
            x = act(apply_layer(conv, x, cdt))
        if tuple(x.shape[-2:]) != true_hw:              # the alignment padding off
            x = x[..., :true_hw[0], :true_hw[1]]
        return unfold(self._output_chain(x).movedim(1, -1))

    def _output_chain(self, x: torch.Tensor) -> torch.Tensor:
        """dec_final_dense → act, dec_final_conv → out_act, output_proj
        (1×1 layers: cell by cell), then float32."""
        x = self.act(apply_layer(self.dec_final_dense, x, self.cdt_io))
        x = self.out_act(apply_layer(self.dec_final_conv, x, self.cdt_io))
        if self.output_proj is not None:
            x = apply_layer(self.output_proj, x, self.cdt_io)
        if self.cdt is not None:
            x = x.float()
        return x
