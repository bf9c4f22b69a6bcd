"""Residual network (Model 2: the learned adaptive PDE time step).

Port of ``srm_tpu/nn/residual.py``: ``num_blocks`` residual blocks
conv→[BN]→act→[dropout]→conv→[BN] + shortcut→act (SAME padding), the first
with a 1×1 projection shortcut [+ BN] where the channels change, then one
head:

* the plain 1×1 head (a 1×1 conv, or a ``Dense`` for ``dense``) and the
  output activation, as the model map sets it;
* ``output_distribution``: global average pool → Dense(bins) → softmax,
  shaped ``(B, [T,] 1, 1, bins)`` (the reference's ``:162-172``);
* the VAE head (``latent_output``, constructor only, as in the reference,
  whose ``from_config`` passes none; ``:174-183``): pooled features →
  ``z_mean`` and ``z_log_var`` (Dense layers with flax's default
  lecun-normal kernel, as the reference builds them), z = z_mean +
  exp(z_log_var/2)·ε squashed by a sigmoid into (latent_a, latent_b) and
  broadcast over the grid; ε is given, or drawn from an explicit
  ``torch.Generator`` (the reference draws it from its ``"sample"`` rng and
  fails without one; so does the port without either);
* none (``include_output_layer=False``): the block features.

``network_type``: ``cnn`` (2D convolutions), ``cnn3d`` (3D) or ``dense``
(per-position dense layers on the channel axis, ``nn.Linear`` applied to
channel dim 1). Input and output are channels-last, ``(B, [T,] *S, C)``;
with ``temporal`` the leading (B, T) fold into one batch axis, and the
layers run channels-first inside.

Batch norm is flax's ``nn.BatchNorm`` (:class:`BatchNorm`: momentum 0.99,
ε 1e-5, scale 1 and bias 0, running mean 0 and variance 1 at init; the
block convolutions then have no bias). Dropout is ``F.dropout``. Both
follow the forward's explicit ``training`` flag (default False, as the
reference's), never ``nn.Module.training``: evaluated, BN uses its running
statistics and dropout is the identity. The loss refuses a training forward
through either (``PhysicsLoss``; ROADMAP C19): the reference's cannot train
them either.

The initializer is the config's ``kernel_initializer`` when it is a string,
else glorot normal (the reference's ``:115-117``), for every convolution and
every Dense but the VAE head's.

With ``compute_dtype`` (the reference's ``:48-60``, ``:185-193``) every
block layer casts its input, kernel and bias to that dtype and returns it;
BN has no dtype of its own and computes in float32 (its float32 statistics
and parameters promote the input); a shortcut sum promotes, so an identity
shortcut of a float32 input keeps the sum float32, as in flax. The heads
have no dtype of their own: they compute in float32 on the block features;
the plain head's output is cast to float32 (``:192-193``).

``spatial_pad_to`` (the reference's ``:133-158``, ``cnn`` and ``cnn3d``
only) zero-pads the height and width at their ends up to that size before
the blocks and crops the padding off after them, before the head.

On a mesh's space axis (``forward(..., rows=)``, ``parallel/halo.py``) the
input and the output hold this rank's rows of H: each SAME convolution
computes the rank's rows from them and one fetched row of each neighbour
(``nn.common.conv_rows``), and the pooled heads (the distribution head's
and the VAE head's global average pool) take the whole grid's mean: the
rank's sum over the whole grid's cell count, summed over the space group.
The VAE head's noise is one ε per sample for the whole space group: an
``eps`` given is used as it is (the caller passes every rank the same);
drawn from ``generator``, every rank draws (so that the ranks' generators
step alike) and the space group's first rank's draw is broadcast to the
others.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from srm_tpu_torch.nn.common import (apply_layer, conv_rows, fold_time, get_activation,
                                     init_conv_, initializer_name, pad_height_width,
                                     pad_width_rows, resolve_dtype)
from srm_tpu_torch.parallel.halo import Rows, broadcast_over_space, sum_over_space, take_rows


_CONV = {"cnn": nn.Conv2d, "cnn3d": nn.Conv3d}


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm`` over channel dim 1: with ``training`` the
    batch statistics (float32, variance E[x²] − E[x]² clamped at 0) and an
    update of the running ones by ``momentum``; else the running ones.
    y = (x − mean)·(rsqrt(var + ε)·scale) + bias, in float32."""

    def __init__(self, channels: int, momentum: float = 0.99, epsilon: float = 1e-5):
        super().__init__()
        self.momentum = float(momentum)
        self.epsilon = float(epsilon)
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if training:
            axes = [0] + list(range(2, x.dim()))
            xf = x.float()
            mean = xf.mean(axes)
            var = torch.clamp_min((xf * xf).mean(axes) - mean * mean, 0.0)
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_((1.0 - self.momentum) * mean)
                self.var.mul_(self.momentum).add_((1.0 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


def _layer(network_type: str, c_in: int, c_out: int, k: int, bias: bool) -> nn.Module:
    if network_type == "dense":
        return nn.Linear(c_in, c_out)               # flax's Dense keeps its bias
    return _CONV[network_type](c_in, c_out, k, padding=k // 2, bias=bias)


class ResidualBlock(nn.Module):
    def __init__(self, in_channels: int, filters: int, kernel_size: int = 3,
                 activation: Any = "swish", use_projection: bool = False,
                 network_type: str = "cnn", compute_dtype: Optional[torch.dtype] = None,
                 use_batch_norm: bool = False, dropout_rate: float = 0.0):
        super().__init__()
        bias = not use_batch_norm
        self.cdt = compute_dtype
        self.act = get_activation(activation)
        self.dropout_rate = float(dropout_rate)
        self.layer1 = _layer(network_type, in_channels, filters, kernel_size, bias)
        self.layer2 = _layer(network_type, filters, filters, kernel_size, bias)
        self.proj = (_layer(network_type, in_channels, filters, 1, bias)
                     if use_projection and in_channels != filters else None)
        bn = use_batch_norm
        self.bn1 = BatchNorm(filters) if bn else None
        self.bn2 = BatchNorm(filters) if bn else None
        self.bn_proj = BatchNorm(filters) if bn and self.proj is not None else None

    def forward(self, x: torch.Tensor, training: bool = False, rows: Optional[Rows] = None,
                out: Optional[Rows] = None) -> torch.Tensor:
        """``rows``: on a space axis, the layout of ``x``'s H, and ``out``
        the output's (None: the same)."""
        def norm(bn, y):
            return y if bn is None else bn(y, training)

        def layer(conv, y, src):
            if rows is None:
                return apply_layer(conv, y, self.cdt)
            return conv_rows(conv, y, src, out, self.cdt)

        out = out if out is not None else rows
        y = self.act(norm(self.bn1, layer(self.layer1, x, rows)))
        if self.dropout_rate > 0:
            y = F.dropout(y, self.dropout_rate, training=training)
        y = norm(self.bn2, layer(self.layer2, y, out))
        shortcut = x if rows is None else take_rows(x, rows, out.blocks)
        if self.proj is not None:
            shortcut = norm(self.bn_proj, apply_layer(self.proj, shortcut, self.cdt))
        return self.act(y + shortcut)


class ResidualNetwork(nn.Module):
    def __init__(self, in_channels: int, num_blocks: int = 4, filters: int = 32,
                 kernel_size: int = 3, activation: Any = "swish",
                 output_activation: Optional[Callable] = None, output_filters: int = 1,
                 network_type: str = "cnn", compute_dtype: Optional[str] = None,
                 spatial_pad_to: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 kernel_initializer: str = "glorot_normal", use_batch_norm: bool = False,
                 dropout_rate: float = 0.0, output_distribution: bool = False,
                 number_of_output_bins: int = 50, include_output_layer: bool = True,
                 latent_output: bool = False, latent_a: float = 0.0, latent_b: float = 1.0,
                 temporal: bool = True):
        super().__init__()
        network_type = network_type.lower()
        if network_type not in ("cnn", "cnn3d", "dense"):
            raise ValueError(f"Unknown network_type: {network_type}")
        self.network_type = network_type
        self.cdt = resolve_dtype(compute_dtype)
        self.temporal = temporal
        self.spatial_pad_to = spatial_pad_to if network_type != "dense" else None
        self.include_output_layer = include_output_layer
        self.output_distribution = output_distribution
        self.latent_output = latent_output
        self.latent_a, self.latent_b = float(latent_a), float(latent_b)
        self.dropout_rate = float(dropout_rate)
        self.use_batch_norm = bool(use_batch_norm)
        blocks = []
        c = in_channels
        for i in range(num_blocks):
            blocks.append(ResidualBlock(c, filters, kernel_size, activation,
                                        use_projection=(i == 0), network_type=network_type,
                                        compute_dtype=self.cdt, use_batch_norm=use_batch_norm,
                                        dropout_rate=dropout_rate))
            c = filters
        self.blocks = nn.ModuleList(blocks)
        self.output_layer = self.timestep_dense = self.z_mean = self.z_log_var = None
        if include_output_layer and output_distribution:
            self.timestep_dense = nn.Linear(c, number_of_output_bins)
        elif include_output_layer and latent_output:
            self.z_mean = nn.Linear(c, output_filters)
            self.z_log_var = nn.Linear(c, output_filters)
        elif include_output_layer:
            self.output_layer = _layer(network_type, c, output_filters, 1, True)
        self.output_activation = get_activation(output_activation)
        init = initializer_name(kernel_initializer)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear)):
                vae = m is self.z_mean or m is self.z_log_var
                init_conv_(m, generator, "lecun_normal" if vae else init)

    @classmethod
    def from_config(cls, config: Dict[str, Any], in_channels: int,
                    generator: Optional[torch.Generator] = None) -> "ResidualNetwork":
        init = config.get("kernel_initializer", "glorot_normal")
        return cls(in_channels, num_blocks=config.get("num_blocks", 4),
                   filters=config.get("filters", 32), kernel_size=config.get("kernel_size", 3),
                   activation=config.get("hidden_activation", "swish"),
                   output_activation=config.get("output_activation"),
                   output_filters=config.get("output_filters", 1),
                   network_type=config.get("network_type", "cnn"),
                   compute_dtype=config.get("compute_dtype"),
                   spatial_pad_to=config.get("spatial_pad_to"), generator=generator,
                   kernel_initializer=init if isinstance(init, str) else "glorot_normal",
                   use_batch_norm=config.get("use_batch_norm", False),
                   dropout_rate=config.get("dropout_rate", 0.0),
                   output_distribution=config.get("output_distribution", False),
                   number_of_output_bins=config.get("number_of_output_bins", 50),
                   temporal=config.get("temporal", False))

    def _blocks_rows(self, x: torch.Tensor, rows: Rows, training: bool) -> torch.Tensor:
        """The blocks on this rank's rows of a channels-first input (the
        width padded locally, the height as zero rows past the last, which
        the first block's windows read), cropped back to the input's rows."""
        true_w = x.shape[-1]
        x, n = pad_width_rows(x, rows.n, self.spatial_pad_to)
        cur = rows if n == rows.n else Rows.split(rows.mesh, n)
        for i, block in enumerate(self.blocks):
            x = block(x, training, rows if i == 0 else cur, cur)
        return take_rows(x[..., :true_w], cur, rows.blocks)

    def forward(self, inputs: torch.Tensor, training: bool = False,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                rows: Optional[Rows] = None) -> torch.Tensor:
        """``eps`` (or ``generator``, to draw it) is the VAE head's noise of
        shape (B·T, output_filters); the other heads take neither.
        ``rows``: on a mesh's space axis, the layout of the input's H (this
        rank's rows; the output has the same rows). There ``eps`` must be
        the same on every rank of the space group; a ``generator``'s draw
        is the group's first rank's, broadcast."""
        if self.temporal:
            x, unfold = fold_time(inputs)
        else:
            x, unfold = inputs, (lambda y: y)
        x = x.movedim(-1, 1)                            # channels-last → channels-first
        if rows is not None:
            x = self._blocks_rows(x, rows, training)
        else:
            true_hw = tuple(x.shape[-2:])
            x = pad_height_width(x, self.spatial_pad_to)
            for block in self.blocks:
                x = block(x, training)
            if tuple(x.shape[-2:]) != true_hw:          # the alignment padding off
                x = x[..., :true_hw[0], :true_hw[1]]
        if not self.include_output_layer:
            return unfold(x.movedim(1, -1))
        spatial = tuple(range(2, x.dim()))
        ones = (1,) * len(spatial)
        if self.output_distribution or self.latent_output:
            if rows is None:
                pooled = x.mean(dim=spatial)
            else:                                       # the whole grid's mean
                cells = rows.n * x[0, 0].numel() // max(rows.count, 1)
                pooled = sum_over_space(x.sum(dim=spatial), rows.mesh) / cells
        if self.output_distribution:
            logits = apply_layer(self.timestep_dense, pooled)
            probs = torch.softmax(logits, dim=-1)
            return unfold(probs.reshape((probs.shape[0],) + ones + (probs.shape[-1],)))
        if self.latent_output:
            z_mean = apply_layer(self.z_mean, pooled)
            z_log_var = apply_layer(self.z_log_var, pooled)
            if eps is None:
                if generator is None:
                    raise ValueError("the VAE head needs its noise: pass eps or a generator")
                eps = torch.randn(z_mean.shape, generator=generator, dtype=z_mean.dtype,
                                  device=generator.device).to(z_mean.device)
                if rows is not None:
                    eps = broadcast_over_space(eps, rows.mesh)
            z = z_mean + torch.exp(0.5 * z_log_var) * eps
            z = (self.latent_b - self.latent_a) * torch.sigmoid(z) + self.latent_a
            out = z.reshape(z.shape + ones).expand((z.shape[0], z.shape[1]) + x.shape[2:])
            return unfold(self.output_activation(out).movedim(1, -1))
        out = self.output_activation(apply_layer(self.output_layer, x))
        if self.cdt is not None:
            out = out.float()
        return unfold(out.movedim(1, -1))
