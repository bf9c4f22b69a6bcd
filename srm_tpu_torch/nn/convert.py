"""Carry the JAX package's flax weights into the port's modules.

:func:`load_flax_params` takes the reference's param tree — the dict that
``srm_tpu.nn.modules.build_model_map`` returns, with every leaf converted
to a numpy array — and fills the port's ``pressure`` and ``time_step``
modules, and the gas-condensate ``saturation_model``, so both packages
compute the same function. The spline PVT has no
params (both packages solve its weights on the host from the same table).

Layouts, in 2D and 3D: a flax ``Conv`` kernel is (*spatial, in, out) →
torch (out, in, *spatial), e.g. (kd, kh, kw, in, out) → (out, in, kd, kh,
kw); a flax ``Dense`` kernel (in, out) becomes a 1×1 (or 1×1×1) conv; a
flax ``ConvTranspose`` does not flip its kernel and torch's does, so its
(*spatial, in, out) kernel is flipped on every spatial axis and reordered
to torch's (in, out, *spatial).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn


def _conv_weight(kernel: np.ndarray, nd: int) -> np.ndarray:
    if kernel.ndim == 2:                               # Dense (in, out)
        return kernel.T.reshape(kernel.T.shape + (1,) * nd)
    return np.transpose(kernel, (nd + 1, nd) + tuple(range(nd)))


def _deconv_weight(kernel: np.ndarray, nd: int) -> np.ndarray:
    flipped = kernel[(slice(None, None, -1),) * nd]
    return np.transpose(flipped, (nd, nd + 1) + tuple(range(nd)))


def _load(module: nn.Module, leaf: Mapping[str, Any], transpose: bool = False):
    kernel = np.asarray(leaf["kernel"], np.float32)
    nd = module.weight.dim() - 2                       # spatial dims of the torch layer
    weight = _deconv_weight(kernel, nd) if transpose else _conv_weight(kernel, nd)
    if tuple(weight.shape) != tuple(module.weight.shape):
        raise ValueError(f"weight shape {weight.shape} does not fit {tuple(module.weight.shape)}")
    with torch.no_grad():
        module.weight.copy_(torch.tensor(np.ascontiguousarray(weight)))
        module.bias.copy_(torch.tensor(np.asarray(leaf["bias"], np.float32)))


def _load_encoder_decoder(ed, p: Mapping[str, Any]):
    for i, conv in enumerate(ed.enc_convs):
        _load(conv, p[f"enc_conv_{i + 1}"])
    for j, conv in enumerate(ed.enc_extra):
        _load(conv, p[f"enc_extra_conv_{j + 1}"])
    for d, dense in enumerate(ed.latent):
        _load(dense, p[f"latent_dense_{d}"])
    for i, deconv in enumerate(ed.dec_deconvs):       # applied first = deepest level
        _load(deconv, p[f"dec_deconv_{ed.depth - 1 - i}"], transpose=True)
    for j, conv in enumerate(ed.dec_extra):
        _load(conv, p[f"dec_extra_conv_{j + 1}"])
    _load(ed.dec_final_dense, p["dec_final_dense"])
    _load(ed.dec_final_conv, p["dec_final_conv"])
    if ed.output_proj is not None:
        _load(ed.output_proj, p["output_proj"])


def _load_residual(net, p: Mapping[str, Any]):
    for i, block in enumerate(net.blocks):
        bp = p[f"res_block_{i + 1}"]
        _load(block.layer1, bp["layer1"])
        _load(block.layer2, bp["layer2"])
        if block.proj is not None:
            _load(block.proj, bp["proj"])
    _load(net.output_layer, p["output_layer"])


def _load_hard_trainable(module, p: Mapping[str, Any]):
    """An encoder–decoder + HardLayer module (Model 1 or 1S)."""
    _load_encoder_decoder(module.network, p["network"])
    kexp = np.asarray(p["hard_layer"]["kernel_exponent"], np.float32)
    target = module.hard_layer.kernel_exponent
    if kexp.shape != tuple(target.shape):
        raise ValueError(f"kernel_exponent {kexp.shape} does not fit {tuple(target.shape)}: "
                         "the models were built for another grid")
    with torch.no_grad():
        target.copy_(torch.tensor(kexp))


def _load_time_step(module, p: Mapping[str, Any]):
    _load_residual(module.network, p["network"])


_LOADERS = {"pressure": _load_hard_trainable, "time_step": _load_time_step,
            "saturation_model": _load_hard_trainable}


def load_flax_params(models: Dict[str, Any], params_np: Mapping[str, Any]) -> None:
    """Fill each of ``models['pressure']``, ``models['time_step']`` and
    ``models['saturation_model']`` whose tree the reference's ``params_np``
    holds (the spline PVT and the well model have no params)."""
    for name, load in _LOADERS.items():
        if name in params_np:
            load(models[name], params_np[name]["params"])
