"""Carry the JAX package's flax weights into the port's modules.

:func:`load_flax_params` takes the reference's variable trees — the dict
that ``srm_tpu.nn.modules.build_model_map`` returns, with every leaf
converted to a numpy array — and fills the port's models of the same names
(``pressure``, ``time_step``, ``pvt_model`` where it is the polynomial
PVT, ``saturation_model``), so both packages compute the same function.
:func:`load_flax_module` fills one module from its own variables
(``{"params": ..., ["batch_stats": ...]}``): an encoder–decoder, a residual
net, a HardLayer, their composition, or a PVT. The spline PVT has no
params (both packages solve its weights on the host from the same table).

Layouts, in 2D and 3D: a flax ``Conv`` kernel is (*spatial, in, out) →
torch (out, in, *spatial), e.g. (kd, kh, kw, in, out) → (out, in, kd, kh,
kw); a flax ``Dense`` kernel (in, out) becomes a 1×1 (or 1×1×1) conv, or
an ``nn.Linear``'s (out, in) weight; a flax ``ConvTranspose`` does not flip
its kernel and torch's does, so its (*spatial, in, out) kernel is flipped on
every spatial axis and reordered to torch's (in, out, *spatial). A layer
without a bias (a convolution before a BatchNorm) has none in either. A
BatchNorm's ``scale`` and ``bias`` are params, its ``mean`` and ``var`` the
``batch_stats`` collection's.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from srm_tpu_torch.nn.encoder_decoder import EncoderDecoder
from srm_tpu_torch.nn.hard_layer import HardLayer
from srm_tpu_torch.nn.residual import ResidualNetwork
from srm_tpu_torch.physics.pvt import PolynomialPVT, SplinePVT


def _conv_weight(kernel: np.ndarray, nd: int) -> np.ndarray:
    if kernel.ndim == 2:                               # Dense (in, out)
        return kernel.T.reshape(kernel.T.shape + (1,) * nd)
    return np.transpose(kernel, (nd + 1, nd) + tuple(range(nd)))


def _deconv_weight(kernel: np.ndarray, nd: int) -> np.ndarray:
    flipped = kernel[(slice(None, None, -1),) * nd]
    return np.transpose(flipped, (nd, nd + 1) + tuple(range(nd)))


def _copy(target: torch.Tensor, value, what: str) -> None:
    value = np.ascontiguousarray(np.asarray(value, np.float32))
    if tuple(value.shape) != tuple(target.shape):
        raise ValueError(f"{what} {value.shape} does not fit {tuple(target.shape)}")
    with torch.no_grad():
        target.copy_(torch.tensor(value))


def _load(module: nn.Module, leaf: Mapping[str, Any], transpose: bool = False):
    kernel = np.asarray(leaf["kernel"], np.float32)
    if isinstance(module, nn.Linear):
        weight = kernel.T
    else:
        nd = module.weight.dim() - 2                   # spatial dims of the torch layer
        weight = _deconv_weight(kernel, nd) if transpose else _conv_weight(kernel, nd)
    _copy(module.weight, weight, "weight shape")
    if module.bias is not None:
        _copy(module.bias, leaf["bias"], "bias shape")
    elif "bias" in leaf:
        raise ValueError("the flax layer has a bias and the port's layer has none")


def _load_batch_norm(bn, p: Mapping[str, Any], stats: Mapping[str, Any]):
    _copy(bn.scale, p["scale"], "BatchNorm scale")
    _copy(bn.bias, p["bias"], "BatchNorm bias")
    if stats:
        _copy(bn.mean, stats["mean"], "BatchNorm mean")
        _copy(bn.var, stats["var"], "BatchNorm var")


def _load_encoder_decoder(ed, p: Mapping[str, Any], stats: Optional[Mapping] = None):
    for i, conv in enumerate(ed.enc_convs):
        _load(conv, p[f"enc_conv_{i + 1}"])
    for j, conv in enumerate(ed.enc_extra):
        _load(conv, p[f"enc_extra_conv_{j + 1}"])
    for d, dense in enumerate(ed.latent):
        _load(dense, p[f"latent_dense_{d}"])
    if ed.latent_dense is not None:
        _load(ed.latent_dense, p["latent_dense"])
    if ed.dec_dense_start is not None:
        _load(ed.dec_dense_start, p["dec_dense_start"])
    for level, proj in ed.skip_proj.items():
        _load(proj, p[f"skip_proj_{level}"])
    for i, deconv in enumerate(ed.dec_deconvs):       # applied first = deepest level
        _load(deconv, p[f"dec_deconv_{ed.depth - 1 - i}"], transpose=True)
    for j, conv in enumerate(ed.dec_extra):
        _load(conv, p[f"dec_extra_conv_{j + 1}"])
    _load(ed.dec_final_dense, p["dec_final_dense"])
    _load(ed.dec_final_conv, p["dec_final_conv"])
    if ed.output_proj is not None:
        _load(ed.output_proj, p["output_proj"])


def _load_residual(net, p: Mapping[str, Any], stats: Optional[Mapping] = None):
    stats = stats or {}
    for i, block in enumerate(net.blocks):
        name = f"res_block_{i + 1}"
        bp, bs = p[name], stats.get(name, {})
        for layer in ("layer1", "layer2", "proj"):
            if getattr(block, layer) is not None:
                _load(getattr(block, layer), bp[layer])
        for bn in ("bn1", "bn2", "bn_proj"):
            if getattr(block, bn) is not None:
                _load_batch_norm(getattr(block, bn), bp[bn], bs.get(bn))
    for head in ("output_layer", "timestep_dense", "z_mean", "z_log_var"):
        if getattr(net, head) is not None:
            _load(getattr(net, head), p[head])


def _load_hard_layer(hl, p: Mapping[str, Any], stats: Optional[Mapping] = None):
    kexp = np.asarray(p["kernel_exponent"], np.float32)
    if kexp.shape != tuple(hl.kernel_exponent.shape):
        raise ValueError(f"kernel_exponent {kexp.shape} does not fit "
                         f"{tuple(hl.kernel_exponent.shape)}: the models were built for another "
                         f"grid")
    _copy(hl.kernel_exponent, kexp, "kernel_exponent")
    if hl.rbf_kernel is not None:
        _copy(hl.rbf_kernel, p["rbf_kernel"], "rbf_kernel")


def _load_pvt(pvt, p: Mapping[str, Any], stats: Optional[Mapping] = None):
    """A PVT, from its own params or from the model map's tree, whose PVT
    sits in a ``PVTModuleWithHardLayer`` (``pvt_layer``)."""
    if "pvt_layer" in p:
        p = p["pvt_layer"]
    if isinstance(pvt, PolynomialPVT):
        for prop in pvt.properties:
            _copy(pvt.coefficients(prop), p[f"{prop}_coefficients"], f"{prop}_coefficients")
    elif p:
        raise ValueError(f"a {type(pvt).__name__} takes no params, got {sorted(p)}")


def _load_composite(module, p: Mapping[str, Any], stats: Optional[Mapping] = None):
    """A CompleteTrainableModule (``network``, ``hard_layer``) or a
    PVTModuleWithHardLayer (``pvt_layer``, ``hard_layer``)."""
    stats = stats or {}
    for name in ("network", "pvt_layer", "hard_layer"):
        child = getattr(module, name, None)
        if child is not None and name in p:
            _loader(child)(child, p[name], stats.get(name))


def _loader(module):
    for cls, load in ((EncoderDecoder, _load_encoder_decoder), (ResidualNetwork, _load_residual),
                      (HardLayer, _load_hard_layer), (PolynomialPVT, _load_pvt),
                      (SplinePVT, _load_pvt)):
        if isinstance(module, cls):
            return load
    if hasattr(module, "network") or hasattr(module, "pvt_layer"):
        return _load_composite
    raise TypeError(f"no flax loader for a {type(module).__name__}")


def load_flax_module(module: nn.Module, variables: Mapping[str, Any]) -> None:
    """Fill ``module`` from its flax variables ``{"params": ...,
    ["batch_stats": ...]}`` (numpy leaves)."""
    _loader(module)(module, variables.get("params", {}), variables.get("batch_stats"))


def load_flax_params(models: Dict[str, Any], params_np: Mapping[str, Any]) -> None:
    """Fill each model of ``models`` whose variables the reference's
    ``params_np`` holds (the well model has none)."""
    for name, variables in params_np.items():
        if name in models and name != "well_rate_bhp_model":
            load_flax_module(models[name], variables)
