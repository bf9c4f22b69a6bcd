"""Composition modules and the model map.

Port of ``srm_tpu/nn/modules.py`` for dry gas and gas condensate, in 2D
and 3D (``Nz > 1``), with the reference's ``compute_dtype``,
``precision_policy`` (``"mixed"``: float32 input conv and output head) and
``spatial_pad_to`` passed to the networks, and ``network_width`` as the
encoder–decoders' ``Bottom_Size`` (Models 1 and 1S, not Model 2):

* :class:`CompleteTrainableModule` — a backbone with an optional HardLayer
  fed the time (``inputs[..., -2:-1]``) and property (``inputs[..., -1:]``)
  channels, or with ``hard_enforcement_only`` the HardLayer alone on the
  mean of the last two channels (the reference's ``:44-64``).
* :class:`PVTModuleWithHardLayer` — a PVT with an optional HardLayer on
  its input (``:67-83``).
* :func:`build_model_map` — Model 1 (pressure: encoder–decoder +
  HardLayer), Model 2 (adaptive Δt: residual net with the scaled x·tanh(x)
  head), Model 3 (the PVT: spline, or the trainable polynomial with
  ``pvt_fitting_method="polynomial"``), the well rate/BHP model and, for gas
  condensate, Model 1S (saturation: encoder–decoder + HardLayer at Sgi),
  keyed by the reference's logical names. The trainable modules are
  initialized from an explicit ``torch.Generator`` and moved to ``device``.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from srm_tpu_torch.config import (DEFAULT_GENERAL_CONFIG, DEFAULT_RESERVOIR_CONFIG,
                                  DEFAULT_SCAL_CONFIG, get_configuration)
from srm_tpu_torch.data.pvt_table import load_pvt_table
from srm_tpu_torch.nn.common import scaled_tanh_lisht
from srm_tpu_torch.nn.encoder_decoder import EncoderDecoder
from srm_tpu_torch.nn.hard_layer import HardLayer
from srm_tpu_torch.nn.residual import ResidualNetwork
from srm_tpu_torch.physics.pvt import make_pvt_layer, properties_for
from srm_tpu_torch.physics.well_solver import WellRatesPressure


class CompleteTrainableModule(nn.Module):
    """Backbone + optional HardLayer (srm_tpu/nn/modules.py:44-64)."""

    def __init__(self, network: Optional[nn.Module] = None,
                 hard_layer: Optional[HardLayer] = None,
                 time_slice: Tuple[int, Optional[int]] = (-2, -1),
                 property_slice: Tuple[int, Optional[int]] = (-1, None),
                 hard_enforcement_only: bool = False):
        super().__init__()
        self.network = network
        self.hard_layer = hard_layer
        self.time_slice = tuple(time_slice)
        self.property_slice = tuple(property_slice)
        self.hard_enforcement_only = hard_enforcement_only

    def forward(self, inputs: torch.Tensor, rectifier_input: Optional[torch.Tensor] = None,
                training: bool = False, rows=None) -> torch.Tensor:
        """``rows``: on a mesh's space axis, the layout of the input's H
        (``parallel/halo.py``); the network and the HardLayer's per-cell
        exponent take this rank's rows."""
        if self.hard_enforcement_only:
            net_out = inputs[..., -2:].mean(dim=-1, keepdim=True)
        else:
            extra = {} if rows is None else {"rows": rows}
            net_out = self.network(inputs, training=training, **extra)
            if self.hard_layer is None:
                return net_out
        t = inputs[..., slice(*self.time_slice)]
        prop = inputs[..., slice(*self.property_slice)]
        return self.hard_layer(t, prop, net_out, rect_input=rectifier_input, rows=rows)


class PVTModuleWithHardLayer(nn.Module):
    """Optional HardLayer + PVT (srm_tpu/nn/modules.py:67-83); the HardLayer
    takes the whole input as its network output."""

    def __init__(self, pvt_layer: nn.Module, hard_layer: Optional[HardLayer] = None,
                 use_hard_layer: bool = False,
                 time_slice: Tuple[int, Optional[int]] = (-2, -1),
                 property_slice: Tuple[int, Optional[int]] = (-1, None)):
        super().__init__()
        self.pvt_layer = pvt_layer
        self.hard_layer = hard_layer
        self.use_hard_layer = use_hard_layer
        self.time_slice = tuple(time_slice)
        self.property_slice = tuple(property_slice)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        p = inputs
        if self.use_hard_layer and self.hard_layer is not None:
            t = inputs[..., slice(*self.time_slice)]
            prop = inputs[..., slice(*self.property_slice)]
            p = self.hard_layer(t, prop, inputs)
        return self.pvt_layer(p)


def _encoder_decoder_config(general_config: Dict, reservoir_config: Dict) -> Dict:
    """The encoder–decoder of Models 1 and 1S: 2D or, for ``Nz > 1``, 3D,
    two extra convolutions on each side, one linear latent layer, no skip
    connections (srm_tpu/nn/modules.py:96-117, :152-165)."""
    ed = get_configuration("encoder_decoder")
    ed["spatial_dims"] = 3 if reservoir_config.get("Nz", 1) > 1 else 2
    ed["temporal"] = True
    rp = ed["residual_params"]
    rp["Extra_Conv_Layers"]["Count"] = 2
    rp["Extra_Dec_Conv_Layers"]["Count"] = 2
    rp["Latent_Layer"]["Depth"] = 1
    rp["Latent_Layer"]["Activation"] = None
    rp["Out_Activation_Func"] = None
    rp["Skip_Connections"] = {"Add": False, "Layers": [1, 1, 1, 1]}
    # H/W alignment padding, and the channels of Models 1 and 1S only
    # (srm_tpu/nn/modules.py:115-117, :163-165)
    ed["spatial_pad_to"] = general_config.get("spatial_pad_to")
    if general_config.get("network_width"):
        ed["width"]["Bottom_Size"] = int(general_config["network_width"])
    # bf16 network compute with float32 params; "mixed" keeps the input conv
    # and the output head in float32 (srm_tpu/nn/modules.py:113-114)
    ed["compute_dtype"] = general_config.get("compute_dtype")
    ed["f32_io"] = general_config.get("precision_policy") == "mixed"
    return ed


def _hard_trainable(ed: Dict, hard: Dict, sample_shape: Tuple[int, ...],
                    generator: Optional[torch.Generator]) -> CompleteTrainableModule:
    if len(sample_shape) != ed["spatial_dims"] + 2:
        raise ValueError(f"sample shape {tuple(sample_shape)} does not fit a "
                         f"{ed['spatial_dims']}D grid")
    hard["kernel_activation"] = None
    hard["kernel_exponent_config"].update(initial_value=0.5, min_value=0.1, max_value=1.0)
    # the HardLayer's exponent is per cell: (T, H, W, 1) or (1, D, H, W, 1)
    return CompleteTrainableModule(
        EncoderDecoder.from_config(ed, in_channels=sample_shape[-1], generator=generator,
                                   grid=sample_shape[-1 - ed["spatial_dims"]:-1]),
        HardLayer.from_config(hard, exp_shape=tuple(sample_shape[:-1]) + (1,)))


def build_pressure_model(sample_shape: Tuple[int, ...], general_config: Optional[Dict] = None,
                         reservoir_config: Optional[Dict] = None,
                         generator: Optional[torch.Generator] = None) -> CompleteTrainableModule:
    """Model 1: temporal encoder–decoder + HardLayer (init value Pi), over
    (H, W) or, for ``Nz > 1``, over (D, H, W) with the leading singleton as
    the temporal axis (srm_tpu/nn/modules.py:89-130). ``sample_shape`` is
    one model input without the batch axis, (T, H, W, C) or (1, D, H, W, C).
    The network raises ``ValueError`` on a grid that its encoder collapses
    (Nz < 9)."""
    g = general_config or DEFAULT_GENERAL_CONFIG
    res = reservoir_config or DEFAULT_RESERVOIR_CONFIG
    hard = get_configuration("hard_layer")
    hard["init_value"] = res["initialization"]["Pi"]
    return _hard_trainable(_encoder_decoder_config(g, res), hard, sample_shape, generator)


def build_saturation_model(sample_shape: Tuple[int, ...], general_config: Optional[Dict] = None,
                           reservoir_config: Optional[Dict] = None,
                           scal_config: Optional[Dict] = None,
                           generator: Optional[torch.Generator] = None
                           ) -> CompleteTrainableModule:
    """Model 1S, the gas-condensate saturation network: Model 1's
    encoder–decoder under a HardLayer whose initial value is Sgi = 1 − Swmin
    and whose departure ``Sgi − α·act(net)`` goes through softplus, or
    through ``general_config["sat_input_activation"]`` (e.g. "abs") when set
    (srm_tpu/nn/modules.py:133-182)."""
    g = general_config or DEFAULT_GENERAL_CONFIG
    res = reservoir_config or DEFAULT_RESERVOIR_CONFIG
    scal = scal_config or DEFAULT_SCAL_CONFIG
    hard = get_configuration("hard_layer")
    hard["init_value"] = 1.0 - scal["end_points"]["Swmin"]
    hard["input_activation"] = g.get("sat_input_activation") or "softplus"
    return _hard_trainable(_encoder_decoder_config(g, res), hard, sample_shape, generator)


def build_time_step_model(sample_shape: Tuple[int, ...], general_config: Optional[Dict] = None,
                          generator: Optional[torch.Generator] = None
                          ) -> CompleteTrainableModule:
    """Model 2: residual net with the scaled x·tanh(x) Δt head in
    (0.1, maximum_srm_timestep]; ``cnn`` on (T, H, W, C) samples, ``cnn3d``
    on (1, D, H, W, C) samples (srm_tpu/nn/modules.py:185-209)."""
    g = general_config or DEFAULT_GENERAL_CONFIG
    cfg = get_configuration("residual")
    cfg["network_type"] = "cnn3d" if len(sample_shape) == 5 else "cnn"
    cfg["temporal"] = True
    cfg["output_distribution"] = False
    cfg["output_activation"] = partial(scaled_tanh_lisht, min_val=0.1,
                                       max_val=g["maximum_srm_timestep"])
    cfg["compute_dtype"] = g.get("compute_dtype")
    cfg["spatial_pad_to"] = g.get("spatial_pad_to")
    return CompleteTrainableModule(
        ResidualNetwork.from_config(cfg, in_channels=sample_shape[-1], generator=generator))


def build_pvt_model(fluid_type: str = "DG", general_config: Optional[Dict] = None) -> nn.Module:
    """Model 3: the PVT of the fluid's properties (two for dry gas, seven
    for gas condensate) on Model 1's pressure: the spline PVT of order 1, as
    the reference's ``build_pvt_model`` sets it, or with
    ``pvt_fitting_method="polynomial"`` the trainable polynomial PVT from
    the config's default coefficients (srm_tpu/nn/modules.py:212-225)."""
    g = general_config or DEFAULT_GENERAL_CONFIG
    cfg = get_configuration("pvt_layer", fluid_type=fluid_type)
    cfg["fitting_method"] = (g.get("pvt_fitting_method") or "spline").lower()
    table = load_pvt_table() if cfg["fitting_method"] == "spline" else None
    return make_pvt_layer(cfg, table, properties=properties_for(fluid_type), order=1)


def build_model_map(input_shape: Tuple[int, ...], device: torch.device,
                    fluid_type: Optional[str] = None, seed: Optional[int] = None,
                    general_config: Optional[Dict] = None,
                    reservoir_config: Optional[Dict] = None,
                    wells_config: Optional[Dict] = None,
                    data_summary=None,
                    well_solver_kwargs: Optional[Dict] = None) -> Dict[str, Any]:
    """All models keyed by the reference's logical names: 'pressure',
    'time_step', 'pvt_model', 'well_rate_bhp_model' and, for gas condensate,
    'saturation_model'. ``well_solver_kwargs`` pass through to
    ``WellRatesPressure`` (``use_non_iterative=False`` for the Newton BHP,
    ``use_blocking_factor=True`` for the blocking integral; both
    differentiable, so they may sit inside the training loss), as in
    ``srm_tpu/nn/modules.py:271-274``.

    ``input_shape`` is the training-data shape: (K, T, 1, H, W, C) in 2D,
    where a model input (B, 1, H, W, C) folds the singleton as its temporal
    axis, or (K, T, 1, D, H, W, C) in 3D, where a model input is
    (B, 1, D, H, W, C)."""
    g = general_config or DEFAULT_GENERAL_CONFIG
    fluid_type = (fluid_type or g["fluid_type"]).upper()
    res = reservoir_config or DEFAULT_RESERVOIR_CONFIG
    gen = torch.Generator().manual_seed(int(g["seed"] if seed is None else seed))
    sample_shape = tuple(input_shape[2:])
    models = {
        "pressure": build_pressure_model(sample_shape, g, res, gen).to(device),
        "time_step": build_time_step_model(sample_shape, g, gen).to(device),
        "pvt_model": build_pvt_model(fluid_type, g).to(device),
        "well_rate_bhp_model": WellRatesPressure(
            data_summary, device, fluid_type=fluid_type, general_config=g,
            reservoir_config=res, wells_config=wells_config, **(well_solver_kwargs or {})),
    }
    if fluid_type == "GC":
        models["saturation_model"] = build_saturation_model(sample_shape, g, res,
                                                            generator=gen).to(device)
    return models
