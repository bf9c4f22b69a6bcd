"""Default configurations of the port.

The port's own copy of ``srm_tpu/config/defaults.py``, with the same names
and values: general/run settings, reservoir description, wells, network
architectures, hard layer, input slicing, PVT (DG/GC), SCAL, the
simulation-data pipeline, per-role optimizers, optimizer→model maps,
field-unit conversion constants and the md5 config hash that keys the
dataset caches. The port imports nothing of the JAX package, so it keeps
this copy; ``tests/test_torch_config.py`` holds the two equal, and while
their ``generate_full_config_hash`` agree the two packages share one
dataset cache.

One difference: :func:`load_spline_data` returns the port's PVT table
(``srm_tpu_torch.data.pvt_table.load_pvt_table``, column name → vector)
rather than the JAX package's ``DataSummary``.

All values are plain Python so that configs remain hashable and
serializable; accessors return deep copies so that call-site mutation never
aliases the defaults.
"""

from __future__ import annotations

import copy
import hashlib
import json
import os
from typing import Any, Dict, Optional

import numpy as np

# Working directory for dataset caches: the repository's _srm_data/ (the
# JAX package's default too), overridable by environment variable.
WORKING_DIRECTORY = os.environ.get(
    "SRM_TPU_WORKING_DIRECTORY",
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "_srm_data"),
)

# --------------------------------------------------------------------------
# General settings
# --------------------------------------------------------------------------
DEFAULT_GENERAL_CONFIG: Dict[str, Any] = {
    "save_compressed": False,
    "load_compressed": False,
    "seed": 2000,
    "dtype": "float32",
    # Network compute precision ("bfloat16" keeps params in f32);
    # "precision_policy": "mixed" keeps the input conv and output head of
    # each encoder-decoder in f32. Neither is ported yet.
    "compute_dtype": None,
    "precision_policy": None,
    "training_batch_size": 32,
    "testing_batch_size": 64,
    "unit_target_shape": (1, 1, 39, 39, 1),
    # Time stepping
    "srm_start_time": 0.0,
    "srm_end_time": 365.0,
    "cfd_start_time": 0.0,
    "cfd_end_time": 540.0,
    "srm_timestep": 5.0,
    "cfd_timestep": 1.0,
    "maximum_srm_timestep": 10.0,
    "minimum_srm_timestep": 0.1,
    "maximum_cfd_timestep": 1.0,
    "minimum_cfd_timestep": 1.0,
    # Normalization
    "data_normalization": {
        "feature_normalization_method": "lnk-linear-scaling",
        "normalization_limits": [-1.0, 1.0],
        "save_stats": True,
    },
    # Splits: axis 0 = permeability realizations, axis 1 = time
    "split_keys": ["train", "val", "test"],
    "split_axis": [0, 1],
    "split_ratio": {0: (0.3, 0.0, 0.7), 1: (0.7, 0.0, 0.3)},
    "split_sampling_method": "random",
    # Physics / data mode
    "physics_mode_fraction": 1.0,
    # td (training-data) error scaling: None (raw), "balance" (rescale the
    # 2nd+ labels' errors to the 1st label's batch std) or "label_std"
    # (pure relative errors)
    "td_loss_normalization": None,
    # GC dropout-focus weighting for the Sg td error: beta >= 0
    "sg_td_focus": None,
    # Debug: log per-loss-term gradient L2 norms per model at watched epochs
    "log_term_grad_norms": False,
    # Fluid
    "fluid_type": "DG",
    "above_dew_point": True,
    "pvt_fitting_method": "spline",
    # Loss weights per phase
    "default_weights": {
        "gas": {"dom": 1.0, "ibc": 1.0, "obc": 0.0, "ic": 0.0, "td": 0.0, "mbc": 1.0, "cmbc": 0.0, "tde": 1.0},
        "oil": {"dom": 1.0, "ibc": 1.0, "obc": 0.0, "ic": 0.0, "td": 0.0, "mbc": 1.0, "cmbc": 0.0, "tde": 1.0},
    },
    "srm_units": "field",
}

# The JAX package's production profile for its TPU (bf16 networks, a 2x
# strided Δt input, batch 128 with a batch-scaled LR decay). Its measured
# effects are the JAX package's, on its hardware; the port's are in PERF.md.
TPU_PRODUCTION_OVERRIDES: Dict[str, Any] = {
    "compute_dtype": "bfloat16",
    "dt_input_stride": 2,
    "training_batch_size": 128,
}

# The production LR decay: one decay period every ~8000 samples
# (250 steps at batch 32).
PRODUCTION_DECAY_SAMPLES = 8000
PRODUCTION_DECAY_STEPS = 250        # the b32 form


def production_decay_steps(batch_size: Optional[int] = None) -> int:
    """LR-decay transition steps for the production schedule at a given
    batch size (the ~8000-sample decay period, batch-invariant)."""
    b = int(batch_size
            or TPU_PRODUCTION_OVERRIDES.get("training_batch_size", 32))
    return max(1, round(PRODUCTION_DECAY_SAMPLES / b))


def apply_production_overrides(general_config: Dict[str, Any]) -> Dict[str, Any]:
    """Return a copy of ``general_config`` with the production settings
    applied (a value that differs from the DEFAULT_GENERAL_CONFIG default is
    left alone)."""
    out = copy.deepcopy(general_config)
    for k, v in TPU_PRODUCTION_OVERRIDES.items():
        cur = out.get(k)
        if cur in (None, False) or cur == DEFAULT_GENERAL_CONFIG.get(k):
            out[k] = v
    return out


# The GC below-dew-point (drawdown) recipe: mixed physics/data training on
# FV-simulator labels, balanced td errors and the 'abs' saturation-departure
# rectifier (``train --drawdown``).
GC_DRAWDOWN_OVERRIDES: Dict[str, Any] = {
    "fluid_type": "GC",
    "label_source": "simulator",
    "physics_mode_fraction": 0.5,
    "td_loss_normalization": "balance",
    "sat_input_activation": "abs",
}

# Case geometry for the recipe: the shipped defaults (Pi=5000 psia,
# minimum_bhp=4100) never cross the 4048.4-psia dew point; these make
# condensate dropout reachable. Pass to ``setup_case(..., pi=..., min_bhp=...)``.
GC_DRAWDOWN_CASE: Dict[str, float] = {"pi": 4300.0, "min_bhp": 2000.0}

# The GC drawdown recipe shares the production schedule.
GC_DRAWDOWN_DECAY_STEPS = PRODUCTION_DECAY_STEPS


def apply_drawdown_overrides(general_config: Dict[str, Any]) -> Dict[str, Any]:
    """Return a copy of ``general_config`` with the GC drawdown recipe
    applied (these always win: the preset is the recipe)."""
    out = copy.deepcopy(general_config)
    out.update(GC_DRAWDOWN_OVERRIDES)
    return out


def production_optimizer_configs(decay_steps: int = None,
                                 batch_size: int = None) -> Dict[str, Dict[str, Any]]:
    """Optimizer configs with the retuned LR decay applied to every decaying
    schedule: ``decay_steps`` if given, else the ~8000-sample period scaled
    to ``batch_size`` (default: the production batch)."""
    steps = int(production_decay_steps(batch_size)
                if decay_steps is None else decay_steps)
    cfgs = copy.deepcopy(DEFAULT_OPTIMIZER_CONFIGS)
    for cfg in cfgs.values():
        lr = cfg.get("exponential_decay", {}).get("learning_rate")
        if lr and lr.get("enabled"):
            lr["decay_steps"] = steps
    return cfgs


def drawdown_optimizer_configs() -> Dict[str, Dict[str, Any]]:
    """Optimizer configs for the GC drawdown recipe (the production
    schedule)."""
    return production_optimizer_configs(GC_DRAWDOWN_DECAY_STEPS)

# --------------------------------------------------------------------------
# Reservoir
# --------------------------------------------------------------------------
DEFAULT_RESERVOIR_CONFIG: Dict[str, Any] = {
    "porosity": 0.2,
    "permx": 3.0,
    "horizontal_anisotropy": 1.0,
    "vertical_anisotropy": 1.0,
    "depth": 11000.0,
    "length": 2900.0,
    "width": 2900.0,
    "thickness": 80.0,
    "Nx": 39,
    "Ny": 39,
    "Nz": 1,
    "initialization": {"Pi": 5000.0, "Pa": 1000.0},
    "realizations": {
        "permx": {
            "number": 200,
            "mean": 3.0,
            "std": 1.5,
            "method": "KLE",
            "correlation_length_factor": 0.2,
            "energy_threshold": 0.95,
            "seed": None,
            "reverse_order": True,
            "conditional_values": {
                (29, 29, 0): 2.0,
                (29, 9, 0): 1.5,
                (9, 9, 0): 1.0,
                (9, 29, 0): 0.5,
            },
        },
        "poro": None,
    },
}

# --------------------------------------------------------------------------
# Wells. shutin windows with start>end mean "never shut".
# --------------------------------------------------------------------------
DEFAULT_WELLS_CONFIG: Dict[str, Any] = {
    "connections": [
        {"name": "P1", "i": 29, "j": 29, "k": 0, "type": "producer", "control": "ORAT", "value": 500.0,
         "minimum_bhp": 4100.0, "wellbore_radius": 0.09525, "completion_ratio": 0.5, "shutin_days": [[1000.0, 0.0]]},
        {"name": "P2", "i": 29, "j": 9, "k": 0, "type": "producer", "control": "ORAT", "value": 1000.0,
         "minimum_bhp": 4100.0, "wellbore_radius": 0.09525, "completion_ratio": 0.5, "shutin_days": [[1000.0, 0.0]]},
        {"name": "P3", "i": 9, "j": 9, "k": 0, "type": "producer", "control": "ORAT", "value": 500.0,
         "minimum_bhp": 4100.0, "wellbore_radius": 0.09525, "completion_ratio": 0.5, "shutin_days": [[1000.0, 0.0]]},
        {"name": "P4", "i": 9, "j": 29, "k": 0, "type": "producer", "control": "ORAT", "value": 1000.0,
         "minimum_bhp": 4100.0, "wellbore_radius": 0.09525, "completion_ratio": 0.5, "shutin_days": [[1000.0, 0.0]]},
        {"name": "I1", "i": 19, "j": 19, "k": 0, "type": "injector", "control": "ORAT", "value": 0.0,
         "minimum_bhp": 4100.0, "wellbore_radius": 0.09525, "completion_ratio": 0.5, "shutin_days": [[1000.0, 0.0]]},
    ],
}

# --------------------------------------------------------------------------
# Networks
# --------------------------------------------------------------------------
DEFAULT_ENCODER_DECODER_CONFIG: Dict[str, Any] = {
    "depth": 4,
    "width": {"Bottom_Size": 32, "Growth_Rate": 1.5},
    "spatial_dims": 2,
    "temporal": False,
    "output_filters": 1,
    "residual_params": {
        "Kernel_Size": 3,
        "Kernel_Init": "glorot_normal",
        "Activation_Func": "swish",
        "Out_Activation_Func": None,
        "Dropout": {"Add": False, "Rate": 0.2, "Layer": [1, 0, 0, 0]},
        "Skip_Connections": {"Add": True, "Layers": [1, 1, 1, 1]},
        "Decoder_Filter_Fac": 1.0,
        "Latent_Layer": {"Flatten": False, "Depth": 1, "Width": 128, "Activation": None},
        "Extra_Conv_Layers": {"Count": 2},
        "Extra_Dec_Conv_Layers": {"Count": 2},
    },
}

DEFAULT_ENCODER_DECODER_3D_CONFIG: Dict[str, Any] = copy.deepcopy(DEFAULT_ENCODER_DECODER_CONFIG)
DEFAULT_ENCODER_DECODER_3D_CONFIG["spatial_dims"] = 3

DEFAULT_RESIDUAL_NETWORK_CONFIG: Dict[str, Any] = {
    "num_blocks": 4,
    "filters": 32,
    "kernel_size": 3,
    "hidden_activation": "swish",
    "output_activation": None,
    "output_filters": 1,
    "kernel_initializer": "glorot_normal",
    "network_type": "cnn",
    "use_batch_norm": False,
    "dropout_rate": 0.0,
    "output_distribution": True,
    "number_of_output_bins": 50,
}

DEFAULT_HARD_LAYER_CONFIG: Dict[str, Any] = {
    "norm_limits": [-1.0, 1.0],
    "init_value": 1.0,
    "kernel_activation": None,
    "input_activation": None,
    "kernel_exponent_config": {
        "initial_value": 0.5,
        "trainable": True,
        "min_value": 0.1,
        "max_value": 0.99,
    },
    "use_rbf": False,
    "regularization": 0.001,
    "rectifier": None,
}

# Channel slices into the woven feature tensor [..., (z,y,x,t,k)]
DEFAULT_INPUT_SLICE_CONFIG: Dict[str, Any] = {
    "encoder_decoder": slice(None),
    "residual_network": slice(None),
    "hard_layer": {"time": slice(-2, -1), "property": slice(-1, None)},
}

# --------------------------------------------------------------------------
# PVT / SCAL
# --------------------------------------------------------------------------
DEFAULT_PVT_DG_CONFIG: Dict[str, Any] = {
    "fluid_type": "DG",
    "fitting_method": "polynomial",
    "polynomial_config": {
        "invBg": [1.0, 0.1, 0.01],
        "invug": [0.5, 0.05, 0.005],
    },
    "spline_order": 2,
    "regularization_weight": 0.001,
    "min_input_threshold": 14.7,
    "max_input_threshold": 10000.0,
}

DEFAULT_PVT_GC_CONFIG: Dict[str, Any] = {
    "fluid_type": "GC",
    "fitting_method": "polynomial",
    "polynomial_config": {
        "invBg": [1.0, 0.1, 0.01],
        "invBo": [1.2, 0.12, 0.012],
        "invug": [0.5, 0.05, 0.005],
        "invuo": [0.6, 0.06, 0.006],
        "Rs": [0.7, 0.07, 0.007],
        "Rv": [0.8, 0.08, 0.008],
        "Vro": [0.9, 0.09, 0.009],
    },
    "spline_order": 2,
    "regularization_weight": 0.001,
    "min_input_threshold": 14.7,
    "max_input_threshold": 10000.0,
    "dew_point": 4048.4,
}

DEFAULT_SCAL_CONFIG: Dict[str, Any] = {
    "end_points": {"kro_Somax": 0.90, "krg_Sorg": 0.80, "krg_Swmin": 0.90, "Swmin": 0.22,
                   "Sorg": 0.2, "Sgc": 0.05, "Socr": 0.2, "So_max": 0.28},
    "corey_exponents": {"nog": 3.0, "ng": 6.0, "nw": 2.0},
    "blocking_factor": {"number_of_intervals": 5, "number_of_iterations": 5},
}

DEFAULT_PVT_MODULE_CONFIG: Dict[str, Any] = {
    "use_hard_layer": True,
    "hard_layer_config": copy.deepcopy(DEFAULT_HARD_LAYER_CONFIG),
    "pvt_layer_config": copy.deepcopy(DEFAULT_PVT_DG_CONFIG),
    "input_slice_config": copy.deepcopy(DEFAULT_INPUT_SLICE_CONFIG),
}

# --------------------------------------------------------------------------
# Simulation-output processing pipeline
# --------------------------------------------------------------------------
DEFAULT_SIMDATA_PROCESS_CONFIG: Dict[str, Any] = {
    "simulation_pipeline": {
        "enabled": True,
        "parallel": False,
        "max_workers": 4,
        "save_results": True,
        "combine": True,
        "flatten": True,
        "stack_realizations": True,
        "combined_filename": "combined_results.npz",
        "file_vectors": {
            ".FINIT": ["PERMX", "PERMZ", "PORO"],
            ".FUNRST": ["PRESSURE", "SOIL", "SGAS"],
            ".RSM": [["TIME"], ["WOPR", "15 15 1"], "WGPR", "WWPR", "WBHP"],
        },
        "shape": (39, 39, 1),
    },
    "array_pipeline": {
        "enabled": True,
        "ext": ".npz",
        "file": None,
        "keys": ["PRESSURE", "SGAS"],
        "exclusions": ["PERMX", "PERMY", "PERMZ", "PORO"],
        "slice_dim": 1,
        "reshape_dims": (0,),
        "dtype": "float32",
    },
}

# --------------------------------------------------------------------------
# Optimizers per logical role
# --------------------------------------------------------------------------
DEFAULT_OPTIMIZER_CONFIGS: Dict[str, Any] = {
    "pressure": {
        "type": "adamw", "learning_rate": 0.005, "beta_1": 0.9, "beta_2": 0.999,
        "weight_decay": 0.00005, "trainable": True,
        "exponential_decay": {
            "enabled": True,
            "learning_rate": {"enabled": True, "decay_steps": 25, "decay_rate": 0.90},
            "weight_decay": {"enabled": True, "decay_rate": 0.90},
            "staircase": False,
        },
    },
    "time_step": {
        "type": "adam", "learning_rate": 0.0001, "beta_1": 0.9, "beta_2": 0.999,
        "weight_decay": 0.00001, "trainable": True,
        "exponential_decay": {
            "enabled": True,
            "learning_rate": {"enabled": True, "decay_steps": 25, "decay_rate": 0.90},
            "weight_decay": {"enabled": False, "decay_rate": 0.90},
            "staircase": False,
        },
    },
    "fluid_property": {
        "type": "adamw", "learning_rate": 0.0005, "beta_1": 0.9, "beta_2": 0.999,
        "weight_decay": 0.0005, "trainable": False,
        "exponential_decay": {
            "enabled": False,
            "learning_rate": {"enabled": False, "decay_steps": 100, "decay_rate": 0.96},
            "weight_decay": {"enabled": False, "decay_rate": 0.98},
            "staircase": False,
        },
    },
    "well_rate_bhp": {
        "type": "adamw", "learning_rate": 0.0005, "beta_1": 0.9, "beta_2": 0.999,
        "weight_decay": 0.0005, "trainable": False,
        "exponential_decay": {
            "enabled": False,
            "learning_rate": {"enabled": False, "decay_steps": 100, "decay_rate": 0.96},
            "weight_decay": {"enabled": False, "decay_rate": 0.98},
            "staircase": False,
        },
    },
    "saturation": {
        "type": "adamw", "learning_rate": 0.0005, "beta_1": 0.9, "beta_2": 0.999,
        "weight_decay": 0.0005, "trainable": True,
        "exponential_decay": {
            "enabled": True,
            "learning_rate": {"enabled": True, "decay_steps": 100, "decay_rate": 0.96},
            "weight_decay": {"enabled": False, "decay_rate": 0.98},
            "staircase": False,
        },
    },
}

DEFAULT_OPTIMIZER_MODEL_MAPPING_DG: Dict[str, str] = {
    "pressure": "encoder_decoder",
    "time_step": "residual_network",
    "fluid_property": "pvt_model",
    "well_rate_bhp": "well_rate_bhp_model",
}

DEFAULT_OPTIMIZER_MODEL_MAPPING_GC: Dict[str, str] = {
    **DEFAULT_OPTIMIZER_MODEL_MAPPING_DG,
    "saturation": "saturation_model",
}

# Field-unit conversion constants
DEFAULT_CONVERSION_CONSTANTS: Dict[str, Dict[str, float]] = {
    "field": {"C": 0.001127, "D": 5.6145833334},
}


# --------------------------------------------------------------------------
# Accessors
# --------------------------------------------------------------------------
def get_optimizer_config(name: str) -> Optional[Dict[str, Any]]:
    cfg = DEFAULT_OPTIMIZER_CONFIGS.get(name)
    return copy.deepcopy(cfg) if cfg is not None else None


def get_conversion_constants(name: str) -> Optional[Dict[str, float]]:
    cfg = DEFAULT_CONVERSION_CONSTANTS.get(name)
    return copy.deepcopy(cfg) if cfg is not None else None


def get_optimizer_model_mapping(fluid_type: Optional[str] = None) -> Dict[str, str]:
    """Optimizer-role → logical model name."""
    if fluid_type is None:
        fluid_type = DEFAULT_GENERAL_CONFIG.get("fluid_type", "DG")
    if fluid_type == "GC":
        return dict(DEFAULT_OPTIMIZER_MODEL_MAPPING_GC)
    return dict(DEFAULT_OPTIMIZER_MODEL_MAPPING_DG)


def get_configuration(config_type: str, input_shape=None, use_rbf: bool = False,
                      fluid_type: Optional[str] = None,
                      fitting_method: Optional[str] = None) -> Dict[str, Any]:
    """Configuration dispatcher.

    'encoder_decoder' auto-selects the 3D variant when the depth axis of
    ``input_shape`` exceeds 1. 'pvt_layer' with fitting_method='spline'
    attaches the bundled PVT table as the spline knot source.
    """
    ct = config_type.lower()
    if ct == "encoder_decoder":
        if input_shape and len(input_shape) >= 4 and input_shape[-3] > 1:
            return copy.deepcopy(DEFAULT_ENCODER_DECODER_3D_CONFIG)
        return copy.deepcopy(DEFAULT_ENCODER_DECODER_CONFIG)
    if ct == "residual":
        return copy.deepcopy(DEFAULT_RESIDUAL_NETWORK_CONFIG)
    if ct == "hard_layer":
        return copy.deepcopy(DEFAULT_HARD_LAYER_CONFIG)
    if ct == "input_slice":
        return copy.deepcopy(DEFAULT_INPUT_SLICE_CONFIG)
    if ct == "pvt_layer":
        if fluid_type and fluid_type.upper() == "GC":
            cfg = copy.deepcopy(DEFAULT_PVT_GC_CONFIG)
        else:
            cfg = copy.deepcopy(DEFAULT_PVT_DG_CONFIG)
        if fitting_method:
            cfg["fitting_method"] = fitting_method.lower()
            if fitting_method.lower() == "spline":
                spline = load_spline_data()
                if spline is not None:
                    cfg["spline_config"] = spline
                else:
                    cfg["fitting_method"] = "polynomial"
        return cfg
    if ct == "pvt_module":
        cfg = copy.deepcopy(DEFAULT_PVT_MODULE_CONFIG)
        cfg["pvt_layer_config"] = get_configuration("pvt_layer", fluid_type=fluid_type,
                                                    fitting_method=fitting_method)
        cfg["hard_layer_config"] = get_configuration("hard_layer", use_rbf=use_rbf)
        return cfg
    raise ValueError(
        f"Unknown configuration type: {config_type}. Valid types: encoder_decoder, "
        f"residual, hard_layer, input_slice, pvt_layer, pvt_module")


def load_spline_data():
    """The bundled PVT table (37 rows of [Pre, InvBg, InvBo, Invug, Invuo,
    Rs, Rv, InvBgd, Invugd, Vro]) as column name (lowercased) → vector, or
    None if it cannot be read."""
    from srm_tpu_torch.data.pvt_table import load_pvt_table
    try:
        return load_pvt_table()
    except OSError:
        return None


# --------------------------------------------------------------------------
# Config-hash identity
# --------------------------------------------------------------------------
def flatten_dict(d: Dict[str, Any], parent_key: str = "", sep: str = ".") -> Dict[str, Any]:
    """Flatten a nested dict into dotted keys; tuple keys are stringified."""
    items = {}
    for k, v in d.items():
        key = f"{parent_key}{sep}{k}" if parent_key else str(k)
        if isinstance(v, dict):
            items.update(flatten_dict({str(kk): vv for kk, vv in v.items()}, key, sep))
        else:
            items[key] = v
    return items


def _jsonable(v: Any) -> Any:
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if isinstance(v, (tuple, set)):
        return list(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, slice):
        return [v.start, v.stop, v.step]
    return v


def generate_full_config_hash(general_config: Optional[Dict] = None,
                              reservoir_config: Optional[Dict] = None,
                              wells_config: Optional[Dict] = None,
                              pvt_config: Optional[Dict] = None,
                              scal_config: Optional[Dict] = None) -> tuple[str, str]:
    """(readable_name, md5[:16]) identity over the physics-relevant configs:
    any change to time settings, reservoir description, wells, PVT or SCAL
    invalidates the dataset caches by construction."""
    general_config = general_config or DEFAULT_GENERAL_CONFIG
    reservoir_config = reservoir_config or DEFAULT_RESERVOIR_CONFIG
    wells_config = wells_config or DEFAULT_WELLS_CONFIG
    pvt_config = pvt_config or (DEFAULT_PVT_GC_CONFIG if general_config.get("fluid_type") == "GC"
                                else DEFAULT_PVT_DG_CONFIG)
    scal_config = scal_config or DEFAULT_SCAL_CONFIG

    time_keys = ["srm_start_time", "srm_end_time", "srm_timestep", "maximum_srm_timestep",
                 "minimum_srm_timestep", "split_ratio", "split_keys", "seed",
                 # label provenance changes the processed dataset contents
                 "label_source", "physics_mode_fraction"]
    payload = {
        "time": {k: general_config.get(k) for k in time_keys},
        "reservoir": reservoir_config,
        "wells": wells_config,
        "pvt": {k: v for k, v in pvt_config.items() if k != "spline_config"},
        "scal": scal_config,
    }
    flat = flatten_dict(payload)
    flat = {k: _jsonable(v) for k, v in sorted(flat.items())}
    blob = json.dumps(flat, sort_keys=True, default=str)
    h = hashlib.md5(blob.encode("utf-8")).hexdigest()[:16]
    res = reservoir_config
    name = f"KLE_{res['Nx']}x{res['Ny']}x{res['Nz']}_R{res['realizations']['permx']['number']}"
    return name, h
