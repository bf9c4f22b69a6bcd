"""Case construction for the training entry points.

Port of ``srm_tpu/examples/common.py::setup_case`` for dry gas ("DG") and
gas condensate ("GC"): the data processor, the generated or cached
physics-mode dataset, its statistics, the model map on ``device`` and the
PhysicsLoss, as one dict bundle. ``nx``, ``nz`` and ``n_realizations``
resize the problem, and ``kle_method="uncorrelated"`` selects iid log-normal
permeability fields, as in the reference; ``nz > 1`` gives the 3D
(7-point) dry-gas case, which needs ``nz >= 9`` at the default encoder depth
(``EncoderDecoder``). ``pi`` and ``min_bhp`` set the initial pressure and
the wells' BHP floor (the reference's drawdown scenarios); both enter the
config hash.

The case runs on the GPU: ``device=None`` means ``"cuda"``, and without a
usable CUDA device the call raises. Pass ``device="cpu"`` to run on the CPU.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import torch

from srm_tpu_torch.config import DEFAULT_GENERAL_CONFIG, get_optimizer_model_mapping
from srm_tpu_torch.data.dataset import SRMDataProcessor
from srm_tpu_torch.losses.physics_loss import PhysicsLoss
from srm_tpu_torch.nn.modules import build_model_map
from srm_tpu_torch.utils.stats import DataSummary


def setup_case(fluid_type: str, base_dir: Optional[str] = None,
               nx: Optional[int] = None, n_realizations: Optional[int] = None,
               general_config: Optional[Dict] = None, seed: Optional[int] = None,
               nz: Optional[int] = None, kle_method: Optional[str] = None,
               pi: Optional[float] = None, min_bhp: Optional[float] = None,
               device: Optional[torch.device] = None) -> Dict:
    """Build everything for one training case; returns a dict bundle."""
    fluid_type = fluid_type.upper()
    if fluid_type not in ("DG", "GC"):
        raise ValueError(f"Unknown fluid type: {fluid_type}. Use 'DG' or 'GC'.")
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no usable CUDA device: the port runs on the GPU by default; "
                           'pass device="cpu" (CLI: --device cpu) to run on the CPU')
    g = copy.deepcopy(general_config or DEFAULT_GENERAL_CONFIG)
    g["fluid_type"] = fluid_type
    if seed is not None:
        g["seed"] = seed
    processor = SRMDataProcessor(base_dir=base_dir, general_config=g)
    res = processor.reservoir_config
    if nx is not None or nz is not None:
        # resize the grid: rescale well positions and the unit target shape
        nx = nx or res["Nx"]
        nz = nz or res["Nz"]
        scale = nx / res["Nx"]
        res["Nx"] = res["Ny"] = nx
        res["Nz"] = nz
        g["unit_target_shape"] = (1, nz, nx, nx, 1) if nz > 1 else (1, 1, nx, nx, 1)
        for conn in processor.wells_config["connections"]:
            conn["i"] = min(int(conn["i"] * scale), nx - 1)
            conn["j"] = min(int(conn["j"] * scale), nx - 1)
            conn["k"] = min(conn.get("k", 0), nz - 1)
        res["realizations"]["permx"]["conditional_values"] = {
            (min(5, nx - 1), min(5, nx - 1), 0): 2.0}
        processor.general_config = g
    if n_realizations is not None:
        res["realizations"]["permx"]["number"] = n_realizations
    if kle_method is not None:
        res["realizations"]["permx"]["method"] = kle_method
    if pi is not None:
        res["initialization"]["Pi"] = float(pi)
    if min_bhp is not None:
        for conn in processor.wells_config["connections"]:
            conn["minimum_bhp"] = float(min_bhp)

    path, train_groups, val_groups, test_groups, pred_groups = \
        processor.get_or_generate_training_data()
    statistics = processor.load_training_statistics()
    data_summary = DataSummary([statistics])
    models = build_model_map(train_groups[0][0].shape, device, fluid_type=fluid_type,
                             general_config=g, reservoir_config=res,
                             wells_config=processor.wells_config, data_summary=data_summary)
    loss_fn = PhysicsLoss(models, data_summary,
                          optimizer_model_names_map=get_optimizer_model_mapping(fluid_type),
                          general_config=g, reservoir_config=res,
                          wells_config=processor.wells_config, fluid_type=fluid_type)
    return {
        "processor": processor, "data_path": path,
        "train_groups": train_groups, "val_groups": val_groups,
        "test_groups": test_groups, "pred_groups": pred_groups,
        "statistics": statistics, "data_summary": data_summary,
        "models": models, "loss_fn": loss_fn, "general_config": g, "device": device,
    }
