"""Case construction for the training entry points.

Port of ``srm_tpu/examples/common.py::setup_case`` for dry gas ("DG") and
gas condensate ("GC"): the data processor, the generated or cached
physics-mode dataset, its statistics, the model map on ``device`` and the
PhysicsLoss, as one dict bundle. ``nx``, ``nz`` and ``n_realizations``
resize the problem, and ``kle_method="uncorrelated"`` selects iid log-normal
permeability fields, as in the reference; ``nz > 1`` gives the 3D
(7-point) case of either fluid, which needs ``nz >= 9`` at the default
encoder depth (``EncoderDecoder``). For gas condensate in 3D,
``general_config["label_source"] = "files"`` gives zero labels, which the
physics-mode loss never reads, so that no split is simulated. ``pi`` and ``min_bhp`` set the initial pressure and
the wells' BHP floor (the reference's drawdown scenarios); both enter the
config hash. ``well_solver_kwargs`` pass through to the well model
(``physics/well_solver.py``): ``{"use_non_iterative": False}`` solves the
BHP by Newton, ``{"use_blocking_factor": True}`` adds the blocking-factor
integral; the JAX CLI has no flag for either, so these paths run from here.
``use_cuda_stencil`` is the JAX package's ``use_pallas_stencil``: None
leaves the loss's choice (on with the models on a GPU), False turns the
fused op off, True on (where the tensors lie on the CPU it runs its plain
version); a per-cell porosity or gas condensate in 3D keeps it off, as
there is no fused op for either.

The case runs on the GPU: ``device=None`` means ``"cuda"``, and without a
usable CUDA device the call raises. Pass ``device="cpu"`` to run on the CPU.
With ``general_config["label_source"] == "simulator"`` the test split's
labels come from the FV simulator, on the same device.

Under an initialised process group (data-parallel training,
``parallel/mesh.py``) ``"cuda"`` means ``cuda:LOCAL_RANK``, and rank 0
builds the dataset cache, simulator labels included, while the other ranks
wait at a barrier and then load it, so that N ranks do not each simulate
the labels.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import torch

from srm_tpu_torch.config import DEFAULT_GENERAL_CONFIG, get_optimizer_model_mapping
from srm_tpu_torch.data.dataset import SRMDataProcessor
from srm_tpu_torch.losses.physics_loss import PhysicsLoss
from srm_tpu_torch.nn.modules import build_model_map
from srm_tpu_torch.parallel.mesh import rank_device, rank_zero_first
from srm_tpu_torch.utils.stats import DataSummary


def setup_case(fluid_type: str, base_dir: Optional[str] = None,
               nx: Optional[int] = None, n_realizations: Optional[int] = None,
               general_config: Optional[Dict] = None, seed: Optional[int] = None,
               nz: Optional[int] = None, kle_method: Optional[str] = None,
               pi: Optional[float] = None, min_bhp: Optional[float] = None,
               well_solver_kwargs: Optional[Dict] = None,
               use_cuda_stencil: Optional[bool] = None,
               device: Optional[torch.device] = None) -> Dict:
    """Build everything for one training case; returns a dict bundle."""
    fluid_type = fluid_type.upper()
    if fluid_type not in ("DG", "GC"):
        raise ValueError(f"Unknown fluid type: {fluid_type}. Use 'DG' or 'GC'.")
    device = rank_device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no usable CUDA device: the port runs on the GPU by default; "
                           'pass device="cpu" (CLI: --device cpu) to run on the CPU')
    g = copy.deepcopy(general_config or DEFAULT_GENERAL_CONFIG)
    g["fluid_type"] = fluid_type
    if seed is not None:
        g["seed"] = seed
    processor = SRMDataProcessor(base_dir=base_dir, general_config=g, device=device)
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

    with rank_zero_first():
        path, train_groups, val_groups, test_groups, pred_groups = \
            processor.get_or_generate_training_data()
        statistics = processor.load_training_statistics()
    data_summary = DataSummary([statistics])
    models = build_model_map(train_groups[0][0].shape, device, fluid_type=fluid_type,
                             general_config=g, reservoir_config=res,
                             wells_config=processor.wells_config, data_summary=data_summary,
                             well_solver_kwargs=well_solver_kwargs)
    loss_fn = PhysicsLoss(models, data_summary,
                          optimizer_model_names_map=get_optimizer_model_mapping(fluid_type),
                          general_config=g, reservoir_config=res,
                          wells_config=processor.wells_config, fluid_type=fluid_type)
    if use_cuda_stencil is not None:
        loss_fn.use_cuda_stencil = (bool(use_cuda_stencil) and loss_fn.phi_field is None
                                    and not (fluid_type == "GC" and res["Nz"] > 1))
    return {
        "processor": processor, "data_path": path,
        "train_groups": train_groups, "val_groups": val_groups,
        "test_groups": test_groups, "pred_groups": pred_groups,
        "statistics": statistics, "data_summary": data_summary,
        "models": models, "loss_fn": loss_fn, "general_config": g, "device": device,
    }
