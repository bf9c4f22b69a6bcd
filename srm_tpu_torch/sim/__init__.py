"""Simulator labels without an external simulator binary.

Port of ``srm_tpu/sim``: ``simulate_labels(processor, split)`` is what
``SRMDataProcessor.simulation_labels`` calls when
``general_config['label_source'] == 'simulator'``.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import numpy as np

from srm_tpu_torch.sim.fv_simulator import (
    FVProblem, build_problem, simulate_dry_gas, simulate_gas_condensate,
    simulate_realizations, simulate_realizations_gc,
)

log = logging.getLogger(__name__)

__all__ = ["FVProblem", "build_problem", "simulate_dry_gas",
           "simulate_gas_condensate", "simulate_realizations",
           "simulate_realizations_gc", "simulate_labels"]


def simulate_labels(processor, split: str, permx: Optional[np.ndarray] = None,
                    times: Optional[np.ndarray] = None, device=None,
                    stats: Optional[Dict] = None) -> Optional[Dict[str, np.ndarray]]:
    """Simulator labels (K, T, Nz, Ny, Nx per key) for one split: dry gas
    gives {PRESSURE}, gas condensate {PRESSURE, SGAS}.

    The realizations run on ``device``, else the processor's, else
    ``"cuda"`` (which raises without a card). The reference's environment
    overrides apply under their own names: ``SRM_TPU_SIM_SOLVER``,
    ``SRM_TPU_SIM_CHUNK``, ``SRM_TPU_SIM_TOL`` and ``SRM_TPU_SIM_MAXITER``
    (environment reads, as there: the JAX package's ``simulate_labels``
    takes no such arguments).
    A ``stats`` dict collects the iterative solver's trips per solve."""
    from srm_tpu_torch.config import DEFAULT_SCAL_CONFIG, get_configuration
    from srm_tpu_torch.data.pvt_table import load_pvt_table
    from srm_tpu_torch.physics.pvt import make_spline_pvt, properties_for
    from srm_tpu_torch.physics.relperm import RelativePermeability
    from srm_tpu_torch.sim.fv_simulator import _device

    fluid = processor.general_config["fluid_type"].upper()
    if permx is None:
        permx = processor.generate_kle_splits()[split]
    if times is None:
        times = processor.generate_time_tensor()[split]
    times = np.asarray(times).reshape(-1)
    if permx.shape[0] == 0 or times.size < 2:
        return None   # empty split: caller falls back to zero labels
    dev = _device(device if device is not None else getattr(processor, "device", None))

    # the order-1 spline, its weights solved once in float64
    pvt_fn = make_spline_pvt(get_configuration("pvt_layer", fluid_type=fluid),
                             load_pvt_table(), properties=properties_for(fluid),
                             order=1).to(dev)
    prob, kscale = build_problem(processor.reservoir_config, processor.wells_config,
                                 DEFAULT_SCAL_CONFIG, processor.general_config)
    log.info("FV simulator (%s): %d realizations × %d times on grid %s, %s",
             fluid, permx.shape[0], times.size, prob.shape, dev)
    kwargs: Dict = {"solver": os.environ.get("SRM_TPU_SIM_SOLVER", "auto"),
                    "device": dev, "stats": stats}
    if os.environ.get("SRM_TPU_SIM_CHUNK"):
        kwargs["chunk"] = int(os.environ["SRM_TPU_SIM_CHUNK"])
    if os.environ.get("SRM_TPU_SIM_TOL"):
        kwargs["cg_tol"] = float(os.environ["SRM_TPU_SIM_TOL"])
    if os.environ.get("SRM_TPU_SIM_MAXITER"):
        kwargs["cg_maxiter"] = int(os.environ["SRM_TPU_SIM_MAXITER"])
    permx = np.asarray(permx, np.float32)
    times = np.asarray(times, np.float32)
    if fluid == "DG":
        return {"PRESSURE": simulate_realizations(prob, kscale, permx, times, pvt_fn,
                                                  **kwargs)}
    scal = DEFAULT_SCAL_CONFIG
    relperm = RelativePermeability.from_config(scal["end_points"], scal["corey_exponents"])
    p, sg = simulate_realizations_gc(prob, kscale, permx, times, pvt_fn, relperm,
                                     Swmin=scal["end_points"]["Swmin"], **kwargs)
    return {"PRESSURE": p, "SGAS": sg}
