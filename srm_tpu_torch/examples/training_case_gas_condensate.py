"""Gas-condensate (GC) two-phase training case.

Port of ``srm_tpu/examples/training_case_gas_condensate.py``: pressure and
saturation encoder–decoders, the 7-property PVT, condensate rate splitting
and the two-phase PDE residuals, trained on one GPU (with ``--device cpu``
on the CPU; without a usable CUDA device and without it, it raises) or
data-parallel over the processes that torchrun starts, one GPU each
(``parallel/mesh.py``).

Run::

    python -m srm_tpu_torch.examples.training_case_gas_condensate --epochs 5
    torchrun --nproc-per-node=N -m srm_tpu_torch.examples.training_case_gas_condensate
"""

from __future__ import annotations

import argparse
import logging
from typing import Dict, Optional

from srm_tpu_torch.examples.common import setup_case
from srm_tpu_torch.parallel.mesh import process_group_from_env
from srm_tpu_torch.training.trainer import train_combined_models_unified

log = logging.getLogger(__name__)


def setup_gas_condensate_case(base_dir: Optional[str] = None, nx: Optional[int] = None,
                              n_realizations: Optional[int] = None,
                              general_config: Optional[Dict] = None,
                              seed: Optional[int] = None, nz: Optional[int] = None,
                              kle_method: Optional[str] = None,
                              use_cuda_stencil: Optional[bool] = None,
                              pi: Optional[float] = None,
                              min_bhp: Optional[float] = None, device=None):
    """Gas-condensate case bundle (see
    :func:`srm_tpu_torch.examples.common.setup_case`; ``use_cuda_stencil``
    is the JAX package's ``use_pallas_stencil``)."""
    return setup_case("GC", base_dir=base_dir, nx=nx, n_realizations=n_realizations,
                      general_config=general_config, seed=seed, nz=nz, kle_method=kle_method,
                      use_cuda_stencil=use_cuda_stencil, pi=pi, min_bhp=min_bhp,
                      device=device)


def main(argv=None):
    parser = argparse.ArgumentParser(description="SRM gas-condensate training case (GPU)")
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--base-dir", type=str, default=None)
    parser.add_argument("--nx", type=int, default=None)
    parser.add_argument("--realizations", type=int, default=None)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    with process_group_from_env(args.device) as mesh:
        case = setup_gas_condensate_case(base_dir=args.base_dir, nx=args.nx,
                                         n_realizations=args.realizations, device=args.device)
        trainer, history, best = train_combined_models_unified(
            case["train_groups"], case["val_groups"], case["loss_fn"],
            training_batch_size=args.batch_size, epochs=args.epochs,
            general_config=case["general_config"], mesh=mesh)
    if mesh.rank == 0:
        print("Final total train loss:", history["total_train_loss"][-1])
    return trainer, history, best


if __name__ == "__main__":
    main()
