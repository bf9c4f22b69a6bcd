"""srm_tpu_torch command-line interface.

    python -m srm_tpu_torch train --fluid DG|GC [--epochs N] [--batch-size B]
                                  [--nx N] [--realizations K] [--base-dir DIR]
                                  [--checkpoint-dir DIR] [--resume]
                                  [--device cuda|cpu]

Port of the ``train`` command of ``srm_tpu/__main__.py`` for dry gas and gas
condensate in physics mode. It builds the case (dataset, models, loss),
trains on the first GPU (``--device cuda``, the default; without a usable
CUDA device it fails) or, when asked with ``--device cpu``, on the CPU, and
prints per-epoch losses. On the card each training and eval step is one
CUDA graph replay (after a few eager warm-up steps). ``--checkpoint-dir``
saves the training state there after every epoch and after the best-epoch
restore; with ``--resume`` training continues from the latest checkpoint
there (the JAX package's flags of the same names). ``--device`` is the
port's spelling of the JAX package's ``JAX_PLATFORMS``. Float32 means
float32: TF32 is turned off for matmuls and cuDNN convolutions here.
"""

from __future__ import annotations

import argparse
import logging
import sys


def cmd_train(args) -> int:
    import torch

    from srm_tpu_torch.examples.common import setup_case
    from srm_tpu_torch.training.trainer import train_combined_models_unified

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    case = setup_case(args.fluid, base_dir=args.base_dir, nx=args.nx,
                      n_realizations=args.realizations, device=args.device)
    print(f"device: {case['device']}"
          + (f" ({torch.cuda.get_device_name(case['device'])})"
             if case["device"].type == "cuda" else ""))
    _, history, _ = train_combined_models_unified(
        case["train_groups"], case["val_groups"], case["loss_fn"],
        training_batch_size=args.batch_size, epochs=args.epochs,
        general_config=case["general_config"], checkpoint_dir=args.checkpoint_dir,
        resume=args.resume)
    if not history["total_train_loss"]:
        if args.resume:
            print("nothing left to train: the checkpoint is at the last epoch")
            return 0
        print("no training batches: the train split is empty")
        return 1
    print("final total train loss:", history["total_train_loss"][-1])
    return 0


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(prog="srm_tpu_torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)
    t = sub.add_parser("train", help="train the SRM")
    t.add_argument("--fluid", default="DG", type=str.upper, choices=["DG", "GC"])
    t.add_argument("--epochs", type=int, default=5)
    t.add_argument("--batch-size", type=int, default=None)
    t.add_argument("--base-dir", default=None)
    t.add_argument("--nx", type=int, default=None)
    t.add_argument("--realizations", type=int, default=None)
    t.add_argument("--checkpoint-dir", default=None)
    t.add_argument("--resume", action="store_true")
    t.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    t.set_defaults(fn=cmd_train)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
