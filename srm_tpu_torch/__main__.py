"""srm_tpu_torch command-line interface.

    python -m srm_tpu_torch generate-data [--base-dir DIR] [--realizations N] [--no-dat]
    python -m srm_tpu_torch train --fluid DG|GC [--epochs N] [--batch-size B]
                                  [--nx N] [--realizations K] [--base-dir DIR]
                                  [--checkpoint-dir DIR] [--resume]
                                  [--production] [--drawdown]
                                  [--device cuda|cpu]
    python -m srm_tpu_torch predict --fluid DG|GC [--drawdown]
                                    [--times 0,30,90,180,365]
                                    [--max-realizations K] [--checkpoint-dir DIR]
                                    [--out FILE.npz] [--device cuda|cpu] ...
    python -m srm_tpu_torch export --fluid DG|GC [--drawdown] --out-dir DIR
                                   [--platforms cpu,cuda] [--checkpoint-dir DIR]
                                   [--device cuda|cpu] ...

Port of the ``generate-data``, ``train``, ``predict`` and ``export``
commands of ``srm_tpu/__main__.py`` for dry gas and gas condensate.
``generate-data`` writes the KLE dataset tree (grids, splits, summaries
and the ``PERMX_nnnn.dat`` Eclipse decks, ``--no-dat`` without them) under
``--base-dir``: host work with the numpy sampler in both packages, so the
files are byte-identical to the JAX package's; it uses no device.
``train`` builds the case (dataset, models, loss),
trains on the first GPU (``--device cuda``, the default; without a usable
CUDA device it fails) or, when asked with ``--device cpu``, on the CPU, and
prints per-epoch losses. Launched by ``torchrun --nproc-per-node=N -m
srm_tpu_torch train ...`` it trains data-parallel over the N processes, as
the JAX package's ``train`` does over every device of its host: a process
group started from torchrun's environment (NCCL for ``--device cuda``, one
GPU a rank, ``cuda:LOCAL_RANK``; gloo for ``--device cpu``), each step on
the rank's block of the batch with the gradients summed over the ranks
(``parallel/mesh.py``); rank 0 builds the dataset cache while the others
wait, prints and writes the checkpoints. Without torchrun's variables it
is one process, as before. On the card each training and eval step is one
CUDA graph replay (after a few eager warm-up steps). ``--checkpoint-dir``
saves the training state there after every epoch and after the best-epoch
restore; with ``--resume`` training continues from the latest checkpoint
there (the JAX package's flags of the same names). ``--device`` is the
port's spelling of the JAX package's ``JAX_PLATFORMS``. Float32 means
float32: TF32 is turned off for matmuls and cuDNN convolutions here.

The reference's two presets, as its ``cmd_train`` applies them:
``--production`` applies ``apply_production_overrides`` (bfloat16
networks, Model 2 on a 2x strided input, batch 128) and the production LR
decay scaled to the batch (``production_optimizer_configs``: 62 decay
steps at batch 128); ``--drawdown`` (which implies ``--fluid GC``)
applies ``apply_drawdown_overrides`` (mixed physics/data training on FV
labels of every split, balanced td errors, the ``abs`` saturation
rectifier) at ``GC_DRAWDOWN_CASE`` (Pi 4300 psia, BHP floor 2000 psia)
with ``drawdown_optimizer_configs`` (250 decay steps). Given both, the
drawdown recipe is applied over the production overrides and its
250-step schedule replaces the batch-scaled one, as in the reference.

``predict`` and ``export`` rebuild the same case (the dataset comes from the
cache that ``train`` wrote under the same ``--base-dir``; ``--drawdown``
rebuilds the drawdown case, as the reference's ``_restore_predictor``
does), restore the latest checkpoint of ``--checkpoint-dir`` into the
models in place, and build an ``SRMPredictor`` on the device. ``predict``
rolls out pressure (and for gas condensate the gas saturation) over the
first ``--max-realizations`` test realizations × ``--times`` (days) and
saves them with ``--out``; ``export`` writes a ``torch.export`` serving
bundle for ``--platforms`` (``eval/serving.py``). Like the reference's,
they have no ``--production`` flag: a checkpoint is served by float32
networks.
"""

from __future__ import annotations

import argparse
import logging
import sys


def _case_presets(args, train: bool = False):
    """(fluid, general config, optimizer configs, setup keyword arguments)
    of the presets named by ``args``, as the reference's ``cmd_train``
    (``train=True``) and ``_restore_predictor`` build them
    (srm_tpu/__main__.py:31-64, :79-94)."""
    from srm_tpu_torch.config import (DEFAULT_GENERAL_CONFIG, GC_DRAWDOWN_CASE,
                                      apply_drawdown_overrides, apply_production_overrides,
                                      drawdown_optimizer_configs, production_optimizer_configs)
    drawdown = args.drawdown
    fluid = "GC" if drawdown else args.fluid
    g, opt_cfgs, setup_kwargs = None, None, {}
    if train and args.production:
        g = apply_production_overrides(DEFAULT_GENERAL_CONFIG)
        # the production decay is a ~8000-sample period: its step count
        # scales with the batch this run trains with
        opt_cfgs = production_optimizer_configs(
            batch_size=args.batch_size or g["training_batch_size"])
    if drawdown:
        g = apply_drawdown_overrides(g or DEFAULT_GENERAL_CONFIG)
        if train:
            opt_cfgs = drawdown_optimizer_configs()
        setup_kwargs = dict(GC_DRAWDOWN_CASE)
    return fluid, g, opt_cfgs, setup_kwargs


def cmd_generate_data(args) -> int:
    from srm_tpu_torch.data.kle_generator import KLConfig, generate_and_save_realizations
    cfg = KLConfig.from_reservoir_config()
    if args.realizations:
        cfg.n_realizations = args.realizations
    folder = generate_and_save_realizations(cfg, base_dir=args.base_dir,
                                            write_dat_files=not args.no_dat)
    print(f"KLE dataset written to {folder}")
    return 0


def cmd_train(args) -> int:
    from srm_tpu_torch.parallel.mesh import process_group_from_env

    with process_group_from_env(args.device) as mesh:
        return _train(args, mesh)


def _train(args, mesh) -> int:
    import torch

    from srm_tpu_torch.examples.common import setup_case
    from srm_tpu_torch.training.trainer import train_combined_models_unified

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lead = mesh.rank == 0
    fluid, g, opt_cfgs, setup_kwargs = _case_presets(args, train=True)
    case = setup_case(fluid, base_dir=args.base_dir, nx=args.nx,
                      n_realizations=args.realizations, general_config=g, device=args.device,
                      **setup_kwargs)
    if lead:
        print(f"device: {case['device']}"
              + (f" ({torch.cuda.get_device_name(case['device'])})"
                 if case["device"].type == "cuda" else "")
              + (f", data-parallel over {mesh.size} ranks ({mesh.backend})"
                 if mesh.group is not None else ""))
    _, history, _ = train_combined_models_unified(
        case["train_groups"], case["val_groups"], case["loss_fn"],
        training_batch_size=args.batch_size, epochs=args.epochs,
        general_config=case["general_config"], checkpoint_dir=args.checkpoint_dir,
        resume=args.resume, optimizer_configs=opt_cfgs, mesh=mesh)
    if not history["total_train_loss"]:
        if args.resume:
            if lead:
                print("nothing left to train: the checkpoint is at the last epoch")
            return 0
        if lead:
            print("no training batches: the train split is empty")
        return 1
    if lead:
        print("final total train loss:", history["total_train_loss"][-1])
    return 0


def _restore_predictor(args):
    """Shared by predict and export: rebuild the case (the ``--drawdown``
    case where asked), restore the latest checkpoint into its models in
    place; returns (predictor, case, fluid)."""
    import torch

    from srm_tpu_torch.eval.predictor import SRMPredictor
    from srm_tpu_torch.examples.common import setup_case
    from srm_tpu_torch.utils.checkpoint import CheckpointManager

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fluid, g, _, setup_kwargs = _case_presets(args)
    case = setup_case(fluid, base_dir=args.base_dir, nx=args.nx,
                      n_realizations=args.realizations, general_config=g, device=args.device,
                      **setup_kwargs)
    models, loss_fn = case["models"], case["loss_fn"]
    if args.checkpoint_dir:
        # the trained models, as the trainer saves them (Trainer.trained_models)
        trained = {loss_fn.logical_name(k): models[loss_fn.logical_name(k)]
                   for k in loss_fn.trainable_models_keys}
        restored = CheckpointManager(args.checkpoint_dir).restore(params=trained)
        if restored is None:
            print(f"no checkpoint in {args.checkpoint_dir}: the initial weights")
        else:
            print(f"restored checkpoint step {restored[3]} ({', '.join(trained)})")
    pred = SRMPredictor(models, case["data_summary"], general_config=case["general_config"],
                        reservoir_config=case["processor"].reservoir_config)
    return pred, case, fluid


def cmd_predict(args) -> int:
    import numpy as np

    pred, case, fluid = _restore_predictor(args)
    permx = case["processor"].generate_kle_splits()["test"]
    if args.max_realizations:
        permx = permx[: args.max_realizations]
    times = [float(t) for t in args.times.split(",")]
    p = pred.predict_pressure(permx, times)
    print(f"pressure rollout: shape {p.shape}, range "
          f"[{p.min():.1f}, {p.max():.1f}] psia")
    arrays = {"pressure": p, "times": np.asarray(times)}
    if fluid == "GC":
        sg = pred.predict_saturation(permx, times)
        print(f"gas-saturation rollout: shape {sg.shape}, range "
              f"[{sg.min():.4f}, {sg.max():.4f}]")
        arrays["saturation"] = sg
    if args.out:
        np.savez_compressed(args.out, **arrays)
        print(f"saved to {args.out}")
    return 0


def cmd_export(args) -> int:
    from srm_tpu_torch.eval.serving import export_surrogate

    platforms = tuple(p.strip() for p in args.platforms.split(",") if p.strip())
    pred, _, fluid = _restore_predictor(args)
    fields = ("pressure", "saturation") if fluid == "GC" else ("pressure",)
    paths = export_surrogate(pred, args.out_dir, fields=fields, platforms=platforms)
    for field, by_platform in paths.items():
        for platform, path in by_platform.items():
            print(f"exported {field} ({platform}): {path}")
    print(f"serving bundle written to {args.out_dir} "
          f"(platforms: {', '.join(platforms)})")
    return 0


def _case_flags(p) -> None:
    """The flags that rebuild a trained case (predict, export)."""
    p.add_argument("--fluid", default="DG", type=str.upper, choices=["DG", "GC"])
    p.add_argument("--drawdown", action="store_true",
                   help="rebuild the --drawdown train preset's case (implies --fluid GC, "
                        "Pi 4300 / BHP floor 2000 psia)")
    p.add_argument("--base-dir", default=None)
    p.add_argument("--nx", type=int, default=None)
    p.add_argument("--realizations", type=int, default=None)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(prog="srm_tpu_torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)
    gd = sub.add_parser("generate-data",
                        help="generate the KLE dataset + Eclipse decks (host work with the "
                             "numpy sampler, as in the JAX package; no device)")
    gd.add_argument("--base-dir", default=None)
    gd.add_argument("--realizations", type=int, default=None)
    gd.add_argument("--no-dat", action="store_true")
    gd.set_defaults(fn=cmd_generate_data)

    t = sub.add_parser("train", help="train the SRM")
    t.add_argument("--fluid", default="DG", type=str.upper, choices=["DG", "GC"])
    t.add_argument("--epochs", type=int, default=5)
    t.add_argument("--batch-size", type=int, default=None)
    t.add_argument("--base-dir", default=None)
    t.add_argument("--nx", type=int, default=None)
    t.add_argument("--realizations", type=int, default=None)
    t.add_argument("--checkpoint-dir", default=None)
    t.add_argument("--resume", action="store_true")
    t.add_argument("--production", action="store_true",
                   help="the production profile: bfloat16 networks, Model 2 on a 2x strided "
                        "input, batch 128 with the batch-scaled LR decay")
    t.add_argument("--drawdown", action="store_true",
                   help="the GC below-dew-point recipe (implies --fluid GC): mixed "
                        "physics/data training on FV labels, balanced td errors, 'abs' Sg "
                        "rectifier, 250 decay steps, Pi 4300 / BHP floor 2000 psia")
    t.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    t.set_defaults(fn=cmd_train)

    p = sub.add_parser("predict", help="pressure (and, for GC, gas-saturation) rollout with "
                                       "the trained surrogate")
    _case_flags(p)
    p.add_argument("--times", default="0,30,90,180,365")
    p.add_argument("--max-realizations", type=int, default=4)
    p.add_argument("--out", default=None)
    p.set_defaults(fn=cmd_predict)

    e = sub.add_parser("export", help="save the trained surrogate as a torch.export serving "
                                      "bundle (loads with no model or config code)")
    _case_flags(e)
    e.add_argument("--out-dir", required=True)
    e.add_argument("--platforms", default="cpu,cuda",
                   help="comma-separated platforms to export a program for (default: cpu,cuda)")
    e.set_defaults(fn=cmd_export)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
