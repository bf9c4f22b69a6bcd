"""Time to accuracy: training with the pressure RMSE against FV labels.

    python -m srm_tpu_torch.tools.rmse_experiment train --fluid DG|GC
        [--epochs 100] [--batch 32] [--eval-every 5] [--nx N] [--nz N]
        [--realizations K] [--decay-steps S] [--lr-scale F] [--pi P]
        [--min-bhp P] [--bf16] [--precision mixed] [--dt-stride S]
        [--physics-fraction F] [--td-norm balance|label_std] [--sg-focus B]
        [--sg-td-weight W] [--sat-act abs|softplus] [--width W] [--pad N]
        [--device cuda|cpu]

Port of the ``train`` command of ``tools/rmse_experiment.py``. It builds the
case with FV labels from the port's simulator (``label_source="simulator"``:
the test split's in physics mode, every split's with
``--physics-fraction`` below 1), trains through the graphed ``Trainer`` on
the device-resident train split (physics mode by default, no labels in the
loss; mixed physics/data training with ``--physics-fraction``), and every
``--eval-every`` epochs takes the pressure RMSE (and for gas condensate the
Sg RMSE) of the test split. The reference's knob flags set the same
config keys as there: ``--bf16`` (``compute_dtype="bfloat16"``),
``--precision mixed``, ``--dt-stride``, ``--physics-fraction``,
``--td-norm``, ``--sg-focus``, ``--sg-td-weight`` (the oil-phase td
weight), ``--sat-act``, ``--width`` (``network_width``) and ``--pad``
(``spatial_pad_to``). It prints one JSON
line: the ``trajectory`` of ``wall_s`` (training wall clock at the
evaluation, the earlier evaluations included, as the reference counts it),
``epoch``, ``steps``, ``rmse_psia`` [, ``rmse_sg``] and, beyond the
reference's line, ``bias_psia`` (the prediction's mean signed error) and
``pred_vs_pi_psia`` (the prediction's RMSE against Pi, to set beside the
labels' ``rmse_predict_pi``), the trivial
predict-Pi baseline ``rmse_predict_pi`` and ``setup_s`` (case build, label
simulation included). It runs on the GPU unless ``--device cpu``; TF32 is
off.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

def build_case(nx=None, nz=None, realizations=None, fluid="DG", pi=None, min_bhp=None,
               device=None, base_dir=None, bf16=False, precision=None, dt_stride=None,
               physics_fraction=None, td_norm=None, sg_focus=None, sg_td_weight=None,
               sat_act=None, width=None, pad=None):
    """The case of the reference's ``build_case`` (tools/rmse_experiment.py:44-88)."""
    from srm_tpu_torch.config import DEFAULT_GENERAL_CONFIG
    from srm_tpu_torch.examples.common import setup_case

    g = copy.deepcopy(DEFAULT_GENERAL_CONFIG)
    g["label_source"] = "simulator"          # FV labels (every split's below f = 1)
    if physics_fraction is not None:
        g["physics_mode_fraction"] = float(physics_fraction)
    if sg_td_weight is not None:
        g["default_weights"]["oil"]["td"] = float(sg_td_weight)
    if td_norm:
        g["td_loss_normalization"] = td_norm
    if sg_focus:
        g["sg_td_focus"] = float(sg_focus)
    if sat_act:
        g["sat_input_activation"] = sat_act
    if bf16:
        g["compute_dtype"] = "bfloat16"
    if precision:
        g["precision_policy"] = precision
    if width:
        g["network_width"] = int(width)
    if pad:
        g["spatial_pad_to"] = int(pad)
    if dt_stride:
        g["dt_input_stride"] = int(dt_stride)
    # volumetric grids: iid log-normal fields replace the dense KLE, as the
    # reference's tool selects them
    kle_method = "uncorrelated" if (nz or 1) > 1 else None
    return setup_case(fluid, base_dir=base_dir or os.path.join(REPO, "_srm_data"),
                      nx=nx, nz=nz, n_realizations=realizations, general_config=g,
                      kle_method=kle_method, pi=pi, min_bhp=min_bhp, device=device)


def optimizer_configs(lr_scale=None, decay_steps=None):
    """The default optimizers with every initial learning rate scaled by
    ``lr_scale`` and every enabled exponential decay at ``decay_steps``."""
    from srm_tpu_torch.config import DEFAULT_OPTIMIZER_CONFIGS

    if not lr_scale and not decay_steps:
        return None
    cfgs = copy.deepcopy(DEFAULT_OPTIMIZER_CONFIGS)
    for cfg in cfgs.values():
        if lr_scale and "learning_rate" in cfg:
            cfg["learning_rate"] = float(cfg["learning_rate"]) * lr_scale
        lr = cfg.get("exponential_decay", {}).get("learning_rate")
        if decay_steps and lr and lr.get("enabled"):
            lr["decay_steps"] = int(decay_steps)
    return cfgs


def eval_line(epoch: int, wall: float, rmse: float, rmse_sg=None) -> str:
    """The stderr line of one evaluation, which ``tools/salvage_rmse_log.py``
    parses back from the log of an interrupted run."""
    return (f"epoch {epoch}: wall {wall:.1f}s rmse {rmse:.2f} psia"
            + (f" / Sg {rmse_sg:.4f}" if rmse_sg is not None else ""))


def train(args) -> dict:
    import torch

    from srm_tpu_torch.eval.plotting import predictions_and_labels, saturation_rmse
    from srm_tpu_torch.training.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    case = build_case(nx=args.nx, nz=args.nz, realizations=args.realizations,
                      fluid=args.fluid, pi=args.pi, min_bhp=args.min_bhp,
                      device=args.device, base_dir=args.base_dir, bf16=args.bf16,
                      precision=args.precision, dt_stride=args.dt_stride,
                      physics_fraction=args.physics_fraction, td_norm=args.td_norm,
                      sg_focus=args.sg_focus, sg_td_weight=args.sg_td_weight,
                      sat_act=args.sat_act, width=args.width, pad=args.pad)
    device = case["device"]
    trainer = Trainer(case["loss_fn"],
                      optimizer_configs=optimizer_configs(args.lr_scale, args.decay_steps))
    nb, _ = trainer.stage_dataset("train", case["train_groups"], args.batch)

    _, yte = case["test_groups"][0]
    labels = yte["PRESSURE"] if isinstance(yte, dict) else yte
    pi = float(case["processor"].reservoir_config["initialization"]["Pi"])
    rmse_pi = float(np.sqrt(np.mean((np.asarray(labels) - pi) ** 2)))
    rmse_sgi = None
    if args.fluid == "GC" and isinstance(yte, dict) and "SGAS" in yte:
        sgi = float(case["loss_fn"].Sgi)
        rmse_sgi = float(np.sqrt(np.mean((np.asarray(yte["SGAS"]) - sgi) ** 2)))

    def rmse_now():
        """The pressure RMSE, the prediction's mean signed error and its RMSE
        against Pi (how far it draws down), and the Sg RMSE."""
        pred, true = predictions_and_labels(case["models"], case["test_groups"])
        p = float(np.sqrt(np.mean((pred - true) ** 2)))
        diag = {"bias_psia": round(float(np.mean(pred - true)), 3),
                "pred_vs_pi_psia": round(float(np.sqrt(np.mean((pred - pi) ** 2))), 3)}
        s = (saturation_rmse(case["models"], case["test_groups"])
             if rmse_sgi is not None else None)
        return p, s, diag

    traj = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_setup = time.perf_counter() - t_start
    t0 = time.perf_counter()
    for epoch in range(args.epochs):
        te = time.perf_counter()
        m = trainer.train_epoch_resident("train")          # host metrics: synchronised
        ep_loss = float(np.asarray(m["total"]).reshape(-1)[-1])
        print(f"  epoch {epoch + 1}/{args.epochs} done in {time.perf_counter() - te:.1f}s "
              f"loss {ep_loss:.4g}", file=sys.stderr, flush=True)
        if (epoch + 1) % args.eval_every == 0 or epoch == args.epochs - 1:
            wall = time.perf_counter() - t0
            r, s, diag = rmse_now()
            rec = {"wall_s": round(wall, 2), "epoch": epoch + 1,
                   "steps": (epoch + 1) * nb, "rmse_psia": round(r, 3), **diag}
            if s is not None:
                rec["rmse_sg"] = round(s, 5)
            traj.append(rec)
            print(eval_line(epoch + 1, wall, r, s), file=sys.stderr, flush=True)

    result = {
        "framework": "srm_tpu_torch",
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"),
        "fluid": args.fluid, "nz": args.nz, "bf16": args.bf16, "precision": args.precision,
        "width": args.width, "pad": args.pad, "dt_stride": args.dt_stride,
        "decay_steps": args.decay_steps, "lr_scale": args.lr_scale,
        "physics_fraction": args.physics_fraction, "pi": args.pi, "min_bhp": args.min_bhp,
        "sg_td_weight": args.sg_td_weight, "td_norm": args.td_norm, "sg_focus": args.sg_focus,
        "sat_act": args.sat_act,
        "batch": args.batch, "steps_per_epoch": nb,
        "setup_s": round(t_setup, 1),
        "rmse_predict_pi": round(rmse_pi, 3),
        "rmse_predict_sgi": (round(rmse_sgi, 5) if rmse_sgi is not None else None),
        "trajectory": traj,
    }
    print(json.dumps(result), flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m srm_tpu_torch.tools.rmse_experiment",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    pt = sub.add_parser("train")
    pt.add_argument("--epochs", type=int, default=100)
    pt.add_argument("--batch", type=int, default=32)
    pt.add_argument("--eval-every", type=int, default=5)
    pt.add_argument("--nx", type=int, default=None)
    pt.add_argument("--nz", type=int, default=None,
                    help="number of layers; > 1 builds the volumetric 3D case, labelled "
                         "by the matrix-free iterative solver")
    pt.add_argument("--realizations", type=int, default=None)
    pt.add_argument("--fluid", default="DG", type=str.upper, choices=["DG", "GC"])
    pt.add_argument("--pi", type=float, default=None, help="initial-pressure override (psia)")
    pt.add_argument("--min-bhp", type=float, default=None, dest="min_bhp",
                    help="minimum-BHP override (psia) for every well")
    pt.add_argument("--lr-scale", type=float, default=None, dest="lr_scale",
                    help="multiply every optimizer's initial learning rate")
    pt.add_argument("--decay-steps", type=int, default=None, dest="decay_steps",
                    help="decay steps of every decaying optimizer (the reference's 25 "
                         "per step by default)")
    pt.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    pt.add_argument("--base-dir", default=None,
                    help="dataset cache directory (default: _srm_data in the checkout)")
    pt.add_argument("--bf16", action="store_true",
                    help="bfloat16 network compute with float32 parameters")
    pt.add_argument("--precision", default=None, choices=["mixed"],
                    help="'mixed': bfloat16 bulk with a float32 input conv and output head")
    pt.add_argument("--dt-stride", type=int, default=None, dest="dt_stride",
                    help="spatial stride of the time-step network's input (e.g. 2)")
    pt.add_argument("--physics-fraction", type=float, default=None, dest="physics_fraction",
                    help="physics_mode_fraction; below 1, mixed physics/data training on FV "
                         "labels of every split (0: data only)")
    pt.add_argument("--td-norm", default=None, dest="td_norm", choices=["balance", "label_std"],
                    help="td error scaling (td_loss_normalization)")
    pt.add_argument("--sg-focus", type=float, default=None, dest="sg_focus",
                    help="dropout-focus beta of the Sg td error (sg_td_focus)")
    pt.add_argument("--sg-td-weight", type=float, default=None, dest="sg_td_weight",
                    help="the oil-phase (Sg label) td weight")
    pt.add_argument("--sat-act", default=None, dest="sat_act", choices=["abs", "softplus"],
                    help="the saturation HardLayer's departure rectifier")
    pt.add_argument("--width", type=int, default=None,
                    help="network_width: Bottom_Size of the encoder-decoders (e.g. 64)")
    pt.add_argument("--pad", type=int, default=None,
                    help="spatial_pad_to: the networks' height and width padding (e.g. 48)")
    args = ap.parse_args(argv)
    train(args)


if __name__ == "__main__":
    main()
