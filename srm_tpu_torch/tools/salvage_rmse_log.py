"""Salvage an interrupted ``rmse_experiment train`` run.

    python -m srm_tpu_torch.tools.salvage_rmse_log LOGFILE --out RESULTS.json
        [--fluid GC] [--physics-fraction 0.5] [--pi 4300] [--min-bhp 2000]
        [--td-norm balance] [--rmse-predict-pi 223.4] [--rmse-predict-sgi 0.0425]
        [--steps-per-epoch 95] ...

A copy of the repo's pure-Python ``tools/salvage_rmse_log.py``, kept in the
port. ``python -m srm_tpu_torch.tools.rmse_experiment train`` prints its
results JSON only at the end, but streams every evaluation to stderr as
(``rmse_experiment.eval_line``)::

    epoch 10: wall 808.9s rmse 24.19 psia / Sg 0.0861

This tool rebuilds the results record from such a log and the run's flags,
marked ``"partial": true``, writes it to ``--out`` and prints it.
"""

from __future__ import annotations

import argparse
import json
import re
import sys

LINE_RE = re.compile(
    r"epoch (?P<epoch>\d+): wall (?P<wall>[\d.]+)s rmse (?P<rmse>[\d.]+) psia"
    r"(?: / Sg (?P<sg>[\d.]+))?")


def parse_log(path: str, steps_per_epoch: int):
    traj = []
    with open(path, errors="replace") as f:
        for line in f:
            m = LINE_RE.search(line)
            if not m:
                continue
            rec = {"wall_s": float(m.group("wall")),
                   "epoch": int(m.group("epoch")),
                   "steps": int(m.group("epoch")) * steps_per_epoch,
                   "rmse_psia": float(m.group("rmse"))}
            if m.group("sg") is not None:
                rec["rmse_sg"] = float(m.group("sg"))
            traj.append(rec)
    return traj


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m srm_tpu_torch.tools.salvage_rmse_log")
    ap.add_argument("log")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cpu (salvaged)")
    ap.add_argument("--fluid", default="DG")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--dt-stride", type=int, default=None, dest="dt_stride")
    ap.add_argument("--decay-steps", type=int, default=None, dest="decay_steps")
    ap.add_argument("--physics-fraction", type=float, default=None, dest="physics_fraction")
    ap.add_argument("--pi", type=float, default=None)
    ap.add_argument("--min-bhp", type=float, default=None, dest="min_bhp")
    ap.add_argument("--td-norm", default=None, dest="td_norm")
    ap.add_argument("--sg-td-weight", type=float, default=None, dest="sg_td_weight")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps-per-epoch", type=int, default=95, dest="steps_per_epoch")
    ap.add_argument("--rmse-predict-pi", type=float, default=None, dest="rmse_predict_pi")
    ap.add_argument("--rmse-predict-sgi", type=float, default=None, dest="rmse_predict_sgi")
    args = ap.parse_args(argv)

    traj = parse_log(args.log, args.steps_per_epoch)
    if not traj:
        sys.exit("no eval lines found in " + args.log)
    rec = {
        "framework": "srm_tpu_torch", "device": args.device,
        "fluid": args.fluid, "bf16": args.bf16,
        "precision": None, "width": args.width, "pad": None,
        "dt_stride": args.dt_stride, "decay_steps": args.decay_steps,
        "physics_fraction": args.physics_fraction,
        "pi": args.pi, "min_bhp": args.min_bhp,
        "sg_td_weight": args.sg_td_weight, "td_norm": args.td_norm,
        "batch": args.batch, "steps_per_epoch": args.steps_per_epoch,
        "partial": True,
        "rmse_predict_pi": args.rmse_predict_pi,
        "rmse_predict_sgi": args.rmse_predict_sgi,
        "trajectory": traj,
    }
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
