"""The surrogate against the FV simulator: processing time on one workload.

    python -m srm_tpu_torch.tools.infer_vs_sim [--fluid DG|GC] [--nx N]
        [--realizations K] [--reps 5] [--sim-reps 3] [--device cuda|cpu]
        [--base-dir DIR]

Port of ``bench.py::measure_inference`` (``:212-301``), the reference's
headline claim that the surrogate saves "up to 90% of the total processing
time" against the numerical simulator. The workload is the reference's: the
default case (its grid resized by ``--nx``), its first 16 test realizations
(``--realizations``) × the test split's times, and the case's initial
weights (the time does not depend on them). The case is built without simulator labels
(``label_source="files"``, none present: zero labels), as neither side's
time depends on them.

Both sides are timed as device work. The surrogate's features are built and
staged on the device once, and each of ``--reps`` repeats is the predictor's
batches (batch 256; on the card one CUDA graph replay each, the graph
captured in a warm-up run) ending in ``torch.cuda.synchronize()``. One
end-to-end ``predict_pressure`` wall (host weave, copies both ways) is kept
beside it. The simulator (``simulate_labels`` on the same realizations and
times) runs once on 2 realizations as a warm-up, then ``--sim-reps`` times.
Medians are reported with their spread, every repeat's seconds with them.

It runs on the GPU unless ``--device cpu``; without a usable CUDA device it
raises. On the card it first prints the card's name and power limit. The
last line is one JSON object with the reference's keys, plus ``device``,
``setup_s`` and the repeats' seconds.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _spread_pct(ts) -> float:
    """Half the range over the median, in percent (the reference's spread)."""
    return 100.0 * (max(ts) - min(ts)) / (2 * float(np.median(ts)))


def measure_inference(fluid: str = "DG", n_realizations: int = 16, reps: int = 5,
                      nx=None, setup_realizations=None, sim_reps: int = 3,
                      device: str = "cuda", base_dir=None) -> dict:
    import torch

    from srm_tpu_torch.config import DEFAULT_GENERAL_CONFIG
    from srm_tpu_torch.eval.predictor import SRMPredictor
    from srm_tpu_torch.examples.common import setup_case
    from srm_tpu_torch.sim import simulate_labels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = copy.deepcopy(DEFAULT_GENERAL_CONFIG)
    g["label_source"] = "files"
    t0 = time.perf_counter()
    case = setup_case(fluid, base_dir=base_dir or os.path.join(REPO, "_srm_data"), nx=nx,
                      n_realizations=setup_realizations, general_config=g, device=device)
    dev = case["device"]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    setup_s = time.perf_counter() - t0
    proc = case["processor"]
    permx = proc.generate_kle_splits()["test"][:n_realizations]
    times = np.asarray(proc.generate_time_tensor()["test"]).reshape(-1)
    pred = SRMPredictor(case["models"], case["data_summary"],
                        general_config=case["general_config"],
                        reservoir_config=proc.reservoir_config)

    # --- surrogate: features staged on the device once, device-only repeats ---
    feats = pred.build_features(permx, times)
    K, T = feats.shape[:2]
    x = pred.stage(feats.reshape((-1,) + feats.shape[2:]))

    def run_device():
        pred.run_batches("pressure", x)
        sync()

    run_device()                                   # warm-up (and the graph's capture)
    sur_ts = []
    for _ in range(reps):
        t = time.perf_counter()
        run_device()
        sur_ts.append(time.perf_counter() - t)
    t = time.perf_counter()
    pred.predict_pressure(permx, times)           # host → device → host, once
    sur_e2e = time.perf_counter() - t

    # --- the FV simulator on the same workload ---
    simulate_labels(proc, "test", permx=permx[:2], times=times)
    sim_ts = []
    for _ in range(sim_reps):
        sync()
        t = time.perf_counter()
        simulate_labels(proc, "test", permx=permx, times=times)
        sync()
        sim_ts.append(time.perf_counter() - t)

    t_sur, t_sim = float(np.median(sur_ts)), float(np.median(sim_ts))
    res = proc.reservoir_config
    return {
        "grid": f"{res['Nx']}x{res['Ny']}x{res['Nz']}",
        "realizations": int(permx.shape[0]), "timesteps": int(times.size),
        "surrogate_s": t_sur, "simulator_s": t_sim, "surrogate_s_e2e": sur_e2e,
        "surrogate_reps": len(sur_ts), "simulator_reps": len(sim_ts),
        "surrogate_spread_pct": _spread_pct(sur_ts),
        "simulator_spread_pct": _spread_pct(sim_ts),
        "surrogate_fields_per_sec": K * T / t_sur,
        "speedup_vs_simulator": t_sim / t_sur,
        "time_saving_pct": 100.0 * (1.0 - t_sur / t_sim),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "setup_s": setup_s, "surrogate_reps_s": sur_ts, "simulator_reps_s": sim_ts,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m srm_tpu_torch.tools.infer_vs_sim",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--fluid", default="DG", type=str.upper, choices=["DG", "GC"])
    ap.add_argument("--nx", type=int, default=None)
    ap.add_argument("--realizations", type=int, default=16,
                    help="the first K test realizations of the case are the workload "
                         "(default 16, the reference's)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sim-reps", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--base-dir", default=None,
                    help="dataset cache directory (default: _srm_data in the checkout)")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("no usable CUDA device: pass --device cpu to run on the CPU")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0], flush=True)
    result = measure_inference(args.fluid, n_realizations=args.realizations, reps=args.reps,
                               nx=args.nx, sim_reps=args.sim_reps, device=args.device,
                               base_dir=args.base_dir)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
