"""Data-parallel training of a case over the ranks that torchrun starts:
steps/s against one rank, and the gradient all-reduce on the device.

    torchrun --standalone --nproc-per-node=N -m srm_tpu_torch.tools.data_parallel
        [--fluid DG|GC] [--batch 32] [--realizations 20] [--epochs 3]
        [--nx N] [--nz N] [--base-dir DIR] [--device cuda|cpu] [--spatial K]
        [--label-source simulator|files] [--remat]

``--spatial K`` trains on ``make_mesh(N, spatial=K)``: N/K data blocks of
the batch, each rank also its rows of H (``parallel/halo.py``), with the
halo exchanges (NCCL point-to-point sends) in the step's graph beside the
all-reduce. ``--remat`` sets ``remat_forwards`` (the ranks and the rank
alone): the backward recomputes each network's forward, on a space axis
its halo exchanges too, inside the same graph. ``--nz``
gives the 3D case (uncorrelated permeability fields). ``--label-source
files`` gives zero labels, which the physics-mode loss never reads, so that
setup simulates no split.

Every rank builds the case (rank 0 builds the dataset cache, the others
then load it) and trains it from the same initial weights through the
trainer over the process group (``parallel/mesh.py``): NCCL on the card,
each step one CUDA graph replay with the gradient all-reduce inside it;
gloo on the CPU (``--device cpu``, eager). The first epoch warms up and
captures; the per-step totals of every epoch are rank 0's (each rank's are
the same, the whole batch's). Then, on the card, the ranks meet at a
barrier and a profiler window over an epoch's replayed steps (9 at most)
gives rank 0's device operations, the device ms of its other kernels, and
its NCCL all-reduce kernels per step with the median and least of their
device us (each includes the wait for the slowest rank). Then rank 0 trains the
same case alone (no process group; the other ranks wait) from the same
weights on the same batches, its epochs timed the same way, and its first
step's total is held to the ranks' within FIRST_RTOL, and the gradients
that the ranks' first step handed the optimizers (summed over the ranks)
to its own within GRAD_RTOL (SPACE_GRAD_RTOL on a space axis on the card)
per model (but NOISY_GRADIENTS'): the same
function of the same weights, summed in another order (each rank's
block, then the all-reduce). Adam would hide a mean over the ranks in the weights; the
gradients show it. Later steps move apart as float32 rounding, which Adam
magnifies and Model 2's noisy gradient feeds (ROADMAP C2), moves the
weights, so they are printed, not held. Past either bound, after the
ranks have ended, rank 0 exits non-zero.

Prints, on rank 0, one JSON line last: ``world``, ``spatial``, ``remat``,
``batch``, ``rows`` (a rank's batch rows), ``h_rows`` (its rows of H), the steps/s of
each timed epoch over the ranks and alone, ``nccl_kernels_per_step``,
``all_reduce_us_median``, ``all_reduce_us_min``, ``send_recv_kernels_per_step``,
``send_recv_us_per_step`` (the halo exchanges' NCCL kernels, with their
waits), ``compute_ms_per_step``, ``device_ops_per_step`` (null on the CPU:
not measured), the peak allocated and reserved bytes of each rank's
training and of the rank alone (``peak_allocated``, ``peak_reserved``,
``alone_peak_allocated``: over what the ranks' trainer still holds on rank
0's card, ``alone_peak_reserved``: with it; null on the CPU),
``first_step_rtol``, ``grad_gaps`` (per model the summed and, for
comparison, the averaged gradients' relative distance), ``grad_rtol``, the
first epoch's per-step totals over the ranks and alone, ``device`` and
``card`` (the name and power limit ``nvidia-smi`` gives).
"""

from __future__ import annotations

import argparse
import copy
import json
import re
import subprocess
import sys
import time

#: the first step's total over the ranks against one rank's, relative
FIRST_RTOL = 1e-5
#: the first step's gradients summed over the ranks against one rank's on
#: the whole batch, per model, as the L2 distance over the norm (float32
#: sums in another order; an average over n ranks is 1 - 1/n off: 0.5 at
#: 2 ranks, 0.75 at 4). Readings of the pressure net: DG 9×9 on the CPU,
#: 0.0054-0.0092 at 2 and 4 ranks.
GRAD_RTOL = 0.05
#: the same on a space axis on the card (``--spatial``): each convolution
#: and stencil cell is computed from the same rows as on one rank, only the
#: sums run in another order. Readings on H100s: 6.6e-8 to 7.7e-6 (chip
#: smoke's phase 19, two ranks on one card), 3.2e-6 and 5.0e-6 at 2 × 2; a
#: halo exchange whose backward drops the halo rows' cotangents (a block's
#: edge gradients lost) reads 2.2e-3 in phase 19 (DG 39²) and 2.0e-2 at
#: DG 13×13 over 2 CPU ranks. On the CPU the sound reading is 2.2e-3 there
#: (oneDNN's float32 convolutions on row blocks of other shapes), so the
#: CPU keeps GRAD_RTOL, and the CPU tests hold the space axis in float64.
SPACE_GRAD_RTOL = 1e-4
#: the models whose float32 gradient is rounding noise (the Δt net,
#: ROADMAP C2: 3.6 apart at 2 ranks of DG 9×9 on the CPU, 0.21 at 4 ranks of
#: DG 39×39 b32 on H100s, against 2.1 and 0.80 if averaged): their distance
#: is printed, not held. Every gradient shares the one all-reduce, so a
#: mean over the ranks shows in the pressure net's (5.5e-6 there, 0.75 if
#: averaged).
NOISY_GRADIENTS = ("time_step",)


def _epochs(trainer, n: int, sync) -> tuple:
    """``n`` epochs of the staged split: each one's per-step metrics and
    steps/s (host clock, synchronised)."""
    metrics, rates = [], []
    for _ in range(n):
        sync()
        t0 = time.perf_counter()
        metrics.append(trainer.train_epoch_resident("train"))
        sync()
        rates.append(trainer._resident["train"][2] / (time.perf_counter() - t0))
    return metrics, rates


def record_first_gradients(trainer) -> dict:
    """Make ``trainer`` copy the gradients that its next training step
    hands the optimizers (under a group, summed over the ranks) to the
    host; returns the dict that the step fills, by optimizer key. The step
    must run eagerly (the first steps of a graphed trainer do)."""
    first: dict = {}
    body = trainer._train_body

    def recording(s):
        body(s)
        if not first:
            first.update({k: [g.detach().cpu().clone() for g in v]
                          for k, v in trainer._grad_views.items()})

    trainer._train_body = recording
    return first


def gradient_gaps(got: dict, want: dict, world: int) -> dict:
    """Per model: the L2 distance of the ranks' summed gradients ``got``
    from one rank's ``want`` over its norm, and the same for their average
    over ``world`` ranks (what DDP's mean would leave)."""
    import torch

    def rel(a, b):
        num = torch.sqrt(sum(((x.double() - y.double()) ** 2).sum() for x, y in zip(a, b)))
        return float(num / torch.sqrt(sum((y.double() ** 2).sum() for y in b)))

    return {k: {"summed": rel(got[k], want[k]),
                "averaged": rel([g / world for g in got[k]], want[k])} for k in want}


def _device(trainer, steps: int = 9, names=None) -> dict:
    """A profiler window over ``steps`` replayed steps (at most an epoch's):
    device operations and the
    device ms of everything but the NCCL kernels per step, the NCCL
    all-reduce kernels per step with the median and least of their device
    us, the point-to-point (halo) kernels per step and their device us per
    step, and how many device kernels of each of ``names`` (name → device
    name) it shows. An NCCL kernel's time includes its wait for the slowest
    rank, which the profiler's start on each rank skews, so the median
    stands for the all-reduce, not the sum."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    steps = min(steps, trainer._resident["train"][2])
    replays = trainer.replays["train"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.train_epoch_resident("train", steps=steps)
        torch.cuda.synchronize()
    if trainer.replays["train"] != replays + steps:
        raise AssertionError("the profiled steps were not graph replays")
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    nccl = [e for e in device if re.search(r"nccl\w*AllReduce", e.name)]
    p2p = [e for e in device if re.search(r"nccl\w*(SendRecv|Send|Recv)", e.name)]
    us = [e.time_range.elapsed_us() for e in nccl]
    p2p_us = sum(e.time_range.elapsed_us() for e in p2p)
    return {"device_ops_per_step": len(device) / steps,
            "compute_ms_per_step": (sum(e.time_range.elapsed_us() for e in device) - sum(us)
                                    - p2p_us) / steps / 1e3,
            "nccl_kernels_per_step": len(nccl) / steps,
            "send_recv_kernels_per_step": len(p2p) / steps,
            "send_recv_us_per_step": p2p_us / steps,
            "all_reduce_us_median": float(np.median(us)) if us else None,
            "all_reduce_us_min": min(us) if us else None,
            "nccl_kernels": sorted({e.name for e in nccl + p2p}),
            "seen": {k: sum(bool(re.search(rf"(^|::){n}\(", e.name)) for e in device)
                     for k, n in (names or {}).items()}}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--fluid", default="DG", type=str.upper, choices=["DG", "GC"])
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--realizations", type=int, default=20)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--nx", type=int, default=None)
    p.add_argument("--nz", type=int, default=None)
    p.add_argument("--base-dir", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--spatial", type=int, default=1)
    p.add_argument("--label-source", default=None, choices=["simulator", "files"])
    p.add_argument("--remat", action="store_true", help="set remat_forwards")
    args = p.parse_args(argv)

    import torch

    from srm_tpu_torch.config import DEFAULT_GENERAL_CONFIG
    from srm_tpu_torch.examples.common import setup_case
    from srm_tpu_torch.parallel.mesh import Mesh, barrier, make_mesh, process_group_from_env
    from srm_tpu_torch.training.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = args.device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    with process_group_from_env(args.device):
        mesh = make_mesh(spatial=args.spatial)
        g = copy.deepcopy(DEFAULT_GENERAL_CONFIG)
        if args.label_source:
            g["label_source"] = args.label_source
        g["remat_forwards"] = args.remat
        case = setup_case(args.fluid, base_dir=args.base_dir, nx=args.nx, nz=args.nz,
                          n_realizations=args.realizations, device=args.device,
                          general_config=g, kle_method="uncorrelated" if args.nz else None)
        initial = copy.deepcopy(case["models"])

        def trainer_over(m):
            loss = copy.copy(case["loss_fn"])
            loss.models = {**loss.models, **copy.deepcopy(
                {k: initial[k] for k in (loss.logical_name(key)
                                         for key in loss.trainable_models_keys)})}
            t = Trainer(loss, mesh=m)
            t.stage_dataset("train", case["train_groups"], args.batch)
            return t

        def peaks(base: int = 0):
            """Peak allocated bytes over ``base`` and peak reserved bytes."""
            if not cuda:
                return None, None
            return torch.cuda.max_memory_allocated() - base, torch.cuda.max_memory_reserved()

        if cuda:
            torch.cuda.reset_peak_memory_stats()
        ranks = trainer_over(mesh)
        failures, result = [], None
        try:
            grads = record_first_gradients(ranks)
            metrics, rates = _epochs(ranks, args.epochs, sync)
            peak = [peaks()] * mesh.size
            if mesh.group is not None:
                torch.distributed.all_gather_object(peak, peaks())
            barrier(mesh)
            device = _device(ranks) if cuda else {}
            rows = ranks._states[("train", "train", ranks._resident["train"][3])].rows
            h_rows = ranks._resident["train"][0].shape[-3]
            if mesh.rank == 0:
                base = 0
                if cuda:
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                alone = trainer_over(Mesh(device=mesh.device))
                alone_grads = record_first_gradients(alone)
                alone_metrics, alone_rates = _epochs(alone, args.epochs, sync)
                alone_peak = peaks(base)
                totals, alone_totals = (m[0]["total"].tolist() for m in (metrics, alone_metrics))
                first = abs(totals[0] - alone_totals[0]) / abs(alone_totals[0])
                gaps = gradient_gaps(grads, alone_grads, mesh.size)
                bound = SPACE_GRAD_RTOL if cuda and mesh.space_size > 1 else GRAD_RTOL
                card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                        "--format=csv,noheader"], capture_output=True,
                                       text=True).stdout.strip().splitlines()[0]
                        if cuda else None)
                result = {"world": mesh.size, "spatial": mesh.space_size, "remat": args.remat,
                          "batch": args.batch,
                          "rows": rows, "h_rows": h_rows,
                          "steps_per_s": rates, "alone_steps_per_s": alone_rates,
                          **{k: device.get(k) for k in ("nccl_kernels_per_step",
                                                        "all_reduce_us_median",
                                                        "all_reduce_us_min",
                                                        "send_recv_kernels_per_step",
                                                        "send_recv_us_per_step",
                                                        "compute_ms_per_step",
                                                        "device_ops_per_step")},
                          "peak_allocated": [p[0] for p in peak],
                          "peak_reserved": [p[1] for p in peak],
                          "alone_peak_allocated": alone_peak[0],
                          "alone_peak_reserved": alone_peak[1],
                          "first_step_rtol": first, "grad_gaps": gaps, "grad_rtol": bound,
                          "totals": totals, "alone_totals": alone_totals,
                          "device": torch.cuda.get_device_name(mesh.device) if cuda else "cpu",
                          "card": card}
                if device.get("nccl_kernels"):
                    print("NCCL kernels:", device["nccl_kernels"])
                print(json.dumps(result))
                if first > FIRST_RTOL:
                    failures.append(f"the first step's total is {first:.3e} from one rank's "
                                    f"(bound {FIRST_RTOL})")
                failures += [f"the first step's {k} gradients are {g['summed']:.3e} from one "
                             f"rank's (bound {bound})" for k, g in gaps.items()
                             if k not in NOISY_GRADIENTS and g["summed"] > bound]
        finally:
            ranks.release_graphs()          # before the group ends
        barrier(mesh)
    if failures:
        raise SystemExit(f"over {mesh.size} ranks: " + "; ".join(failures))
    return result


if __name__ == "__main__":
    main()
    sys.exit(0)
