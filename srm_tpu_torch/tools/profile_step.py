"""Profile the port's training step and its stencil kernel on one GPU.

    python -m srm_tpu_torch.tools.profile_step [--case dg2d|dg3d|gc2d ...]
                                               [--steps 9] [--out DIR]

For each case (the configurations ``chip_smoke.py`` trains: DG 39×39, DG
39×39×10 with uncorrelated fields, GC 39×39; batch 32, float32 with TF32
off, 20 realizations) it builds the case, trains one warm-up epoch, then
measures on the card:

* the step: steps/s over one timed epoch (host clock around work that ends
  in a synchronise), the device-busy share and the device operations per
  step from ``torch.profiler`` over ``--steps`` steps (the sum of the
  device kernels' durations over the window's host-clock length), the
  convolution and matmul FLOP of one step (``torch.utils.flop_counter``,
  forward and backward) and the peak device memory of the epoch;
* the case's stencil kernel and its plain version on the stencil inputs of
  one main-path batch: device time per call from the profiler over 100
  calls each, and the device launches each call makes; the same for its
  backward, for the cotangents of a sum of squares of its outputs: the
  backward kernel, its plain version (the explicit adjoint) and autograd
  through the recomputed plain version (``_plain_backward``, what runs on
  the CPU), with each one's host-inclusive time per call (CUDA events
  around back-to-back calls) and the backward's bound (the bytes it must
  move at the HBM rate, ``backward_bytes``); and the kernel's and its
  backward kernel's time on a warm and on a cold L2 (``event_ms``).

Run against another checkout's package (the parent commit, unpacked into a
directory that ``.gitignore`` lists), it measures that checkout's step and
kernels with this file's code, for an A/B in one call::

    PYTHONPATH=build/parent python srm_tpu_torch/tools/profile_step.py --case dg3d

Prints one JSON object per case and writes it to ``DIR/profile_<case>.json``
(default ``build/profile/``, listed in ``.gitignore``). It needs a CUDA device
and fails without one.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

CASES = {
    "dg2d": dict(fluid="DG", kernel="dg_stencil_residual"),
    "dg3d": dict(fluid="DG", kernel="dg3d_stencil_residual", nz=10, kle_method="uncorrelated"),
    "gc2d": dict(fluid="GC", kernel="gc_stencil_residual"),
}


def _device_events(prof):
    """(kernel count, summed device µs) of the device events of a trace."""
    import torch
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(events), sum(e.time_range.elapsed_us() for e in events)


# the card's published peaks (H100 SXM, NVIDIA's data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores
HBM_BYTES_PER_S, FP32_OPS_PER_S = 3.35e12, 67e12


# what a stencil's backward must read of its inputs: not the well rates
# (their gradients are images of the cotangents alone), and of a padded
# input that the stencil reads at the centre only, its interior
BACKWARD_UNREAD = {"dg_stencil_residual": ("q",), "dg3d_stencil_residual": ("q",),
                   "gc_stencil_residual": ("qfg", "qdg", "qfo", "qvo")}
BACKWARD_CENTRE_ONLY = {"dg_stencil_residual": ("p0p",), "dg3d_stencil_residual": ("p0p",),
                        "gc_stencil_residual": ()}


def backward_bytes(kernel: str, args, outs, grads) -> int:
    """The bytes that ``kernel``'s backward must move: each input that it
    reads once (``BACKWARD_UNREAD``, ``BACKWARD_CENTRE_ONLY``), the
    cotangents of the outputs ``outs`` once, each gradient in ``grads``
    written once."""
    from srm_tpu_torch.kernels.stencil import DG3D_ARGS, DG_ARGS, GC_ARGS
    names = {"dg_stencil_residual": DG_ARGS, "dg3d_stencil_residual": DG3D_ARGS,
             "gc_stencil_residual": GC_ARGS + ("qwell", "tsteps")}[kernel]
    cells = outs[0].numel()
    read = sum((cells if n in BACKWARD_CENTRE_ONLY[kernel] else t.numel()) * t.element_size()
               for n, t in zip(names, args, strict=True) if n not in BACKWARD_UNREAD[kernel])
    return read + sum(t.numel() * t.element_size() for t in list(outs) + list(grads))


def time_ms(fn, repeats: int = 5, calls: int = 100) -> float:
    """Median over ``repeats`` of the CUDA-event time per call of ``calls``
    back-to-back calls (launch overhead included, as the loop pays it)."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def event_ms(fn, cold: bool, reps: int = 20) -> float:
    """Median CUDA-event time of one call of ``fn``, on a warm L2 (right
    after the previous call) or, with ``cold``, right after writing a
    256 MiB buffer (over 2x the H100's 50 MB L2). Before each call a spin
    kernel holds the card for ~1 ms, so the host has enqueued the call by
    the time the card reaches it: the events, recorded after the flush and
    the spin, time the card's work and not the host's."""
    import torch
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if cold:
            flush.zero_()
        torch.cuda._sleep(2_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def warm_cold_ms(fn) -> dict:
    """``event_ms`` warm and cold, alternated: warm, cold, cold, warm."""
    w1, c1, c2, w2 = (event_ms(fn, cold) for cold in (False, True, True, False))
    return {"warm_ms": [w1, w2], "cold_ms": [c1, c2]}


def backward_calls(kernel: str, args, cfg) -> dict:
    """Callables computing the kernel's backward on ``args`` for the
    cotangents of a sum of squares of its outputs, every input's gradient
    but qwell's: "kernel" (its backward kernel, where it has one), "adjoint"
    (the kernel's plain version) and "autograd" (autograd through the
    recomputed plain version, as ``_plain_backward`` does it)."""
    from types import SimpleNamespace

    import torch

    from srm_tpu_torch.kernels import stencil as st
    with torch.no_grad():
        cots = [2.0 * o for o in getattr(st, f"{kernel}_reference")(*args, cfg)]
    qwell = len(args) - 2
    ctx = SimpleNamespace(saved_tensors=tuple(args), cfg=cfg,
                          needs_input_grad=tuple(i != qwell for i in range(len(args))) + (False,))
    calls = {"autograd": lambda: st._plain_backward(getattr(st, f"{kernel}_reference"), ctx,
                                                    cots)}
    if hasattr(st, f"{kernel}_backward"):
        calls["kernel"] = lambda: getattr(st, f"{kernel}_backward")(*args, *cots, cfg)
        calls["adjoint"] = lambda: getattr(st, f"{kernel}_backward_reference")(*args, *cots, cfg)
    return calls


def profile_calls(fn, n: int):
    """Run ``fn`` n times under the profiler; returns (device kernels per
    call, device µs per call, host-clock ms of the window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    count, device_us = _device_events(prof)
    return count / n, device_us / n, window_ms


def profile_case(name: str, base_dir: str, steps: int) -> dict:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from srm_tpu_torch.examples.common import setup_case
    from srm_tpu_torch.kernels import stencil as st
    from srm_tpu_torch.training.trainer import Trainer

    spec = dict(CASES[name])
    fluid, kernel = spec.pop("fluid"), spec.pop("kernel")
    case = setup_case(fluid, base_dir=base_dir, n_realizations=20, device="cuda", **spec)
    loss_fn = case["loss_fn"]
    trainer = Trainer(loss_fn)
    nb, _ = trainer.stage_dataset("train", case["train_groups"], 32)
    trainer.train_epoch_resident("train")                       # warm-up
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.train_epoch_resident("train")
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    peak_mib = torch.cuda.max_memory_allocated() / 2**20

    x_all, y_all, _, bs = trainer._resident["train"]
    batches = [(x_all[i * bs:(i + 1) * bs], {k: v[i * bs:(i + 1) * bs] for k, v in y_all.items()})
               for i in range(nb)]
    cycle = itertools.cycle(batches)

    def step():
        trainer.train_step(*next(cycle))

    ops_per_step, busy_us, window_ms = profile_calls(step, steps)
    with FlopCounterMode(display=False) as flops:
        step()
    torch.cuda.synchronize()

    with torch.no_grad():
        args, _ = loss_fn.stencil_inputs(batches[0][0])
        fused, plain = getattr(st, kernel), getattr(st, f"{kernel}_reference")
        k_launches, k_us, _ = profile_calls(lambda: fused(*args, loss_fn.stencil_cfg), 100)
        p_launches, p_us, _ = profile_calls(lambda: plain(*args, loss_fn.stencil_cfg), 100)
        k_events = warm_cold_ms(lambda: fused(*args, loss_fn.stencil_cfg))
    calls = backward_calls(kernel, args, loss_fn.stencil_cfg)
    grads = [g for g in calls["autograd"]() if g is not None]
    with torch.no_grad():
        outs = plain(*args, loss_fn.stencil_cfg)
    nbytes = backward_bytes(kernel, args, outs, grads)
    backward = {"bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    for which, fn in calls.items():
        launches, us, _ = profile_calls(fn, 100)
        backward[which] = {"device_us": us, "launches_per_call": launches,
                           "host_ms": time_ms(fn, repeats=3, calls=20)}
    if "kernel" in calls:
        backward["kernel"].update(warm_cold_ms(calls["kernel"]))

    return {
        "case": name, "batch": bs, "features": list(x_all.shape), "steps_per_s": nb / epoch_s,
        "samples_per_s": nb * bs / epoch_s, "profiled_steps": steps,
        "device_ops_per_step": ops_per_step, "device_busy_ms_per_step": busy_us / 1e3,
        "window_ms_per_step": window_ms / steps,
        "device_busy_share": busy_us / 1e3 / (window_ms / steps),
        "flop_per_step": flops.get_total_flops(), "peak_memory_mib": peak_mib,
        "kernel": {"name": kernel, "device_us": k_us, "launches_per_call": k_launches,
                   **k_events, "plain_device_us": p_us, "plain_launches_per_call": p_launches,
                   "backward": backward},
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="srm_tpu_torch.tools.profile_step",
                                     description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--case", action="append", choices=sorted(CASES))
    parser.add_argument("--steps", type=int, default=9)
    parser.add_argument("--out", default=os.path.join("build", "profile"))
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device is available; it measures a GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    os.makedirs(args.out, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="profile_data_") as tmp:
        for name in args.case or sorted(CASES):
            result = {"card": card, "torch": torch.__version__, **profile_case(name, tmp, args.steps)}
            print(json.dumps(result), flush=True)
            with open(os.path.join(args.out, f"profile_{name}.json"), "w") as f:
                json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
