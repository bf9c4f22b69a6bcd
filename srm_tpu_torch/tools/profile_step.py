"""Profile the port's training step and its stencil kernel on one GPU.

    python -m srm_tpu_torch.tools.profile_step [--case NAME ...] [--steps 9]
                                               [--batch B] [--bf16]
                                               [--precision mixed]
                                               [--dt-stride S] [--out DIR]

For each case it builds the case at 20 realizations, trains warm-up epochs
until the trainer's eager warm-up steps and its graph capture are behind it
(one epoch at batch 32, two at 128, where an epoch holds 2 steps), then
measures on the card. The cases: the configurations
``chip_smoke.py`` trains in float32 (TF32 off) at batch 32, ``dg2d`` (DG
39×39), ``dg3d`` (DG 39×39×10 with uncorrelated fields) and ``gc2d`` (GC
39×39); and ``bench.py``'s production cases (``bench.py:458-480``:
``apply_production_overrides``, i.e. bfloat16 networks and Model 2 on a 2x
strided input), ``dg2d_production`` and ``dg3d_production`` at batch 32
and ``dg3d_production_b128`` at 128, with ``dg2d_production_b128`` and
``gc2d_production_b128`` beside them (``train --production``'s batch);
and ``bench.py``'s cases of the last configurations ported: ``gc3d`` (GC
39×39×10, uncorrelated, f32 at batch 32; no stencil kernel, so no kernel
section), ``gc3d_production`` (the same with bfloat16 networks and the
strided Model 2), ``dg3d_production_b256_remat`` (``dg3d_production`` at
batch 256 with ``remat_forwards``) and ``dg3d_production_b256`` (without
it, the comparison that decides remat), and ``dg2d_large`` (DG 117×117,
uncorrelated, f32 at batch 128). At batch 256 an epoch of the 20
realizations holds one step.
``--batch``, ``--bf16`` (``compute_dtype="bfloat16"``), ``--precision``
and ``--dt-stride`` override every case's batch and config, as
``tools/step_profile.py``'s flags of those names do. Measured:

* the step as the trainer runs it (a CUDA graph replay per step where the
  trainer has graphs, the eager step otherwise): steps/s over the whole
  epochs that hold at least ``--steps`` steps (host clock around work that
  ends in a synchronise), the device operations and device time per step
  from ``torch.profiler`` over as many epochs (CUPTI records the kernels
  inside a graph), the busy share (device time over the window's host-clock length,
  and device time × the untraced steps/s), the convolution and matmul FLOP
  of one loss-and-gradient evaluation (``torch.utils.flop_counter``,
  forward and backward, eager), the peak device memory allocated and
  reserved over the warm-up and timed epochs (reserved includes the
  graph's private pool),
  the step's top device kernels by time (``top_kernels``) and the achieved
  FLOP/s (FLOP/step × steps/s) against a named peak: the card's dense
  bfloat16 tensor-core rate for a case with bfloat16 networks, its float32
  rate outside the tensor cores otherwise;
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

A parent without graphs (whose trainer has no ``cuda_graph``) is profiled
through its ``train_step`` on the epoch's batches, as before.

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

_DG3D = dict(fluid="DG", kernel="dg3d_stencil_residual", nz=10, kle_method="uncorrelated")
# gas condensate in 3D has no stencil kernel (kernel None)
_GC3D = dict(fluid="GC", kernel=None, nz=10, kle_method="uncorrelated")
CASES = {
    "dg2d": dict(fluid="DG", kernel="dg_stencil_residual"),
    "dg3d": _DG3D,
    "gc2d": dict(fluid="GC", kernel="gc_stencil_residual"),
    "dg2d_production": dict(fluid="DG", kernel="dg_stencil_residual", production=True),
    "dg2d_production_b128": dict(fluid="DG", kernel="dg_stencil_residual", production=True,
                                 batch=128),
    "dg3d_production": dict(_DG3D, production=True),
    "dg3d_production_b128": dict(_DG3D, production=True, batch=128),
    "gc2d_production_b128": dict(fluid="GC", kernel="gc_stencil_residual", production=True,
                                 batch=128),
    # bench.py's cases of the JAX package's last training configurations:
    # gc3d (:492), gc3d_production (:467-470: bf16 and the strided Model 2,
    # batch 32), dg3d_production_b256_remat (:480-486) and the same without
    # remat beside it, and dg2d_large (:497-500: 117x117, batch 128)
    "gc3d": _GC3D,
    "gc3d_production": dict(_GC3D, config={"compute_dtype": "bfloat16", "dt_input_stride": 2}),
    "dg3d_production_b256": dict(_DG3D, production=True, batch=256),
    "dg3d_production_b256_remat": dict(_DG3D, production=True, batch=256,
                                       config={"remat_forwards": True}),
    "dg2d_large": dict(fluid="DG", kernel="dg_stencil_residual", nx=117, batch=128,
                       kle_method="uncorrelated"),
}


def _device_events(prof):
    """(kernel count, summed device µs) of the device events of a trace."""
    import torch
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(events), sum(e.time_range.elapsed_us() for e in events)


def top_kernels(prof, steps: int, top: int = 12):
    """The ``top`` device kernels of a trace by summed device time: name
    (cut to 90 characters), launches and µs, each per step."""
    import collections

    import torch
    calls, us = collections.Counter(), collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            calls[e.name] += 1
            us[e.name] += e.time_range.elapsed_us()
    return [{"name": n[:90], "launches": calls[n] / steps, "us": t / steps}
            for n, t in us.most_common(top)]


# the card's published peaks (H100 SXM, NVIDIA's data sheet): HBM bytes/s,
# float32 operations/s outside the tensor cores and dense bfloat16
# tensor-core operations/s
HBM_BYTES_PER_S, FP32_OPS_PER_S, BF16_TENSOR_OPS_PER_S = 3.35e12, 67e12, 989e12


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


def profile_calls(fn, n: int, table: list = None):
    """Run ``fn`` n times under the profiler; returns (device kernels per
    call, device µs per call, host-clock ms of the window). With ``table``
    (a list), appends the trace's :func:`top_kernels` per call to it."""
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
    if table is not None:
        table.extend(top_kernels(prof, n))
    return count / n, device_us / n, window_ms


def case_config(production: bool, overrides: dict, config: dict = None) -> dict:
    """The general config of a case: the defaults, with the production
    overrides where the case has them, then the case's own ``config``, then
    the command line's ``overrides`` (those not None)."""
    import copy

    from srm_tpu_torch.config import DEFAULT_GENERAL_CONFIG, apply_production_overrides
    g = (apply_production_overrides(DEFAULT_GENERAL_CONFIG) if production
         else copy.deepcopy(DEFAULT_GENERAL_CONFIG))
    g.update(config or {})
    g.update({k: v for k, v in overrides.items() if v is not None})
    return g


def profile_case(name: str, base_dir: str, steps: int, batch=None, overrides=None) -> dict:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from srm_tpu_torch.examples.common import setup_case
    from srm_tpu_torch.kernels import stencil as st
    from srm_tpu_torch.training.trainer import Trainer

    spec = dict(CASES[name])
    fluid, kernel = spec.pop("fluid"), spec.pop("kernel")
    g = case_config(spec.pop("production", False), overrides or {}, spec.pop("config", None))
    batch = batch or spec.pop("batch", 32)
    spec.pop("batch", None)
    case = setup_case(fluid, base_dir=base_dir, n_realizations=20, device="cuda",
                      general_config=g, **spec)
    loss_fn = case["loss_fn"]
    trainer = Trainer(loss_fn)
    graphed = bool(getattr(trainer, "cuda_graph", False))
    nb, _ = trainer.stage_dataset("train", case["train_groups"], batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # warm-up: whole epochs until the trainer's eager warm-up steps and its
    # capture are behind it, however few batches an epoch holds
    done = 0
    while done < getattr(Trainer, "warmup_steps", 0) + 1:
        trainer.train_epoch_resident("train")
        done += nb
    torch.cuda.synchronize()

    # timed and profiled: whole epochs, at least ``steps`` steps
    epochs = -(-steps // nb)
    t0 = time.perf_counter()
    for _ in range(epochs):
        trainer.train_epoch_resident("train")
    torch.cuda.synchronize()
    steps_per_s = epochs * nb / (time.perf_counter() - t0)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    reserved_mib = torch.cuda.max_memory_reserved() / 2**20

    x_all, y_all, _, bs = trainer._resident["train"]
    batches = [(x_all[i * bs:(i + 1) * bs], {k: v[i * bs:(i + 1) * bs] for k, v in y_all.items()})
               for i in range(nb)]
    table = []
    if graphed:
        n = epochs * nb
        ops, busy_us, window_ms = profile_calls(
            lambda: [trainer.train_epoch_resident("train") for _ in range(epochs)], 1, table)
        ops_per_step, busy_us, steps = ops / n, busy_us / n, n
        for row in table:
            row["launches"], row["us"] = row["launches"] / n, row["us"] / n
    else:
        cycle = itertools.cycle(batches)
        ops_per_step, busy_us, window_ms = profile_calls(
            lambda: trainer.train_step(*next(cycle)), steps, table)
    with FlopCounterMode(display=False) as flops:
        loss_fn.pinn_batch_sse_grad(*batches[0])
    torch.cuda.synchronize()
    result = {
        "case": name, "batch": bs, "features": list(x_all.shape), "graphed": graphed,
        "compute_dtype": g.get("compute_dtype"), "precision_policy": g.get("precision_policy"),
        "dt_input_stride": g.get("dt_input_stride", 1),
        "remat_forwards": bool(g.get("remat_forwards")),
        "fused_stencil": bool(getattr(loss_fn, "use_cuda_stencil", kernel is not None)),
        **_rates(flops.get_total_flops(), steps_per_s, g.get("compute_dtype") == "bfloat16"),
        "replays": getattr(trainer, "replays", None), "steps_per_s": steps_per_s,
        "samples_per_s": steps_per_s * bs, "profiled_steps": steps,
        "device_ops_per_step": ops_per_step, "device_busy_ms_per_step": busy_us / 1e3,
        "window_ms_per_step": window_ms / steps,
        "device_busy_share": busy_us / 1e3 / (window_ms / steps),
        "busy_share_untraced": busy_us / 1e3 * steps_per_s / 1e3,
        "flop_per_step": flops.get_total_flops(), "peak_memory_mib": peak_mib,
        "peak_reserved_mib": reserved_mib, "top_kernels_per_step": table,
        "kernel": None,
    }
    if kernel is None:
        return result

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

    result["kernel"] = {"name": kernel, "device_us": k_us, "launches_per_call": k_launches,
                        **k_events, "plain_device_us": p_us,
                        "plain_launches_per_call": p_launches, "backward": backward}
    return result


def _rates(flop_per_step: float, steps_per_s: float, bf16: bool) -> dict:
    """The achieved FLOP/s and its share of the named peak: the dense
    bfloat16 tensor-core rate for bfloat16 networks, else the float32 rate
    outside the tensor cores."""
    peak = (("bf16 dense tensor core, H100 SXM data sheet", BF16_TENSOR_OPS_PER_S) if bf16
            else ("fp32 outside the tensor cores, H100 SXM data sheet", FP32_OPS_PER_S))
    flop_per_s = flop_per_step * steps_per_s
    return {"achieved_flop_per_s": flop_per_s, "peak_name": peak[0], "peak_flop_per_s": peak[1],
            "achieved_share_of_peak": flop_per_s / peak[1]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="srm_tpu_torch.tools.profile_step",
                                     description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--case", action="append", choices=sorted(CASES))
    parser.add_argument("--steps", type=int, default=9)
    parser.add_argument("--batch", type=int, default=None,
                        help="batch size of every case (default: the case's)")
    parser.add_argument("--bf16", action="store_true",
                        help='compute_dtype="bfloat16" in every case')
    parser.add_argument("--precision", default=None, choices=["mixed"],
                        help="precision_policy of every case")
    parser.add_argument("--dt-stride", type=int, default=None, dest="dt_stride",
                        help="dt_input_stride of every case")
    parser.add_argument("--out", default=os.path.join("build", "profile"))
    args = parser.parse_args(argv)
    overrides = {"compute_dtype": "bfloat16" if args.bf16 else None,
                 "precision_policy": args.precision, "dt_input_stride": args.dt_stride}

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
            result = {"card": card, "torch": torch.__version__,
                      **profile_case(name, tmp, args.steps, args.batch, overrides)}
            print(json.dumps(result), flush=True)
            with open(os.path.join(args.out, f"profile_{name}.json"), "w") as f:
                json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
