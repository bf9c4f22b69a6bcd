#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, in order; any failure raises and
the process exits non-zero:

1. device — CUDA must be available (there is no CPU path); prints the
   torch/CUDA/nvcc versions and the card's name and power limit; turns TF32
   off for matmuls and cuDNN convolutions (the slices are float32).
2. build — compiles every CUDA kernel of the main paths from
   ``srm_tpu_torch/kernels/csrc/`` with nvcc for sm_90a, one nvcc per
   source, all started together.
3. kernels — each kernel against its plain PyTorch version on the card, at
   its main path's shape and at a ragged one, forward and backward; CUDA
   event times of both at the main path's shape, and the kernel's bound
   (the larger of its bytes over the HBM rate and its operations over the
   float32 peak), and the card's time for one kernel call on a warm L2 and
   on a cold one (after writing 256 MiB, over 2x the L2). B1 is the 2D
   5-point DG residual, B2 the 3D 7-point one (fed kz ≠ kx), B3 the 2D
   two-phase gas-condensate one.
   Then the backward kernels of B1, B2 and B3, for the cotangents of a sum of
   squares of the outputs, at the same two shapes: against their plain
   version (the explicit adjoint, ``*_backward_reference``) and against
   autograd through the plain forward, within the forward's tolerance
   (B3's p0 gradient, a difference of large terms, within CANCELLING_TOL),
   and bitwise the same over three runs; at the main path's shape the device time (profiler) and the
   host-inclusive time (CUDA events) of the backward kernel, the explicit
   adjoint and ``_plain_backward`` (autograd through the recomputed plain
   version, what the backward was before), warm and cold L2 as above, and
   the kernel's bound.
4. main path DG 2D — the dry-gas 2D case at the full 39×39 grid and full
   model widths, trained for two epochs at batch 32 through the port's
   Trainer.
5. main path DG 3D — the dry-gas 3D case at 39×39×10 (``setup_case("DG",
   nz=10, kle_method="uncorrelated")``, the JAX package's ``dg3d``
   configuration) at full widths, two epochs at batch 32.
6. main path GC 2D — the gas-condensate case at 39×39 (``setup_case("GC")``,
   the JAX package's ``gc2d`` configuration: pressure, time-step and
   saturation networks at full widths), two epochs at batch 32.
   In each, only the realization count is cut, to 20 (6 train realizations
   × 51 times = 306 samples, 9 batches of 32); the launch counters are set
   to 0 just before training and read just after. Each checks that every
   loss is finite, that every loss evaluation launched its kernel and the
   other kernels not at all, that every training step's backward launched
   its backward kernel once with no autograd recompute of the plain
   version, that every trainable model changed, and that the kernel
   and its plain version agree on the stencil inputs the trained models
   give for one batch.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

# kernel vs plain: the kernel keeps the plain version's operation order and
# is built without multiply-add contraction, so the two differ only where
# PyTorch's own kernels round differently (division by a scalar as a
# reciprocal multiply, the order of the mbc sum): a few float32 ulps of the
# largest value of each output.
RTOL, ATOL_REL = 1e-4, 1e-5
# backward kernel vs autograd of the plain forward, for B3's p0: its
# gradient is a difference of large terms (the chord slopes and the
# accumulation), which the kernel rounds in the explicit adjoint's order and
# autograd in its own, each up to a few 1e-4 of the gradient's largest
# magnitude from the float64 gradient (the phase prints both distances); the
# bound is their sum with room
CANCELLING_TOL = 1e-3

DG_OUTPUTS = ("dom", "ibc", "tde", "mbc")
GC_OUTPUTS = ("dom_g", "dom_o", "ibc", "trn_g", "trn_o", "mbc_g", "mbc_o")

# the kernels of the main paths: the wrapper's name in
# srm_tpu_torch.kernels.stencil (its plain version is <name>_reference), the
# source, the TPU kernel it replaces, its launch counter, the shapes it is
# checked at (the main path's first), the arguments it is differentiated by,
# its outputs (per-sample balances start with "mbc") and its floating-point
# operations per cell, counted from the source (comparisons, negations and
# the mbc reduction included)
KERNELS = {
    "dg_stencil_residual": dict(
        source="dg_stencil.cu", replaces="srm_tpu/kernels/stencil_pallas.py:132",
        counter="launches", shapes=[(32, 39, 39), (3, 13, 17)], wrt=(1, 9),
        outputs=DG_OUTPUTS, ops_per_cell=96),
    "dg3d_stencil_residual": dict(
        source="dg3d_stencil.cu", replaces="srm_tpu/kernels/stencil_pallas.py:265",
        counter="launches_3d", shapes=[(32, 10, 39, 39), (3, 5, 13, 17)], wrt=(1, 3, 10),
        outputs=DG_OUTPUTS, ops_per_cell=124),
    "gc_stencil_residual": dict(
        source="gc_stencil.cu", replaces="srm_tpu/kernels/stencil_pallas.py:495",
        counter="launches_gc", shapes=[(32, 39, 39), (3, 13, 17)], wrt=(1, 4, 26),
        outputs=GC_OUTPUTS, ops_per_cell=377),
}


# the backward kernels: the forward they differentiate, the reference's
# custom-vjp backward they replace, their launch counter, qwell's index (no
# gradient), the inputs whose gradient is a difference of large terms (held
# to autograd within CANCELLING_TOL) and their floating-point operations per cell, counted from the
# source as the header of the source states them (the recomputed forward,
# the adjoint, the gather's adds and the Δt block sums)
BACKWARD = {
    "dg_stencil_residual_backward": dict(
        forward="dg_stencil_residual", replaces="srm_tpu/kernels/stencil_pallas.py:568",
        counter="launches_bwd", qwell=8, cancelling=(), ops_per_cell=257),
    "dg3d_stencil_residual_backward": dict(
        forward="dg3d_stencil_residual", replaces="srm_tpu/kernels/stencil_pallas.py:313",
        counter="launches_3d_bwd", qwell=9, cancelling=(), ops_per_cell=291),
    "gc_stencil_residual_backward": dict(
        forward="gc_stencil_residual", replaces="srm_tpu/kernels/stencil_pallas.py:533",
        counter="launches_gc_bwd", qwell=25, cancelling=(0,), ops_per_cell=1016),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check_close(name: str, got, want) -> float:
    """Raise unless |got - want| <= ATOL_REL*max|want| + RTOL*|want|;
    returns the largest absolute error."""
    import torch
    err = (got - want).abs()
    tol = ATOL_REL * want.abs().max() + RTOL * want.abs()
    if not torch.isfinite(got).all() or (err > tol).any():
        raise AssertionError(f"{name}: kernel disagrees with the plain version "
                             f"(max abs err {float(err.max()):.3e}, max |ref| "
                             f"{float(want.abs().max()):.3e})")
    return float(err.max())


def make_gc_inputs(B: int, H: int, W: int, seed: int = 0):
    """B3's inputs on the card, on the scales of the gas-condensate case (the
    PVT table's values between 3500 and 5000 psia, two-phase saturations,
    rates in the centre cell only; p1 = p0 on the first row, where the chord
    slope is masked), in GC_ARGS order, then qwell, tsteps."""
    import torch
    from srm_tpu_torch.kernels.stencil import GC_ARGS, GC_PADDED, GCStencilConfig
    from srm_tpu_torch.ops.stencil import pad_symmetric
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (B, H, W)

    def u(lo, hi, *shp):
        return lo + (hi - lo) * torch.rand(*(shp or shape), generator=g, device="cuda")

    p0 = u(4500.0, 5000.0)
    p1 = p0 - u(0.0, 50.0)
    p1[:, 0, :] = p0[:, 0, :]
    Sg0 = u(0.6, 0.78)
    f = dict(p0=p0, p1p=p1, kxp=u(0.5, 10.0), Sg0=Sg0, Sg1=Sg0 - u(0.0, 0.01),
             krgo1p=u(0.3, 0.9), krog1p=u(0.0, 0.05), invBg0=u(1.85, 1.95),
             invBo0=u(0.30, 0.43), Rs0=u(3.3, 6.1), Rv0=u(0.045, 0.095),
             dinvBg0=u(0.5e-4, 1.5e-4), dinvBo0=u(-1e-4, 0.0), dRs0=u(2e-4, 6e-4),
             dRv0=u(0.0, 2e-5), invBg1p=u(1.85, 1.95), invBo1p=u(0.30, 0.43),
             invug1p=u(14.0, 25.0), invuo1p=u(4.6, 9.1), Rs1p=u(3.3, 6.1), Rv1p=u(0.045, 0.095))
    for k, rate in zip(("qfg", "qdg", "qfo", "qvo"), (1000.0, 500.0, 50.0, 300.0)):
        f[k] = torch.zeros(shape, device="cuda")
        f[k][:, H // 2, W // 2] = rate
    qwell = torch.zeros((H, W), device="cuda")
    qwell[H // 2, W // 2] = 1.0
    args = [pad_symmetric(f[n]) if n in GC_PADDED else f[n] for n in GC_ARGS]
    cfg = GCStencilConfig(C=0.001127, D=5.6145833334, dx=2900.0 / 39, dy=2900.0 / 39,
                          dz=80.0, Swmin=0.22, phi=0.2)
    return args + [qwell, u(1.0, 9.0, B, 2)], cfg


def make_stencil_inputs(name: str, B: int, *grid: int, seed: int = 0):
    """Physically scaled stencil inputs on the card (pressures in psia,
    permeability in mD, the default reservoir's cell sizes) for B1
    (grid = (H, W)), B2 (grid = (D, H, W); kz = 0.1·kx, so that a mix-up
    of kx and kz shows) or B3."""
    if name == "gc_stencil_residual":
        return make_gc_inputs(B, *grid, seed=seed)
    import torch
    from srm_tpu_torch.kernels.stencil import StencilConfig
    from srm_tpu_torch.ops.stencil import pad_symmetric, pad_symmetric_3d
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (B,) + grid
    centre = (0,) * (len(grid) - 2) + (grid[-2] // 2, grid[-1] // 2)

    def u(lo, hi, *shp):
        return lo + (hi - lo) * torch.rand(*shp, generator=g, device="cuda")

    p0 = u(4500.0, 5000.0, *shape)
    p1 = p0 - u(0.0, 50.0, *shape)
    kx = u(0.5, 10.0, *shape)
    invBg0 = u(0.9, 1.2, *shape)
    invug = u(30.0, 40.0, *shape)
    invBg1 = invBg0 * 0.99
    dinvBg0 = u(1e-4, 3e-4, *shape)
    q = torch.zeros(shape, device="cuda")
    q[(slice(None),) + centre] = 500.0
    qwell = torch.zeros(grid, device="cuda")
    qwell[centre] = 1.0
    tsteps = u(1.0, 9.0, B, 2)
    nz = grid[0] if len(grid) == 3 else 1
    cfg = StencilConfig(C=0.001127, D=5.6145833334, dx=2900.0 / 39, dy=2900.0 / 39,
                        dz=80.0 / nz, Sgi=0.78, krgo=0.9, phi=0.2)
    pad = pad_symmetric_3d if len(grid) == 3 else pad_symmetric
    perm = (pad(kx), pad(0.1 * kx)) if len(grid) == 3 else (pad(kx),)
    args = [pad(p0), pad(p1), *perm, pad(invBg1 * invug), invBg0, invBg1, dinvBg0, q, qwell,
            tsteps]
    return args, cfg


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available; this check runs on a GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from srm_tpu_torch.kernels.build import find_nvcc
    nvcc = subprocess.run([find_nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"CUDA {torch.version.cuda}  nvcc: {nvcc}")
    log(f"device: {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()})")
    log(smi)                                   # the card's name and power limit


def phase_build():
    """One nvcc per kernel source, all started together."""
    from srm_tpu_torch.kernels.build import build_library

    def build(source):
        t0 = time.time()
        path, compiler_log = build_library(source)
        return source, path, compiler_log, time.time() - t0

    with ThreadPoolExecutor(len(KERNELS)) as pool:
        results = list(pool.map(build, [k["source"] for k in KERNELS.values()]))
    for source, path, compiler_log, seconds in results:
        log(f"build: {source} -> {os.path.relpath(path, ROOT)} in {seconds:.2f} s")
        for line in compiler_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas: {line.strip()}")


def phase_kernels(name: str) -> dict:
    """One kernel vs its plain version, forward and backward, at its main
    path's shape and a ragged one; returns its measured numbers and bound
    at the main path's shape."""
    import torch
    from srm_tpu_torch.kernels import stencil as st
    from srm_tpu_torch.tools.profile_step import (FP32_OPS_PER_S, HBM_BYTES_PER_S, time_ms,
                                                  warm_cold_ms)
    spec = KERNELS[name]
    fused, plain = getattr(st, name), getattr(st, f"{name}_reference")
    max_err = 0.0
    for shape in spec["shapes"]:
        args, cfg = make_stencil_inputs(name, *shape)
        with torch.no_grad():
            got = fused(*args, cfg)
            want = plain(*args, cfg)
        torch.cuda.synchronize()
        for out, a, b in zip(spec["outputs"], got, want):
            max_err = max(max_err, check_close(f"{name} forward {out} {shape}", a, b))

        # backward: the Function's gradient vs autograd through the plain version
        grads = []
        for fn in (fused, plain):
            a = list(args)
            for i in spec["wrt"]:
                a[i] = args[i].clone().requires_grad_(True)
            loss = sum((o ** 2).sum() for o in fn(*a, cfg))
            grads.append(torch.autograd.grad(loss, [a[i] for i in spec["wrt"]]))
        for i, a, b in zip(spec["wrt"], grads[0], grads[1]):
            check_close(f"{name} backward d/d(arg {i}) {shape}", a, b)
        log(f"{name} kernel vs plain {shape}: forward and backward agree "
            f"(max abs err so far {max_err:.3e})")

    args, cfg = make_stencil_inputs(name, *spec["shapes"][0])
    with torch.no_grad():
        plain_ms = time_ms(lambda: plain(*args, cfg))
        ms = time_ms(lambda: fused(*args, cfg))
        ms2 = time_ms(lambda: fused(*args, cfg))
        plain_ms2 = time_ms(lambda: plain(*args, cfg))
        outs = fused(*args, cfg)
        events = warm_cold_ms(lambda: fused(*args, cfg))
    # the least time for this call: each input read once, each output
    # written once, at the HBM rate; or its operations at the float32 peak
    nbytes = sum(t.numel() * t.element_size() for t in list(args) + list(outs))
    ops = spec["ops_per_cell"] * outs[0].numel()
    bounds = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "operations": ops / FP32_OPS_PER_S * 1e3}
    bound_by = max(bounds, key=bounds.get)
    log(f"{name} time per call at {spec['shapes'][0]} (plain, kernel, kernel, plain): "
        f"{plain_ms:.4f} {ms:.4f} {ms2:.4f} {plain_ms2:.4f} ms; {nbytes} bytes, {ops} "
        f"operations: bound {bounds[bound_by]:.6f} ms by {bound_by}; one call on the card "
        f"(warm, cold, cold, warm L2): {events['warm_ms'][0]:.4f} {events['cold_ms'][0]:.4f} "
        f"{events['cold_ms'][1]:.4f} {events['warm_ms'][1]:.4f} ms")
    return {"max_abs_err": max_err, "ms": min(ms, ms2), "plain_ms": min(plain_ms, plain_ms2),
            "bound_ms": bounds[bound_by], "bound_by": bound_by, **events}


def phase_backward(name: str) -> dict:
    """One backward kernel vs its explicit adjoint and vs autograd through
    the plain forward, at its forward's two shapes, and bitwise run to run;
    returns its measured numbers and bound at the main path's shape."""
    import torch
    from srm_tpu_torch.kernels import stencil as st
    from srm_tpu_torch.tools.profile_step import (FP32_OPS_PER_S, HBM_BYTES_PER_S, backward_bytes,
                                                  backward_calls, profile_calls, time_ms,
                                                  warm_cold_ms)
    spec = BACKWARD[name]
    fwd = KERNELS[spec["forward"]]
    qwell = spec["qwell"]
    max_err = 0.0
    plain = getattr(st, f"{spec['forward']}_reference")
    adjoint = getattr(st, f"{spec['forward']}_backward_reference")
    for shape in fwd["shapes"]:
        args, cfg = make_stencil_inputs(spec["forward"], *shape)
        calls = backward_calls(spec["forward"], args, cfg)
        got = calls["kernel"]()
        want = calls["adjoint"]()
        torch.cuda.synchronize()
        grads = calls["autograd"]()[:-1]
        # the same cotangents, and the explicit adjoint in float64: the
        # gradient both float32 versions round
        with torch.no_grad():
            cots = [2.0 * o.double() for o in plain(*args, cfg)]
            exact = adjoint(*(a.double() for a in args), *cots, cfg)
        worst = 0.0
        for i in range(len(args)):
            if i == qwell:
                if got[i] is not None:
                    raise AssertionError(f"{name} gave a gradient for qwell")
                continue
            max_err = max(max_err, check_close(f"{name} d/d(arg {i}) {shape}", got[i], want[i]))
            scale = float(grads[i].abs().max())
            err = float((got[i] - grads[i]).abs().max())
            if i in spec["cancelling"]:
                exact_scale = float(exact[i].abs().max())
                log(f"{name} d/d(arg {i}) {shape}: kernel {err / scale:.3e} of its scale from "
                    f"autograd; from the float64 gradient kernel "
                    f"{float((got[i].double() - exact[i]).abs().max()) / exact_scale:.3e}, "
                    f"autograd {float((grads[i].double() - exact[i]).abs().max()) / exact_scale:.3e}")
                if not torch.isfinite(got[i]).all() or err > CANCELLING_TOL * scale:
                    raise AssertionError(f"{name} d/d(arg {i}) {shape}: {err:.3e} from autograd "
                                         f"(scale {scale:.3e})")
            else:
                check_close(f"{name} d/d(arg {i}) {shape} vs autograd", got[i], grads[i])
            worst = max(worst, err / scale)
        for _ in range(3):
            again = calls["kernel"]()
            if not all(a is None or torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{name} {shape}: not the same bit for bit run to run")
        log(f"{name} {shape}: agrees with the explicit adjoint (max abs err so far "
            f"{max_err:.3e}) and with autograd of the plain forward (largest difference "
            f"{worst:.3e} of a gradient's scale), "
            f"bitwise the same over three runs")

    args, cfg = make_stencil_inputs(spec["forward"], *fwd["shapes"][0])
    calls = backward_calls(spec["forward"], args, cfg)
    host = {k: time_ms(calls[k], calls=20) for k in ("adjoint", "kernel", "autograd")}
    host2 = {k: time_ms(calls[k], calls=20) for k in ("autograd", "kernel", "adjoint")}
    device = {k: profile_calls(calls[k], 20) for k in ("kernel", "adjoint", "autograd")}
    events = warm_cold_ms(calls["kernel"])
    # the least time: each input that the backward needs read once (not the
    # well rates; p0p's interior only), each cotangent read once, each
    # gradient (all but qwell's) written once; or its operations at the
    # float32 peak
    got = calls["kernel"]()
    with torch.no_grad():
        outs = plain(*args, cfg)
    nbytes = backward_bytes(spec["forward"], args, outs, [g for g in got if g is not None])
    ops = spec["ops_per_cell"] * outs[0].numel()
    bounds = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "operations": ops / FP32_OPS_PER_S * 1e3}
    bound_by = max(bounds, key=bounds.get)
    ms = {k: min(host[k], host2[k]) for k in host}
    log(f"{name} at {fwd['shapes'][0]}: host-inclusive ms per call (adjoint, kernel, autograd; "
        f"autograd, kernel, adjoint): {host['adjoint']:.4f} {host['kernel']:.4f} "
        f"{host['autograd']:.4f}; {host2['autograd']:.4f} {host2['kernel']:.4f} "
        f"{host2['adjoint']:.4f}")
    log(f"{name} device us per call and launches: " + ", ".join(
        f"{k} {device[k][1]:.2f} us / {device[k][0]:.0f}" for k in device)
        + f"; {nbytes} bytes, {ops} operations: bound {bounds[bound_by]:.6f} ms by {bound_by}; "
        f"one kernel call on the card (warm, cold, cold, warm L2): {events['warm_ms'][0]:.4f} "
        f"{events['cold_ms'][0]:.4f} {events['cold_ms'][1]:.4f} {events['warm_ms'][1]:.4f} ms")
    return {"max_abs_err": max_err, "ms": ms["kernel"], "plain_ms": ms["adjoint"],
            "bound_ms": bounds[bound_by], "bound_by": bound_by,
            "device_us": device["kernel"][1], "launches_per_call": device["kernel"][0],
            "plain_device_us": device["adjoint"][1],
            "plain_launches_per_call": device["adjoint"][0],
            "autograd_ms": ms["autograd"], "autograd_device_us": device["autograd"][1],
            "autograd_launches_per_call": device["autograd"][0], **events}


def phase_main_path(base_dir: str, kernel: str, fluid: str = "DG", **case_kwargs) -> dict:
    """Two epochs at batch 32 of the case ``setup_case(fluid, **case_kwargs)``;
    returns the launch counts during training, and checks that no other
    kernel launched and that each training step's backward went through
    ``kernel``'s backward kernel, where it has one, and nothing else."""
    import numpy as np
    import torch
    from srm_tpu_torch.examples.common import setup_case
    from srm_tpu_torch.kernels import stencil as st
    from srm_tpu_torch.training.trainer import train_combined_models_unified

    t0 = time.time()
    case = setup_case(fluid, base_dir=base_dir, n_realizations=20, device="cuda",
                      **case_kwargs)
    loss_fn, models = case["loss_fn"], case["models"]
    if not loss_fn.use_cuda_stencil:
        raise AssertionError("the CUDA stencil is not selected on a CUDA device")
    x_shape = case["train_groups"][0][0].shape
    grid = tuple(x_shape[3:-1])                  # (H, W) or (D, H, W)
    log(f"setup: train features {x_shape} in {time.time() - t0:.1f} s")
    trained = [loss_fn.logical_name(k) for k in loss_fn.trainable_models_keys]
    before = {k: [p.detach().clone() for p in models[k].parameters()] for k in trained}

    torch.cuda.reset_peak_memory_stats()
    counters = [k["counter"] for k in KERNELS.values()] + [k["counter"] for k in BACKWARD.values()]
    plain_backward, recomputes = st._plain_backward, []

    def counted(*a):
        recomputes.append(1)
        return plain_backward(*a)

    st._plain_backward = counted
    try:
        for c in counters:
            setattr(st, c, 0)
        trainer, history = train_combined_models_unified(
            case["train_groups"], case["val_groups"], loss_fn, training_batch_size=32,
            epochs=2, general_config=case["general_config"])
        torch.cuda.synchronize()
        counts = {c: getattr(st, c) for c in counters}
    finally:
        st._plain_backward = plain_backward

    steps = history["step_total_loss"]
    n_train = trainer._resident["train"][2]
    n_val = trainer._resident["val"][2] if trainer._resident["val"] else 0
    for i, v in enumerate(steps):
        log(f"step {i + 1}: total loss {v:.6e}")
    if len(steps) != 2 * n_train or not np.all(np.isfinite(steps)):
        raise AssertionError(f"expected {2 * n_train} finite step losses, got {steps}")
    mine = KERNELS[kernel]["counter"]
    bwd = next((b["counter"] for b in BACKWARD.values() if b["forward"] == kernel), None)
    want = {c: 2 * (n_train + n_val) if c == mine else 2 * n_train if c == bwd else 0
            for c in counters}
    want_recomputes = 0 if bwd else 2 * n_train
    if counts != want or len(recomputes) != want_recomputes:
        raise AssertionError(
            f"kernel launches {counts} and {len(recomputes)} plain recomputes, expected {want} "
            f"and {want_recomputes} for {2 * (n_train + n_val)} loss evaluations, "
            f"{2 * n_train} of them with a backward")
    for k, ps in before.items():
        if all(torch.equal(a, b) for a, b in zip(ps, models[k].parameters())):
            raise AssertionError(f"the {k} model did not change in training")
    steps_per_s = n_train / (history["epoch_times"][1] / 1000.0)
    log(f"main path {fluid} {grid}: {len(steps)} steps, launches {counts}, "
        f"{len(recomputes)} plain recomputes, "
        f"{steps_per_s:.2f} steps/s in epoch 2, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    # the kernel and its plain version on the stencil inputs that the
    # trained models give for one batch of the main path
    x_all, y_all, _, bs = trainer._resident["train"]
    x, y = x_all[:bs], {k: v[:bs] for k, v in y_all.items()}
    with torch.no_grad():
        args, _ = loss_fn.stencil_inputs(x)
        got = getattr(st, kernel)(*args, loss_fn.stencil_cfg)
        want_out = getattr(st, f"{kernel}_reference")(*args, loss_fn.stencil_cfg)
        total, _ = loss_fn.loss_and_metrics(x, y)
    for t, a, b in zip(KERNELS[kernel]["outputs"], got, want_out):
        want_shape = (bs,) if t.startswith("mbc") else (bs,) + grid
        if tuple(a.shape) != want_shape:
            raise AssertionError(f"{t} has shape {tuple(a.shape)}, expected {want_shape}")
        check_close(f"trained-model inputs {t}", a, b)
    if not torch.isfinite(total):
        raise AssertionError(f"non-finite loss {float(total)} after training")
    log(f"trained models: {kernel} and its plain version agree on the main path's "
        f"stencil inputs; total loss {float(total):.6e}")
    return counts


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "srm_tpu_torch")):
        raise SystemExit("chip_smoke: run from the root of a checkout of the repository")
    sys.path.insert(0, ROOT)
    t_start = time.time()
    phase_device()
    phase_build()
    measured = {name: phase_kernels(name) for name in KERNELS}
    measured.update({name: phase_backward(name) for name in BACKWARD})
    # the cases' datasets go under the checkout's build/ (listed in .gitignore)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    counts = {}
    with tempfile.TemporaryDirectory(prefix="smoke_data_", dir=os.path.join(ROOT, "build")) as tmp:
        counts["dg_stencil_residual"] = phase_main_path(tmp, "dg_stencil_residual")
        counts["dg3d_stencil_residual"] = phase_main_path(
            tmp, "dg3d_stencil_residual", nz=10, kle_method="uncorrelated")
        counts["gc_stencil_residual"] = phase_main_path(tmp, "gc_stencil_residual",
                                                        fluid="GC")
    # each kernel's launches on its own main path (a backward kernel's on
    # its forward's)
    launches = {name: counts[name][spec["counter"]] for name, spec in KERNELS.items()}
    launches.update({name: counts[spec["forward"]][spec["counter"]]
                     for name, spec in BACKWARD.items()})
    sources = {name: KERNELS[spec["forward"]]["source"] for name, spec in BACKWARD.items()}
    sources.update({name: spec["source"] for name, spec in KERNELS.items()})
    replaces = {name: spec["replaces"] for name, spec in {**KERNELS, **BACKWARD}.items()}

    import torch
    log(f"all phases passed in {time.time() - t_start:.1f} s")
    # library_ms: no single PyTorch call computes any of these stencils or
    # their gradients
    log(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"srm_tpu_torch/kernels/csrc/{sources[name]}",
        "replaces": replaces[name], "launches": launches[name], **measured[name],
        "library_ms": None} for name in measured]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
