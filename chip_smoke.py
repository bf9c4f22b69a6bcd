#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, in order; any failure raises and
the process exits non-zero:

1. device — CUDA must be available (there is no CPU path); prints the
   torch/CUDA/nvcc versions and the card's name and power limit; turns TF32
   off for matmuls and cuDNN convolutions (the slice is float32).
2. build — compiles every CUDA kernel of the main path from
   ``srm_tpu_torch/kernels/csrc/`` with nvcc for sm_90a.
3. kernels — each kernel against its plain PyTorch version on the card, at
   the main path's shape and at a ragged one, forward and backward; CUDA
   event times of both at the main path's shape.
4. main path — the dry-gas 2D case at the full 39×39 grid and full model
   widths (only the realization count is cut, to 20: 6 train realizations ×
   51 times = 306 samples, 9 batches of 32), trained for two epochs through
   the port's Trainer. Checks that every loss is finite, that every loss
   evaluation launched the kernel (launch counter), that both trainable
   models changed, and that the kernel and its plain version agree on the
   stencil inputs the trained models give for one batch.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# kernel vs plain: the kernel keeps the plain version's operation order and
# is built without multiply-add contraction, so the two differ only where
# PyTorch's own kernels round differently (division by a scalar as a
# reciprocal multiply, the order of the mbc sum): a few float32 ulps of the
# largest value of each output.
RTOL, ATOL_REL = 1e-4, 1e-5


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


def make_stencil_inputs(B: int, H: int, W: int, seed: int = 0):
    """Physically scaled stencil inputs on the card (pressures in psia,
    permeability in mD, the default reservoir's cell sizes)."""
    import torch
    from srm_tpu_torch.kernels.stencil import StencilConfig
    from srm_tpu_torch.ops.stencil import pad_symmetric
    g = torch.Generator(device="cuda").manual_seed(seed)

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=g, device="cuda")

    p0 = u(4500.0, 5000.0, B, H, W)
    p1 = p0 - u(0.0, 50.0, B, H, W)
    kx = u(0.5, 10.0, B, H, W)
    invBg0 = u(0.9, 1.2, B, H, W)
    invug = u(30.0, 40.0, B, H, W)
    invBg1 = invBg0 * 0.99
    dinvBg0 = u(1e-4, 3e-4, B, H, W)
    q = torch.zeros(B, H, W, device="cuda")
    q[:, H // 2, W // 2] = 500.0
    qwell = torch.zeros(H, W, device="cuda")
    qwell[H // 2, W // 2] = 1.0
    tsteps = u(1.0, 9.0, B, 2)
    cfg = StencilConfig(C=0.001127, D=5.6145833334, dx=2900.0 / 39, dy=2900.0 / 39,
                        dz=80.0, Sgi=0.78, krgo=0.9, phi=0.2)
    args = [pad_symmetric(p0), pad_symmetric(p1), pad_symmetric(kx),
            pad_symmetric(invBg1 * invug), invBg0, invBg1, dinvBg0, q, qwell, tsteps]
    return args, cfg


def time_ms(fn, repeats: int = 7, calls: int = 200) -> float:
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
    from srm_tpu_torch.kernels.build import build_library
    t0 = time.time()
    path, compiler_log = build_library("dg_stencil.cu")
    log(f"build: {os.path.relpath(path, ROOT)} in {time.time() - t0:.2f} s")
    for line in compiler_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


def phase_kernels():
    """dg_stencil_residual vs its plain version; returns (max_abs_err, ms, plain_ms)."""
    import torch
    from srm_tpu_torch.kernels import stencil as st
    max_err = 0.0
    for (B, H, W) in ((32, 39, 39), (3, 13, 17)):
        args, cfg = make_stencil_inputs(B, H, W)
        with torch.no_grad():
            got = st.dg_stencil_residual(*args, cfg)
            want = st.dg_stencil_residual_reference(*args, cfg)
        torch.cuda.synchronize()
        for name, a, b in zip(("dom", "ibc", "tde", "mbc"), got, want):
            max_err = max(max_err, check_close(f"forward {name} B={B} {H}x{W}", a, b))

        # backward: the Function's gradient vs autograd through the plain version
        grads = []
        for fn in (st.dg_stencil_residual, st.dg_stencil_residual_reference):
            p1p = args[1].clone().requires_grad_(True)
            ts = args[9].clone().requires_grad_(True)
            dom, ibc, tde, mbc = fn(args[0], p1p, *args[2:9], ts, cfg)
            loss = (dom ** 2).sum() + (ibc ** 2).sum() + (tde ** 2).sum() + (mbc ** 2).sum()
            grads.append(torch.autograd.grad(loss, (p1p, ts)))
        for name, a, b in zip(("d/dp1p", "d/dtsteps"), grads[0], grads[1]):
            check_close(f"backward {name} B={B} {H}x{W}", a, b)
        log(f"kernel vs plain B={B} {H}x{W}: forward and backward agree "
            f"(max abs err so far {max_err:.3e})")

    args, cfg = make_stencil_inputs(32, 39, 39)
    with torch.no_grad():
        plain_ms = time_ms(lambda: st.dg_stencil_residual_reference(*args, cfg))
        ms = time_ms(lambda: st.dg_stencil_residual(*args, cfg))
        plain_ms2 = time_ms(lambda: st.dg_stencil_residual_reference(*args, cfg))
        ms2 = time_ms(lambda: st.dg_stencil_residual(*args, cfg))
    log(f"time per call at B=32 39x39 (plain, kernel, kernel, plain): "
        f"{plain_ms:.4f} {ms:.4f} {ms2:.4f} {plain_ms2:.4f} ms")
    return max_err, min(ms, ms2), min(plain_ms, plain_ms2)


def phase_main_path(base_dir: str) -> int:
    """Two epochs of the DG 39×39 slice at batch 32; returns the kernel's
    launch count during training."""
    import numpy as np
    import torch
    from srm_tpu_torch.examples.common import setup_case
    from srm_tpu_torch.kernels import stencil as st
    from srm_tpu_torch.training.trainer import train_combined_models_unified

    t0 = time.time()
    case = setup_case("DG", base_dir=base_dir, n_realizations=20, device="cuda")
    loss_fn, models = case["loss_fn"], case["models"]
    if not loss_fn.use_cuda_stencil:
        raise AssertionError("the CUDA stencil is not selected on a CUDA device")
    x_shape = case["train_groups"][0][0].shape
    log(f"setup: train features {x_shape} in {time.time() - t0:.1f} s")
    before = {k: [p.detach().clone() for p in models[k].parameters()]
              for k in ("pressure", "time_step")}

    torch.cuda.reset_peak_memory_stats()
    st.launches = 0
    trainer, history = train_combined_models_unified(
        case["train_groups"], case["val_groups"], loss_fn, training_batch_size=32,
        epochs=2, general_config=case["general_config"])
    torch.cuda.synchronize()
    launches = st.launches

    steps = history["step_total_loss"]
    n_train = trainer._resident["train"][2]
    n_val = trainer._resident["val"][2] if trainer._resident["val"] else 0
    for i, v in enumerate(steps):
        log(f"step {i + 1}: total loss {v:.6e}")
    if len(steps) != 2 * n_train or not np.all(np.isfinite(steps)):
        raise AssertionError(f"expected {2 * n_train} finite step losses, got {steps}")
    if launches != 2 * (n_train + n_val):
        raise AssertionError(f"kernel launched {launches} times for "
                             f"{2 * (n_train + n_val)} loss evaluations")
    for k, ps in before.items():
        if all(torch.equal(a, b) for a, b in zip(ps, models[k].parameters())):
            raise AssertionError(f"the {k} model did not change in training")
    steps_per_s = n_train / (history["epoch_times"][1] / 1000.0)
    log(f"main path: {len(steps)} steps, {launches} kernel launches, "
        f"{steps_per_s:.2f} steps/s in epoch 2, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    # the kernel and its plain version on the stencil inputs that the
    # trained models give for one batch of the main path
    x_all, y_all, _, bs = trainer._resident["train"]
    x, y = x_all[:bs], {k: v[:bs] for k, v in y_all.items()}
    with torch.no_grad():
        args, _ = loss_fn.stencil_inputs(x)
        got = st.dg_stencil_residual(*args, loss_fn.stencil_cfg)
        want = st.dg_stencil_residual_reference(*args, loss_fn.stencil_cfg)
        total, _ = loss_fn.loss_and_metrics(x, y)
    for t, a, b in zip(("dom", "ibc", "tde", "mbc"), got, want):
        want_shape = (bs,) if t == "mbc" else (bs,) + tuple(x_shape[3:5])
        if tuple(a.shape) != want_shape:
            raise AssertionError(f"{t} has shape {tuple(a.shape)}, expected {want_shape}")
        check_close(f"trained-model inputs {t}", a, b)
    if not torch.isfinite(total):
        raise AssertionError(f"non-finite loss {float(total)} after training")
    log(f"trained models: kernel and plain version agree on the main path's stencil "
        f"inputs; total loss {float(total):.6e}")
    return launches


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "srm_tpu_torch")):
        raise SystemExit("chip_smoke: run from the root of a checkout of the repository")
    sys.path.insert(0, ROOT)
    phase_device()
    phase_build()
    max_err, ms, plain_ms = phase_kernels()
    # the case's dataset goes under the checkout's build/ (listed in .gitignore)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="smoke_data_", dir=os.path.join(ROOT, "build")) as tmp:
        launches = phase_main_path(tmp)

    import torch
    log(json.dumps({"kernels": [{
        "name": "dg_stencil_residual", "route": "cuda",
        "source": "srm_tpu_torch/kernels/csrc/dg_stencil.cu",
        "replaces": "srm_tpu/kernels/stencil_pallas.py:132",
        "launches": launches, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
