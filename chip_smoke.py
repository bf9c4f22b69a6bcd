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
   float32 peak). B1 is the 2D 5-point DG residual, B2 the 3D 7-point one
   (fed kz ≠ kx), B3 the 2D two-phase gas-condensate one.
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
   other kernels not at all, that every trainable model changed, and that
   the kernel and its plain version agree on the stencil inputs the trained
   models give for one batch.

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
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

# kernel vs plain: the kernel keeps the plain version's operation order and
# is built without multiply-add contraction, so the two differ only where
# PyTorch's own kernels round differently (division by a scalar as a
# reciprocal multiply, the order of the mbc sum): a few float32 ulps of the
# largest value of each output.
RTOL, ATOL_REL = 1e-4, 1e-5

# the card's published peaks (H100 SXM, NVIDIA's data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores
HBM_BYTES_PER_S, FP32_OPS_PER_S = 3.35e12, 67e12

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
    # the least time for this call: each input read once, each output
    # written once, at the HBM rate; or its operations at the float32 peak
    nbytes = sum(t.numel() * t.element_size() for t in list(args) + list(outs))
    ops = spec["ops_per_cell"] * outs[0].numel()
    bounds = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "operations": ops / FP32_OPS_PER_S * 1e3}
    bound_by = max(bounds, key=bounds.get)
    log(f"{name} time per call at {spec['shapes'][0]} (plain, kernel, kernel, plain): "
        f"{plain_ms:.4f} {ms:.4f} {ms2:.4f} {plain_ms2:.4f} ms; {nbytes} bytes, {ops} "
        f"operations: bound {bounds[bound_by]:.6f} ms by {bound_by}")
    return {"max_abs_err": max_err, "ms": min(ms, ms2), "plain_ms": min(plain_ms, plain_ms2),
            "bound_ms": bounds[bound_by], "bound_by": bound_by}


def phase_main_path(base_dir: str, kernel: str, fluid: str = "DG", **case_kwargs) -> int:
    """Two epochs at batch 32 of the case ``setup_case(fluid, **case_kwargs)``;
    returns the launch count of ``kernel`` during training, and checks that
    no other kernel launched."""
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
    counters = [k["counter"] for k in KERNELS.values()]
    for c in counters:
        setattr(st, c, 0)
    trainer, history = train_combined_models_unified(
        case["train_groups"], case["val_groups"], loss_fn, training_batch_size=32,
        epochs=2, general_config=case["general_config"])
    torch.cuda.synchronize()
    counts = {c: getattr(st, c) for c in counters}

    steps = history["step_total_loss"]
    n_train = trainer._resident["train"][2]
    n_val = trainer._resident["val"][2] if trainer._resident["val"] else 0
    for i, v in enumerate(steps):
        log(f"step {i + 1}: total loss {v:.6e}")
    if len(steps) != 2 * n_train or not np.all(np.isfinite(steps)):
        raise AssertionError(f"expected {2 * n_train} finite step losses, got {steps}")
    mine = KERNELS[kernel]["counter"]
    want = {c: 2 * (n_train + n_val) if c == mine else 0 for c in counters}
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, expected {want} for "
                             f"{2 * (n_train + n_val)} loss evaluations")
    for k, ps in before.items():
        if all(torch.equal(a, b) for a, b in zip(ps, models[k].parameters())):
            raise AssertionError(f"the {k} model did not change in training")
    steps_per_s = n_train / (history["epoch_times"][1] / 1000.0)
    log(f"main path {fluid} {grid}: {len(steps)} steps, launches {counts}, "
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
    return counts[mine]


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "srm_tpu_torch")):
        raise SystemExit("chip_smoke: run from the root of a checkout of the repository")
    sys.path.insert(0, ROOT)
    t_start = time.time()
    phase_device()
    phase_build()
    measured = {name: phase_kernels(name) for name in KERNELS}
    # the cases' datasets go under the checkout's build/ (listed in .gitignore)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    launches = {}
    with tempfile.TemporaryDirectory(prefix="smoke_data_", dir=os.path.join(ROOT, "build")) as tmp:
        launches["dg_stencil_residual"] = phase_main_path(tmp, "dg_stencil_residual")
        launches["dg3d_stencil_residual"] = phase_main_path(
            tmp, "dg3d_stencil_residual", nz=10, kle_method="uncorrelated")
        launches["gc_stencil_residual"] = phase_main_path(tmp, "gc_stencil_residual",
                                                          fluid="GC")

    import torch
    log(f"all phases passed in {time.time() - t_start:.1f} s")
    # library_ms: no single PyTorch call computes any of these stencils
    log(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"srm_tpu_torch/kernels/csrc/{spec['source']}",
        "replaces": spec["replaces"], "launches": launches[name], **measured[name],
        "library_ms": None} for name, spec in KERNELS.items()]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
