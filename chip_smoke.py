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
   its main paths' shapes (batch 32, and the production profile's batch
   128), at a ragged one and at the last configurations' (B1 and B3 at
   117×117 and batch 128, B2 at batch 256), forward and backward, each
   forward bitwise the same over three runs; CUDA event times of both at
   the timed shapes, the device time and launches per call (profiler; one
   launch per forward call), the kernel's bound
   (the larger of its bytes over the HBM rate and its operations over the
   float32 peak), and the card's time for one kernel call on a warm L2 and
   on a cold one (after writing 256 MiB, over 2x the L2). B1 is the 2D
   5-point DG residual, B2 the 3D 7-point one (fed kz ≠ kx), B3 the 2D
   two-phase gas-condensate one.
   Then the backward kernels of B1, B2 and B3, for the cotangents of a sum of
   squares of the outputs, at the same two shapes: against their plain
   version (the explicit adjoint, ``*_backward_reference``) and against
   autograd through the plain forward, within the forward's tolerance
   (B3's p0 gradient, a difference of large terms, within CANCELLING_TOL;
   on the 117×117 grid within P0_FROM_F64_TOL of the float64 gradient),
   and bitwise the same over three runs; at the timed shapes the device
   time (profiler) and the host-inclusive time (CUDA events) of the
   backward kernel, the explicit adjoint and ``_plain_backward`` (autograd
   through the recomputed plain version, what the backward was before),
   warm and cold L2 as above, and the kernel's bound; each backward kernel
   must show one device launch per call.
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
   to 0 just before training and read just after. The trainer runs each
   step as a CUDA graph replay after 3 eager warm-up steps (its counters
   count launches per replay). Each checks that every loss is finite, that
   every step after the warm-up was one graph replay, that every loss
   evaluation launched its kernel and the other kernels not at all, that
   every training step's backward launched its backward kernel once with
   no autograd recompute of the plain version, that every trainable model
   changed, and that the kernel and its plain version agree on the stencil
   inputs the trained models give for one batch. Then, on the graphed
   trainer (``phase_graph``): a profiler window over 3 replayed steps shows
   the forward and backward kernels once per step by their device names;
   from the same weights and batches the replayed and the eager step
   (``cuda_graph=False``, cuDNN deterministic) agree within
   GRAPH_LOSS_RTOL and GRAPH_WEIGHT_REL; and after a best-epoch restore
   the replayed eval step computes with the restored weights.
7. serving — on the trained DG 2D and GC 2D models: the predictor's rollout
   of the test split (14 realizations × 74 times, batch 256; pressure, and
   for GC the gas saturation) as one CUDA graph replay per batch, bitwise
   its eager rollout (cuDNN deterministic for both), within SERVE_CPU_REL
   of the field's scale of the same predictor on the CPU; the serving
   bundle (GC with both heads) exported for cpu and cuda and loaded from
   its directory on each, within SERVE_BUNDLE_REL of the live predictor on
   that platform, serving batches of 1, 3, 7 and 300, t = 0 giving Pi; then
   ``python -m srm_tpu_torch.tools.infer_vs_sim --sim-reps 1`` (the
   surrogate's and the FV simulator's seconds on the reference's workload,
   its JSON line).
8. production — the production profile (``apply_production_overrides``:
   bfloat16 networks, Model 2 on a 2x strided input, batch 128; the
   batch-scaled decay, 62 steps) on DG 2D (B1) and DG 3D (B2) at 20
   realizations: two epochs through the graphed trainer, each kernel's
   forward and backward counters once per step, the kernel against its
   plain version on the trained models' inputs at batch 128, then
   ``phase_graph``'s checks as in phases 4-6 with the production
   optimizers (steps run across the 2-step epochs); 10 timed steps
   (steps/s) and the profiled device ms and operations per step printed
   beside the f32 batch-32 numbers of phases 4 and 5; on DG 2D also the
   serving path with the bfloat16 networks (graphed rollout bitwise the
   eager one, the cuda bundle within SERVE_BF16_REL of the live predictor,
   beside a float32 bundle and predictor of the same weights).
9. drawdown — the CLI's ``--drawdown`` preset (mixed physics/data training
   on FV labels, balanced td errors, the ``abs`` Sg rectifier, Pi 4300 /
   BHP floor 2000 psia, 250 decay steps) on GC at 20 realizations: every
   split labelled by the simulator, two epochs of mixed training on B3,
   then ``predict --drawdown`` and ``export --drawdown`` through the CLI
   from the training's checkpoint, the bundle on cuda and cpu held to the
   live predictor.
10. per-cell porosity (after serving, on the trained DG 2D models) — a
    constant field's loss (the unfused residual: B1 takes a scalar
    porosity, and the loss turns it off with a field, as the JAX package
    turns off its Pallas kernel) within the kernel-vs-plain tolerance of
    the scalar porosity's (B1) on one batch; two graphed epochs on a
    two-zone field with B1 launched no time.
11. gas condensate 3D — the JAX package's gc3d (39×39×10, uncorrelated,
    zero labels, 20 realizations), which has no stencil kernel in either
    package: two graphed epochs f32 at batch 32 with no kernel launched and
    ``phase_graph``'s checks, then two epochs of gc3d_production (bfloat16,
    Model 2 on a 2x strided input); steps/s, device ms and operations per
    step and peak memory of each.
12. remat — DG 3D production at batch 256 (one step per epoch) without and
    with ``remat_forwards``, from the same weights: REMAT_EPOCHS graphed
    epochs each through B2, B2 against its plain version on the trained
    inputs, ``phase_graph``'s checks (without the eager-vs-eager spread run),
    samples/s over 5 timed steps and the training's peak memory; the two
    runs' losses and Model 1's update held together.
13. knobs — ``spatial_pad_to=48`` and ``network_width=64`` on DG 2D: two
    graphed epochs through B1, B1 against its plain version on the trained
    inputs.

The line before the last is a JSON object describing each kernel (its
numbers at batch 32, under ``at_b128`` those at batch 128, under
``at_128x117x117`` or ``at_256x10x39x39`` those at the last
configurations' shape, its launches on its f32 main path and, under
``launches_by_path``, on every path of this run that runs it); the last
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
# a replayed training step against the eager step from the same weights, with
# cuDNN deterministic: the replay launches the eager step's kernels on the
# same values, so the two agree where the kernels are deterministic (DG 2D:
# bitwise) and otherwise as two eager runs do, float32 rounding that Adam
# magnifies where a gradient is near zero (measured on the card, replay vs
# eager and eager vs eager: step losses up to the first replayed step up to
# 3.4e-5 relative, Model 1's update after 9 steps up to 9.3e-4 of its size,
# Model 2's after the first replayed step up to 3.7e-4, in DG 3D and GC 2D;
# Model 2's float32 gradient is rounding noise once the weights move, C2).
# A replay on stale weights or another batch is 6e-2 to 1.3 off (the restore
# check's "before" numbers).
GRAPH_LOSS_RTOL, GRAPH_WEIGHT_REL, GRAPH_MODEL2_REL = 1e-3, 1e-2, 1e-2
# the same for the weights on gas condensate 3D, which has no kernel: its
# unfused residual's backward was not deterministic on the card until the
# pads' backward became fixed-order (ROADMAP C16; the bound below was set
# before that), and its float32 gradients are largely noise (the three-step float32 update lies 0.27 from float64
# on the CPU, tests/test_torch_slice_gc3d.py), which Adam turns into
# updates: measured at 9x9x9 on the card, eager vs eager 1.3e-2 and replay
# vs eager 3.0e-2 and 3.8e-2 after 6 steps; a replay that dropped or
# repeated an update would be O(0.5) apart
GRAPH_UNFUSED_WEIGHT_REL = 0.1
# the batch-256 runs' epochs (one step each at 20 realizations): the 3
# eager warm-up steps, then replays
REMAT_EPOCHS = 5

# the simulator labels (phase_labels): the test split of each 2D case at 20
# realizations, the reference's physical bounds and its mass-balance bound
# (tests/test_fv_simulator.py:36-93), its bound between the dense and the
# iterative solver (:202, 0.1 psia), and its bound on the RMSE of a barely
# trained pressure model (:131-134)
LABEL_REALIZATIONS = 20
MASS_BALANCE_TOL = 0.02
SOLVER_PSIA_TOL = 0.1
RMSE_BOUND = 3500.0
# backward kernel vs autograd of the plain forward, for B3's p0: its
# gradient is a difference of large terms (the chord slopes and the
# accumulation), which the kernel rounds in the explicit adjoint's order and
# autograd in its own, each up to a few 1e-4 of the gradient's largest
# magnitude from the float64 gradient (the phase prints both distances); the
# bound is their sum with room
CANCELLING_TOL = 1e-3
# on a 117×117 grid both float32 orders lie up to 3.8e-3 of the gradient's
# largest magnitude from the float64 gradient at batch 128 (on the CPU, over
# the largest of more cells: ROADMAP C17, tests/test_torch_cuda.py), beyond
# CANCELLING_TOL: there B3's p0 gradient is held to the float64 explicit
# adjoint within P0_FROM_F64_TOL, and not to float32 autograd
P0_FROM_F64_TOL = 1e-2
# the grids where it is (each other shape keeps CANCELLING_TOL from autograd)
P0_FROM_F64_GRIDS = ((117, 117),)

# the serving phase: the card's rollout against the CPU's, relative to the
# field's largest magnitude (float32 convolutions in another order, through
# five encoder and five decoder layers); a served bundle against the live
# predictor on the same platform (the same network at another batch size,
# normalised on the device instead of the host); the batch sizes served
SERVE_CPU_REL = 1e-4
SERVE_BUNDLE_REL = 1e-5
SERVE_BATCHES = (1, 3, 7, 300)
# a bundle of bfloat16-compute networks against the live predictor, of the
# field's scale: the bundle normalizes its inputs on the device, the
# predictor on the host, and a float32 ulp there may move a bfloat16 rounding
# inside the network (measured on the card, max: 7.5e-6 and 3.6e-6); the
# bound is over 10x that. It does not tell the precisions apart: a float32
# bundle of the same weights lay 4.3e-6 (max) from the bfloat16 predictor.
# The RMS distance does (5.2e-8 against 2.7e-7 of the scale): the bundle's
# RMS distance from the predictor is held within SERVE_BF16_RMS_SHARE of
# the float32 predictor's RMS distance from it, measured in the same run.
SERVE_BF16_REL = 1e-4
SERVE_BF16_RMS_SHARE = 0.5

DG_OUTPUTS = ("dom", "ibc", "tde", "mbc")
GC_OUTPUTS = ("dom_g", "dom_o", "ibc", "trn_g", "trn_o", "mbc_g", "mbc_o")

# the kernels of the main paths: the wrapper's name in
# srm_tpu_torch.kernels.stencil (its plain version is <name>_reference), the
# source, the TPU kernel it replaces, its launch counter, the shapes it is
# checked at (the f32 main path's first, then the production batch, timed
# both; then a ragged one; then the last configurations' shape, timed:
# B1 on dg2d_large's 117×117 at batch 128, B2 at dg3d_production_b256's
# batch 256, B3 on the same 117×117 grid, where its p0 gradient is held to
# the float64 one, ROADMAP C17), the arguments it is differentiated by,
# its outputs (per-sample balances start with "mbc"), its floating-point
# operations per cell, counted from the source (comparisons, negations and
# the mbc reduction included), and its device name: one launch per call
KERNELS = {
    "dg_stencil_residual": dict(
        source="dg_stencil.cu", replaces="srm_tpu/kernels/stencil_pallas.py:132",
        counter="launches", shapes=[(32, 39, 39), (128, 39, 39), (3, 13, 17), (128, 117, 117)],
        wrt=(1, 9), outputs=DG_OUTPUTS, ops_per_cell=96, device_name="dg_stencil_fwd"),
    "dg3d_stencil_residual": dict(
        source="dg3d_stencil.cu", replaces="srm_tpu/kernels/stencil_pallas.py:265",
        counter="launches_3d",
        shapes=[(32, 10, 39, 39), (128, 10, 39, 39), (3, 5, 13, 17), (256, 10, 39, 39)],
        wrt=(1, 3, 10),
        outputs=DG_OUTPUTS, ops_per_cell=124, device_name="dg3d_stencil_cells"),
    "gc_stencil_residual": dict(
        source="gc_stencil.cu", replaces="srm_tpu/kernels/stencil_pallas.py:495",
        counter="launches_gc", shapes=[(32, 39, 39), (128, 39, 39), (3, 13, 17), (128, 117, 117)],
        wrt=(1, 4, 26), outputs=GC_OUTPUTS, ops_per_cell=385, device_name="gc_stencil_fwd"),
}


# the backward kernels: the forward they differentiate, the reference's
# custom-vjp backward they replace, their launch counter, qwell's index (no
# gradient), the inputs whose gradient is a difference of large terms (held
# to autograd within CANCELLING_TOL), their floating-point operations per
# cell, counted from the source as the header of the source states them (the
# recomputed forward, the adjoint, the gather's adds and the Δt sums; B1's
# and B3's with the recompute of their tiles' rings, 1.103 cells computed
# per cell at 39×39 and 117×117), and their device name: one launch per
# call each. B3's is checked on the 117×117 grid (ROADMAP C17) and timed
# there though no path runs GC on that grid
BACKWARD = {
    "dg_stencil_residual_backward": dict(
        forward="dg_stencil_residual", replaces="srm_tpu/kernels/stencil_pallas.py:568",
        counter="launches_bwd", qwell=8, cancelling=(), ops_per_cell=282,
        device_name="dg_stencil_bwd"),
    "dg3d_stencil_residual_backward": dict(
        forward="dg3d_stencil_residual", replaces="srm_tpu/kernels/stencil_pallas.py:313",
        counter="launches_3d_bwd", qwell=9, cancelling=(), ops_per_cell=291,
        device_name="dg3d_stencil_bwd"),
    "gc_stencil_residual_backward": dict(
        forward="gc_stencil_residual", replaces="srm_tpu/kernels/stencil_pallas.py:533",
        counter="launches_gc_bwd", qwell=25, cancelling=(0,), ops_per_cell=1115,
        device_name="gc_stencil_bwd"),
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
    paths' shapes (batch 32 and the production batch 128) and a ragged one;
    returns its measured numbers and bound at batch 32, and under "at_b128"
    those at batch 128."""
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
        with torch.no_grad():
            for _ in range(2):
                if not all(torch.equal(a, b) for a, b in zip(got, fused(*args, cfg))):
                    raise AssertionError(f"{name} forward {shape}: not the same bit for bit "
                                         f"run to run")

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
            f"(max abs err so far {max_err:.3e}), the forward bitwise the same over three runs")

    timed = [_time_forward(name, shape) for shape in _timed_shapes(spec)]
    _check_one_launch(name, spec["device_name"], _timed_shapes(spec), timed)
    return {"max_abs_err": max_err, **timed[0], "at_b128": timed[1], **_extra_shapes(spec, timed)}


def _check_one_launch(name: str, device_name: str, shapes, timed) -> None:
    """One device launch per call at each timed shape: the profiler's
    window shows the kernel ``device_name`` and no other, at most once a
    call (CUPTI may miss a window's first kernels, so fewer; a second kernel
    shows by its name). Takes each shape's "device_kernels" out of
    ``timed``."""
    for shape, t in zip(shapes, timed):
        names = t.pop("device_kernels")
        if not (0 < t["launches_per_call"] <= 1 and all(device_name + "(" in n for n in names)):
            raise AssertionError(f"{name} {shape}: the profiler shows {t['launches_per_call']} "
                                 f"device launches per call of {names}, expected one of "
                                 f"{device_name}")


def _timed_shapes(spec) -> list:
    """The shapes a kernel is timed at: its f32 main path's, the production
    batch's, and the last configurations' (after the ragged shape)."""
    return spec["shapes"][:2] + spec["shapes"][3:]


def _extra_shapes(spec, timed) -> dict:
    """The numbers at the last configurations' shapes, keyed by the shape:
    B1 at 117×117 (dg2d_large), B2 at batch 256 (dg3d_production_b256)."""
    return {"at_" + "x".join(map(str, shape)): t for shape, t in zip(spec["shapes"][3:], timed[2:])}


def _time_forward(name: str, shape) -> dict:
    """A kernel's and its plain version's times at ``shape`` (CUDA events,
    plain, kernel, kernel, plain; the card's time for one call on a warm and
    a cold L2; the device time and launches per call from the profiler over
    20 calls of each) and its bound: each input read once, each output
    written once, at the HBM rate, or its operations at the float32 peak."""
    import torch
    from srm_tpu_torch.kernels import stencil as st
    from srm_tpu_torch.tools.profile_step import (FP32_OPS_PER_S, HBM_BYTES_PER_S, profile_calls,
                                                  time_ms, warm_cold_ms)
    spec = KERNELS[name]
    fused, plain = getattr(st, name), getattr(st, f"{name}_reference")
    args, cfg = make_stencil_inputs(name, *shape)
    with torch.no_grad():
        plain_ms = time_ms(lambda: plain(*args, cfg))
        ms = time_ms(lambda: fused(*args, cfg))
        ms2 = time_ms(lambda: fused(*args, cfg))
        plain_ms2 = time_ms(lambda: plain(*args, cfg))
        outs = fused(*args, cfg)
        events = warm_cold_ms(lambda: fused(*args, cfg))
        table = []
        launches, device_us, _ = profile_calls(lambda: fused(*args, cfg), 20, table)
        plain_launches, plain_device_us, _ = profile_calls(lambda: plain(*args, cfg), 20)
    nbytes = sum(t.numel() * t.element_size() for t in list(args) + list(outs))
    ops = spec["ops_per_cell"] * outs[0].numel()
    bounds = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "operations": ops / FP32_OPS_PER_S * 1e3}
    bound_by = max(bounds, key=bounds.get)
    log(f"{name} time per call at {shape} (plain, kernel, kernel, plain): "
        f"{plain_ms:.4f} {ms:.4f} {ms2:.4f} {plain_ms2:.4f} ms; {nbytes} bytes, {ops} "
        f"operations: bound {bounds[bound_by]:.6f} ms by {bound_by}; one call on the card "
        f"(warm, cold, cold, warm L2): {events['warm_ms'][0]:.4f} {events['cold_ms'][0]:.4f} "
        f"{events['cold_ms'][1]:.4f} {events['warm_ms'][1]:.4f} ms; device us per call and "
        f"launches: kernel {device_us:.2f} us / {launches:.2f}, plain {plain_device_us:.2f} us "
        f"/ {plain_launches:.2f}")
    return {"ms": min(ms, ms2), "plain_ms": min(plain_ms, plain_ms2),
            "bound_ms": bounds[bound_by], "bound_by": bound_by, "device_us": device_us,
            "launches_per_call": launches, "plain_device_us": plain_device_us,
            "plain_launches_per_call": plain_launches,
            "device_kernels": sorted({row["name"] for row in table}), **events}


def phase_backward(name: str) -> dict:
    """One backward kernel vs its explicit adjoint and vs autograd through
    the plain forward, at its forward's shapes, and bitwise run to run;
    returns its measured numbers and bound at batch 32, and under
    "at_b128" those at batch 128."""
    import torch
    from srm_tpu_torch.kernels import stencil as st
    from srm_tpu_torch.tools.profile_step import backward_calls
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
                from_f64 = float((got[i].double() - exact[i]).abs().max()) / exact_scale
                log(f"{name} d/d(arg {i}) {shape}: kernel {err / scale:.3e} of its scale from "
                    f"autograd; from the float64 gradient kernel {from_f64:.3e}, "
                    f"autograd {float((grads[i].double() - exact[i]).abs().max()) / exact_scale:.3e}")
                if shape[-2:] in P0_FROM_F64_GRIDS:
                    if not torch.isfinite(got[i]).all() or from_f64 > P0_FROM_F64_TOL:
                        raise AssertionError(f"{name} d/d(arg {i}) {shape}: {from_f64:.3e} of its "
                                             f"scale from the float64 gradient")
                elif not torch.isfinite(got[i]).all() or err > CANCELLING_TOL * scale:
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

    timed = [_time_backward(name, shape) for shape in _timed_shapes(fwd)]
    _check_one_launch(name, spec["device_name"], _timed_shapes(fwd), timed)
    return {"max_abs_err": max_err, **timed[0], "at_b128": timed[1], **_extra_shapes(fwd, timed)}


def _time_backward(name: str, shape) -> dict:
    """A backward kernel's, its explicit adjoint's and ``_plain_backward``'s
    host-inclusive times (CUDA events) and device times and launches
    (profiler) at ``shape``, the kernel's time on a warm and a cold L2, and
    its bound: each input that the backward needs read once (not the well
    rates; p0p's interior only), each cotangent read once, each gradient
    (all but qwell's) written once; or its operations at the float32
    peak."""
    import torch
    from srm_tpu_torch.kernels import stencil as st
    from srm_tpu_torch.tools.profile_step import (FP32_OPS_PER_S, HBM_BYTES_PER_S, backward_bytes,
                                                  backward_calls, profile_calls, time_ms,
                                                  warm_cold_ms)
    spec = BACKWARD[name]
    plain = getattr(st, f"{spec['forward']}_reference")
    args, cfg = make_stencil_inputs(spec["forward"], *shape)
    calls = backward_calls(spec["forward"], args, cfg)
    host = {k: time_ms(calls[k], calls=20) for k in ("adjoint", "kernel", "autograd")}
    host2 = {k: time_ms(calls[k], calls=20) for k in ("autograd", "kernel", "adjoint")}
    table = []
    device = {k: profile_calls(calls[k], 20, table if k == "kernel" else None)
              for k in ("kernel", "adjoint", "autograd")}
    events = warm_cold_ms(calls["kernel"])
    got = calls["kernel"]()
    with torch.no_grad():
        outs = plain(*args, cfg)
    nbytes = backward_bytes(spec["forward"], args, outs, [g for g in got if g is not None])
    ops = spec["ops_per_cell"] * outs[0].numel()
    bounds = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "operations": ops / FP32_OPS_PER_S * 1e3}
    bound_by = max(bounds, key=bounds.get)
    ms = {k: min(host[k], host2[k]) for k in host}
    log(f"{name} at {shape}: host-inclusive ms per call (adjoint, kernel, autograd; "
        f"autograd, kernel, adjoint): {host['adjoint']:.4f} {host['kernel']:.4f} "
        f"{host['autograd']:.4f}; {host2['autograd']:.4f} {host2['kernel']:.4f} "
        f"{host2['adjoint']:.4f}")
    log(f"{name} at {shape} device us per call and launches: " + ", ".join(
        f"{k} {device[k][1]:.2f} us / {device[k][0]:.0f}" for k in device)
        + f"; {nbytes} bytes, {ops} operations: bound {bounds[bound_by]:.6f} ms by {bound_by}; "
        f"one kernel call on the card (warm, cold, cold, warm L2): {events['warm_ms'][0]:.4f} "
        f"{events['cold_ms'][0]:.4f} {events['cold_ms'][1]:.4f} {events['warm_ms'][1]:.4f} ms")
    return {"ms": ms["kernel"], "plain_ms": ms["adjoint"],
            "bound_ms": bounds[bound_by], "bound_by": bound_by,
            "device_us": device["kernel"][1], "launches_per_call": device["kernel"][0],
            "plain_device_us": device["adjoint"][1],
            "plain_launches_per_call": device["adjoint"][0],
            "autograd_ms": ms["autograd"], "autograd_device_us": device["autograd"][1],
            "autograd_launches_per_call": device["autograd"][0],
            "device_kernels": sorted({row["name"] for row in table}), **events}


def _timed(fn):
    """fn() and its seconds on the host clock, the card synchronised."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _labelled_config(fluid: str) -> dict:
    import copy
    from srm_tpu_torch.config import DEFAULT_GENERAL_CONFIG
    g = copy.deepcopy(DEFAULT_GENERAL_CONFIG)
    g["fluid_type"] = fluid
    g["label_source"] = "simulator"
    return g


def simulator_pvt(fluid: str):
    """The simulator's order-1 spline PVT, on the card."""
    from srm_tpu_torch.config import get_configuration
    from srm_tpu_torch.data.pvt_table import load_pvt_table
    from srm_tpu_torch.physics.pvt import make_spline_pvt, properties_for
    return make_spline_pvt(get_configuration("pvt_layer", fluid_type=fluid), load_pvt_table(),
                           properties=properties_for(fluid), order=1).cuda()


def phase_labels(base_dir: str) -> None:
    """The FV simulator on the card: the test split of the DG 2D and GC 2D
    default cases at LABEL_REALIZATIONS realizations (dense solver), each
    simulated twice and required bitwise equal, held to the reference's
    physical checks; then one DG 3D realization at 39×39×10 for 5 time
    steps, the CG path against the dense solve in float64; prints the
    seconds of each."""
    import numpy as np
    import torch
    from srm_tpu_torch.config import DEFAULT_SCAL_CONFIG
    from srm_tpu_torch.data.dataset import SRMDataProcessor
    from srm_tpu_torch.physics.relperm import RelativePermeability
    from srm_tpu_torch.sim import build_problem, simulate_dry_gas, simulate_labels
    from srm_tpu_torch.sim.fv_simulator import mass_balance
    scal = DEFAULT_SCAL_CONFIG
    relperm = RelativePermeability.from_config(scal["end_points"], scal["corey_exponents"])
    for fluid in ("DG", "GC"):
        g = _labelled_config(fluid)
        proc = SRMDataProcessor(base_dir=base_dir, general_config=g, device="cuda")
        proc.reservoir_config["realizations"]["permx"]["number"] = LABEL_REALIZATIONS
        permx = proc.generate_kle_splits()["test"]
        times = proc.generate_time_tensor()["test"].reshape(-1)
        (a, t1), (b, t2) = (_timed(lambda: simulate_labels(proc, "test", permx=permx,
                                                           times=times)) for _ in range(2))
        for k in a:
            if a[k].tobytes() != b[k].tobytes():
                raise AssertionError(f"{fluid} {k}: two simulations on the card differ")
        p = a["PRESSURE"]
        K, T = p.shape[:2]
        Pi = float(proc.reservoir_config["initialization"]["Pi"])
        Sgi = 1.0 - scal["end_points"]["Swmin"]
        means = p.mean(axis=(0, 2, 3, 4))
        checks = {"p at t0 is Pi": bool((p[:, 0] == Pi).all()),
                  "field mean falls at every step": bool((np.diff(means) < 0).all()),
                  "1000 < p <= Pi": bool(p.min() > 1000.0 and p.max() <= Pi + 1e-3),
                  "finite": bool(np.isfinite(p).all())}
        prob, kscale = build_problem(proc.reservoir_config, proc.wells_config, scal, g)
        pvt = simulator_pvt(fluid)
        kx = torch.from_numpy(permx.reshape(K, -1)).cuda()
        if fluid == "DG":
            out = torch.from_numpy(p.reshape(K, T, -1)).cuda()
            mb = mass_balance(prob, kscale, kx, times, out, pvt)
        else:
            sg = a["SGAS"]
            checks["0 <= Sg <= Sgi"] = bool(sg.min() >= 0.0 and sg.max() <= Sgi + 1e-5)
            out = torch.from_numpy(np.stack([p.reshape(K, T, -1), sg.reshape(K, T, -1)], -1)).cuda()
            mb = mass_balance(prob, kscale, kx, times, out, pvt, relperm,
                              scal["end_points"]["Swmin"])
        worst = float(mb.abs().max())
        checks[f"mass balance within {MASS_BALANCE_TOL}"] = worst < MASS_BALANCE_TOL
        log(f"labels {fluid} {p.shape} (dense): {t1:.2f} s and {t2:.2f} s, bitwise equal; "
            f"p in [{p.min():.2f}, {p.max():.2f}], worst mass balance {worst:.2e}"
            + (f", Sg in [{a['SGAS'].min():.5f}, {a['SGAS'].max():.5f}]" if fluid == "GC" else ""))
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"{fluid} labels fail: {failed}")

    # DG 3D: one realization at 39×39×10, 5 time steps. The float32 dense
    # solve is itself more than 0.1 psia from the float64 solution in 3D
    # (both packages; tests/test_torch_sim.py), so the CG path is held to
    # the dense solve in float64 within the reference's 0.1 psia
    import copy
    from srm_tpu_torch.config import DEFAULT_RESERVOIR_CONFIG, DEFAULT_WELLS_CONFIG
    res = copy.deepcopy(DEFAULT_RESERVOIR_CONFIG)
    res["Nz"] = 10
    g = _labelled_config("DG")
    prob, kscale = build_problem(res, DEFAULT_WELLS_CONFIG, scal, g)
    n = 10 * res["Ny"] * res["Nx"]
    spec = res["realizations"]["permx"]
    rng = np.random.RandomState(g["seed"])
    kx = torch.from_numpy(np.exp(rng.normal(np.log(spec["mean"]), spec["std"] / spec["mean"],
                                            (1, n))).astype(np.float32)).cuda()
    times = np.arange(5, dtype=np.float32) * g["srm_timestep"]
    stats = {}
    pvt, pvt64 = simulator_pvt("DG"), simulator_pvt("DG").double()
    exact, t_exact = _timed(lambda: simulate_dry_gas(prob, kscale, kx.double(), times, pvt64,
                                                     solver="dense"))
    dense, t_dense = _timed(lambda: simulate_dry_gas(prob, kscale, kx, times, pvt,
                                                     solver="dense"))
    cg, t_cg = _timed(lambda: simulate_dry_gas(prob, kscale, kx, times, pvt, solver="cg",
                                               stats=stats))
    gap = {k: float((v.double() - exact).abs().max()) for k, v in (("cg", cg), ("dense", dense))}
    log(f"labels DG 3D {tuple(cg.shape)} (1 realization, 10x39x39, 5 times): CG {t_cg:.2f} s, "
        f"dense {t_dense:.2f} s, dense float64 {t_exact:.2f} s; CG trips per solve (checked "
        f"every 32) {stats['trips']}; from the float64 solution: CG {gap['cg']:.4f} psia, "
        f"float32 dense {gap['dense']:.4f} psia; drawdown {prob.Pi - float(exact.min()):.2f} psia")
    if not torch.isfinite(cg).all() or gap["cg"] > SOLVER_PSIA_TOL or max(stats["trips"]) >= 1000:
        raise AssertionError(f"DG 3D: CG {gap['cg']:.4f} psia from the float64 dense solve "
                             f"(bound {SOLVER_PSIA_TOL}), trips {stats['trips']}")


def phase_rmse(case) -> None:
    """The pressure RMSE of the trained model against the case's labelled
    test split, and of predicting Pi everywhere."""
    import numpy as np
    from srm_tpu_torch.eval.plotting import pressure_rmse
    _, labels = case["test_groups"][0]
    p = np.asarray(labels["PRESSURE"])
    Pi = float(case["processor"].reservoir_config["initialization"]["Pi"])
    if not p.min() > 1000.0:
        raise AssertionError(f"the test split is not labelled (min {p.min()})")
    rmse, secs = _timed(lambda: pressure_rmse(case["models"], case["test_groups"]))
    rmse_pi = float(np.sqrt(np.mean((p - Pi) ** 2)))
    log(f"pressure RMSE after two epochs: {rmse:.3f} psia on the labelled test split {p.shape} "
        f"({secs:.2f} s), predict-Pi {rmse_pi:.3f} psia")
    if not np.isfinite(rmse) or rmse >= RMSE_BOUND:
        raise AssertionError(f"pressure RMSE {rmse} is not finite and below {RMSE_BOUND}")


def phase_main_path(base_dir: str, kernel: str, fluid: str = "DG", **case_kwargs):
    """Two epochs at batch 32 of the case ``setup_case(fluid, **case_kwargs)``;
    returns the launch counts during training, the trained case and the
    step's steps/s (epoch 2) and device ms (``phase_graph``), and
    checks that no other
    kernel launched and that each training step's backward went through
    ``kernel``'s backward kernel, where it has one, and nothing else."""
    import numpy as np
    import torch
    from srm_tpu_torch.examples.common import setup_case
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
    (trainer, history, _), counts, recomputes = _counted_training(
        kernel, lambda: train_combined_models_unified(
            case["train_groups"], case["val_groups"], loss_fn, training_batch_size=32,
            epochs=2, general_config=case["general_config"]))
    steps = history["step_total_loss"]
    n_train = trainer._resident["train"][2]
    n_val = trainer._resident["val"][2] if trainer._resident["val"] else 0
    for i, v in enumerate(steps):
        log(f"step {i + 1}: total loss {v:.6e}")
    if len(steps) != 2 * n_train or not np.all(np.isfinite(steps)):
        raise AssertionError(f"expected {2 * n_train} finite step losses, got {steps}")
    _check_launches(kernel, counts, recomputes, n_train, n_val, 2)
    for k, ps in before.items():
        if all(torch.equal(a, b) for a, b in zip(ps, models[k].parameters())):
            raise AssertionError(f"the {k} model did not change in training")
    # every step after the eager warm-up steps is one replay of its graph
    warm = trainer.warmup_steps
    want_replays = {"train": max(0, 2 * n_train - warm), "eval": max(0, 2 * n_val - warm)}
    if not trainer.cuda_graph or trainer.replays != want_replays:
        raise AssertionError(f"graph replays {trainer.replays}, expected {want_replays} "
                             f"({warm} eager warm-up steps of each kind)")
    steps_per_s = n_train / (history["epoch_times"][1] / 1000.0)
    log(f"main path {fluid} {grid}: {len(steps)} steps, {warm} eager warm-up steps and "
        f"replays {trainer.replays}, launches {counts}, {recomputes} plain recomputes, "
        f"{steps_per_s:.2f} steps/s in epoch 2, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    # the kernel and its plain version on the stencil inputs that the
    # trained models give for one batch of the main path
    x_all, y_all, _, bs = trainer._resident["train"]
    x, y = x_all[:bs], {k: v[:bs] for k, v in y_all.items()}
    _stencil_agrees(loss_fn, kernel, x, grid)
    with torch.no_grad():
        total, _ = loss_fn.loss_and_metrics(x, y)
    if not torch.isfinite(total):
        raise AssertionError(f"non-finite loss {float(total)} after training")
    log(f"trained models: {kernel} and its plain version agree on the main path's "
        f"stencil inputs; total loss {float(total):.6e}")
    if case["general_config"].get("label_source") == "simulator":
        phase_rmse(case)
    return counts, case, {"steps_per_s": steps_per_s, **phase_graph(trainer, kernel)}


def _copy_loss(loss_fn):
    """The loss with copies of its trained models (the same weights)."""
    import copy
    out = copy.copy(loss_fn)
    trained = [loss_fn.logical_name(k) for k in loss_fn.trainable_models_keys]
    out.models = {**loss_fn.models, **{k: copy.deepcopy(loss_fn.models[k]) for k in trained}}
    return out


def _rel(got, want) -> float:
    import torch
    with torch.no_grad():
        num = torch.sqrt(sum(((g.double() - w.double()) ** 2).sum() for g, w in zip(got, want)))
        return float(num / torch.sqrt(sum((w.double() ** 2).sum() for w in want)))


def _train_steps(trainer, n: int):
    """The step losses of ``n`` training steps over the staged train split,
    epoch after epoch (an epoch of a small split holds fewer steps)."""
    import numpy as np
    losses = []
    while len(losses) < n:
        losses.extend(trainer.train_epoch_resident("train", steps=n - len(losses))["total"])
    return np.asarray(losses)


def _device_per_step(trainer, steps: int = 3, names=None) -> dict:
    """A profiler window over ``steps`` replayed training steps: the device
    ms and device operations per step, and how many device kernels of each
    of ``names`` (name → device name) it shows."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile
    replays = trainer.replays["train"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _train_steps(trainer, steps)
        torch.cuda.synchronize()
    if trainer.replays["train"] != replays + steps:
        raise AssertionError("the profiled steps were not graph replays")
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    seen = {k: sum(bool(re.search(rf"(^|::){n}\(", e.name)) for e in device)
            for k, n in (names or {}).items()}
    return {"device_ms_per_step": sum(e.time_range.elapsed_us() for e in device) / steps / 1e3,
            "device_ops_per_step": len(device) / steps, "seen": seen,
            "stencil_kernels": sorted({e.name for e in device if "stencil" in e.name})}


def phase_graph(trainer, kernel, optimizer_configs=None, spread: bool = True) -> dict:
    """After a path's training, on its graphed trainer (steps run epoch after
    epoch where the staged split holds fewer; the trainers built here take
    ``optimizer_configs``, the path's):

    1. a profiler window over 3 replayed training steps shows ``kernel``
       (by its device name) once per step and its backward kernel once per
       step: the kernels run inside the replay (a path without a kernel,
       ``kernel`` None, shows no stencil kernel);
    2. from the same weights on the same batches, the graphed trainer (its
       eager warm-up steps, then replays) and the eager one
       (``cuda_graph=False``), with cuDNN deterministic, give the same step
       losses up to the first replayed step within GRAPH_LOSS_RTOL, Model
       1's weights after 9 steps within GRAPH_WEIGHT_REL of their update and
       Model 2's after the first replayed step within GRAPH_MODEL2_REL (held
       on one step only: its float32 gradient is rounding noise once the
       weights move, ROADMAP C2), or on a path without a kernel within
       GRAPH_UNFUSED_WEIGHT_REL; with ``spread`` the eager step against a
       second eager run is logged beside it and must agree bit for bit
       (losses and weights): since the pads' backward is fixed-order
       (ROADMAP C16) no op of a step adds in a varying order;
    3. a best-epoch restore (``load_snapshot``, in place) is seen by the next
       replay: the replayed eval losses on the restored weights equal the
       eager eval step's; before the restore the weights are trained (whole
       replayed epochs) until their eval losses lie beyond twice
       GRAPH_LOSS_RTOL of the snapshot's, so that a replay on stale weights
       would show.

    Returns the device ms and device operations per replayed step of the
    profiler window."""
    import gc

    import numpy as np
    import torch

    from srm_tpu_torch.training.trainer import Trainer

    # 1. the kernels inside the replayed step
    names = {}
    if kernel is not None:
        bwd = next(b for b in BACKWARD.values() if b["forward"] == kernel)
        names = {"forward": KERNELS[kernel]["device_name"], "backward": bwd["device_name"]}
    snap = trainer.snapshot()
    eager = Trainer(trainer.loss_fn, cuda_graph=False)
    eager._resident["train"] = trainer._resident["train"]
    at_snap = eager.eval_epoch_resident("train")["total"]
    device = _device_per_step(trainer, 3, names)
    seen = device["seen"]
    if seen != {k: 3 for k in names} or (kernel is None and device["stencil_kernels"]):
        raise AssertionError(f"in 3 replayed steps the trace shows {seen} of {names} "
                             f"(stencil kernels: {device['stencil_kernels']})")
    log(f"profiler over 3 replayed steps: {device['device_ops_per_step'] * 3:.0f} device kernels, "
        + "".join(f"{names[k]} {seen[k]}x, " for k in names)
        + f"device time {device['device_ms_per_step']:.3f} ms per step")

    # 2. replay against the eager step, from the same weights (and the eager
    # step against itself, for the kernels' own run-to-run spread)
    m1, m2 = trainer.optimizer_keys[:2]
    start = {k: [p.detach().clone() for p in trainer.optimizers[k].params] for k in (m1, m2)}
    warm = Trainer.warmup_steps
    torch.backends.cudnn.deterministic = True
    runs, replayed = {}, None
    try:
        kinds = (("graph", True), ("eager", False)) + ((("eager again", False),) if spread else ())
        for name, graph in kinds:
            t = Trainer(_copy_loss(trainer.loss_fn), optimizer_configs=optimizer_configs,
                        seed=7, cuda_graph=graph)
            t._resident["train"] = trainer._resident["train"]
            # the warm-up steps, then the first replayed step
            first = _train_steps(t, warm + 1)
            after_first = [p.detach().clone() for p in t.optimizers[m2].params]
            rest = _train_steps(t, 8 - warm)
            runs[name] = ([p.detach().clone() for p in t.optimizers[m1].params],
                          np.concatenate([first, rest]), after_first)
            if graph:
                replayed = t.replays["train"]
            # one run's memory at a time: the large batches' graphs fill the card
            del t
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    if replayed != 9 - warm:
        raise AssertionError(f"the graphed trainer replayed {replayed} of 9 steps")

    def apart(a, b):
        (pa, la, a2), (pb, lb, b2) = runs[a], runs[b]
        rel = np.abs(la - lb) / np.abs(lb)
        return (float(rel[:warm + 1].max()), float(rel.max()),
                _rel([x - s for x, s in zip(pa, start[m1])],
                     [y - s for y, s in zip(pb, start[m1])]),
                _rel([x - s for x, s in zip(a2, start[m2])],
                     [y - s for y, s in zip(b2, start[m2])]))

    got = apart("graph", "eager")
    compared = [("replay vs eager", got)]
    if spread:
        compared.append(("eager vs eager", apart("eager again", "eager")))
    for what, (l1, l9, w1, w2) in compared:
        log(f"{what} from the same weights, 9 steps ({warm} warm-up): step losses {l1:.3e} apart "
            f"up to the first "
            f"replayed step, {l9:.3e} over all 9 (relative); {m1} weights after 9 steps "
            f"{w1:.3e} and {m2} after the first replayed step {w2:.3e} of their update")
    if spread and any(v != 0.0 for v in compared[1][1]):
        raise AssertionError(f"two eager runs from the same weights differ: {compared[1][1]} "
                             f"(each op of the step is deterministic; ROADMAP C16)")
    l1, _, w1, w2 = got
    bounds = (GRAPH_WEIGHT_REL, GRAPH_MODEL2_REL)
    if kernel is None:
        bounds = (GRAPH_UNFUSED_WEIGHT_REL, GRAPH_UNFUSED_WEIGHT_REL)
    if not np.all(np.isfinite(runs["graph"][1])) or l1 > GRAPH_LOSS_RTOL or \
            w1 > bounds[0] or w2 > bounds[1]:
        raise AssertionError(f"the replayed step differs from the eager one: {got} (bounds "
                             f"{bounds})")

    # 3. a restore seen by the next replay: eval steps over the train split
    # (the cases have no val split at 20 realizations), the warm-up steps
    # and capture before the restore
    bs = trainer._resident["train"][3]

    def replayed_eval():
        out = trainer.eval_epoch_resident("train")["total"]
        while trainer._states[("eval", "train", bs)].graph is None:
            out = trainer.eval_epoch_resident("train")["total"]
        return out

    moved, extra = replayed_eval(), 0
    while np.allclose(moved, at_snap, rtol=2 * GRAPH_LOSS_RTOL, atol=0):
        if extra == 20:
            raise AssertionError(f"{extra} more epochs left the eval losses within "
                                 f"{2 * GRAPH_LOSS_RTOL} of the snapshot's")
        trainer.train_epoch_resident("train")
        moved, extra = replayed_eval(), extra + 1
    n_eval = trainer.replays["eval"]
    trainer.load_snapshot(snap)
    restored = trainer.eval_epoch_resident("train")["total"]
    if trainer.replays["eval"] != n_eval + len(restored):
        raise AssertionError("the eval steps after the restore were not graph replays")
    want = eager.eval_epoch_resident("train")["total"]
    err = float(np.max(np.abs(restored - want) / np.abs(want)))
    log(f"restore: replayed eval losses on the restored weights {err:.3e} from the eager eval "
        f"step's (before the restore {float(np.max(np.abs(moved - want) / np.abs(want))):.3e}, "
        f"after {extra} more training epochs)")
    if err > GRAPH_LOSS_RTOL or np.allclose(moved, want, rtol=GRAPH_LOSS_RTOL, atol=0):
        raise AssertionError("the replay after a restore did not compute with the restored "
                             "weights")
    return {"device_ms_per_step": device["device_ms_per_step"],
            "device_ops_per_step": device["device_ops_per_step"]}


def _counted_training(kernel: str, train):
    """``train()`` with every launch counter set to 0 just before and read
    just after, and ``_plain_backward`` (autograd through a recomputed
    plain version) counted; returns (train()'s result, counts, recomputes)."""
    import torch
    from srm_tpu_torch.kernels import stencil as st
    counters = [k["counter"] for k in KERNELS.values()] + [k["counter"] for k in BACKWARD.values()]
    plain_backward, recomputes = st._plain_backward, []

    def counted(*a):
        recomputes.append(1)
        return plain_backward(*a)

    st._plain_backward = counted
    try:
        for c in counters:
            setattr(st, c, 0)
        out = train()
        torch.cuda.synchronize()
        counts = {c: getattr(st, c) for c in counters}
    finally:
        st._plain_backward = plain_backward
    return out, counts, len(recomputes)


def _check_launches(kernel: str, counts: dict, recomputes: int, n_train: int, n_val: int,
                    epochs: int) -> None:
    """Each loss evaluation launched ``kernel`` once, each training step its
    backward kernel once, nothing else launched and nothing recomputed."""
    mine = KERNELS[kernel]["counter"]
    bwd = next(b["counter"] for b in BACKWARD.values() if b["forward"] == kernel)
    want = {c: epochs * (n_train + n_val) if c == mine else epochs * n_train if c == bwd else 0
            for c in counts}
    if counts != want or recomputes:
        raise AssertionError(f"kernel launches {counts} and {recomputes} plain recomputes, "
                             f"expected {want} and 0")


def _stencil_agrees(loss_fn, kernel: str, x, grid) -> None:
    """The kernel and its plain version, of the expected shapes, on the
    stencil inputs that the trained models give for the batch ``x`` on the
    grid ``grid``."""
    import torch
    from srm_tpu_torch.kernels import stencil as st
    with torch.no_grad():
        args, _ = loss_fn.stencil_inputs(x)
        got = getattr(st, kernel)(*args, loss_fn.stencil_cfg)
        want = getattr(st, f"{kernel}_reference")(*args, loss_fn.stencil_cfg)
    bs = x.shape[0]
    for t, a, b in zip(KERNELS[kernel]["outputs"], got, want):
        want_shape = (bs,) if t.startswith("mbc") else (bs,) + tuple(grid)
        if tuple(a.shape) != want_shape:
            raise AssertionError(f"{t} has shape {tuple(a.shape)}, expected {want_shape}")
        check_close(f"trained-model inputs {t} at batch {bs}", a, b)


def phase_production(base_dir: str, kernel: str, f32: dict, **case_kwargs) -> dict:
    """The production profile (``apply_production_overrides``: bfloat16
    networks, Model 2 on a 2x strided input, batch 128, and
    ``production_optimizer_configs`` at that batch, 62 decay steps) on the
    dry-gas case ``setup_case("DG", **case_kwargs)`` at 20 realizations:
    two epochs through the graphed trainer (each loss evaluation through
    ``kernel``, each training step's backward through its backward kernel),
    finite losses; ``kernel`` against its plain version on the trained
    models' stencil inputs at batch 128; ``phase_graph``'s checks with the
    production optimizers (the kernels inside the replays, the device ms and
    operations per step, replay against eager, a restore); then steps/s over
    10 timed steps, printed beside the f32 batch-32 numbers ``f32`` of the
    same case in this run. Returns the launch counts of the two training
    epochs."""
    import numpy as np
    import torch

    from srm_tpu_torch.config import (DEFAULT_GENERAL_CONFIG, apply_production_overrides,
                                      production_optimizer_configs)
    from srm_tpu_torch.examples.common import setup_case
    from srm_tpu_torch.training.trainer import train_combined_models_unified

    g = apply_production_overrides(DEFAULT_GENERAL_CONFIG)
    bs = g["training_batch_size"]
    opt = production_optimizer_configs(batch_size=bs)
    decay = {c["exponential_decay"]["learning_rate"]["decay_steps"] for c in opt.values()
             if c.get("exponential_decay", {}).get("learning_rate", {}).get("enabled")}
    case, secs = _timed(lambda: setup_case("DG", base_dir=base_dir, n_realizations=20,
                                           general_config=g, device="cuda", **case_kwargs))
    loss_fn, models = case["loss_fn"], case["models"]
    nets = (models["pressure"].network, models["time_step"].network)
    if (not loss_fn.use_cuda_stencil or loss_fn.dt_input_stride != 2 or bs != 128
            or any(n.cdt != torch.bfloat16 for n in nets) or decay != {62}):
        raise AssertionError(f"not the production profile: stride {loss_fn.dt_input_stride}, "
                             f"batch {bs}, compute dtypes {[n.cdt for n in nets]}, decay {decay}")
    x_shape = case["train_groups"][0][0].shape
    log(f"production setup: train features {x_shape} in {secs:.1f} s; bf16 networks, "
        f"Model 2 on a 2x strided input, batch {bs}, decay steps {decay}")
    trained = [loss_fn.logical_name(k) for k in loss_fn.trainable_models_keys]
    before = {k: [p.detach().clone() for p in models[k].parameters()] for k in trained}

    torch.cuda.reset_peak_memory_stats()
    (trainer, history, _), counts, recomputes = _counted_training(
        kernel, lambda: train_combined_models_unified(
            case["train_groups"], case["val_groups"], loss_fn, epochs=2, general_config=g,
            optimizer_configs=opt))
    x_all, _, n_train, got_bs = trainer._resident["train"]
    n_val = trainer._resident["val"][2] if trainer._resident["val"] else 0
    steps = history["step_total_loss"]
    if got_bs != bs or len(steps) != 2 * n_train or not np.all(np.isfinite(steps)):
        raise AssertionError(f"batch {got_bs}: expected {2 * n_train} finite step losses, "
                             f"got {steps}")
    _check_launches(kernel, counts, recomputes, n_train, n_val, 2)
    warm = trainer.warmup_steps
    if trainer.replays["train"] != max(0, 2 * n_train - warm):
        raise AssertionError(f"graph replays {trainer.replays}, {2 * n_train} steps")
    for k, ps in before.items():
        if all(torch.equal(a, b) for a, b in zip(ps, models[k].parameters())):
            raise AssertionError(f"the {k} model did not change in training")
    log(f"production {kernel} batch {bs}: step losses {[f'{v:.6e}' for v in steps]}; "
        f"launches {counts}, replays {trainer.replays}")
    _stencil_agrees(loss_fn, kernel, x_all[:bs], x_shape[3:-1])

    device = phase_graph(trainer, kernel, optimizer_configs=opt)
    n_timed = 5 * n_train
    _, secs = _timed(lambda: _train_steps(trainer, n_timed))
    steps_per_s = n_timed / secs
    if kernel == "dg_stencil_residual":
        phase_serving_bf16(base_dir, case)
    log(f"production {kernel}: bf16, batch {bs}: {steps_per_s:.3f} steps/s "
        f"({steps_per_s * bs:.1f} samples/s, {n_timed} steps), "
        f"{device['device_ms_per_step']:.3f} device ms per step, "
        f"{device['device_ops_per_step']:.1f} device operations per step, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; f32 batch 32 in this run: "
        f"{f32['steps_per_s']:.3f} steps/s ({f32['steps_per_s'] * 32:.1f} samples/s), "
        f"{f32['device_ms_per_step']:.3f} device ms per step, "
        f"{f32['device_ops_per_step']:.1f} device operations per step")
    return counts


def phase_serving_bf16(base_dir: str, case) -> None:
    """The serving path on the production case's trained bfloat16 networks:
    the predictor's graphed rollout of the test split bitwise its eager one
    (cuDNN deterministic), and the bundle exported for cuda within
    SERVE_BF16_REL (max) of the live predictor, and by RMS within
    SERVE_BF16_RMS_SHARE of the distance between the live predictor and
    the same weights with every layer in float32: the bundle holds the
    bfloat16 casts. The float32 bundle's distances are logged beside."""
    import copy

    import numpy as np
    import torch
    from srm_tpu_torch.eval import SRMPredictor, export_surrogate, load_surrogate

    proc = case["processor"]
    permx = proc.generate_kle_splits()["test"]
    times = proc.generate_time_tensor()["test"].reshape(-1)
    args = (case["models"], case["data_summary"], case["general_config"], proc.reservoir_config)
    torch.backends.cudnn.deterministic = True
    try:
        graphed, eager = SRMPredictor(*args), SRMPredictor(*args, cuda_graph=False)
        live = graphed.predict_pressure(permx, times)
        plain = eager.predict_pressure(permx, times)
    finally:
        torch.backends.cudnn.deterministic = False
    if not graphed.replays.get("pressure") or live.tobytes() != plain.tobytes():
        raise AssertionError(f"bf16 serving: replays {graphed.replays}, graphed vs eager "
                             f"{np.abs(live - plain).max():.3e}")
    f32 = copy.deepcopy(case["models"]["pressure"])
    for m in f32.modules():
        for attr in ("cdt", "cdt_io"):
            if hasattr(m, attr):
                setattr(m, attr, None)

    def served(models, name):
        out = os.path.join(base_dir, name)
        export_surrogate(SRMPredictor(models, *args[1:]), out, fields=("pressure",),
                         platforms=("cuda",))
        srv = load_surrogate(out, device="cuda")
        return srv("pressure", np.repeat(permx, times.size, axis=0),
                   np.tile(times.astype(np.float32), permx.shape[0])).reshape(live.shape)

    def dist(a, b):
        """max and RMS of a - b over the field's scale and over its range"""
        d = np.abs(a.astype(np.float64) - b)
        scale, drop = np.abs(b).max(), np.ptp(b)
        return (d.max() / scale, np.sqrt(np.mean(d ** 2)) / scale, d.max() / drop,
                np.sqrt(np.mean(d ** 2)) / drop)

    got, got32 = served(case["models"], "bundle_bf16"), served({"pressure": f32}, "bundle_f32")
    live32 = SRMPredictor({"pressure": f32}, *args[1:], cuda_graph=False).predict_pressure(
        permx, times)
    (rel, rms, _, _), gap = dist(got, live), dist(live32, live)[1]
    for what, d in (("bf16 bundle vs bf16 predictor", dist(got, live)),
                    ("f32 bundle vs bf16 predictor", dist(got32, live)),
                    ("f32 predictor vs bf16 predictor", dist(live32, live)),
                    ("f32 bundle vs f32 predictor", dist(got32, live32))):
        log(f"bf16 serving, {what}: max {d[0]:.3e} and RMS {d[1]:.3e} of the field's scale, "
            f"max {d[2]:.3e} and RMS {d[3]:.3e} of its range")
    log(f"bf16 serving {live.shape}: graphed rollout bitwise the eager one "
        f"({graphed.replays['pressure']} replays); bundle on cuda {rel:.3e} (max) of the field's "
        f"scale from the live predictor (bound {SERVE_BF16_REL:.3e}), RMS {rms / gap:.3f} of "
        f"the float32 network's (bound {SERVE_BF16_RMS_SHARE}); p in "
        f"[{live.min():.2f}, {live.max():.2f}]")
    if rel > SERVE_BF16_REL or not np.isfinite(got).all():
        raise AssertionError(f"bf16 bundle on cuda: {rel:.3e} from the live predictor")
    if not gap > 0 or rms > SERVE_BF16_RMS_SHARE * gap:
        raise AssertionError(f"bf16 bundle on cuda: RMS {rms:.3e} from the live predictor, "
                             f"the float32 network {gap:.3e}")


def phase_drawdown(base_dir: str) -> dict:
    """The ``--drawdown`` preset as the CLI builds it (``_case_presets``:
    mixed physics/data training on FV labels, balanced td errors, the
    ``abs`` saturation rectifier, 250 decay steps, Pi 4300 / BHP floor
    2000 psia) on the GC case at 20 realizations: every non-empty split
    labelled by the simulator (physical bounds, condensate dropout below
    the dew point); two epochs of mixed training through the graphed
    trainer on B3 (each loss evaluation through the kernel, each step's
    backward through its backward kernel; finite losses, physics and label
    terms both live), checkpointed; then ``predict --drawdown`` and
    ``export --drawdown`` through the CLI, restoring that checkpoint: the
    rollout's t = 0 at Pi and Sgi, and the bundle on cuda and cpu within
    SERVE_BUNDLE_REL of the live predictor on the trained models. Returns
    the launch counts of the training."""
    import argparse

    import numpy as np
    from srm_tpu_torch.__main__ import _case_presets
    from srm_tpu_torch.__main__ import main as cli
    from srm_tpu_torch.eval import SRMPredictor, load_surrogate
    from srm_tpu_torch.examples.common import setup_case
    from srm_tpu_torch.training.trainer import train_combined_models_unified

    kernel = "gc_stencil_residual"
    args = argparse.Namespace(drawdown=True, production=False, fluid="DG", batch_size=None)
    fluid, g, opt, setup_kwargs = _case_presets(args, train=True)
    case, secs = _timed(lambda: setup_case(fluid, base_dir=base_dir, n_realizations=20,
                                           general_config=g, device="cuda", **setup_kwargs))
    loss_fn, models = case["loss_fn"], case["models"]
    Pi, Sgi = setup_kwargs["pi"], loss_fn.Sgi
    if fluid != "GC" or loss_fn.physics_mode_fraction != 0.5 or not loss_fn.use_cuda_stencil:
        raise AssertionError(f"not the drawdown recipe: {fluid}, f {loss_fn.physics_mode_fraction}")
    labelled = {}
    for split in ("train", "val", "test"):
        _, y = case[f"{split}_groups"][0]
        p, sg = np.asarray(y["PRESSURE"]), np.asarray(y["SGAS"])
        if p.shape[0] == 0:
            labelled[split] = "empty"
            continue
        ok = (np.isfinite(p).all() and (p[:, 0] == Pi).all() and p.min() > 1000.0
              and p.max() <= Pi + 1e-3 and sg.min() >= 0.0 and sg.max() <= Sgi + 1e-5
              and sg.min() < Sgi - 1e-3)
        if not ok:
            raise AssertionError(f"drawdown {split} labels: p in [{p.min()}, {p.max()}], "
                                 f"Sg in [{sg.min()}, {sg.max()}]")
        labelled[split] = (f"{p.shape}: p [{p.min():.2f}, {p.max():.2f}] psia, "
                           f"Sg [{sg.min():.5f}, {sg.max():.5f}]")
    if labelled["train"] == "empty" or labelled["test"] == "empty":
        raise AssertionError(f"drawdown splits: {labelled}")
    log(f"drawdown setup in {secs:.1f} s (every split simulated): {labelled}")

    ckpt = os.path.join(base_dir, "ckpt_drawdown")
    (trainer, history, _), counts, recomputes = _counted_training(
        kernel, lambda: train_combined_models_unified(
            case["train_groups"], case["val_groups"], loss_fn, epochs=2, general_config=g,
            optimizer_configs=opt, checkpoint_dir=ckpt))
    n_train = trainer._resident["train"][2]
    n_val = trainer._resident["val"][2] if trainer._resident["val"] else 0
    steps = history["step_total_loss"]
    terms = {k: history["train"][ph][k][-1] for ph, k in (("gas", "dom_g"), ("gas", "td_g"),
                                                         ("oil", "dom_o"), ("oil", "td_o"))}
    if len(steps) != 2 * n_train or not np.all(np.isfinite(steps)) or \
            not all(v > 0 for v in terms.values()):
        raise AssertionError(f"drawdown training: step losses {steps}, terms {terms}")
    _check_launches(kernel, counts, recomputes, n_train, n_val, 2)
    log(f"drawdown training: {len(steps)} steps, last epoch's terms "
        + ", ".join(f"{k} {v:.4e}" for k, v in terms.items())
        + f"; launches {counts}, replays {trainer.replays}")
    x_all, _, _, bs = trainer._resident["train"]
    _stencil_agrees(loss_fn, kernel, x_all[:bs], x_all.shape[2:-1])

    flags = ["--drawdown", "--realizations", "20", "--base-dir", base_dir,
             "--checkpoint-dir", ckpt]
    npz = os.path.join(base_dir, "drawdown_rollout.npz")
    out_dir = os.path.join(base_dir, "bundle_drawdown")
    if cli(["predict", *flags, "--out", npz]) or \
            cli(["export", *flags, "--out-dir", out_dir, "--platforms", "cpu,cuda"]):
        raise AssertionError("predict or export --drawdown failed")
    with np.load(npz) as z:
        p, sg, times = z["pressure"], z["saturation"], z["times"]
    permx = case["processor"].generate_kle_splits()["test"]
    live = SRMPredictor(models, case["data_summary"], g, case["processor"].reservoir_config)
    want = {"pressure": live.predict_pressure(permx[:p.shape[0]], times),
            "saturation": live.predict_saturation(permx[:p.shape[0]], times)}
    rel = {f: float(np.abs(a - want[f]).max() / np.abs(want[f]).max())
           for f, a in (("pressure", p), ("saturation", sg))}
    if max(rel.values()) > SERVE_BUNDLE_REL or not (p[:, 0] == Pi).all() or \
            not np.allclose(sg[:, 0], Sgi) or sg.min() < 0.0 or sg.max() > Sgi + 1e-5:
        raise AssertionError(f"predict --drawdown: {rel} from the live predictor, t0 p "
                             f"{p[:, 0].min()}..{p[:, 0].max()}, Sg [{sg.min()}, {sg.max()}]")
    px = np.repeat(permx, times.size, axis=0)
    tt = np.tile(times.astype(np.float32), permx.shape[0])
    full = {"pressure": live.predict_pressure(permx, times),
            "saturation": live.predict_saturation(permx, times)}
    for platform in ("cuda", "cpu"):
        srv = load_surrogate(out_dir, device=platform)
        brel = {f: float(np.abs(srv(f, px, tt).reshape(w.shape) - w).max() / np.abs(w).max())
                for f, w in full.items()}
        log(f"drawdown bundle on {platform}: vs the live predictor (cuda) "
            + ", ".join(f"{f} {v:.3e}" for f, v in brel.items()))
        if platform == "cuda" and max(brel.values()) > SERVE_BUNDLE_REL:
            raise AssertionError(f"drawdown bundle on cuda: {brel} (bound {SERVE_BUNDLE_REL})")
        if platform == "cpu" and max(brel.values()) > SERVE_CPU_REL:
            raise AssertionError(f"drawdown bundle on cpu: {brel} (bound {SERVE_CPU_REL})")
    log(f"predict --drawdown {p.shape}: {rel} from the live predictor; p in "
        f"[{p.min():.2f}, {p.max():.2f}], Sg in [{sg.min():.5f}, {sg.max():.5f}]")
    return counts


def _rollouts(pred, permx, times, fields) -> dict:
    return {f: getattr(pred, f"predict_{f}")(permx, times) for f in fields}


def phase_serving(base_dir: str, dg_case, gc_case) -> None:
    """The serving path on the trained DG 2D and GC 2D models: the
    predictor's graphed rollout of the test split (14 realizations × 74
    times, batch 256) against its eager one bitwise (cuDNN deterministic for
    both), one graph replay per batch, the card against the same predictor
    on the CPU within SERVE_CPU_REL of the field's scale; the serving bundle
    (GC with both heads) exported for cpu and cuda, loaded from its
    directory on each, within SERVE_BUNDLE_REL of the live predictor on the
    same platform, serving batches of SERVE_BATCHES, and t = 0 giving Pi;
    then ``infer_vs_sim`` at one simulator repeat."""
    import copy

    import numpy as np
    import torch
    from srm_tpu_torch.eval import SRMPredictor, export_surrogate, load_surrogate
    from srm_tpu_torch.tools import infer_vs_sim

    for fluid, case in (("DG", dg_case), ("GC", gc_case)):
        proc, models = case["processor"], case["models"]
        permx = proc.generate_kle_splits()["test"]
        times = proc.generate_time_tensor()["test"].reshape(-1)
        n = permx.shape[0] * times.size
        fields = ("pressure", "saturation") if fluid == "GC" else ("pressure",)
        names = {"pressure": "pressure", "saturation": "saturation_model"}
        args = (case["data_summary"], case["general_config"], proc.reservoir_config)

        torch.backends.cudnn.deterministic = True
        try:
            graphed = SRMPredictor(models, *args)
            eager = SRMPredictor(models, *args, cuda_graph=False)
            live, t_graph = _timed(lambda: _rollouts(graphed, permx, times, fields))
            first = dict(graphed.replays)
            again, t_again = _timed(lambda: _rollouts(graphed, permx, times, fields))
            plain, t_eager = _timed(lambda: _rollouts(eager, permx, times, fields))
        finally:
            torch.backends.cudnn.deterministic = False
        batches = -(-n // graphed.batch_size)
        want_replays = {names[f]: batches for f in fields}
        if not graphed.cuda_graph or first != want_replays or \
                graphed.replays != {k: 2 * v for k, v in want_replays.items()}:
            raise AssertionError(f"{fluid}: graph replays {first}, then {graphed.replays}, "
                                 f"expected {want_replays} per rollout ({n} fields in batches "
                                 f"of {graphed.batch_size})")
        for f in fields:
            if live[f].tobytes() != plain[f].tobytes() or live[f].tobytes() != again[f].tobytes():
                raise AssertionError(f"{fluid} {f}: the graphed rollout differs from the eager "
                                     f"one (max {np.abs(live[f] - plain[f]).max():.3e})")

        cpu_models = {names[f]: copy.deepcopy(models[names[f]]).cpu() for f in fields}
        on_cpu = SRMPredictor(cpu_models, *args)
        ref, t_cpu = _timed(lambda: _rollouts(on_cpu, permx, times, fields))
        cpu_rel = {f: float(np.abs(live[f] - ref[f]).max() / np.abs(ref[f]).max())
                   for f in fields}
        log(f"serving {fluid} {live['pressure'].shape}: graphed rollout bitwise the eager one "
            f"and a second rollout, replays per rollout {first} ({batches} batches of "
            f"{graphed.batch_size} for {n} fields); seconds graphed {t_graph:.3f} and "
            f"{t_again:.3f}, eager {t_eager:.3f}, CPU {t_cpu:.3f}; card vs CPU "
            + ", ".join(f"{f} {cpu_rel[f]:.3e}" for f in fields) + " of the field's scale; "
            + ", ".join(f"{f} in [{live[f].min():.4f}, {live[f].max():.4f}]" for f in fields))
        if max(cpu_rel.values()) > SERVE_CPU_REL or not all(np.isfinite(live[f]).all()
                                                          for f in fields):
            raise AssertionError(f"{fluid}: the card's rollout is {cpu_rel} of the field's "
                                 f"scale from the CPU's (bound {SERVE_CPU_REL})")

        out = os.path.join(base_dir, f"bundle_{fluid}")
        _, t_export = _timed(lambda: export_surrogate(graphed, out, fields=fields,
                                                      platforms=("cpu", "cuda")))
        px = np.repeat(permx, times.size, axis=0)
        tt = np.tile(times.astype(np.float32), permx.shape[0])
        Pi = float(proc.reservoir_config["initialization"]["Pi"])
        for platform, want in (("cuda", live), ("cpu", ref)):
            srv = load_surrogate(out, device=platform)
            if srv.fields != sorted(fields):
                raise AssertionError(f"{fluid} bundle on {platform}: fields {srv.fields}")
            rel = {}
            for f in fields:
                got = srv(f, px, tt).reshape(want[f].shape)
                rel[f] = float(np.abs(got - want[f]).max() / np.abs(want[f]).max())
            sizes = {}
            for b in SERVE_BATCHES:
                idx = np.arange(b) % n
                got = srv("pressure", px[idx], tt[idx])
                flat = want["pressure"].reshape((n,) + got.shape[1:])
                sizes[b] = float(np.abs(got - flat[idx]).max() / np.abs(flat).max())
            t0 = srv("pressure", permx, np.zeros(permx.shape[0], np.float32))
            log(f"bundle {fluid} on {platform} (exported in {t_export:.2f} s): vs the live "
                f"predictor " + ", ".join(f"{f} {rel[f]:.3e}" for f in fields)
                + f"; batches {list(sizes)} {max(sizes.values()):.3e}; t = 0 in "
                f"[{t0.min():.4f}, {t0.max():.4f}] (Pi {Pi})")
            if max(rel.values()) > SERVE_BUNDLE_REL or max(sizes.values()) > SERVE_BUNDLE_REL:
                raise AssertionError(f"{fluid} bundle on {platform}: {rel}, batches {sizes} "
                                     f"(bound {SERVE_BUNDLE_REL})")
            if not np.all(t0 == Pi):
                raise AssertionError(f"{fluid} bundle on {platform}: t = 0 does not give Pi")

    infer_vs_sim.main(["--sim-reps", "1", "--base-dir", base_dir])


def _train_epochs(case, kernel, batch: int, optimizer_configs=None, epochs: int = 2):
    """``epochs`` epochs of the case through the graphed trainer with the
    launch counters set to 0 just before and read just after; checks finite
    step losses, every step after the warm-up steps a replay, every trained
    model moved, and the launches of ``kernel`` (each loss evaluation
    launches it, each training step its backward kernel, nothing else; a
    path without a kernel, ``kernel`` None, launches none). Returns
    (trainer, history, counts, steps/s of the last epoch, peak MiB)."""
    import numpy as np
    import torch
    from srm_tpu_torch.training.trainer import train_combined_models_unified
    loss_fn = case["loss_fn"]
    models = loss_fn.models
    trained = [loss_fn.logical_name(k) for k in loss_fn.trainable_models_keys]
    before = {k: [p.detach().clone() for p in models[k].parameters()] for k in trained}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (trainer, history, _), counts, recomputes = _counted_training(
        kernel, lambda: train_combined_models_unified(
            case["train_groups"], case["val_groups"], loss_fn, training_batch_size=batch,
            epochs=epochs, general_config=case["general_config"], verbose=0,
            optimizer_configs=optimizer_configs))
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    n_train = trainer._resident["train"][2]
    n_val = trainer._resident["val"][2] if trainer._resident["val"] else 0
    steps = history["step_total_loss"]
    if trainer._resident["train"][3] != batch or len(steps) != epochs * n_train or \
            not np.all(np.isfinite(steps)):
        raise AssertionError(f"batch {trainer._resident['train'][3]}: expected "
                             f"{epochs * n_train} finite step losses, got {steps}")
    if kernel is None:
        if any(counts.values()) or recomputes:
            raise AssertionError(f"a path without a kernel launched {counts}, {recomputes} "
                                 f"plain recomputes")
    else:
        _check_launches(kernel, counts, recomputes, n_train, n_val, epochs)
    warm = trainer.warmup_steps
    if not trainer.cuda_graph or trainer.replays["train"] != max(0, epochs * n_train - warm):
        raise AssertionError(f"graph replays {trainer.replays}, {epochs * n_train} steps")
    for k, ps in before.items():
        if all(torch.equal(a, b) for a, b in zip(ps, models[k].parameters())):
            raise AssertionError(f"the {k} model did not change in training")
    steps_per_s = n_train / (history["epoch_times"][-1] / 1000.0)
    return trainer, history, counts, steps_per_s, peak_mib


def _free_cached() -> None:
    """Collect what the caller has dropped and give the card's cached
    memory back (a large batch's graph pool fills the card)."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def phase_gc3d(base_dir: str) -> dict:
    """Gas condensate in 3D (the JAX package's gc3d: 39×39×10, uncorrelated
    fields, zero labels, ``label_source="files"``; 20 realizations), which
    runs no stencil kernel in either package: two graphed epochs at batch
    32 in float32 (no kernel launched, ``phase_graph``'s replay against
    eager), then two epochs of the ``gc3d_production`` profile (bfloat16
    networks, Model 2 on a 2x strided input, batch 32); for each its
    steps/s, device ms and operations per step and peak memory. Returns
    the launch counts of both."""
    import copy

    from srm_tpu_torch.config import DEFAULT_GENERAL_CONFIG
    from srm_tpu_torch.examples.common import setup_case

    counts = {}
    for label, extra in (("gc3d", {}),
                         ("gc3d_production", {"compute_dtype": "bfloat16", "dt_input_stride": 2})):
        g = copy.deepcopy(DEFAULT_GENERAL_CONFIG)
        g.update(label_source="files", **extra)
        case, secs = _timed(lambda: setup_case("GC", base_dir=base_dir, nz=10,
                                               kle_method="uncorrelated", n_realizations=20,
                                               general_config=g, device="cuda"))
        loss_fn = case["loss_fn"]
        if loss_fn.use_cuda_stencil or loss_fn.Nz != 10 or \
                loss_fn.dt_input_stride != g.get("dt_input_stride", 1):
            raise AssertionError(f"{label}: not the unfused 3D two-phase residual")
        trainer, history, counts[label], steps_per_s, peak = _train_epochs(case, None, 32)
        if label == "gc3d":
            device = phase_graph(trainer, None)
        else:
            device = _device_per_step(trainer)
        x_shape = case["train_groups"][0][0].shape
        log(f"{label} {x_shape} (setup {secs:.1f} s): step losses "
            f"{[f'{v:.6e}' for v in history['step_total_loss'][-3:]]} (last 3); "
            f"{steps_per_s:.3f} steps/s ({steps_per_s * 32:.1f} samples/s) in epoch 2, "
            f"{device['device_ms_per_step']:.3f} device ms and "
            f"{device['device_ops_per_step']:.1f} device operations per step, peak memory "
            f"{peak:.1f} MiB; launches {counts[label]}")
        del case, trainer, loss_fn
        _free_cached()
    return counts


def phase_remat(base_dir: str) -> dict:
    """DG 3D production at batch 256 (bench.py's dg3d_production_b256_remat,
    39×39×10, 20 realizations: one step per epoch), without and with
    ``remat_forwards``, from the same initial weights on the same batches:
    each REMAT_EPOCHS graphed epochs (3 eager warm-up steps, then replays;
    B2 and its backward kernel once per step, the counters counting under
    the recompute), B2 against its plain version on
    the trained models' inputs at B = 256, ``phase_graph``'s checks, 5 timed
    steps (samples/s) and the training's peak memory; then the two runs'
    step losses up to the first replayed step within GRAPH_LOSS_RTOL and
    Model 1's update over the training within GRAPH_WEIGHT_REL. Returns the
    launch counts of each."""
    import numpy as np
    from srm_tpu_torch.config import (DEFAULT_GENERAL_CONFIG, apply_production_overrides,
                                      production_optimizer_configs)
    from srm_tpu_torch.examples.common import setup_case

    kernel, bs = "dg3d_stencil_residual", 256
    opt = production_optimizer_configs(batch_size=bs)
    _free_cached()
    counts, runs = {}, {}
    for remat in (False, True):
        label = "b256_remat" if remat else "b256"
        g = apply_production_overrides(DEFAULT_GENERAL_CONFIG)
        g["remat_forwards"] = remat
        case, secs = _timed(lambda: setup_case("DG", base_dir=base_dir, nz=10,
                                               kle_method="uncorrelated", n_realizations=20,
                                               general_config=g, device="cuda"))
        loss_fn = case["loss_fn"]
        if not loss_fn.use_cuda_stencil or loss_fn.remat_forwards != remat:
            raise AssertionError(f"{label}: remat_forwards {loss_fn.remat_forwards}")
        model1 = list(case["models"]["pressure"].parameters())
        start = [p.detach().clone() for p in model1]
        trainer, history, counts[label], _, peak = _train_epochs(case, kernel, bs, opt,
                                                                     epochs=REMAT_EPOCHS)
        runs[label] = (np.asarray(history["step_total_loss"]),
                       [p.detach() - s for p, s in zip(model1, start)])
        x_all = trainer._resident["train"][0]
        _stencil_agrees(loss_fn, kernel, x_all[:bs], x_all.shape[2:-1])
        device = phase_graph(trainer, kernel, optimizer_configs=opt, spread=False)
        n_timed = 5
        _, t = _timed(lambda: _train_steps(trainer, n_timed))
        log(f"dg3d_production_{label}: batch {bs}, {n_timed / t:.3f} steps/s "
            f"({n_timed * bs / t:.1f} samples/s), {device['device_ms_per_step']:.3f} device ms "
            f"and {device['device_ops_per_step']:.1f} device operations per step, peak memory of "
            f"the training {peak:.1f} MiB (setup {secs:.1f} s); launches {counts[label]}")
        del case, trainer, loss_fn
        _free_cached()
    (l0, u0), (l1, u1) = runs["b256"], runs["b256_remat"]
    warm = 3                                     # the trainer's eager warm-up steps
    loss_rel = float(np.max(np.abs(l1[:warm + 1] - l0[:warm + 1]) / np.abs(l0[:warm + 1])))
    weight_rel = _rel(u1, u0)
    log(f"remat vs no remat at batch 256, the same weights and batches: step losses "
        f"{loss_rel:.3e} apart up to the first replayed step, Model 1's update {weight_rel:.3e}")
    if loss_rel > GRAPH_LOSS_RTOL or weight_rel > GRAPH_WEIGHT_REL:
        raise AssertionError(f"remat changes the training: losses {loss_rel}, update {weight_rel}")
    return counts


def phase_porosity(case) -> dict:
    """Per-cell porosity on the trained DG 2D main-path models: a constant
    field's loss (the unfused residual: the kernels take a scalar porosity)
    against the scalar porosity's (kernel B1) on one batch, the total and
    each term but tde (float32 noise, ROADMAP C1) within the kernel-vs-plain
    tolerance; then two graphed epochs on a two-zone
    field (the western half at a quarter) with the counters set to 0 just
    before: finite losses, B1 and its backward kernel launched no time.
    Returns the launch counts of the two-zone training and of one scalar
    evaluation."""
    import copy

    import numpy as np
    import torch
    from srm_tpu_torch.kernels import stencil as st
    from srm_tpu_torch.losses.physics_loss import PhysicsLoss

    proc = case["processor"]
    res = copy.deepcopy(proc.reservoir_config)
    cells = (res["Nz"], res["Ny"], res["Nx"])

    def with_porosity(porosity):
        r = copy.deepcopy(res)
        r["porosity"] = porosity
        return PhysicsLoss(case["models"], case["data_summary"],
                           general_config=case["general_config"], reservoir_config=r,
                           wells_config=proc.wells_config, fluid_type="DG")

    const = with_porosity(np.full(cells, res["porosity"], np.float32))
    if const.use_cuda_stencil or not case["loss_fn"].use_cuda_stencil:
        raise AssertionError("with a porosity field the fused stencil must be off, with a "
                             "scalar on")
    x, y = _first_batch(case, 32)
    before = st.launches
    with torch.no_grad():
        total_s, aux_s = case["loss_fn"].loss_and_metrics(x, y)
        scalar_launches = st.launches - before
        total_c, aux_c = const.loss_and_metrics(x, y)
    torch.cuda.synchronize()
    if scalar_launches != 1 or st.launches != before + 1:
        raise AssertionError(f"B1 launches: scalar {scalar_launches}, field "
                             f"{st.launches - before - scalar_launches}")
    # every term but tde, which is float32 rounding noise (ROADMAP C1) that
    # the fused and unfused forms round apart (measured 3.5e-4 of the
    # trained models' tde term), and the total
    worst = 0.0
    for t, (a, b) in [(t, (float(aux_c["gas"][t]), float(aux_s["gas"][t])))
                      for t in aux_s["gas"] if t != "tde"] + [
                         ("total", (float(total_c), float(total_s)))]:
        worst = max(worst, abs(a - b) / max(abs(b), 1e-30))
        if abs(a - b) > (RTOL + ATOL_REL) * abs(b):
            raise AssertionError(f"constant field {t}: {a} against the scalar's {b}")
    tde = [float(aux["gas"]["tde"]) for aux in (aux_c, aux_s)]
    phi = np.full(cells, res["porosity"], np.float32)
    phi[:, :, : res["Nx"] // 2] *= 0.25
    field = dict(case, loss_fn=_copy_loss(with_porosity(phi)))
    trainer, history, counts, steps_per_s, _ = _train_epochs(field, None, 32)
    log(f"per-cell porosity: constant field vs scalar {worst:.3e} (largest term's relative "
        f"distance; total {float(total_c):.6e} vs {float(total_s):.6e}; tde term "
        f"{tde[0]:.6e} vs {tde[1]:.6e}); B1 launched "
        f"{scalar_launches} time on the scalar evaluation; two-zone field, two graphed epochs: "
        f"last step loss {history['step_total_loss'][-1]:.6e}, launches {counts}, "
        f"{steps_per_s:.2f} steps/s (unfused residual)")
    del trainer, field
    _free_cached()
    return {"field": counts, "scalar": {"launches": scalar_launches}}


def _first_batch(case, bs: int):
    """The first ``bs`` collapsed training samples on the card."""
    import torch
    from srm_tpu_torch.data.batching import collapse_groups
    x, y = collapse_groups(case["train_groups"])
    return (torch.from_numpy(x[:bs]).cuda(),
            {k: torch.from_numpy(v[:bs]).cuda() for k, v in y.items()})


def phase_knobs(base_dir: str) -> dict:
    """``spatial_pad_to=48`` and ``network_width=64`` on DG 2D (39×39, 20
    realizations): Models 1's and 2's networks padded to 48×48 and Model
    1 with 64 bottom channels, two graphed epochs at batch 32 (B1 and its
    backward kernel once per step), B1 against its plain version on the
    trained models' inputs. Returns the launch counts."""
    import copy

    from srm_tpu_torch.config import DEFAULT_GENERAL_CONFIG
    from srm_tpu_torch.examples.common import setup_case

    kernel = "dg_stencil_residual"
    g = copy.deepcopy(DEFAULT_GENERAL_CONFIG)
    g.update(spatial_pad_to=48, network_width=64)
    case, secs = _timed(lambda: setup_case("DG", base_dir=base_dir, n_realizations=20,
                                           general_config=g, device="cuda"))
    m = case["models"]
    widths = [c.out_channels for c in m["pressure"].network.enc_convs]
    pads = {k: m[k].network.spatial_pad_to for k in ("pressure", "time_step")}
    if widths != [64, 96, 144, 216] or pads != {"pressure": 48, "time_step": 48}:
        raise AssertionError(f"knobs not applied: widths {widths}, pads {pads}")
    trainer, history, counts, steps_per_s, peak = _train_epochs(case, kernel, 32)
    x_all = trainer._resident["train"][0]
    _stencil_agrees(case["loss_fn"], kernel, x_all[:32], x_all.shape[2:-1])
    log(f"spatial_pad_to 48, network_width 64 (widths {widths}): two graphed epochs, last "
        f"step loss {history['step_total_loss'][-1]:.6e}; launches {counts}, "
        f"{steps_per_s:.2f} steps/s in epoch 2, peak memory {peak:.1f} MiB (setup {secs:.1f} s)")
    del case, trainer
    _free_cached()
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
    counts, f32 = {}, {}
    with tempfile.TemporaryDirectory(prefix="smoke_data_", dir=os.path.join(ROOT, "build")) as tmp:
        phase_labels(tmp)
        counts["dg_stencil_residual"], dg_case, f32["dg_stencil_residual"] = phase_main_path(
            tmp, "dg_stencil_residual", general_config=_labelled_config("DG"))
        counts["dg3d_stencil_residual"], _, f32["dg3d_stencil_residual"] = phase_main_path(
            tmp, "dg3d_stencil_residual", nz=10, kle_method="uncorrelated")
        counts["gc_stencil_residual"], gc_case, _ = phase_main_path(tmp, "gc_stencil_residual",
                                                                    fluid="GC")
        phase_serving(tmp, dg_case, gc_case)
        porosity = phase_porosity(dg_case)
        del dg_case, gc_case
        production = {
            "dg_stencil_residual": phase_production(tmp, "dg_stencil_residual",
                                                    f32["dg_stencil_residual"]),
            "dg3d_stencil_residual": phase_production(
                tmp, "dg3d_stencil_residual", f32["dg3d_stencil_residual"], nz=10,
                kle_method="uncorrelated")}
        drawdown = {"gc_stencil_residual": phase_drawdown(tmp)}
        gc3d = phase_gc3d(tmp)
        remat = phase_remat(tmp)
        knobs = phase_knobs(tmp)
    # each kernel's launches on its own f32 main path (a backward kernel's on
    # its forward's), and on each path of this run that runs it (the per-cell
    # porosity path runs the unfused residual: B1 0; gas condensate in 3D
    # has no kernel: its counts, all 0, are checked in phase_gc3d)
    paths = {"f32": counts, "production": production, "drawdown": drawdown,
             "b256": {"dg3d_stencil_residual": remat["b256"]},
             "b256_remat": {"dg3d_stencil_residual": remat["b256_remat"]},
             "pad48_width64": {"dg_stencil_residual": knobs},
             "porosity_field": {"dg_stencil_residual": porosity["field"]}}
    log(f"gas condensate 3D launches (no kernel): {gc3d}")
    by_path = {name: {path: c[fwd][spec["counter"]] for path, c in paths.items() if fwd in c}
               for name, spec in {**KERNELS, **BACKWARD}.items()
               for fwd in [spec.get("forward", name)]}
    launches = {name: by_path[name]["f32"] for name in by_path}
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
        "replaces": replaces[name], "launches": launches[name],
        "launches_by_path": by_path[name], **measured[name],
        "library_ms": None} for name in measured]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
