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
   must show one device launch per call. Each kernel also runs on the row
   blocks of its main path's shape as a space axis hands them to it
   (``_check_blocks``: the 20- and 19-row blocks of a space axis of 2,
   whose first and last ghost rows are the domain's, and the middle block
   of a space axis of 3, whose ghost rows are its neighbours' rows),
   forward and backward against its plain version.
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
14. data generation (run first, after the kernels) — ``python -m
    srm_tpu_torch generate-data`` at the default case (39×39, 200
    realizations, the Eclipse decks; host numpy work), timed and its tree
    checked; the on-device KLE sampler at 39×39 and 200 realizations: its
    mode count against the numpy sampler's, the log-field statistics, its
    host and CUDA-event times.
15. well solvers (last) — the Newton BHP on DG 2D (B1) and the blocking
    factor on GC 2D (B3), ``setup_case(..., well_solver_kwargs=)`` at
    39×39, 20 realizations, batch 32: two graphed epochs, the kernel's and
    its backward's launches, the kernel against its plain version on the
    trained inputs, ``phase_graph``'s checks with the replay bitwise the
    eager step over 6 steps (its restore check left to the main paths);
    steps/s, device ms and operations per step and capture seconds beside
    the default paths'; ``log_iterations`` under replay.
16. polynomial PVT and network options (after the well solvers) — DG 2D
    with ``pvt_fitting_method="polynomial"`` (39×39, 20 realizations,
    batch 32, f32): the ``fluid_property`` optimizer a third one, two
    graphed epochs through B1 and its backward kernel, every loss finite,
    the coefficients changed, B1 against its plain version on the trained
    inputs, ``phase_graph``'s checks; steps/s, device ms and operations
    per step beside dg2d's. Then the options the model map turns off, at
    full width on one batch of 32 at 39×39 against the same modules on
    the CPU: the encoder–decoder with skips and ``latent_flatten``
    (forward and backward), the residual net's distribution head with
    BatchNorm in eval and its ``dense`` variant, Model 1 under a HardLayer
    with the RBF modulation.
17. simulator graphs, tools and examples (last) — the simulator's 3D
    iterative solves as CUDA graphs (``sim/fv_simulator.py::SolverGraphs``,
    blocks of 32 trips and the tail block captured once and replayed): dry
    gas (CG) at 39×39×10 on one realization for 5 times and on a chunk of
    4, gas condensate (BiCGStab) on one realization for 3 times, each
    bitwise the eager loop (``cuda_graph=False``) with the same trips per
    solve, twice on one set of graphs, one realization within
    SOLVER_PSIA_TOL of the float64 dense solve; the eager and graphed
    seconds and the device operations per solve. The GC 2D labels of
    CHUNK_REALIZATIONS test realizations and CHUNK_TIMES times at chunks 8
    and 16 (``tools/label_chunks.compare``), bitwise equal, and their
    seconds. The two example drivers' ``main`` (``examples/
    training_case_{dry_gas,gas_condensate}.py``) at 39×39, 20
    realizations, one epoch, through B1 and B3 with their launches counted
    (each loss evaluation the kernel, each step its backward kernel,
    nothing else), the loss finite, and the steps/s of one more epoch.
    Then the tools: ``mfu_probe`` (``base`` and ``bf16`` at batch 32, one
    JSON line each, 0 < mfu < 1; ``probe_two_nets`` on GC 2D's pair at
    batch 32, sequential and stacked by turns, their gradients within
    OPTIONS_GRAD_REL of each other), ``flops_breakdown`` (DG 3D production at
    batch 32, its total) and ``sg_head_probe.probe`` for one epoch on the
    drawdown phase's trained case (B3 and its backward at every step, every
    key of its report finite).
18. data parallel (last; ``parallel/mesh.py``) — DG 2D at 39×39, 20
    realizations, batch 32, from one set of initial weights. (a) World 1
    over NCCL, graphed: two epochs as the trainer without a process group,
    cuDNN deterministic; every step after the warm-up one replay, each step
    B1 and its backward kernel, the gradient all-reduce called once inside
    the capture (and once in each warm-up step); the per-step metrics and
    final weights bitwise those without a group; then a fresh graphed pair
    (as the main path runs, cuDNN's default) timed by turns for steps/s,
    and a profiler window over 3 replayed steps of the mesh's (B1 and its
    backward once a step; the NCCL device work logged: NCCL 2.28 gives an
    in-place SUM on one rank none). (b) Two ranks on the one card over
    gloo (NCCL refuses two ranks on one device), eager, 16 rows each,
    started as processes: against one eager rank on the same global
    batches the first step's total within DP_FIRST_RTOL and its gradients,
    summed over the ranks, within ``tools/data_parallel.py``'s GRAD_RTOL
    per model but the Δt net (C2; a mean over the ranks is 0.5 off), each
    step's total within
    DP_LOSS_RTOL, each model's update over the epoch within
    DP_UPDATE_RTOL, the two ranks' weights bitwise equal, B1 and its
    backward at every step on both, ``cuda_graph=True`` on that group
    raising; the epoch's seconds and B1's time at B = 16.
19. space axis (right after the main paths; ``parallel/halo.py``) — two
    gloo ranks on the one card as ``make_mesh(2, spatial=2)``: each rank
    the whole batch of 32 and its 20 or 19 rows of the 39 of H, the halos
    staged through the host, eager, from one set of initial weights;
    DG 2D at 39×39, 20 realizations, one epoch, one DG 2D step with
    ``remat_forwards`` (the halo exchanges repeated in the backward's
    recompute) and one GC 2D step. Against
    one eager rank on the same batches: the first step's total within
    DP_FIRST_RTOL and its gradients, summed over the ranks, within
    ``tools/data_parallel.py``'s SPACE_GRAD_RTOL per model but DG's Δt net
    (C2); every step's total within SP_LOSS_RTOL and each model's update
    within DP_UPDATE_RTOL; the ranks' weights bitwise equal; B1 (B3) and
    its backward at every step on both ranks' blocks; ``cuda_graph=True``
    on that group raising. After the remat step the same two ranks run one
    dg2d_newton_bhp step with ``log_iterations`` (rank 0's one file
    against one rank's, SP_LOG_RTOL) and the full-width ``latent_flatten``
    encoder–decoder and VAE residual net's forwards on their rows against
    the whole grid (OPTIONS_RTOL).

The line before the last is a JSON object describing each kernel (its
numbers at batch 32, under ``at_b128`` those at batch 128, under
``at_128x117x117`` or ``at_256x10x39x39`` those at the last
configurations' shape, its launches on its f32 main path and, under
``launches_by_path``, on every path of this run that runs it, the well
solver's paths, the example drivers' ``example_dg`` and ``example_gc``,
``sg_head_probe``, the data-parallel phase's ``dp_nccl_world1``,
``dp_gloo_rank0`` and ``dp_gloo_rank1`` and the space axis's
``sp_gloo_rank0``, ``sp_gloo_rank1``, ``sp_gloo_remat_rank0``,
``sp_gloo_remat_rank1``, ``sp_gloo_gc_rank0`` and ``sp_gloo_gc_rank1``
among them); the last line is
``{"ok": true, "device": {...}}``.
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

# the simulator labels (phase_labels): the test split of each 2D case at 6
# realizations (4 test realizations; cut from 20, then 10, for the time
# limit), the
# reference's physical bounds and its mass-balance bound
# (tests/test_fv_simulator.py:36-93), its bound between the dense and the
# iterative solver (:202, 0.1 psia), and its bound on the RMSE of a barely
# trained pressure model (:131-134)
LABEL_REALIZATIONS = 6
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

# the kernels' timing depth, cut to keep the script well inside its time
# limit: the median of TIMING's repeats of back-to-back calls (profile_step's
# defaults: 5 repeats of 100 calls, and of 20 for a backward), and the calls
# of a profiler window (20 before the cut)
TIMING = dict(repeats=3, calls=40)
BACKWARD_TIMING = dict(repeats=3, calls=10)
PROFILED_CALLS = 10
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
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"CUDA {torch.version.cuda}  nvcc: {nvcc}")
    log(f"device: {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()})")
    log(card_line())


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


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

    max_err = max(max_err, _check_blocks(name))
    timed = [_time_forward(name, shape) for shape in _timed_shapes(spec)]
    _check_one_launch(name, spec["device_name"], _timed_shapes(spec), timed)
    return {"max_abs_err": max_err, **timed[0], "at_b128": timed[1], **_extra_shapes(spec, timed)}


def _block_args(name: str, args, lo: int, hi: int) -> list:
    """The row block ``[lo, hi)`` of a kernel's inputs as a rank of a space
    axis hands it to the kernel: the padded fields' rows ``[lo, hi + 2)``
    (its halo rows are its neighbours' rows, the ghost rows only at the
    domain's first and last rows), the centred fields' and qwell's rows
    ``[lo, hi)``, tsteps whole."""
    from srm_tpu_torch.kernels import stencil as st
    names = {"dg_stencil_residual": st.DG_ARGS, "dg3d_stencil_residual": st.DG3D_ARGS,
             "gc_stencil_residual": st.GC_ARGS + ("qwell", "tsteps")}[name]
    padded = (set(st.GC_PADDED) if name == "gc_stencil_residual"
              else {n for n in names if n.endswith("p")})
    return [a if n == "tsteps" else a[..., lo:hi + 2 if n in padded else hi, :].contiguous()
            for n, a in zip(names, args)]


def _check_blocks(name: str) -> float:
    """The kernel against its plain version, forward and backward (its
    Function's gradient against autograd through the plain version), on
    the row blocks of its main path's shape as a space axis hands them to
    it: the two blocks of a space axis of 2 (``Mesh.row_blocks``: 20 and
    19 of 39 rows, the first's first ghost row and the last's last ghost
    row the domain's, the others their neighbours' rows) and the middle
    block of a space axis of 3 (both ghost rows its neighbours'). Returns
    the largest forward difference."""
    import torch
    from srm_tpu_torch.kernels import stencil as st
    from srm_tpu_torch.parallel.mesh import Mesh
    spec = KERNELS[name]
    fused, plain = getattr(st, name), getattr(st, f"{name}_reference")
    shape = spec["shapes"][0]
    H = shape[-2]
    whole, cfg = make_stencil_inputs(name, *shape)
    first, last = Mesh(size=2, space_size=2).row_blocks(H)
    middle = Mesh(size=3, space_size=3).row_blocks(H)[1]
    max_err = 0.0
    for what, (lo, hi) in (("first edge", first), ("last edge", last), ("interior", middle)):
        args = _block_args(name, whole, lo, hi)
        with torch.no_grad():
            got, want = fused(*args, cfg), plain(*args, cfg)
        for out, a, b in zip(spec["outputs"], got, want):
            max_err = max(max_err, check_close(f"{name} {what} block rows [{lo}, {hi}) forward "
                                               f"{out}", a, b))
        grads = []
        for fn in (fused, plain):
            a = list(args)
            for i in spec["wrt"]:
                a[i] = args[i].clone().requires_grad_(True)
            loss = sum((o ** 2).sum() for o in fn(*a, cfg))
            grads.append(torch.autograd.grad(loss, [a[i] for i in spec["wrt"]]))
        for i, a, b in zip(spec["wrt"], grads[0], grads[1]):
            check_close(f"{name} {what} block rows [{lo}, {hi}) backward d/d(arg {i})", a, b)
        log(f"{name} on the {what} row block [{lo}, {hi}) of {shape}: forward and backward "
            f"agree with the plain version")
    return max_err


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
    PROFILED_CALLS calls of each) and its bound: each input read once, each
    output written once, at the HBM rate, or its operations at the float32
    peak."""
    import torch
    from srm_tpu_torch.kernels import stencil as st
    from srm_tpu_torch.tools.profile_step import (FP32_OPS_PER_S, HBM_BYTES_PER_S, profile_calls,
                                                  time_ms, warm_cold_ms)
    spec = KERNELS[name]
    fused, plain = getattr(st, name), getattr(st, f"{name}_reference")
    args, cfg = make_stencil_inputs(name, *shape)
    with torch.no_grad():
        plain_ms = time_ms(lambda: plain(*args, cfg), **TIMING)
        ms = time_ms(lambda: fused(*args, cfg), **TIMING)
        ms2 = time_ms(lambda: fused(*args, cfg), **TIMING)
        plain_ms2 = time_ms(lambda: plain(*args, cfg), **TIMING)
        outs = fused(*args, cfg)
        events = warm_cold_ms(lambda: fused(*args, cfg))
        table = []
        launches, device_us, _ = profile_calls(lambda: fused(*args, cfg), PROFILED_CALLS, table)
        plain_launches, plain_device_us, _ = profile_calls(lambda: plain(*args, cfg),
                                                           PROFILED_CALLS)
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
    host = {k: time_ms(calls[k], **BACKWARD_TIMING) for k in ("adjoint", "kernel", "autograd")}
    host2 = {k: time_ms(calls[k], **BACKWARD_TIMING) for k in ("autograd", "kernel", "adjoint")}
    table = []
    device = {k: profile_calls(calls[k], PROFILED_CALLS, table if k == "kernel" else None)
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
    physical checks; prints the seconds of each. (The 3D iterative paths
    are checked against the float64 dense solve in ``phase_sim_graphs``.)"""
    import numpy as np
    import torch
    from srm_tpu_torch.config import DEFAULT_SCAL_CONFIG
    from srm_tpu_torch.data.dataset import SRMDataProcessor
    from srm_tpu_torch.physics.relperm import RelativePermeability
    from srm_tpu_torch.sim import build_problem, simulate_labels
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
    capture_s = dict(trainer.capture_seconds)
    log(f"main path {fluid} {grid}: {len(steps)} steps, {warm} eager warm-up steps and "
        f"replays {trainer.replays}, launches {counts}, {recomputes} plain recomputes, "
        f"{steps_per_s:.2f} steps/s in epoch 2, capture {capture_s['train']:.3f} s (train) and "
        f"{capture_s['eval']:.3f} s (eval), peak memory "
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
    return counts, case, {"steps_per_s": steps_per_s, "capture_s": capture_s,
                          **phase_graph(trainer, kernel)}


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


def phase_graph(trainer, kernel, optimizer_configs=None, spread: bool = True,
                bitwise: bool = False, restore: bool = True, steps: int = 9) -> dict:
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
       1's weights after ``steps`` steps within GRAPH_WEIGHT_REL of their
       update and
       Model 2's after the first replayed step within GRAPH_MODEL2_REL (held
       on one step only: its float32 gradient is rounding noise once the
       weights move, ROADMAP C2), or on a path without a kernel within
       GRAPH_UNFUSED_WEIGHT_REL (with ``bitwise``, bit for bit: losses and
       weights); with ``spread`` the eager step against a
       second eager run is logged beside it and must agree bit for bit
       (losses and weights): since the pads' backward is fixed-order
       (ROADMAP C16) no op of a step adds in a varying order;
    3. with ``restore``, a best-epoch restore (``load_snapshot``, in place)
       is seen by the next
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
    if restore:
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
            rest = _train_steps(t, steps - 1 - warm)
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
    if replayed != steps - warm:
        raise AssertionError(f"the graphed trainer replayed {replayed} of {steps} steps")

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
        log(f"{what} from the same weights, {steps} steps ({warm} warm-up): step losses "
            f"{l1:.3e} apart up to the first "
            f"replayed step, {l9:.3e} over all {steps} (relative); {m1} weights after "
            f"{steps} steps "
            f"{w1:.3e} and {m2} after the first replayed step {w2:.3e} of their update")
    if spread and any(v != 0.0 for v in compared[1][1]):
        raise AssertionError(f"two eager runs from the same weights differ: {compared[1][1]} "
                             f"(each op of the step is deterministic; ROADMAP C16)")
    if bitwise and any(v != 0.0 for v in got):
        raise AssertionError(f"the replayed step is not bitwise the eager one: {got}")
    l1, _, w1, w2 = got
    bounds = (GRAPH_WEIGHT_REL, GRAPH_MODEL2_REL)
    if kernel is None:
        bounds = (GRAPH_UNFUSED_WEIGHT_REL, GRAPH_UNFUSED_WEIGHT_REL)
    if not np.all(np.isfinite(runs["graph"][1])) or l1 > GRAPH_LOSS_RTOL or \
            w1 > bounds[0] or w2 > bounds[1]:
        raise AssertionError(f"the replayed step differs from the eager one: {got} (bounds "
                             f"{bounds})")

    result = {"device_ms_per_step": device["device_ms_per_step"],
              "device_ops_per_step": device["device_ops_per_step"]}
    if not restore:
        return result
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
    return result


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
    the launch counts of the training and the trained case."""
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
    return counts, case


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


def phase_datagen(base_dir: str) -> dict:
    """Data generation at the default case: ``python -m srm_tpu_torch
    generate-data`` (39×39×1, 200 realizations, with the Eclipse decks; host
    work with the numpy sampler, as in the JAX package) into ``base_dir``,
    timed, its tree checked (the splits, the 200 PERMX decks, the grid's
    mode count); then the on-device sampler ``generate_kle_torch`` at the
    same grid and 200 realizations (``tools/kle_sampler.py``: two calls,
    host and CUDA-event times, the same fields from the same seed, the
    log-field mean and pooled variance within their statistical bounds),
    its mode count against the numpy sampler's (equal, or one apart: the
    float32 eigendecomposition may put the energy cut one mode off).
    Returns the numbers."""
    import numpy as np
    from srm_tpu_torch.tools.kle_sampler import run

    out_dir = os.path.join(base_dir, "generate_data")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "srm_tpu_torch", "generate-data", "--base-dir",
                           out_dir], cwd=ROOT, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"generate-data failed: {proc.stderr[-3000:]}")
    folder = proc.stdout.strip().splitlines()[-1].split("written to ", 1)[1]
    with open(os.path.join(folder, "grid.json")) as f:
        host_modes = json.load(f)["num_modes"]
    with open(os.path.join(folder, "split_info.json")) as f:
        counts = json.load(f)["counts"]
    decks = [os.path.join(d, f) for d, _, files in os.walk(folder) for f in files
             if f.endswith(".dat")]
    fields = np.load(os.path.join(folder, "realizations_all.npy"))
    if counts != {"train": 60, "val": 0, "test": 140} or len(decks) != 200 or \
            fields.shape != (200, 1, 39, 39) or not np.all(fields > 0):
        raise AssertionError(f"generate-data tree: counts {counts}, {len(decks)} decks, fields "
                             f"{fields.shape}")
    log(f"generate-data (39x39x1, 200 realizations, 200 decks): {secs:.2f} s, "
        f"{host_modes} modes (numpy sampler, float64 eigh on the host)")
    kle = run(39, 1, 200, reps=2, device="cuda")
    log(f"generate_kle_torch on the card (39x39, 200 realizations): {kle['num_modes']} modes "
        f"against the numpy sampler's {host_modes} (difference "
        f"{kle['num_modes'] - host_modes}); calls {kle['host_s']} s on the host, "
        f"{kle['event_ms']} ms by CUDA events, peak {kle['peak_alloc_mib']:.1f} MiB; log-field "
        f"mean {kle['log_mean']:.5f} (mu_log {kle['mu_log']:.5f} +- {kle['mean_bound']:.5f}), "
        f"pooled variance {kle['pooled_var']:.5f} ({kle['want_var']:.5f} +- "
        f"{kle['var_bound']:.5f})")
    if abs(kle["num_modes"] - host_modes) > 1:
        raise AssertionError(f"mode counts {kle['num_modes']} (card) and {host_modes} (numpy)")
    return {"generate_data_s": secs, "numpy_modes": host_modes, **kle}


# the well solver's paths (well_solver_kwargs of setup_case) and the default
# paths they are set beside: the Newton BHP on DG 2D (B1), the blocking
# factor with its Newton saturation roots on GC 2D (B3)
WELL_PATHS = {
    "dg2d_newton_bhp": dict(fluid="DG", kernel="dg_stencil_residual",
                            well_solver_kwargs={"use_non_iterative": False}),
    "gc2d_blocking": dict(fluid="GC", kernel="gc_stencil_residual",
                          well_solver_kwargs={"use_blocking_factor": True}),
}


def phase_well_solvers(base_dir: str, defaults: dict) -> dict:
    """The well solver's two paths at 39×39, 20 realizations, full widths,
    batch 32, f32: ``setup_case(..., well_solver_kwargs=)``, two epochs
    through the graphed trainer (each loss evaluation through its kernel,
    each step's backward through its backward kernel, nothing else), the
    kernel against its plain version on the trained models' inputs,
    ``phase_graph``'s checks with the replay bitwise the eager step; the
    steps/s, device ms and operations per step and capture seconds printed
    beside the default path's (``defaults``, the main paths' numbers); the
    replay is held to the eager step over 6 steps and the restore check is
    left to the main paths. On
    the Newton path also ``log_iterations`` under replay: one file per
    step, each replay's its own. Returns the launch counts of each path."""
    from srm_tpu_torch.examples.common import setup_case

    counts = {}
    for name, spec in WELL_PATHS.items():
        t_path = time.time()
        kernel, kw = spec["kernel"], spec["well_solver_kwargs"]
        g = _labelled_config("DG") if spec["fluid"] == "DG" else None
        case, secs = _timed(lambda: setup_case(spec["fluid"], base_dir=base_dir,
                                               n_realizations=20, general_config=g,
                                               well_solver_kwargs=kw, device="cuda"))
        well = case["models"]["well_rate_bhp_model"]
        if any(getattr(well, k) != v for k, v in kw.items()) or \
                not case["loss_fn"].use_cuda_stencil:
            raise AssertionError(f"{name}: the well solver's knobs or the stencil not taken")
        trainer, history, counts[name], steps_per_s, peak = _train_epochs(case, kernel, 32)
        capture = dict(trainer.capture_seconds)
        x_all = trainer._resident["train"][0]
        _stencil_agrees(case["loss_fn"], kernel, x_all[:32], x_all.shape[2:-1])
        # the restore check is the trainer's, held on the main paths, and 6
        # steps (3 replayed) in place of 9: the blocking path's eager steps
        # take seconds each (~95k launches)
        device = phase_graph(trainer, kernel, bitwise=True, restore=False, steps=6)
        base = defaults[kernel]
        log(f"{name} (setup {secs:.1f} s): last step loss {history['step_total_loss'][-1]:.6e}; "
            f"launches {counts[name]}; {steps_per_s:.3f} steps/s in epoch 2 (default path "
            f"{base['steps_per_s']:.3f}), {device['device_ms_per_step']:.3f} device ms "
            f"({base['device_ms_per_step']:.3f}) and {device['device_ops_per_step']:.1f} "
            f"device operations per step ({base['device_ops_per_step']:.1f}), capture "
            f"{capture['train']:.3f} s train + {capture['eval']:.3f} s eval "
            f"({base['capture_s']['train']:.3f} + {base['capture_s']['eval']:.3f}), peak "
            f"memory {peak:.1f} MiB")
        if name == "dg2d_newton_bhp":
            _replayed_iteration_logs(case, os.path.join(base_dir, "iteration_logs"))
        log(f"[{name}: {time.time() - t_path:.1f} s]")
        del case, trainer, well
        _free_cached()
    return counts


def _replayed_iteration_logs(case, log_dir: str, steps: int = 6) -> None:
    """``log_iterations`` on the trained Newton-BHP path under replay: a
    graphed trainer of a copy of its loss (the well model logging into
    ``log_dir``) runs ``steps`` steps, 3 eager then replays; each step
    writes one file of the pwf history (max_iters rows and the final one)
    after it, and no two steps' histories, as the flush found them in the
    device buffers, are the same bits (a replay that left its buffer stale
    would repeat the step before). The files are not compared: they hold
    the first values at six digits, and where pwf is clipped to the cell's
    pressure near its initial value two steps' files can read the same
    (4 distinct of 6 measured on the card)."""
    import copy

    import torch
    from srm_tpu_torch.training.trainer import Trainer
    loss = _copy_loss(case["loss_fn"])
    well = copy.copy(loss.models["well_rate_bhp_model"])
    well.log_iterations, well.log_dir = True, log_dir
    well._log_buffers, well._log_written = {}, {}
    flushed, flush = [], well.flush_iteration_logs

    def recording_flush():
        """The flush, with a copy of each history it is about to write."""
        counts = {k: int(b[2]) for k, b in well._log_buffers.items()}
        flushed.extend(torch.cat([b[0].flatten(), b[1].flatten()]).cpu()
                       for k, b in well._log_buffers.items()
                       if counts[k] > well._log_written[k])
        return flush()

    well.flush_iteration_logs = recording_flush
    loss.models = {**loss.models, "well_rate_bhp_model": well}
    trainer = Trainer(loss, seed=3)
    trainer.stage_dataset("train", case["train_groups"], 32)
    _, secs = _timed(lambda: _train_steps(trainer, steps))
    texts = []
    for f in os.listdir(log_dir):
        with open(os.path.join(log_dir, f)) as fh:
            texts.append(fh.read())
    rows = {len(t.splitlines()) for t in texts}
    repeats = sum(torch.equal(a, b) for i, a in enumerate(flushed) for b in flushed[:i])
    if len(texts) != steps or len(flushed) != steps or rows != {well.max_iters + 2} or \
            trainer.replays["train"] != steps - trainer.warmup_steps or repeats:
        raise AssertionError(f"log_iterations under replay: {len(texts)} files, "
                             f"{len(flushed)} histories ({repeats} pairs the same bits) for "
                             f"{steps} steps ({trainer.replays} replays), rows {rows}")
    log(f"log_iterations under replay: {len(texts)} pwf histories for {steps} steps "
        f"({trainer.replays['train']} replays) in {secs:.2f} s, each replay's its own "
        f"({len(set(texts))} distinct files at six digits)")
    del trainer, loss


# the network options on the card against the same modules on the CPU
# (phase_options): outputs as tests/test_torch_nn.py holds the networks
# (RTOL, atol RTOL of the output's largest magnitude: float32 convolutions
# summed in another order), parameter gradients of sum(out · c) by their
# relative L2 distance
OPTIONS_RTOL, OPTIONS_GRAD_REL = 1e-4, 1e-4


def phase_polynomial_pvt(base_dir: str, defaults: dict) -> dict:
    """The trainable polynomial PVT (``pvt_fitting_method="polynomial"``)
    on DG 2D at 39×39, 20 realizations, full widths, batch 32, f32: the
    ``fluid_property`` optimizer (AdamW on the coefficients) a third one;
    two epochs through the graphed trainer (B1 at each loss evaluation, its
    backward kernel at each step, nothing else; every loss finite; every
    trained model moved, the coefficients among them); B1 against its plain
    version on the trained inputs; ``phase_graph``'s checks; steps/s,
    device ms and operations per step beside the spline path's
    (``defaults``). Returns the launch counts."""
    from srm_tpu_torch.examples.common import setup_case

    kernel = "dg_stencil_residual"
    g = _labelled_config("DG")
    g["pvt_fitting_method"] = "polynomial"
    case, secs = _timed(lambda: setup_case("DG", base_dir=base_dir, n_realizations=20,
                                           general_config=g, device="cuda"))
    loss_fn, pvt = case["loss_fn"], case["models"]["pvt_model"]
    if loss_fn.trainable_models_keys != ["pressure", "time_step", "fluid_property"] or \
            not loss_fn.use_cuda_stencil or type(pvt).__name__ != "PolynomialPVT":
        raise AssertionError(f"the polynomial PVT path: {loss_fn.trainable_models_keys}, "
                             f"{type(pvt).__name__}, stencil {loss_fn.use_cuda_stencil}")
    start = {n: p.detach().clone() for n, p in pvt.named_parameters()}
    trainer, history, counts, steps_per_s, peak = _train_epochs(case, kernel, 32)
    steps = int(trainer.optimizers["fluid_property"].count)
    moved = {n: float((p.detach() - start[n]).abs().max()) for n, p in pvt.named_parameters()}
    if steps != len(history["step_total_loss"]) or not all(v > 0 for v in moved.values()):
        raise AssertionError(f"fluid_property took {steps} steps; coefficients moved {moved}")
    coeffs = {n: [float(v) for v in p.detach().cpu()] for n, p in pvt.named_parameters()}
    x_all = trainer._resident["train"][0]
    _stencil_agrees(loss_fn, kernel, x_all[:32], x_all.shape[2:-1])
    capture = dict(trainer.capture_seconds)
    device = phase_graph(trainer, kernel)
    base = defaults[kernel]
    losses = history["step_total_loss"]
    log(f"dg2d_polynomial_pvt (setup {secs:.1f} s): step losses {losses[0]:.6e} ... "
        f"{losses[-1]:.6e}; fluid_property {steps} AdamW steps, "
        f"coefficients {coeffs} (moved {moved}); launches {counts}; {steps_per_s:.3f} steps/s "
        f"in epoch 2 (spline path {base['steps_per_s']:.3f}), "
        f"{device['device_ms_per_step']:.3f} device ms ({base['device_ms_per_step']:.3f}) and "
        f"{device['device_ops_per_step']:.1f} device operations per step "
        f"({base['device_ops_per_step']:.1f}), capture {capture['train']:.3f} s train + "
        f"{capture['eval']:.3f} s eval, peak memory {peak:.1f} MiB")
    del case, trainer, pvt, loss_fn
    _free_cached()
    return counts


def _option_modules(seed: int = 0) -> dict:
    """The network options at full width (the default configs' widths), from
    a seed: the encoder–decoder with skips and ``latent_flatten``, the
    residual net's distribution head with BatchNorm (its statistics and
    affine parameters drawn away from their initial values) and its
    ``dense`` variant with the distribution head, and Model 1 under a
    HardLayer with the RBF modulation, its output projection's bias set to
    100 so that the departure from Pi is not ~1e-3 psia. Name → (module,
    trained, the output's offset: Pi for Model 1, compared as the
    departure from it; else 0)."""
    import numpy as np
    import torch
    from srm_tpu_torch.config import DEFAULT_RESERVOIR_CONFIG, get_configuration
    from srm_tpu_torch.nn import modules as tmod
    from srm_tpu_torch.nn.encoder_decoder import EncoderDecoder
    from srm_tpu_torch.nn.hard_layer import HardLayer
    from srm_tpu_torch.nn.residual import BatchNorm, ResidualNetwork

    gen = torch.Generator().manual_seed(seed)
    ed = get_configuration("encoder_decoder")
    ed["temporal"] = True
    ed["residual_params"]["Skip_Connections"] = {"Add": True, "Layers": [1, 1, 1, 1]}
    ed["residual_params"]["Latent_Layer"]["Flatten"] = True
    res = get_configuration("residual")
    res.update(temporal=True, output_distribution=True)
    bn = ResidualNetwork.from_config(dict(res, use_batch_norm=True), 5, generator=gen)
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for m in bn.modules():
            if isinstance(m, BatchNorm):
                for t, lo, hi in ((m.scale, 0.5, 1.5), (m.bias, -0.5, 0.5),
                                  (m.mean, -0.5, 0.5), (m.var, 0.5, 2.0)):
                    t.copy_(torch.from_numpy(rs.uniform(lo, hi, t.shape).astype(np.float32)))
    pi = DEFAULT_RESERVOIR_CONFIG["initialization"]["Pi"]
    pressure = tmod.build_pressure_model((1, 39, 39, 5), generator=gen)
    pressure.hard_layer = HardLayer((1, 39, 39, 1), init_value=pi, exponent_min=0.1,
                                    exponent_max=1.0, use_rbf=True, generator=gen)
    with torch.no_grad():
        pressure.network.output_proj.bias.fill_(100.0)
    return {
        "encoder-decoder, skips + latent_flatten":
            (EncoderDecoder.from_config(ed, 5, generator=gen, grid=(39, 39)), True, 0.0),
        "residual, distribution head + BatchNorm (eval)": (bn, False, 0.0),
        "residual, dense + distribution head":
            (ResidualNetwork.from_config(dict(res, network_type="dense"), 5, generator=gen),
             True, 0.0),
        "Model 1, HardLayer with RBF": (pressure, True, pi),
    }


def phase_options() -> None:
    """The network options that the model map turns off, at full width on
    the card, one batch of 32 at 39×39 (``_option_modules``): the output
    (``training=False``; Model 1's as its departure from Pi) and, for the
    options that train, the parameter
    gradients of sum(out · c) against the same module with the same
    weights on the CPU, within OPTIONS_RTOL and OPTIONS_GRAD_REL."""
    import copy

    import numpy as np
    import torch

    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.uniform(-1, 1, (32, 1, 39, 39, 5)).astype(np.float32))

    def run(module, xb, trained, offset):
        params = list(module.parameters())
        with torch.set_grad_enabled(trained):
            out = module(xb, training=False) - offset
        if not trained:
            return out.detach().cpu(), []
        c = torch.from_numpy(np.random.RandomState(2).uniform(-1, 1, tuple(out.shape))
                             .astype(np.float32)).to(out.device)
        grads = torch.autograd.grad((out * c).sum(), params)
        return out.detach().cpu(), [g.cpu() for g in grads]

    for name, (module, trained, offset) in _option_modules().items():
        want, want_g = run(module, x, trained, offset)
        got, got_g = run(copy.deepcopy(module).cuda(), x.cuda(), trained, offset)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = OPTIONS_RTOL * (want.abs() + want.abs().max())
        if got.shape != want.shape or not torch.isfinite(got).all() or \
                ((got - want).abs() > tol).any():
            raise AssertionError(f"{name}: card vs CPU output, max abs err {err:.3e} of "
                                 f"max |out| {float(want.abs().max()):.3e}")
        grad_rel = _rel(got_g, want_g) if trained else None
        if trained and not grad_rel <= OPTIONS_GRAD_REL:
            raise AssertionError(f"{name}: card vs CPU gradients {grad_rel:.3e} apart")
        log(f"option on the card, {name}: output {tuple(got.shape)}, max abs err {err:.3e} of "
            f"max |out - {offset}| {float(want.abs().max()):.3e} from the CPU"
            + (f"; parameter gradients {grad_rel:.3e} apart (relative L2)" if trained else
               "; evaluated only (BatchNorm cannot train, ROADMAP C19)"))


# phase 17: the GC labels' chunks are compared on the first
# CHUNK_REALIZATIONS test realizations (more than 16, so that both chunk
# sizes run more than one chunk) and the first CHUNK_TIMES test times
CHUNK_REALIZATIONS, CHUNK_TIMES = 17, 6


def _sim_case(fluid: str, count: int):
    """The default reservoir at 39×39×10, ``count`` log-normal fields from
    the config's seed (``phase_labels``' draw), the simulator's spline PVT in
    float32 and float64, the simulation function of ``fluid`` and Pi."""
    import copy

    import numpy as np
    import torch
    from srm_tpu_torch.config import (DEFAULT_RESERVOIR_CONFIG, DEFAULT_SCAL_CONFIG,
                                      DEFAULT_WELLS_CONFIG)
    from srm_tpu_torch.physics.relperm import RelativePermeability
    from srm_tpu_torch.sim import build_problem, simulate_dry_gas, simulate_gas_condensate
    scal = DEFAULT_SCAL_CONFIG
    res = copy.deepcopy(DEFAULT_RESERVOIR_CONFIG)
    res["Nz"] = 10
    g = _labelled_config(fluid)
    prob, kscale = build_problem(res, DEFAULT_WELLS_CONFIG, scal, g)
    spec = res["realizations"]["permx"]
    rng = np.random.RandomState(g["seed"])
    kx = torch.from_numpy(np.exp(rng.normal(np.log(spec["mean"]), spec["std"] / spec["mean"],
                                            (count, 10 * 39 * 39))).astype(np.float32)).cuda()
    if fluid == "DG":
        def sim(k, times, pvt, **kw):
            return simulate_dry_gas(prob, kscale, k, times, pvt, **kw)
    else:
        relperm = RelativePermeability.from_config(scal["end_points"], scal["corey_exponents"])

        def sim(k, times, pvt, **kw):
            return simulate_gas_condensate(prob, kscale, k, times, pvt, relperm,
                                           scal["end_points"]["Swmin"], **kw)
    return (kx, g["srm_timestep"], sim, simulator_pvt(fluid), simulator_pvt(fluid).double(),
            float(prob.Pi))


def _device_ops_per_solve(run) -> tuple:
    """``run(stats)`` under the profiler: device operations and device ms
    per iterative solve."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    stats = {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(stats)
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    solves = len(stats["trips"])
    return len(device) / solves, sum(e.time_range.elapsed_us() for e in device) / solves / 1e3


def phase_sim_graphs() -> dict:
    """The 3D iterative solves as CUDA graphs (``SolverGraphs``): dry gas
    (CG) on one realization for 5 times and on a chunk of 4, gas condensate
    (BiCGStab) on one realization for 3 times, at 39×39×10: the graphed
    simulation bitwise the eager one (``cuda_graph=False``) with the same
    trips per solve, twice on one set of graphs (captured once), and on one
    realization within SOLVER_PSIA_TOL of the float64 dense solve (the
    float32 dense solve's distance printed beside it for dry gas); the
    seconds of each, and the device operations and device ms per solve
    (the first solve of a run)."""
    import numpy as np
    import torch
    from srm_tpu_torch.sim.fv_simulator import SolverGraphs
    out = {}
    for fluid, solver, n_times, blocks in (("DG", "cg", 5, (1, 4)), ("GC", "bicgstab", 3, (1,))):
        kx_all, dt, sim, pvt, pvt64, pi = _sim_case(fluid, sum(blocks))
        times = np.arange(n_times, dtype=np.float32) * dt
        start = 0
        for c in blocks:
            kx = kx_all[start:start + c]
            start += c
            eager_stats, graph_stats, again_stats = {}, {}, {}
            eager, t_eager = _timed(lambda: sim(kx, times, pvt, solver=solver,
                                                stats=eager_stats, cuda_graph=False))
            solvers = SolverGraphs()
            graphed, t_first = _timed(lambda: sim(kx, times, pvt, solver=solver,
                                                  stats=graph_stats, solvers=solvers))
            captures = solvers.captures
            again, t_again = _timed(lambda: sim(kx, times, pvt, solver=solver,
                                                stats=again_stats, solvers=solvers))
            if not (torch.equal(graphed, eager) and torch.equal(again, eager)):
                raise AssertionError(f"{fluid} 3D c={c}: graphed {solver} differs from eager by "
                                     f"{float((graphed - eager).abs().max())}")
            capped = fluid == "DG" and max(graph_stats["trips"]) >= 1000
            if not (graph_stats["trips"] == again_stats["trips"] == eager_stats["trips"]) or \
                    solvers.captures != captures or not solvers.replays or capped:
                raise AssertionError(f"{fluid} 3D c={c}: trips {graph_stats['trips']} / "
                                     f"{again_stats['trips']} vs eager {eager_stats['trips']}, "
                                     f"captures {captures} then {solvers.captures}, replays "
                                     f"{solvers.replays}")
            gap = ""
            if c == 1:
                # the float32 dense solve is itself more than 0.1 psia from
                # the float64 solution in 3D (both packages;
                # tests/test_torch_sim.py), so the iterative path is held
                # to the dense solve in float64 within the reference's bound
                exact = sim(kx.double(), times, pvt64, solver="dense")
                pressure = (lambda o: o) if fluid == "DG" else (lambda o: o[..., 0])
                psia = float((pressure(graphed).double() - pressure(exact)).abs().max())
                gap = (f"; from the float64 dense solve {psia:.4f} psia, drawdown "
                       f"{pi - float(pressure(exact).min()):.2f} psia")
                if fluid == "DG":
                    dense = sim(kx, times, pvt, solver="dense")
                    gap += (f", float32 dense "
                            f"{float((dense.double() - exact).abs().max()):.4f} psia")
                else:
                    gap += f", Sg {float((graphed[..., 1].double() - exact[..., 1]).abs().max()):.2e}"
                if not torch.isfinite(graphed).all() or psia > SOLVER_PSIA_TOL:
                    raise AssertionError(f"{fluid} 3D: graphed {solver} {psia:.4f} psia from the "
                                         f"float64 dense solve (bound {SOLVER_PSIA_TOL})")
            log(f"simulator graphs {fluid} 3D c={c} ({solver}, {n_times} times): eager "
                f"{t_eager:.3f} s, graphed {t_first:.3f} s with {captures} captures, again "
                f"{t_again:.3f} s ({solvers.replays} block replays in both), bitwise equal; "
                f"trips per solve {graph_stats['trips']}{gap}")
            out[f"{fluid}_c{c}"] = {"eager_s": t_eager, "graphed_first_s": t_first,
                                    "graphed_s": t_again}
        kx, step = kx_all[:1], times[:2]
        inner = {"n_picard": 1} if fluid == "DG" else {"n_newton": 1}
        solvers = SolverGraphs()
        sim(kx, step, pvt, solver=solver, solvers=solvers, **inner)          # captures
        ops = {mode: _device_ops_per_solve(lambda st: sim(kx, step, pvt, solver=solver,
                                                          stats=st, **kw, **inner))
               for mode, kw in (("eager", {"cuda_graph": False}),
                                ("graphed", {"solvers": solvers}))}
        log(f"simulator graphs {fluid} 3D c=1, the first solve: device operations and device "
            f"ms: eager {ops['eager'][0]:.1f}, {ops['eager'][1]:.3f} ms; graphed "
            f"{ops['graphed'][0]:.1f}, {ops['graphed'][1]:.3f} ms")
        out[f"{fluid}_ops_per_solve"] = ops
    return out


def phase_label_chunks(base_dir: str) -> None:
    """The GC 2D labels of the default case's first CHUNK_REALIZATIONS test
    realizations and first CHUNK_TIMES test times at chunks 8 and 16
    (``tools/label_chunks.compare``): bitwise equal; the seconds of each."""
    from srm_tpu_torch.data.dataset import SRMDataProcessor
    from srm_tpu_torch.tools.label_chunks import compare
    proc = SRMDataProcessor(base_dir=base_dir, general_config=_labelled_config("GC"),
                            device="cuda")
    permx = proc.generate_kle_splits()["test"][:CHUNK_REALIZATIONS]
    times = proc.generate_time_tensor()["test"].reshape(-1)[:CHUNK_TIMES]
    got = compare(proc, permx, times, (8, 16))
    log(f"GC labels {got['shapes']} at chunks 8 and 16: {got['seconds']['8']:.2f} s and "
        f"{got['seconds']['16']:.2f} s, bitwise equal {got['bitwise_equal']}")
    if permx.shape[0] != CHUNK_REALIZATIONS or not got["bitwise_equal"]:
        raise AssertionError(f"GC labels at chunks 8 and 16: {got}")


EXAMPLES = {"example_dg": ("srm_tpu_torch.examples.training_case_dry_gas", "dg_stencil_residual"),
            "example_gc": ("srm_tpu_torch.examples.training_case_gas_condensate",
                           "gc_stencil_residual")}


def phase_examples(base_dir: str) -> dict:
    """Each example driver's ``main`` at the full 39×39 widths, 20
    realizations, one epoch, on the card: its kernel launched at every loss
    evaluation and its backward kernel at every training step (nothing
    else, no plain recompute), the loss finite; then one more epoch timed
    on the same trainer (graph replays). Returns each path's launches."""
    import importlib

    import numpy as np
    out = {}
    for path, (module, kernel) in EXAMPLES.items():
        main = importlib.import_module(module).main
        args = ["--realizations", "20", "--epochs", "1", "--base-dir", base_dir]
        ((trainer, history, _), counts, recomputes), secs = _timed(
            lambda: _counted_training(kernel, lambda: main(args)))
        n_train = trainer._resident["train"][2]
        n_val = trainer._resident["val"][2] if trainer._resident["val"] else 0
        loss = history["total_train_loss"]
        if len(loss) != 1 or not np.isfinite(loss[0]) or \
                not np.all(np.isfinite(history["step_total_loss"])):
            raise AssertionError(f"{path}: train losses {loss}")
        _check_launches(kernel, counts, recomputes, n_train, n_val, 1)
        _, epoch_s = _timed(lambda: trainer.train_epoch_resident("train"))
        log(f"{path} ({module}.main, {secs:.1f} s with setup): final train loss {loss[0]:.6e}, "
            f"launches {counts}, replays {trainer.replays}; a further epoch {n_train / epoch_s:.3f} "
            f"steps/s ({n_train} steps)")
        out[path] = counts
    return out


def phase_tools(base_dir: str, drawdown_case) -> dict:
    """``mfu_probe`` (``base`` and ``bf16`` at batch 32, 2D: one JSON line
    each, 0 < mfu < 1; ``probe_two_nets`` on GC 2D's pair of encoder–
    decoders at batch 32, one after the other and stacked under ``vmap``,
    by turns, their gradients equal within float32 rounding),
    ``flops_breakdown`` (DG 3D production at batch 32: its total) and
    ``sg_head_probe.probe`` for one epoch on the drawdown phase's trained
    case (B3 at every training step, its backward kernel too; every key
    finite). Returns the probe's launches."""
    import math

    import torch
    from srm_tpu_torch.tools import flops_breakdown, mfu_probe, sg_head_probe
    lines = mfu_probe.main(["--case", "base", "--case", "bf16", "--batch", "32"])
    for line in lines:
        if not (line["ms_per_step"] > 0 and 0.0 < line["mfu"] < 1.0):
            raise AssertionError(f"mfu_probe: {line}")
    pair = [mfu_probe.probe_two_nets(f"gc2d_pair_{'stacked' if stacked else 'sequential'}",
                                     batch=32, nx=39, stacked=stacked)
            for stacked in (False, True, True, False)]
    nets, x = mfu_probe.two_nets(batch=32, nx=39, device="cuda")
    seq, vm = (mfu_probe.two_nets_step(nets, x, stacked)() for stacked in (False, True))
    gap = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(vm, seq))
    log(f"probe_two_nets (GC 2D's pair, 39x39, batch 32): sequential "
        f"{[p['ms_per_step'] for p in pair if not p['stacked']]} ms, stacked "
        f"{[p['ms_per_step'] for p in pair if p['stacked']]} ms a step; gradients "
        f"{gap:.2e} apart (bound {OPTIONS_GRAD_REL})")
    if not all(p["ms_per_step"] > 0 for p in pair) or gap > OPTIONS_GRAD_REL:
        raise AssertionError(f"probe_two_nets: {pair}, gradients {gap:.2e} apart")
    del nets, x, seq, vm
    torch.cuda.empty_cache()
    total, secs = _timed(lambda: flops_breakdown.main(["--base-dir", base_dir]))
    if not total > 0:
        raise AssertionError(f"flops_breakdown total {total}")
    log(f"flops_breakdown (DG 3D production, batch 32): {total / 1e9:.2f} GFLOP a step "
        f"({secs:.1f} s)")
    kernel = "gc_stencil_residual"
    report, counts, recomputes = _counted_training(
        kernel, lambda: sg_head_probe.probe(drawdown_case, epochs=1, batch=32))
    samples = sum(x.shape[0] * x.shape[1] for x, _ in drawdown_case["train_groups"])
    n_train = max(1, samples // 32)                  # the probe's steps: one epoch at 32
    _check_launches(kernel, counts, recomputes, n_train, 0, 1)
    values = [v for item in report.values() if isinstance(item, dict) for v in item.values()]
    values += [report[k] for k in ("Sgi", "sg_label_grad_l1_per_param", "sg_label_sse",
                                   "trivial_sse")]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"sg_head_probe: {report}")
    log(f"sg_head_probe (1 epoch on the drawdown case): {json.dumps(report)}; launches {counts}")
    return counts


# phase_data_parallel (b): two gloo ranks of 16 rows against one rank of 32,
# eager, from the same weights over one epoch of 9 steps. The first step is
# the same function of the same weights, summed in another order (each
# rank's convolutions at batch 16, then the two blocks' sums): its total
# within DP_FIRST_RTOL, and the gradients that it hands the optimizers
# (summed over the ranks) within data_parallel.GRAD_RTOL of one rank's per
# model but the Δt net (its float32 gradient is rounding noise, ROADMAP C2;
# logged), where an average over the ranks would be 0.5 off (Adam hides a
# mean in the weights; the gradients, which share one all-reduce, show it;
# measured on the card: 8.3e-7 for the pressure net, 1.4e-7 for the Δt net). After it the weights move
# apart by float32 rounding that Adam magnifies where a gradient is near
# zero, and Model 2's float32 gradient is rounding noise (ROADMAP C2), which
# moves Δt and so every term (measured on the card: step totals up to
# 4.2e-4, 1.07e-3, 2.08e-3 and 3.17e-3 apart within the epoch in four
# runs): every step's total within DP_LOSS_RTOL; each model's update over
# the epoch (its weights after it less before) within DP_UPDATE_RTOL of one
# rank's, as the L2 distance over the norm (measured: the pressure net's
# 0.0088, 0.054 and 0.013, the Δt net's 0.18, 0.39 and 0.28 in three runs;
# a model that did not move, or moved the other way, is 1 or more off).
DP_FIRST_RTOL, DP_LOSS_RTOL = 1e-5, 1e-2
DP_UPDATE_RTOL = {"pressure": 0.25, "time_step": 0.9, "saturation": 0.25}
DP_ROWS = 16
KERNEL_OF = {"DG": "dg_stencil_residual", "GC": "gc_stencil_residual"}


def _dp_gloo_rank(spec_path: str) -> None:
    """One rank of phase_data_parallel (b) and phase_space, started with
    ``RANK``: a gloo group of two on the one card (``file://`` store), the
    spec's case (``fluid``, DG by default, at 20 realizations) on ``cuda:0``
    from the saved initial weights, on ``make_mesh(spatial=spatial)``;
    ``cuda_graph=True`` must raise on that group; then one eager epoch at
    batch 32 (or its first ``steps`` steps) with the launch counters set to
    0 just before and read just after; writes its metrics, its first
    step's gradients (summed over the ranks), weights, counts, seconds and
    its rows of the batch and of H. With ``then_remat`` the rank then
    reloads the initial weights and writes the same of one step with
    ``remat_forwards`` (under ``remat``), and the results of
    ``_sp_extras`` (under ``extras``)."""
    import torch
    import torch.distributed as dist
    from srm_tpu_torch.examples.common import setup_case
    from srm_tpu_torch.parallel.mesh import make_mesh
    from srm_tpu_torch.tools import data_parallel
    from srm_tpu_torch.training.trainer import Trainer
    with open(spec_path) as f:
        spec = json.load(f)
    rank = int(os.environ["RANK"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{spec['store']}", rank=rank,
                            world_size=2)
    try:
        fluid = spec.get("fluid", "DG")
        case = setup_case(fluid, base_dir=spec["base_dir"], n_realizations=20, device="cuda:0")
        mesh = make_mesh(spatial=spec.get("spatial", 1))
        try:
            Trainer(case["loss_fn"], mesh=mesh, cuda_graph=True)
        except ValueError as e:
            refused = str(e)
        else:
            raise AssertionError("cuda_graph=True on a gloo group did not raise")

        def run(steps, remat: bool) -> dict:
            """``steps`` eager steps from the initial weights."""
            for name, state in torch.load(spec["weights"], weights_only=True).items():
                case["models"][name].load_state_dict(state)
            loss = _copy_loss(case["loss_fn"])
            loss.remat_forwards = remat
            trainer = Trainer(loss, mesh=mesh, cuda_graph=False)
            trainer.stage_dataset("train", case["train_groups"], 32)
            grads = data_parallel.record_first_gradients(trainer)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics, counts, recomputes = _counted_training(
                KERNEL_OF[fluid], lambda: trainer.train_epoch_resident("train", steps))
            rows = loss.rows
            return {"metrics": metrics, "grads": grads, "counts": counts,
                    "recomputes": recomputes, "seconds": time.perf_counter() - t0,
                    "weights": trainer.snapshot(), "refused": refused,
                    "rows": trainer._states[("train", "train", 32)].rows,
                    "h_rows": None if rows is None else rows.count,
                    "n_train": len(metrics["total"])}

        out = run(spec.get("steps"), False)
        if spec.get("then_remat"):
            out["remat"] = run(1, True)
            out["extras"] = _sp_extras(spec, mesh, torch.device("cuda:0"))
        torch.save(out, os.path.join(spec["out"], f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _gloo_ranks(case, base_dir: str, **spec) -> tuple:
    """Start two ``_dp_gloo_rank`` processes on ``spec`` (beside the case's
    initial weights of its trained models) and wait for them: each rank's
    results and the wall clock seconds of the run."""
    import torch
    trained = [case["loss_fn"].logical_name(k) for k in case["loss_fn"].trainable_models_keys]
    with tempfile.TemporaryDirectory(prefix="gloo_", dir=os.path.join(ROOT, "build")) as out:
        weights = os.path.join(out, "initial.pt")
        torch.save({k: case["models"][k].state_dict() for k in trained}, weights)
        path = os.path.join(out, "spec.json")
        with open(path, "w") as f:
            json.dump({"store": os.path.join(out, "store"), "base_dir": base_dir,
                       "weights": weights, "out": out, **spec}, f)
        code = f"import chip_smoke; chip_smoke._dp_gloo_rank({path!r})"
        env = {**os.environ, "WORLD_SIZE": "2"}
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                                  env={**env, "RANK": str(r)}) for r in range(2)]
        try:
            for p in procs:
                p.wait(timeout=600)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        if any(p.returncode for p in procs):
            raise AssertionError(f"gloo ranks exited {[p.returncode for p in procs]}")
        return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                for r in range(2)], wall


def phase_data_parallel(base_dir: str) -> dict:
    """The data axis (``parallel/mesh.py``) on the main path, DG 2D at
    39×39, 20 realizations, batch 32, from one set of initial weights:
    (a) world 1 over NCCL, graphed (``_dp_nccl_world1``), and (b) two
    gloo ranks on the one card, eager (``_dp_gloo_two_ranks``). Returns
    each path's launches (by path name) and its numbers."""
    from srm_tpu_torch.examples.common import setup_case
    case = setup_case("DG", base_dir=base_dir, n_realizations=20, device="cuda")
    a = _dp_nccl_world1(case)
    _free_cached()
    b = _dp_gloo_two_ranks(case, base_dir)
    return {"dp_nccl_world1": a.pop("counts"), "dp_gloo_rank0": b.pop("counts_0"),
            "dp_gloo_rank1": b.pop("counts_1"), "numbers": {**a, **b}}


def _dp_nccl_world1(case) -> dict:
    """(a) World 1 over NCCL, graphed: two epochs from the case's initial
    weights as the trainer without a process group, both graphed, cuDNN
    deterministic; every step after the warm-up one replay, each loss
    evaluation B1 and each step its backward kernel (counters set to 0 just
    before, read just after); the gradient all-reduce called once inside
    the train graph's capture and never outside it after the warm-up; the
    per-step metrics and the final weights bitwise those of the trainer
    without a group (a one-rank SUM is exact). Then, cuDNN as the main path
    runs it, a fresh pair of graphed trainers timed by turns (without a
    group, over the mesh, over the mesh, without) for steps/s, and a
    profiler window over 3 replayed steps of the mesh's: B1's forward and
    backward once per step, and the NCCL device work per step logged (at
    world 1 NCCL 2.28 enqueues none for an in-place SUM)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import srm_tpu_torch.training.trainer as trainer_module
    from srm_tpu_torch.parallel.mesh import Mesh, make_mesh
    from srm_tpu_torch.tools.data_parallel import _device, _epochs

    kernel = "dg_stencil_residual"
    names = {"forward": KERNELS[kernel]["device_name"],
             "backward": BACKWARD[f"{kernel}_backward"]["device_name"]}
    sync = torch.cuda.synchronize
    calls = {"captured": 0, "eager": 0}
    all_reduce = trainer_module.dist.all_reduce

    def two_epochs(mesh):
        trainer = _dp_trainer(case, mesh, warm=False)
        return trainer, _epochs(trainer, 2, sync)[0]

    def counted_all_reduce(*args, **kwargs):
        calls["captured" if torch.cuda.is_current_stream_capturing() else "eager"] += 1
        return all_reduce(*args, **kwargs)

    torch.backends.cudnn.deterministic = True
    try:
        plain, plain_metrics = two_epochs(Mesh(device=torch.device("cuda")))
    finally:
        torch.backends.cudnn.deterministic = False
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    trainer_module.dist.all_reduce = counted_all_reduce
    try:
        mesh = make_mesh()
        if (mesh.size, mesh.backend) != (1, "nccl"):
            raise AssertionError(f"the mesh is {mesh}")
        torch.backends.cudnn.deterministic = True
        try:
            (meshed, mesh_metrics), counts, recomputes = _counted_training(
                kernel, lambda: two_epochs(mesh))
        finally:
            torch.backends.cudnn.deterministic = False
        n_train = meshed._resident["train"][2]
        _check_launches(kernel, counts, recomputes, n_train, 0, 2)
        if meshed.replays["train"] != 2 * n_train - meshed.warmup_steps or \
                calls != {"captured": 1, "eager": meshed.warmup_steps}:
            raise AssertionError(f"replays {meshed.replays} of {2 * n_train} steps, all-reduce "
                                 f"calls {calls} (captured once, once per warm-up step)")
        for got, want in zip(mesh_metrics, plain_metrics):
            for name in want:
                if not np.array_equal(got[name], want[name]):
                    raise AssertionError(f"{name}: {got[name]} over the mesh, {want[name]} "
                                         f"without a group")
        for key in meshed.optimizer_keys:
            if not all(torch.equal(a, b) for a, b in zip(meshed.optimizers[key].params,
                                                         plain.optimizers[key].params)):
                raise AssertionError(f"the {key} weights over the mesh are not bitwise the "
                                     f"trainer's without a group")
        log(f"data parallel (a), NCCL {torch.cuda.nccl.version()} world 1, graphed: launches "
            f"{counts}, replays {meshed.replays}, all-reduce calls {calls}; the per-step "
            f"metrics and final weights bitwise those without a group")
        del meshed, plain
        _free_cached()
        timed = {"plain": _dp_trainer(case, Mesh()), "mesh": _dp_trainer(case, mesh)}
        sps = {"plain": [], "mesh": []}
        for which in ("plain", "mesh", "mesh", "plain"):
            sps[which] += _epochs(timed[which], 1, sync)[1]
        device = _device(timed["mesh"], 3, names)
        timed["mesh"].release_graphs()        # before the group ends
    finally:
        trainer_module.dist.all_reduce = all_reduce
        dist.destroy_process_group()
    log(f"data parallel (a), timed: steps/s (graphed epochs, by turns) {sps['plain'][0]:.3f}, "
        f"{sps['mesh'][0]:.3f}, {sps['mesh'][1]:.3f}, {sps['plain'][1]:.3f} (without a group, "
        f"over the mesh, over the mesh, without); 3 replayed steps of the mesh's show "
        f"{device['seen']} of {names}, NCCL all-reduce kernels {device['nccl_kernels']} "
        f"({device['nccl_kernels_per_step']:.2f} a step, median "
        f"{device['all_reduce_us_median']} us), {device['compute_ms_per_step']:.3f} device ms "
        f"besides and {device['device_ops_per_step']:.1f} operations per step")
    # the all-reduce's kernels are logged, not held: at one rank NCCL 2.28
    # enqueues none for an in-place SUM, which another version may change
    if (device["seen"]["forward"], device["seen"]["backward"]) != (3, 3):
        raise AssertionError(f"3 replayed steps show {device['seen']} of {names}")
    return {"counts": counts, "mesh_steps_per_s": sps["mesh"],
            "plain_steps_per_s": sps["plain"],
            "all_reduce_us_median": device["all_reduce_us_median"],
            "all_reduce_kernels_per_step": device["nccl_kernels_per_step"],
            "compute_ms_per_step": device["compute_ms_per_step"],
            "device_ops_per_step": device["device_ops_per_step"]}


def _dp_trainer(case, mesh, warm: bool = True):
    """A graphed trainer at batch 32 (seed 0) of the case's initial weights
    over ``mesh``, with its warm-up steps and captures done (one epoch)
    where ``warm``."""
    from srm_tpu_torch.training.trainer import Trainer
    trainer = Trainer(_copy_loss(case["loss_fn"]), mesh=mesh)
    trainer.stage_dataset("train", case["train_groups"], 32)
    if warm:
        trainer.train_epoch_resident("train")
    return trainer


def _dp_gloo_two_ranks(case, base_dir: str) -> dict:
    """(b) Two ranks on the one card over gloo (NCCL refuses two ranks on
    one device), eager, 16 rows each (``_dp_gloo_rank``): against one eager
    rank on the same global batches, the first step's total within
    DP_FIRST_RTOL and its gradients (summed over the ranks) within
    data_parallel.GRAD_RTOL per model but the Δt net's (C2), every step's
    total within
    DP_LOSS_RTOL, each model's update over the epoch within
    DP_UPDATE_RTOL; the two ranks' weights bitwise equal, B1 and its
    backward launched on both at every step, ``cuda_graph=True`` on that
    group raising; the epoch's wall clock; then B1's time at B = 16, a
    rank's batch."""
    import numpy as np
    import torch
    from srm_tpu_torch.tools import data_parallel
    from srm_tpu_torch.training.trainer import Trainer

    kernel = "dg_stencil_residual"
    ranks, wall = _gloo_ranks(case, base_dir)
    ref = Trainer(_copy_loss(case["loss_fn"]), cuda_graph=False)
    ref.stage_dataset("train", case["train_groups"], 32)
    ref_grads = data_parallel.record_first_gradients(ref)
    ref_totals = ref.train_epoch_resident("train")["total"]
    grad_gaps = data_parallel.gradient_gaps(ranks[0]["grads"], ref_grads, 2)
    gaps = np.zeros_like(ref_totals)
    for r, got in enumerate(ranks):
        if got["rows"] != DP_ROWS or "NCCL" not in got["refused"]:
            raise AssertionError(f"rank {r}: {got['rows']} rows, refusal {got['refused']!r}")
        _check_launches(kernel, got["counts"], got["recomputes"], got["n_train"], 0, 1)
        gaps = np.maximum(gaps, np.abs(got["metrics"]["total"] - ref_totals) / np.abs(ref_totals))
    updates = {}
    for k in ref.optimizer_keys:
        name = ref.loss_fn.logical_name(k)
        live = dict(ref.models[name].named_parameters())
        start = dict(case["models"][name].named_parameters())
        for n, got in ranks[0]["weights"][k].items():
            if not torch.equal(got, ranks[1]["weights"][k][n]):
                raise AssertionError(f"the ranks' {k} weights differ at {n}")
        updates[k] = _rel([ranks[0]["weights"][k][n].cuda() - start[n] for n in live],
                          [live[n].detach() - start[n] for n in live])
    timing = _time_forward(kernel, (DP_ROWS, 39, 39))
    seconds = max(got["seconds"] for got in ranks)
    log(f"data parallel (b), 2 gloo ranks on one card, eager, {DP_ROWS} rows each: step totals "
        f"{', '.join(f'{g:.3e}' for g in gaps)} from one rank's (relative; bounds "
        f"{DP_FIRST_RTOL} first, {DP_LOSS_RTOL}), the first step's gradients {grad_gaps} "
        f"apart (relative, summed and averaged over the ranks; bound "
        f"{data_parallel.GRAD_RTOL} summed but {data_parallel.NOISY_GRADIENTS}), updates "
        f"{updates} apart (relative; bounds "
        f"{DP_UPDATE_RTOL}), the ranks' weights bitwise equal, launches "
        f"{[got['counts'] for got in ranks]}; the epoch {seconds:.3f} s on the slower rank "
        f"({wall:.1f} s with the ranks' start-up); cuda_graph=True refused: "
        f"{ranks[0]['refused']!r}; B1 at B = {DP_ROWS}: {timing['device_us']:.2f} device us a "
        f"call")
    if gaps[0] > DP_FIRST_RTOL or gaps.max() > DP_LOSS_RTOL:
        raise AssertionError(f"two ranks against one: step totals {gaps} apart")
    if any(g["summed"] > data_parallel.GRAD_RTOL for k, g in grad_gaps.items()
           if k not in data_parallel.NOISY_GRADIENTS):
        raise AssertionError(f"two ranks against one: first gradients {grad_gaps} apart")
    if any(updates[k] > DP_UPDATE_RTOL[k] for k in updates):
        raise AssertionError(f"two ranks against one: updates {updates} apart")
    return {"counts_0": ranks[0]["counts"], "counts_1": ranks[1]["counts"],
            "gloo_epoch_s": seconds, "gloo_loss_gaps": gaps.tolist(), "gloo_updates": updates,
            "gloo_grad_gaps": grad_gaps,
            "b1_device_us_b16": timing["device_us"], "b1_ms_b16": timing["ms"]}


# phase_space (19): two gloo ranks on the one card as a space axis of 2
# (each rank the whole batch of 32, its 20 or 19 of the 39 rows of H, the
# halos staged through the host), eager, against one eager rank on the same
# batches from the same weights: the first step is the same function of the
# same weights, each convolution and stencil cell computed from the same
# rows, its sums (the per-sample means and balances, the gradients) in
# another order: its total within DP_FIRST_RTOL and its gradients, summed
# over the ranks, within data_parallel.SPACE_GRAD_RTOL per model (DG's Δt
# net excepted: its float32 gradient is rounding noise, C2, 0.18 apart;
# logged), where an average over the ranks is 0.5 off and a halo backward
# that drops its rows' cotangents reads 2.2e-3 (Model 1; measured on the
# card with the fault planted in a copy). Later steps move apart as in phase 18 (b), faster: float32
# rounding that Adam magnifies (measured on the card, DG: 1.2e-3, 6.7e-3,
# 4.7e-4 and 1.8e-3 at the 9th step in four runs): every step's total within
# SP_LOSS_RTOL; each model's update within DP_UPDATE_RTOL (measured: DG's
# pressure net 0.021-0.029, Δt net 0.30-0.54; GC's 0.0046-0.0056, 2e-8,
# 4e-7-0.0027). The ranks' weights bitwise equal; the kernel and its
# backward at every step on both, on their blocks.
SP_ROWS = (20, 19)
SP_LOSS_RTOL = 5e-2
SP_NOISY_GRADIENTS = {"DG": ("time_step",), "GC": ()}


def _sp_gloo_two_ranks(case, base_dir: str, fluid: str, steps=None,
                       then_remat: bool = False) -> dict:
    """Phase 19 on ``case`` (DG 2D or GC 2D at 39×39): two gloo ranks as a
    space axis of 2 against one eager rank, the epoch's first ``steps``
    steps (all with None); see SP_ROWS' comment. With ``then_remat`` the
    same ranks then run one step with ``remat_forwards`` from the initial
    weights, held the same way to one rank's (under ``remat``), and
    ``_sp_extras``, held to one rank by ``_check_sp_extras``."""
    ranks, wall = _gloo_ranks(case, base_dir, spatial=2, fluid=fluid, steps=steps,
                              then_remat=then_remat)
    out = _sp_hold(case, fluid, steps, False, ranks, wall)
    if then_remat:
        out["remat"] = _sp_hold(case, fluid, 1, True, [r["remat"] for r in ranks], wall)
        out["extras"] = _check_sp_extras([r["extras"] for r in ranks], case, base_dir)
    return out


def _sp_hold(case, fluid: str, steps, remat: bool, ranks, wall: float) -> dict:
    """The two space ranks' results of ``steps`` steps (``remat_forwards``
    on where ``remat``) against one eager rank's from ``case``'s initial
    weights (SP_ROWS' comment); their gaps and each rank's launches."""
    import numpy as np
    import torch
    from srm_tpu_torch.tools import data_parallel
    from srm_tpu_torch.training.trainer import Trainer

    kernel = KERNEL_OF[fluid]
    ref_loss = _copy_loss(case["loss_fn"])
    ref_loss.remat_forwards = remat
    ref = Trainer(ref_loss, cuda_graph=False)
    ref.stage_dataset("train", case["train_groups"], 32)
    ref_grads = data_parallel.record_first_gradients(ref)
    metrics, ref_seconds = _timed(lambda: ref.train_epoch_resident("train", steps))
    ref_totals = metrics["total"]
    grad_gaps = data_parallel.gradient_gaps(ranks[0]["grads"], ref_grads, 2)
    gaps = np.zeros_like(ref_totals)
    for r, got in enumerate(ranks):
        if (got["rows"], got["h_rows"]) != (32, SP_ROWS[r]) or "NCCL" not in got["refused"]:
            raise AssertionError(f"rank {r}: {got['rows']} rows of the batch, {got['h_rows']} "
                                 f"of H, refusal {got['refused']!r}")
        _check_launches(kernel, got["counts"], got["recomputes"], got["n_train"], 0, 1)
        gaps = np.maximum(gaps, np.abs(got["metrics"]["total"] - ref_totals) / np.abs(ref_totals))
    updates = {}
    for k in ref.optimizer_keys:
        name = ref.loss_fn.logical_name(k)
        live = dict(ref.models[name].named_parameters())
        start = dict(case["models"][name].named_parameters())
        for n, got in ranks[0]["weights"][k].items():
            if not torch.equal(got, ranks[1]["weights"][k][n]):
                raise AssertionError(f"the space ranks' {k} weights differ at {n}")
        updates[k] = _rel([ranks[0]["weights"][k][n].cuda() - start[n] for n in live],
                          [live[n].detach() - start[n] for n in live])
    seconds = max(got["seconds"] for got in ranks)
    noisy = SP_NOISY_GRADIENTS[fluid]
    log(f"space axis, {fluid} 2D{' with remat_forwards' if remat else ''}, 2 gloo ranks on one "
        f"card, eager, rows {SP_ROWS} of 39: "
        f"{len(ref_totals)} steps, totals {', '.join(f'{g:.3e}' for g in gaps)} from one "
        f"rank's (relative; bounds {DP_FIRST_RTOL} on the first, {SP_LOSS_RTOL}), the first "
        f"step's gradients {grad_gaps} apart (relative, summed and averaged over the ranks; "
        f"bound {data_parallel.SPACE_GRAD_RTOL} summed but {noisy}), updates {updates} apart "
        f"(relative; bounds {DP_UPDATE_RTOL}), the ranks' weights bitwise equal, launches "
        f"{[got['counts'] for got in ranks]}; {seconds:.3f} s on the slower rank "
        f"({wall:.1f} s with the ranks' start-up), one eager rank {ref_seconds:.3f} s")
    if gaps[0] > DP_FIRST_RTOL or gaps.max() > SP_LOSS_RTOL:
        raise AssertionError(f"space ranks against one: step totals {gaps} apart")
    if any(g["summed"] > data_parallel.SPACE_GRAD_RTOL for k, g in grad_gaps.items()
           if k not in noisy):
        raise AssertionError(f"space ranks against one: first gradients {grad_gaps} apart")
    if any(updates[k] > DP_UPDATE_RTOL[k] for k in updates):
        raise AssertionError(f"space ranks against one: updates {updates} apart")
    return {"counts_0": ranks[0]["counts"], "counts_1": ranks[1]["counts"],
            "epoch_s": seconds, "one_rank_epoch_s": ref_seconds, "loss_gaps": gaps.tolist(),
            "updates": updates, "grad_gaps": grad_gaps}


# phase_space's extras: on the space axis of two gloo ranks, (a) one DG 2D
# step through the Newton BHP with log_iterations (dg2d_newton_bhp, one loss
# evaluation: one file, written by rank 0 alone from both ranks' rows of H)
# against one rank's file of the same step: the same header and rows, each
# row's values within SP_LOG_RTOL (six significant digits; the pressure
# net's float32 convolutions on each rank's window round apart from the
# whole grid's); (b) full-width module forwards (39×39, batch 32) that read
# the whole grid: the encoder–decoder with latent_flatten (its encoded level,
# 4 rows, split 2/2, gathered for the Dense) and the residual net's VAE head
# (the whole grid's mean) with ε given, and drawing ε from each rank's own
# CUDA generator (seeds 5 and 6, the first rank's draw broadcast), each
# rank's rows against the whole grid's output on the card within
# OPTIONS_RTOL (of the entry and of the output's largest magnitude).
SP_LOG_RTOL = 1e-5
SP_NEWTON = {"use_non_iterative": False, "log_iterations": True}


def _sp_modules():
    """phase_space's full-width modules from seeds, on the CPU: the
    encoder–decoder with ``latent_flatten`` and the residual net with the
    VAE head, their (B, T, H, W, C) input batch of 32 and ε."""
    import torch
    from srm_tpu_torch.config import get_configuration
    from srm_tpu_torch.nn.encoder_decoder import EncoderDecoder
    from srm_tpu_torch.nn.residual import ResidualNetwork

    gen = torch.Generator().manual_seed(3)
    ed = get_configuration("encoder_decoder")
    ed["temporal"] = True
    ed["residual_params"]["Latent_Layer"]["Flatten"] = True
    res = get_configuration("residual")
    vae = ResidualNetwork(5, num_blocks=res["num_blocks"], filters=res["filters"],
                          latent_output=True, latent_a=0.1, latent_b=10.0, temporal=True,
                          generator=gen)
    x = torch.rand((32, 1, 39, 39, 5), generator=gen) * 2 - 1
    eps = torch.randn((32, 1), generator=gen)
    return EncoderDecoder.from_config(ed, 5, generator=gen, grid=(39, 39)), vae, x, eps


def _sp_module_outputs(mesh, device) -> dict:
    """The three forwards of ``_sp_modules`` on ``device``: on this rank's
    rows over ``mesh``'s space axis, or the whole grid without one."""
    import torch
    from srm_tpu_torch.parallel.halo import Rows
    ed, vae, x, eps = (t.to(device) for t in _sp_modules())
    rows = Rows.split(mesh, 39) if mesh is not None else None
    kw = {} if rows is None else {"rows": rows}
    if rows is not None:
        x = x[:, :, rows.lo:rows.hi].contiguous()
    seed = 5 + (mesh.space_rank if mesh is not None else 0)
    with torch.no_grad():
        return {"latent_flatten": ed(x, **kw).cpu(), "vae_eps": vae(x, eps=eps, **kw).cpu(),
                "vae_generator": vae(x, generator=torch.Generator(device).manual_seed(seed),
                                     **kw).cpu()}


def _newton_log_step(base_dir: str, weights: str, mesh, log_dir: str, device) -> tuple:
    """One eager dg2d_newton_bhp training step at batch 32 (its first)
    from ``weights`` with ``log_iterations`` into ``log_dir``, over
    ``mesh`` (None: one rank); the launch counts and the lines of the one
    file written (None where this rank wrote none)."""
    import torch
    from srm_tpu_torch.examples.common import setup_case
    from srm_tpu_torch.training.trainer import Trainer
    case = setup_case("DG", base_dir=base_dir, n_realizations=20, device=device,
                      well_solver_kwargs=dict(SP_NEWTON, log_dir=log_dir))
    for name, state in torch.load(weights, weights_only=True).items():
        case["models"][name].load_state_dict(state)
    trainer = Trainer(case["loss_fn"], mesh=mesh, cuda_graph=False)
    trainer.stage_dataset("train", case["train_groups"], 32)
    _, counts, recomputes = _counted_training(
        "dg_stencil_residual", lambda: trainer.train_epoch_resident("train", 1))
    _check_launches("dg_stencil_residual", counts, recomputes, 1, 0, 1)
    files = os.listdir(log_dir) if os.path.isdir(log_dir) else []
    if len(files) > 1:
        raise AssertionError(f"one step wrote {len(files)} log files")
    if not files:
        return counts, None
    with open(os.path.join(log_dir, files[0])) as f:
        return counts, f.read().splitlines()


def _sp_extras(spec, mesh, device) -> dict:
    """A rank's part of phase_space's extras (see SP_LOG_RTOL's comment)."""
    log_dir = os.path.join(spec["out"], f"newton_logs_rank{mesh.rank}")
    counts, lines = _newton_log_step(spec["base_dir"], spec["weights"], mesh, log_dir, device)
    return {"newton_counts": counts, "log": lines,
            "modules": _sp_module_outputs(mesh, device)}


def _check_sp_extras(ranks, case, base_dir: str) -> dict:
    """The two ranks' ``_sp_extras`` against one rank on the card from
    ``case``'s initial weights (SP_LOG_RTOL's comment); their gaps."""
    import numpy as np
    import torch
    if ranks[1]["log"] is not None or ranks[0]["log"] is None:
        raise AssertionError("the iteration log was not written by rank 0 alone")
    trained = [case["loss_fn"].logical_name(k) for k in case["loss_fn"].trainable_models_keys]
    with tempfile.TemporaryDirectory(prefix="newton_", dir=os.path.join(ROOT, "build")) as d:
        weights = os.path.join(d, "initial.pt")
        torch.save({k: case["models"][k].state_dict() for k in trained}, weights)
        _, want = _newton_log_step(base_dir, weights, None, os.path.join(d, "logs"), "cuda")
    got = ranks[0]["log"]
    if got[0] != want[0] or len(got) != len(want):
        raise AssertionError(f"iteration logs: {got[:1]} ({len(got)} lines) against one "
                             f"rank's {want[:1]} ({len(want)} lines)")
    log_gap = 0.0
    for g, w in zip(got[1:], want[1:]):
        gv = np.array([float(v) for v in g.split('"')[1].split()])
        wv = np.array([float(v) for v in w.split('"')[1].split()])
        if g.split('"')[0] != w.split('"')[0] or gv.shape != wv.shape:
            raise AssertionError(f"iteration log row {g!r} against one rank's {w!r}")
        log_gap = max(log_gap, float(np.max(np.abs(gv - wv) / np.abs(wv))) if wv.size else 0.0)
    want_out = _sp_module_outputs(None, torch.device("cuda"))
    gaps = {}
    for name, w in want_out.items():
        g = torch.cat([r["modules"][name] for r in ranks], dim=2)
        tol = OPTIONS_RTOL * (w.abs() + w.abs().max())
        gaps[name] = float(((g - w).abs() / (w.abs() + w.abs().max())).max())
        if g.shape != w.shape or ((g - w).abs() > tol).any():
            raise AssertionError(f"{name} over the space axis against the whole grid: "
                                 f"{gaps[name]:.3e} apart (bound {OPTIONS_RTOL})")
    log(f"space axis extras: dg2d_newton_bhp's pwf log (rank 0's, {len(got)} lines) within "
        f"{log_gap:.3e} of one rank's (bound {SP_LOG_RTOL}); module forwards over the ranks "
        f"against the whole grid {gaps} (bound {OPTIONS_RTOL} of the entry and the largest); "
        f"Newton step launches {[r['newton_counts'] for r in ranks]}")
    if log_gap > SP_LOG_RTOL:
        raise AssertionError(f"iteration logs {log_gap:.3e} apart")
    return {"log_gap": log_gap, "module_gaps": gaps}


def phase_space(base_dir: str) -> dict:
    """The space axis (``make_mesh(n, spatial=k)``, ``parallel/halo.py``)
    on the main path: DG 2D at 39×39, 20 realizations, batch 32, one epoch,
    then one DG 2D step with ``remat_forwards`` by the same ranks (and
    ``_sp_extras``: a dg2d_newton_bhp step logging its iterations, and the
    full-width ``latent_flatten`` and VAE forwards), and one GC 2D step,
    each over two gloo ranks on the one card against one rank
    (``_sp_gloo_two_ranks``).
    Returns each path's launches by path name and the numbers."""
    from srm_tpu_torch.examples.common import setup_case
    out = {}
    for fluid, steps in (("DG", None), ("GC", 1)):
        case = setup_case(fluid, base_dir=base_dir, n_realizations=20, device="cuda")
        out[fluid] = _sp_gloo_two_ranks(case, base_dir, fluid, steps, then_remat=fluid == "DG")
        del case
        _free_cached()
    return {"sp_gloo_rank0": out["DG"].pop("counts_0"),
            "sp_gloo_rank1": out["DG"].pop("counts_1"),
            "sp_gloo_remat_rank0": out["DG"]["remat"].pop("counts_0"),
            "sp_gloo_remat_rank1": out["DG"]["remat"].pop("counts_1"),
            "sp_gloo_gc_rank0": out["GC"].pop("counts_0"),
            "sp_gloo_gc_rank1": out["GC"].pop("counts_1"), "numbers": out}


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "srm_tpu_torch")):
        raise SystemExit("chip_smoke: run from the root of a checkout of the repository")
    sys.path.insert(0, ROOT)
    t_start = time.time()
    marks = [t_start]

    def mark(what: str) -> None:
        """The host seconds since the previous mark, logged."""
        marks.append(time.time())
        log(f"[{what}: {marks[-1] - marks[-2]:.1f} s]")

    phase_device()
    phase_build()
    mark("device and build")
    measured = {name: phase_kernels(name) for name in KERNELS}
    measured.update({name: phase_backward(name) for name in BACKWARD})
    mark("kernels")
    # the cases' datasets go under the checkout's build/ (listed in .gitignore)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    counts, f32 = {}, {}
    with tempfile.TemporaryDirectory(prefix="smoke_data_", dir=os.path.join(ROOT, "build")) as tmp:
        phase_datagen(tmp)
        mark("datagen")
        phase_labels(tmp)
        mark("labels")
        counts["dg_stencil_residual"], dg_case, f32["dg_stencil_residual"] = phase_main_path(
            tmp, "dg_stencil_residual", general_config=_labelled_config("DG"))
        mark("main path DG 2D")
        counts["dg3d_stencil_residual"], _, f32["dg3d_stencil_residual"] = phase_main_path(
            tmp, "dg3d_stencil_residual", nz=10, kle_method="uncorrelated")
        mark("main path DG 3D")
        counts["gc_stencil_residual"], gc_case, f32["gc_stencil_residual"] = phase_main_path(
            tmp, "gc_stencil_residual", fluid="GC")
        mark("main path GC 2D")
        space = phase_space(tmp)
        mark("space axis")
        phase_serving(tmp, dg_case, gc_case)
        mark("serving")
        porosity = phase_porosity(dg_case)
        mark("porosity")
        del dg_case, gc_case
        production = {
            "dg_stencil_residual": phase_production(tmp, "dg_stencil_residual",
                                                    f32["dg_stencil_residual"]),
            "dg3d_stencil_residual": phase_production(
                tmp, "dg3d_stencil_residual", f32["dg3d_stencil_residual"], nz=10,
                kle_method="uncorrelated")}
        mark("production")
        drawdown_counts, drawdown_case = phase_drawdown(tmp)
        drawdown = {"gc_stencil_residual": drawdown_counts}
        mark("drawdown")
        gc3d = phase_gc3d(tmp)
        mark("gc3d")
        remat = phase_remat(tmp)
        mark("remat")
        knobs = phase_knobs(tmp)
        mark("knobs")
        well = phase_well_solvers(tmp, f32)
        mark("well solvers")
        polynomial = phase_polynomial_pvt(tmp, f32)
        phase_options()
        mark("polynomial PVT and network options")
        phase_sim_graphs()
        phase_label_chunks(tmp)
        later = phase_examples(tmp)
        later["sg_head_probe"] = phase_tools(tmp, drawdown_case)
        del drawdown_case
        mark("simulator graphs, tools and examples")
        data_parallel = phase_data_parallel(tmp)
        mark("data parallel")
    # each kernel's launches on its own f32 main path (a backward kernel's on
    # its forward's), and on each path of this run that runs it (the per-cell
    # porosity path runs the unfused residual: B1 0; gas condensate in 3D
    # has no kernel: its counts, all 0, are checked in phase_gc3d)
    paths = {"f32": counts, "production": production, "drawdown": drawdown,
             "b256": {"dg3d_stencil_residual": remat["b256"]},
             "b256_remat": {"dg3d_stencil_residual": remat["b256_remat"]},
             "pad48_width64": {"dg_stencil_residual": knobs},
             "porosity_field": {"dg_stencil_residual": porosity["field"]},
             "dg2d_polynomial_pvt": {"dg_stencil_residual": polynomial},
             "example_dg": {"dg_stencil_residual": later["example_dg"]},
             "example_gc": {"gc_stencil_residual": later["example_gc"]},
             "sg_head_probe": {"gc_stencil_residual": later["sg_head_probe"]},
             **{path: {"dg_stencil_residual": data_parallel[path]}
                for path in ("dp_nccl_world1", "dp_gloo_rank0", "dp_gloo_rank1")},
             **{path: {"dg_stencil_residual": space[path]}
                for path in ("sp_gloo_rank0", "sp_gloo_rank1", "sp_gloo_remat_rank0",
                             "sp_gloo_remat_rank1")},
             **{path: {"gc_stencil_residual": space[path]}
                for path in ("sp_gloo_gc_rank0", "sp_gloo_gc_rank1")},
             **{path: {WELL_PATHS[path]["kernel"]: c} for path, c in well.items()}}
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
    log(card_line())                           # again, beside the numbers below
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
