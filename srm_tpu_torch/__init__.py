"""srm_tpu_torch — the PyTorch/CUDA port of ``srm_tpu``.

A second package beside the JAX reference: the same physics-informed
surrogate reservoir model (multi-model PINN trained against finite-volume
PDE residuals), written in PyTorch, with each Pallas TPU kernel of the
reference replaced by a hand-written CUDA kernel for Hopper (``sm_90a``).

Subpackages carry the reference's names so each module's counterpart is
easy to find:

  config/    the defaults and the dataset-cache config hash (srm_tpu/config/)
  utils/     normalization transforms + statistics table,
             iteration-history logs                        (srm_tpu/utils/)
  data/      KLE realizations (host and on-device samplers,
             the dataset factory), Eclipse parsers,
             weaving, dataset cache                        (srm_tpu/data/)
  ops/       stencil padding and face helpers              (srm_tpu/ops/stencil.py)
  physics/   relperm, spline PVT, wells, rate/BHP solver   (srm_tpu/physics/)
  nn/        encoder-decoder, residual net, hard layer,
             model map and the flax→torch weight loader    (srm_tpu/nn/)
  kernels/   CUDA kernels + their plain PyTorch versions   (srm_tpu/kernels/)
  losses/    PhysicsLoss                                   (srm_tpu/losses/)
  training/  optimizers + trainer                          (srm_tpu/training/)
  parallel/  data-parallel meshes over a torch.distributed
             process group                                 (srm_tpu/parallel/)
  examples/  case construction                             (srm_tpu/examples/)
  sim/       the implicit FV simulator and its labels      (srm_tpu/sim/)
  eval/      predictor, serving bundle, plots, RMSE,
             time-step log                                 (srm_tpu/eval/)
  tools/     step profiler, time to accuracy, infer_vs_sim,
             KLE sampler timing                            (tools/, bench.py)

The package imports ``torch`` and ``numpy``, never JAX and nothing of the
JAX package: ``config/`` and ``data/assets/pvt_table.csv`` are its own
copies. What is ported so far is every training configuration of the JAX
package: the physics-, data- and mixed-mode training step of dry gas and of
gas condensate in 2D and in 3D (Nz > 1, through
``examples.common.setup_case(nz=...)``), the production knobs and per-cell
porosity, with the well solver's Newton BHP and blocking factor; data
generation (the CLI's ``generate-data``, the on-device KLE sampler, labels
parsed from simulator files); the FV simulator that labels the splits, the
RMSE against those labels, and the serving path (the predictor, the
``torch.export`` bundle, the CLI's ``predict`` and ``export``); training
data-parallel over the processes torchrun starts (the data axis of the JAX
package's mesh); ``ROADMAP.md`` lists what remains. The entry
points run on the GPU unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
