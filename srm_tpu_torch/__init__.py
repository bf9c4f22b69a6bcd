"""srm_tpu_torch — the PyTorch/CUDA port of ``srm_tpu``.

A second package beside the JAX reference: the same physics-informed
surrogate reservoir model (multi-model PINN trained against finite-volume
PDE residuals), written in PyTorch, with each Pallas TPU kernel of the
reference replaced by a hand-written CUDA kernel for Hopper (``sm_90a``).

Subpackages carry the reference's names so each module's counterpart is
easy to find:

  config/    the defaults and the dataset-cache config hash (srm_tpu/config/)
  utils/     normalization transforms + statistics table   (srm_tpu/utils/stats.py)
  data/      KLE realizations, weaving, dataset cache       (srm_tpu/data/)
  ops/       stencil padding and face helpers              (srm_tpu/ops/stencil.py)
  physics/   relperm, spline PVT, wells, rate/BHP solver   (srm_tpu/physics/)
  nn/        encoder-decoder, residual net, hard layer,
             model map and the flax→torch weight loader    (srm_tpu/nn/)
  kernels/   CUDA kernels + their plain PyTorch versions   (srm_tpu/kernels/)
  losses/    PhysicsLoss                                   (srm_tpu/losses/)
  training/  optimizers + trainer                          (srm_tpu/training/)
  examples/  case construction                             (srm_tpu/examples/)

The package imports ``torch`` and ``numpy``, never JAX and nothing of the
JAX package: ``config/`` and ``data/assets/pvt_table.csv`` are its own
copies. What is ported so far is the physics-mode training step of dry gas
in 2D and in 3D (Nz > 1, through ``examples.common.setup_case(nz=...)``)
and of gas condensate in 2D; ``ROADMAP.md`` lists what remains. The entry
points run on the GPU unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
