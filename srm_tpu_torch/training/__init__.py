"""Port of ``srm_tpu/training``; see the package docstring."""
