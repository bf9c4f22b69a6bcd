"""Port of ``srm_tpu/nn``; see the package docstring."""
