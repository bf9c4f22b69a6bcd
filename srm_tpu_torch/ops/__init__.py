"""Port of ``srm_tpu/ops``; see the package docstring."""
