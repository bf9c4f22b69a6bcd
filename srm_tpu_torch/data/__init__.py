"""Port of ``srm_tpu/data``; see the package docstring."""
