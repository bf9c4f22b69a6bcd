"""Port of ``srm_tpu/utils``; see the package docstring."""
