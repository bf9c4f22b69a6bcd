"""Port of ``srm_tpu/losses``; see the package docstring."""
