"""Port of ``srm_tpu/examples``; see the package docstring."""
