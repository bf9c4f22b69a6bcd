"""Port of ``srm_tpu/physics``; see the package docstring."""
