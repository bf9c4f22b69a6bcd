"""Port of ``srm_tpu/kernels``; see the package docstring."""
