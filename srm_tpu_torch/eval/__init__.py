"""Evaluation against labels (srm_tpu/eval)."""
