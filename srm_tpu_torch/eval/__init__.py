"""Evaluation: rollouts, serving bundles, plots and accuracy (srm_tpu/eval)."""

from srm_tpu_torch.eval.plotting import ModelPlotter, pressure_rmse, saturation_rmse  # noqa: F401
from srm_tpu_torch.eval.predictor import SRMPredictor  # noqa: F401
from srm_tpu_torch.eval.serving import (  # noqa: F401
    ServingSurrogate,
    export_surrogate,
    load_surrogate,
)
from srm_tpu_torch.eval.timestep_log import (  # noqa: F401
    TimestepRecorder,
    parse_timestep_log,
    plot_timesteps,
)
