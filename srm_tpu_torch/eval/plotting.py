"""Accuracy against test labels: the pressure and saturation RMSE.

Port of ``pressure_rmse`` and ``saturation_rmse`` of
``srm_tpu/eval/plotting.py`` (``:180-200``) with the batched prediction of
its ``ModelPlotter.predict`` (``:56-74``). The plots and the time-step log
are not ported yet (ROADMAP A14).
"""

from __future__ import annotations

import numpy as np
import torch


@torch.no_grad()
def predict(model: torch.nn.Module, features: np.ndarray, batch_size: int = 64) -> np.ndarray:
    """``model`` over (A, B, *sample) features in chunks of ``batch_size``
    samples, on the model's device; → (A, B, *output) on the host."""
    device = next(model.parameters()).device
    A, B = features.shape[:2]
    flat = features.reshape((-1,) + features.shape[2:])
    outs = [model(torch.from_numpy(np.ascontiguousarray(flat[i:i + batch_size])).to(device)).cpu()
            for i in range(0, flat.shape[0], batch_size)]
    out = torch.cat(outs).numpy()
    return out.reshape((A, B) + out.shape[1:])


def predictions_and_labels(models, test_pairs, key: str = "PRESSURE", batch_size: int = 64,
                           model_key: str = "pressure"):
    """The model's prediction over the first test group and its labels
    ``key``, both shaped (A, B, *grid)."""
    feats, labels = test_pairs[0]
    feats = np.asarray(feats)
    if feats.ndim == 5:
        feats = feats[None]
    pred = predict(models[model_key], feats, batch_size)[..., 0]
    true = np.asarray(labels[key]) if isinstance(labels, dict) else np.asarray(labels)
    return pred, true.reshape(pred.shape)


def pressure_rmse(models, test_pairs, key: str = "PRESSURE", batch_size: int = 64,
                  model_key: str = "pressure") -> float:
    """RMSE of the pressure model against the test labels (psia)."""
    pred, true = predictions_and_labels(models, test_pairs, key, batch_size, model_key)
    return float(np.sqrt(np.mean((pred - true) ** 2)))


def saturation_rmse(models, test_pairs, key: str = "SGAS", batch_size: int = 64) -> float:
    """RMSE of the gas-condensate saturation model against the SGAS labels."""
    return pressure_rmse(models, test_pairs, key=key, batch_size=batch_size,
                         model_key="saturation_model")
