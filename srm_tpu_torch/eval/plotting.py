"""Test-set plots and accuracy against test labels.

Port of ``srm_tpu/eval/plotting.py``: :class:`ModelPlotter` (``:22-178``;
predicted-vs-true time series at grid points and paginated predicted /
observed / %-residual image triptychs) and the pressure and saturation RMSE
(``:180-200``), on :func:`predict`, the batched forward of its
``ModelPlotter.predict`` (``:56-74``) on the model's device. matplotlib is
imported only when a plot is drawn.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from srm_tpu_torch.utils.stats import denormalize


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


class ModelPlotter:
    """Plots model predictions against test labels.

    ``test_pairs`` is a list of (features, labels-dict) groups with features
    shaped (A, B, T, H, W, C): A realizations, B times. Predictions use the
    ``model_key`` model (the pressure model by default). The reference's
    ``params`` argument is gone: the weights live in the modules."""

    def __init__(self, models, test_pairs, time_channel: int = -2, data_summary=None,
                 norm_config=None, batch_size: int = 64, model_key: str = "pressure"):
        self.models = models
        self.model_key = model_key
        self.test_pairs = test_pairs
        self.time_channel = time_channel
        self.data_summary = data_summary
        self.norm_config = norm_config
        self.batch_size = batch_size
        self.font_size = 10.0
        self.font_type = None
        self.x_unit_label = ""
        self.y_unit_label = ""

    def set_unit_labels(self, x_unit_label: str = "", y_unit_label: str = ""):
        self.x_unit_label = x_unit_label
        self.y_unit_label = y_unit_label

    def set_font_settings(self, font_size: float = 10.0, font_type: Optional[str] = None):
        self.font_size = font_size
        self.font_type = font_type

    def predict(self, features: np.ndarray) -> np.ndarray:
        """Batched prediction over (A, B, T, H, W, C) features."""
        return predict(self.models[self.model_key], features, self.batch_size)

    def extract_times(self, features: np.ndarray) -> np.ndarray:
        """Per-(a, b) scalar times from the time channel, denormalized when
        a DataSummary and a normalization config are given."""
        t = features[..., 0, 0, 0, self.time_channel]
        if self.data_summary is not None and self.norm_config is not None:
            row = torch.from_numpy(self.data_summary.row("time"))
            t = denormalize(torch.from_numpy(np.asarray(t, np.float32)), row,
                            method=self.norm_config["feature_normalization_method"],
                            limits=tuple(self.norm_config["normalization_limits"]),
                            is_log=False).numpy()
        return t

    # ------------------------------------------------------------------
    def plot_line(self, key: str = "PRESSURE", a_indices: Optional[Sequence[int]] = None,
                  b_indices: Optional[Sequence[int]] = None, avg: bool = False,
                  indices: Optional[Sequence[Tuple[int, int, int]]] = None,
                  superimpose_indices: bool = True, figsize=(8, 4),
                  title: str = "", save_path: Optional[str] = None):
        """Predicted-vs-true time series at grid points
        (srm_tpu/eval/plotting.py:91-132)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        feats, labels = self.test_pairs[0]
        feats = np.asarray(feats)
        if feats.ndim == 5:      # (A*B, T, H, W, C) — single collapsed axis
            feats = feats[None]
        pred = self.predict(feats)                       # (A, B, T, H, W, 1)
        true = np.asarray(labels[key]) if isinstance(labels, dict) else np.asarray(labels)
        true = true.reshape(pred.shape[:2] + pred.shape[2:-1])
        times = self.extract_times(feats)

        a_indices = list(a_indices or range(min(2, pred.shape[0])))
        indices = list(indices or [(0, pred.shape[-3] // 2, pred.shape[-2] // 2)])

        fig, axes = plt.subplots(len(a_indices), 1, figsize=figsize, squeeze=False)
        for row, a in enumerate(a_indices):
            ax = axes[row][0]
            for (t_i, h, w_) in indices:
                p_series = pred[a, :, t_i, h, w_, 0]
                y_series = true[a, :, t_i, h, w_]
                if avg:
                    p_series = pred[a].mean(axis=(1, 2, 3, 4))
                    y_series = true[a].mean(axis=(1, 2, 3))
                ax.plot(times[a], p_series, "-", label=f"pred ({h},{w_})")
                ax.plot(times[a], y_series, "o", ms=2, label=f"true ({h},{w_})")
            ax.set_xlabel(f"time {self.x_unit_label}", fontsize=self.font_size)
            ax.set_ylabel(f"{key} {self.y_unit_label}", fontsize=self.font_size)
            ax.legend(fontsize=self.font_size * 0.8)
            ax.set_title(f"{title} — realization {a}", fontsize=self.font_size)
        fig.tight_layout()
        if save_path:
            fig.savefig(save_path, dpi=120)
        plt.close(fig)
        return fig

    def plot_images(self, key: str = "PRESSURE", a_index: int = 0,
                    b_indices: Optional[Sequence[int]] = None, per_page: int = 4,
                    save_path: Optional[str] = None, t_index: int = 0):
        """Predicted / observed / %-residual triptychs
        (srm_tpu/eval/plotting.py:134-177).

        ``b_indices`` selects the paginated rows along axis 1 (time groups);
        ``t_index`` picks the slice of the folded temporal/depth axis 2 of
        each image."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        feats, labels = self.test_pairs[0]
        feats = np.asarray(feats)
        if feats.ndim == 5:
            feats = feats[None]
        pred = self.predict(feats)
        true = np.asarray(labels[key]) if isinstance(labels, dict) else np.asarray(labels)
        true = true.reshape(pred.shape[:2] + pred.shape[2:-1])
        b_indices = list(b_indices or range(min(per_page, pred.shape[1])))

        figs = []
        for page_start in range(0, len(b_indices), per_page):
            page = b_indices[page_start:page_start + per_page]
            fig, axes = plt.subplots(len(page), 3, figsize=(9, 3 * len(page)),
                                     squeeze=False)
            for r, b in enumerate(page):
                p_img = pred[a_index, b, t_index, :, :, 0]
                t_img = true[a_index, b, t_index, :, :]
                resid = 100.0 * (p_img - t_img) / np.where(np.abs(t_img) > 0, t_img, 1.0)
                for c, (img, name) in enumerate([(p_img, "predicted"),
                                                 (t_img, "observed"),
                                                 (resid, "% residual")]):
                    im = axes[r][c].imshow(img, cmap="viridis")
                    axes[r][c].set_title(f"{name} b={b}", fontsize=self.font_size)
                    fig.colorbar(im, ax=axes[r][c], fraction=0.046)
            fig.tight_layout()
            if save_path:
                root, ext = os.path.splitext(save_path)
                fig.savefig(f"{root}_p{page_start // per_page}{ext or '.png'}", dpi=120)
            figs.append(fig)
            plt.close(fig)
        return figs


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
