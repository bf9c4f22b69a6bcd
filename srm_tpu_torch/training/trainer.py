"""Multi-model training loop.

Port of ``srm_tpu/training/trainer.py``: a :class:`Trainer` that owns one
optimizer per trainable model and the device-resident datasets, and a
minimal :func:`train_combined_models_unified` loop (epochs, the train and
val history dict, a stop on a non-finite loss).

A dataset is staged once: its (K, T) axes are collapsed first-axis-fastest,
the groups concatenated and the result copied to the device. Each training
epoch draws a fresh permutation from the trainer's ``torch.Generator`` and
runs ``N // B`` full batches; the ragged tail is dropped, a different subset
each epoch, as the reference drops it (``trainer.py:200-229``). Per-step
metrics stay on the device until the epoch ends.

Watched-epoch snapshots, the best-epoch restore and checkpoint/resume wait
for a later slice of the port.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from srm_tpu_torch.config import DEFAULT_GENERAL_CONFIG, get_optimizer_config
from srm_tpu_torch.data.batching import collapse_groups
from srm_tpu_torch.training.optimizers import build_optimizer_from_config

log = logging.getLogger(__name__)


class Trainer:
    """Owns the optimizers, the resident datasets and the train/eval steps."""

    def __init__(self, loss_fn, optimizer_configs: Optional[Dict[str, Dict]] = None,
                 seed: int = 0):
        self.loss_fn = loss_fn
        self.models = loss_fn.models
        self.device = loss_fn.device
        self.generator = torch.Generator().manual_seed(int(seed))
        self.optimizer_keys = list(loss_fn.trainable_models_keys)
        self.optimizers = {}
        for key in self.optimizer_keys:
            cfg = (optimizer_configs or {}).get(key) or get_optimizer_config(key)
            params = list(self.models[loss_fn.logical_name(key)].parameters())
            self.optimizers[key] = build_optimizer_from_config(params, cfg)
        self._resident: Dict[str, Any] = {}

    @staticmethod
    def _scalar_metrics(aux, total) -> Dict[str, torch.Tensor]:
        metrics = {f"{ph}/{t}": v.detach() for ph, terms in aux.items() if ph != "outputs"
                   for t, v in terms.items()}
        metrics["total"] = total.detach()
        metrics["tstep_mean"] = aux["outputs"]["tstep"].detach().mean()
        return metrics

    def train_step(self, x: torch.Tensor, y) -> Dict[str, torch.Tensor]:
        aux, grads, total = self.loss_fn.pinn_batch_sse_grad(x, y)
        for key in self.optimizer_keys:
            self.optimizers[key].step(grads[key])
        return self._scalar_metrics(aux, total)

    @torch.no_grad()
    def eval_step(self, x: torch.Tensor, y) -> Dict[str, torch.Tensor]:
        total, aux = self.loss_fn.loss_and_metrics(x, y)
        return self._scalar_metrics(aux, total)

    # -- device-resident datasets -------------------------------------------
    def stage_dataset(self, name: str, groups, batch_size: int):
        """Collapse (K, T) groups and copy them to the device once.
        Returns (num_batches, num_samples)."""
        if not groups or groups[0][0].shape[0] == 0:
            self._resident[name] = None
            return 0, 0
        x_np, y_np = collapse_groups(groups)
        n = x_np.shape[0]
        if n == 0:
            self._resident[name] = None
            return 0, 0
        if batch_size > n:
            log.warning("stage_dataset[%s]: batch %d > N=%d — clamping the batch to the "
                        "dataset size", name, batch_size, n)
            batch_size = n
        x = torch.from_numpy(x_np).to(self.device)
        y = {k: torch.from_numpy(v).to(self.device) for k, v in y_np.items()}
        nb = n // batch_size
        if n - nb * batch_size:
            log.info("stage_dataset[%s]: N=%d is not divisible by B=%d — %d samples per "
                     "epoch are dropped (shuffled each epoch for training, fixed for eval)",
                     name, n, batch_size, n - nb * batch_size)
        self._resident[name] = (x, y, nb, batch_size)
        return nb, n

    @staticmethod
    def _stack(metrics: List[Dict[str, torch.Tensor]]) -> Dict[str, np.ndarray]:
        """Per-step metrics → host arrays, one copy per epoch."""
        return {k: torch.stack([m[k] for m in metrics]).cpu().numpy() for k in metrics[0]}

    def train_epoch_resident(self, name: str) -> Dict[str, np.ndarray]:
        x, y, nb, bs = self._resident[name]
        perm = torch.randperm(x.shape[0], generator=self.generator)[: nb * bs].to(self.device)
        metrics = []
        for i in range(nb):
            idx = perm[i * bs:(i + 1) * bs]
            metrics.append(self.train_step(x[idx], {k: v[idx] for k, v in y.items()}))
        return self._stack(metrics)

    def eval_epoch_resident(self, name: str) -> Dict[str, np.ndarray]:
        x, y, nb, bs = self._resident[name]
        return self._stack([self.eval_step(x[i * bs:(i + 1) * bs],
                                           {k: v[i * bs:(i + 1) * bs] for k, v in y.items()})
                            for i in range(nb)])


def train_combined_models_unified(train_groups, val_groups, loss_fn,
                                  training_batch_size: Optional[int] = None,
                                  testing_batch_size: Optional[int] = None,
                                  epochs: int = 5, general_config: Optional[Dict] = None,
                                  optimizer_configs: Optional[Dict[str, Dict]] = None,
                                  seed: int = 0, verbose: int = 1):
    """Train for ``epochs``; returns (trainer, history).

    History layout follows the reference: per-phase per-key train/val
    series, ``epoch_times`` (ms), ``total_train_loss``, ``total_val_loss``
    and ``tstep_mean``, plus ``step_total_loss`` (every step's total
    weighted SSE). An empty split is skipped; a non-finite epoch loss stops
    training."""
    g = general_config or DEFAULT_GENERAL_CONFIG
    training_batch_size = training_batch_size or g["training_batch_size"]
    testing_batch_size = testing_batch_size or g["testing_batch_size"]
    trainer = Trainer(loss_fn, optimizer_configs=optimizer_configs, seed=seed)
    n_train, _ = trainer.stage_dataset("train", train_groups, training_batch_size)
    n_val, _ = trainer.stage_dataset("val", val_groups, testing_batch_size)
    loss_keys = loss_fn.loss_keys

    def averages(metrics):
        return {ph: {key: float(np.mean(metrics[f"{ph}/{key.rsplit('_', 1)[0]}"]))
                     for key in keys} for ph, keys in loss_keys.items()}

    history = {
        "train": {ph: {key: [] for key in keys} for ph, keys in loss_keys.items()},
        "val": {ph: {key: [] for key in keys} for ph, keys in loss_keys.items()},
        "epoch_times": [], "total_train_loss": [], "total_val_loss": [],
        "tstep_mean": [], "step_total_loss": [],
    }
    t_total = time.time()
    for epoch in range(epochs):
        if n_train == 0:
            continue
        t0 = time.time()
        metrics = trainer.train_epoch_resident("train")      # one host copy per epoch
        epoch_ms = (time.time() - t0) * 1000.0
        avg = averages(metrics)
        total_train = sum(sum(v.values()) for v in avg.values())
        history["epoch_times"].append(epoch_ms)
        for ph in loss_keys:
            for key in loss_keys[ph]:
                history["train"][ph][key].append(avg[ph][key])
        history["total_train_loss"].append(total_train)
        history["tstep_mean"].append(float(np.mean(metrics["tstep_mean"])))
        history["step_total_loss"].extend(float(v) for v in metrics["total"])
        if not np.isfinite(total_train):
            log.error("Non-finite training loss at epoch %d — stopping.", epoch + 1)
            break
        if verbose:
            print(f"Epoch {epoch + 1}/{epochs} - loss {total_train:.4f} - {epoch_ms:.0f} ms "
                  f"({n_train / max(epoch_ms / 1000.0, 1e-9):.2f} steps/s)")
        if n_val > 0:
            vavg = averages(trainer.eval_epoch_resident("val"))
            for ph in loss_keys:
                for key in loss_keys[ph]:
                    history["val"][ph][key].append(vavg[ph][key])
            history["total_val_loss"].append(sum(sum(v.values()) for v in vavg.values()))
    if verbose:
        print(f"Total training time: {time.time() - t_total:.2f}s")
    return trainer, history
