"""Per-role Adam / AdamW with per-step exponential decay.

Port of ``srm_tpu/training/optimizers.py::build_optimizer_from_config``.
The update is written out, because no stock torch optimizer has these
semantics (those of the reference's optax chains and Keras):

* Adam moments with ε = 1e-7 (Keras) added outside the square root, and
  bias correction by ``1 − β^t``;
* a learning rate ``lr · rate^(step / decay_steps)`` decaying every step
  (``staircase=False``);
* AdamW as the chain ``scale_by_adam → + wd(step) · θ → · (−lr(step))``
  (``optimizers.py:53-57, 68-84``): the decoupled weight decay is applied
  with the learning rate, and where its decay is enabled its coefficient
  decays as ``wd · rate^(step / decay_steps)`` too.

``step`` counts from 0 at the first update, as optax's schedules do.
Parameters are updated in place with ``torch._foreach`` ops.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch


class AdamDecay:
    """Adam / AdamW over a list of parameters with the reference's schedules."""

    def __init__(self, params: List[torch.Tensor], lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-7, weight_decay: float = 0.0,
                 decay_steps: int = 100, lr_decay_rate: Optional[float] = None,
                 wd_decay_rate: Optional[float] = None):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay = weight_decay
        self.decay_steps = decay_steps
        self.lr_decay_rate = lr_decay_rate        # None: constant learning rate
        self.wd_decay_rate = wd_decay_rate        # None: constant weight decay
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def _scheduled(self, value: float, rate: Optional[float]) -> float:
        return value if rate is None else value * rate ** (self.count / self.decay_steps)

    def learning_rate(self) -> float:
        """The learning rate of the next update."""
        return self._scheduled(self.lr, self.lr_decay_rate)

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        lr = self.learning_rate()
        wd = self._scheduled(self.weight_decay, self.wd_decay_rate)
        self.count += 1
        t = self.count
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)
        mu_hat = torch._foreach_div(self.mu, 1.0 - self.b1 ** t)
        nu_hat = torch._foreach_div(self.nu, 1.0 - self.b2 ** t)
        upd = torch._foreach_div(mu_hat, torch._foreach_add(torch._foreach_sqrt(nu_hat),
                                                            self.eps))
        if wd:
            torch._foreach_add_(upd, self.params, alpha=wd)
        torch._foreach_add_(self.params, upd, alpha=-lr)


def build_optimizer_from_config(params: List[torch.Tensor], config: Dict[str, Any]) -> AdamDecay:
    """AdamDecay from one entry of ``DEFAULT_OPTIMIZER_CONFIGS``."""
    opt_type = config["type"].lower()
    if opt_type not in ("adam", "adamw"):
        raise NotImplementedError(f"optimizer type {config['type']!r} is not ported")
    decay = config.get("exponential_decay", {}) or {}
    enabled = decay.get("enabled", False)
    if enabled and decay.get("staircase", False):
        raise NotImplementedError("staircase decay is not ported")
    lr_cfg = decay.get("learning_rate", {}) or {}
    wd_cfg = decay.get("weight_decay", {}) or {}
    adamw = opt_type == "adamw"
    return AdamDecay(
        params, lr=config.get("learning_rate", 1e-3),
        b1=config.get("beta_1", 0.9), b2=config.get("beta_2", 0.999),
        eps=config.get("epsilon", 1e-7),
        weight_decay=config.get("weight_decay", 0.0) if adamw else 0.0,
        decay_steps=lr_cfg.get("decay_steps", 100),
        lr_decay_rate=(lr_cfg.get("decay_rate", 0.96)
                       if enabled and lr_cfg.get("enabled", False) else None),
        wd_decay_rate=(wd_cfg.get("decay_rate", 0.98)
                       if adamw and enabled and wd_cfg.get("enabled", False) else None))
