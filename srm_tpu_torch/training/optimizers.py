"""Per-role Adam / AdamW / AdaBelief with exponential decay, on the device.

Port of ``srm_tpu/training/optimizers.py::build_optimizer_from_config``.
The update is written out, because no stock torch optimizer has these
semantics (those of the reference's optax chains and Keras):

* Adam moments with ε = 1e-7 (Keras) added outside the square root, and
  bias correction by ``1 − β^t``; AdaBelief (``optax.scale_by_belief``)
  keeps the second moment of the prediction error ``g − μ`` instead, with
  ``eps_root`` = 1e-16 added to it;
* a learning rate ``lr · rate^(step / decay_steps)`` (``optax.exponential_decay``;
  with ``staircase`` the exponent is floored);
* AdamW as the chain ``scale_by_adam → + wd(step) · θ → · (−lr(step))``
  (``optimizers.py:53-57, 68-84``): the decoupled weight decay is applied
  with the learning rate, and where its decay is enabled its coefficient
  decays as ``wd · rate^(step / decay_steps)`` too. AdaBelief adds a
  constant weight decay the same way (``:58-61``).

Everything that changes from step to step lives on the parameters' device:
the step count is an int32 tensor that :meth:`AdamDecay.step` increments
itself, and the schedules and bias corrections are float32 tensors computed
from it as the reference's compiled step computes optax's (``count`` from 0
at the first update for the schedules, ``count + 1`` for the bias
corrections). A step therefore never
reads the host, and a CUDA graph that captured one replays the same update
at every later step. Whether there is any weight decay is fixed when the
optimizer is built.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch


class AdamDecay:
    """Adam / AdamW / AdaBelief over a list of parameters with the
    reference's schedules."""

    def __init__(self, params: List[torch.Tensor], lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-7, weight_decay: float = 0.0,
                 decay_steps: int = 100, lr_decay_rate: Optional[float] = None,
                 wd_decay_rate: Optional[float] = None, staircase: bool = False,
                 belief: bool = False, eps_root: float = 1e-16):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay = weight_decay
        self.decay_steps = decay_steps
        self.lr_decay_rate = lr_decay_rate        # None: constant learning rate
        self.wd_decay_rate = wd_decay_rate        # None: constant weight decay
        self.staircase = staircase
        self.belief = belief
        self.eps_root = eps_root if belief else 0.0
        device = self.params[0].device
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self._b1, self._b2 = torch.tensor(b1, **f32), torch.tensor(b2, **f32)
        self._rates = {r: torch.tensor(r, **f32) for r in (lr_decay_rate, wd_decay_rate)
                       if r is not None}
        self._lr0 = torch.tensor(lr, **f32)
        # XLA compiles optax's ``count / transition_steps`` in the reference's
        # jitted step as a multiply by the float32 reciprocal
        self._inv_steps = torch.tensor(1.0 / decay_steps, **f32)
        self._one = torch.tensor(1.0, **f32)

    def _decayed(self, init: torch.Tensor, rate: Optional[float]):
        """``optax.exponential_decay(init, decay_steps, rate, staircase)`` at
        the current count, a float32 device tensor (``init`` itself when
        ``rate`` is None)."""
        if rate is None:
            return init
        c = self.count
        p = c.float() * self._inv_steps
        if self.staircase:
            p = torch.floor(p)
        return torch.where(c <= 0, init, init * torch.pow(self._rates[rate], p))

    def schedules(self) -> Dict[str, torch.Tensor]:
        """The next update's learning rate, weight-decay coefficient (None
        without weight decay) and bias corrections ``1 − β1^t``,
        ``1 − β2^t`` (t = count + 1), as float32 device tensors."""
        t = (self.count + 1).float()
        wd = None
        if self.weight_decay:
            wd = self.weight_decay * self._decayed(self._one, self.wd_decay_rate)
        return {"lr": self._decayed(self._lr0, self.lr_decay_rate), "wd": wd,
                "bc1": 1 - torch.pow(self._b1, t), "bc2": 1 - torch.pow(self._b2, t)}

    def learning_rate(self) -> torch.Tensor:
        """The learning rate of the next update."""
        return self.schedules()["lr"]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        s = self.schedules()
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - b1))
        err = torch._foreach_sub(grads, self.mu) if self.belief else grads
        sq = torch._foreach_mul(err, err)
        torch._foreach_mul_(sq, 1 - b2)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, sq)
        if self.eps_root:
            torch._foreach_add_(self.nu, self.eps_root)
        upd = torch._foreach_div(self.mu, s["bc1"])
        den = torch._foreach_sqrt(torch._foreach_div(self.nu, s["bc2"]))
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(upd, den)
        if s["wd"] is not None:
            torch._foreach_add_(upd, torch._foreach_mul(self.params, s["wd"]))
        torch._foreach_mul_(upd, -s["lr"])
        torch._foreach_add_(self.params, upd)
        self.count.add_(1)

    # -- state, for checkpoints: written into the live tensors in place ----
    def state(self) -> Dict[str, Any]:
        return {"mu": self.mu, "nu": self.nu, "count": self.count}

    @torch.no_grad()
    def load_state(self, state: Dict[str, Any]) -> None:
        for dst, src in zip(self.mu + self.nu + [self.count],
                            list(state["mu"]) + list(state["nu"]) + [state["count"]],
                            strict=True):
            dst.copy_(src)


def build_optimizer_from_config(params: List[torch.Tensor], config: Dict[str, Any]) -> AdamDecay:
    """AdamDecay from one entry of ``DEFAULT_OPTIMIZER_CONFIGS``."""
    opt_type = config["type"].lower()
    if opt_type not in ("adam", "adamw", "adabelief"):
        raise ValueError(f"Unsupported optimizer type: {config['type']}")
    decay = config.get("exponential_decay", {}) or {}
    enabled = decay.get("enabled", False)
    lr_cfg = decay.get("learning_rate", {}) or {}
    wd_cfg = decay.get("weight_decay", {}) or {}
    adamw = opt_type == "adamw"
    return AdamDecay(
        params, lr=config.get("learning_rate", 1e-3),
        b1=config.get("beta_1", 0.9), b2=config.get("beta_2", 0.999),
        eps=config.get("epsilon", 1e-7),
        weight_decay=config.get("weight_decay", 0.0) if opt_type != "adam" else 0.0,
        decay_steps=lr_cfg.get("decay_steps", 100),
        lr_decay_rate=(lr_cfg.get("decay_rate", 0.96)
                       if enabled and lr_cfg.get("enabled", False) else None),
        wd_decay_rate=(wd_cfg.get("decay_rate", 0.98)
                       if adamw and enabled and wd_cfg.get("enabled", False) else None),
        staircase=bool(enabled and decay.get("staircase", False)),
        belief=opt_type == "adabelief")
