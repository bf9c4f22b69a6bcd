"""Checkpoint / resume of the training state.

Port of ``srm_tpu/utils/checkpoint.py``, with its interface: ``save``,
``restore`` (latest step by default), ``latest_step``, ``max_to_keep``,
``wait_until_finished`` and ``close``. The reference writes Orbax
checkpoints; this module writes one ``torch.save`` file per step,
``ckpt_<step>.pt``, holding each trained model's ``state_dict``, each
optimizer's moments and step count, the history (as JSON-able floats) and,
where given, the trainer's generator state. Orbax checkpoints of the JAX
package are not read.

A save writes to a temporary name in the same directory and then renames it
(``os.replace``): a crash leaves the previous checkpoints whole. A restore
writes into the live tensors in place (``copy_``): a CUDA graph that
captured the training step holds their addresses. Under a data-parallel
mesh (``parallel/mesh.py``) rank 0 writes each save and every rank waits at
a barrier after it; every rank restores the same step, the generator's
state included, so that the ranks go on drawing the same batches.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Any, Dict, Optional

import torch

from srm_tpu_torch.parallel.mesh import Mesh, barrier

log = logging.getLogger(__name__)

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


class CheckpointManager:
    """The SRM training state in ``directory``, at most ``max_to_keep``
    steps of it."""

    def __init__(self, directory: str, max_to_keep: int = 3, mesh: Optional[Mesh] = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.mesh = mesh if mesh is not None else Mesh()
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{int(step):08d}.pt")

    def steps(self):
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory)) if m)

    def save(self, step: int, params: Dict[str, torch.nn.Module], opt_state: Dict[str, Any],
             history: Optional[Dict] = None, rng_state: Optional[torch.Tensor] = None) -> bool:
        """``params``: the trained models by name; ``opt_state``: the
        optimizers (``AdamDecay``) by key; ``rng_state``: a generator's
        ``get_state()``. Returns whether this rank wrote the file (rank 0)."""
        if self.mesh.rank != 0:
            barrier(self.mesh)
            return False
        state = {
            "step": int(step),
            "params": {k: {n: _host(t) for n, t in m.state_dict().items()}
                       for k, m in params.items()},
            "opt_state": {k: {"mu": [_host(t) for t in o.mu], "nu": [_host(t) for t in o.nu],
                              "count": _host(o.count)} for k, o in opt_state.items()},
            "history": _jsonable_history(history) if history is not None else None,
            "rng_state": rng_state,
        }
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))
        log.info("Saved checkpoint at step %d to %s", step, self.directory)
        barrier(self.mesh)
        return True

    def restore(self, step: Optional[int] = None,
                params: Optional[Dict[str, torch.nn.Module]] = None,
                opt_state: Optional[Dict[str, Any]] = None,
                generator: Optional[torch.Generator] = None):
        """Restore (params, opt_state, history, step); step=None → latest,
        None when there is no checkpoint. Given the live models, optimizers
        and generator, writes the state into them in place."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        state = torch.load(self._path(step), map_location="cpu", weights_only=True)
        with torch.no_grad():
            for k, module in (params or {}).items():
                live = module.state_dict()
                for n, t in state["params"][k].items():
                    live[n].copy_(t)
            for k, opt in (opt_state or {}).items():
                opt.load_state(state["opt_state"][k])
        if generator is not None and state["rng_state"] is not None:
            generator.set_state(state["rng_state"])
        return state["params"], state["opt_state"], state["history"], state["step"]

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def wait_until_finished(self):
        """Saves are synchronous: nothing to wait for."""

    def close(self):
        """Nothing is held open between saves."""


def _jsonable_history(history: Dict) -> Dict:
    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        try:
            return float(v)
        except (TypeError, ValueError):
            return v
    return conv(history)
