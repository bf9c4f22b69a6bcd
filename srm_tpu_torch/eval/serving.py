"""Ahead-of-time surrogate export for serving (``torch.export``).

Port of ``srm_tpu/eval/serving.py``. The trained field surrogate is saved as
``torch.export`` programs that any process can load and run with nothing
but ``torch`` installed: no model classes, no config dicts, no stats
tables.

* The whole serving pipeline is one module, traced: raw inputs
  ``(permx [b, *grid], time_days [b])`` → the positional grids' channels
  ``[z, y, x, time, permx]`` → channelwise normalization (the stats rows are
  buffers of the module) → the network's forward → the physical field
  (psia or saturation), as the reference's ``_make_serving_fn``
  (``:48-88``).
* The batch dimension is exported as a ``torch.export.Dim``, so one
  program serves any batch size.
* One program per (field, platform): each is traced with the module and its
  example inputs on that platform (``"cpu"`` or ``"cuda"``), so no program
  carries another device's tensors; exporting for ``"cuda"`` needs a card.
  ``manifest.json`` keeps the reference's keys and says which file serves
  which platform (``fields[field]["artifact"][platform]``).
* A network with a ``compute_dtype`` is traced with its per-layer casts
  (bfloat16 layers over float32 parameters); the program's inputs and
  output stay float32.

A bundle is served on one platform (``device``, ``"cuda"`` by default):
:class:`ServingSurrogate` loads that platform's programs and raises if the
bundle has none for it or one fails to load; it returns numpy arrays.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from srm_tpu_torch.utils import stats as stats_mod

_MANIFEST = "manifest.json"

# the predictor's feature channel order (the weave's flip): [z, y, x, time,
# permx]; DataSummary rows 0..4 hold the matching stats
_CHANNELS = ("z", "y", "x", "time", "permx")
# the example batch of the trace: >= 2, so that the batch is not specialised
_EXAMPLE_BATCH = 2


def _field_model_name(field: str) -> str:
    return {"pressure": "pressure", "saturation": "saturation_model"}[field]


class _ServingModule(nn.Module):
    """(permx_raw (b, *vol) in mD, t_days (b,)) → physical field (b, *vol)."""

    def __init__(self, predictor, field: str):
        super().__init__()
        summary = predictor.data_summary
        self.method = stats_mod._method(predictor.norm_config)
        self.limits = stats_mod._norm_limits(predictor.norm_config)
        self.is_log = [bool(summary.is_log_np[i]) for i in range(5)]
        # the positional grids without the predictor's leading broadcast axis
        xg, yg, zg = (np.squeeze(g, axis=0) for g in predictor._grids)
        grids = np.ascontiguousarray(np.stack([zg, yg, xg]))
        self.register_buffer("grids", torch.from_numpy(grids))
        self.register_buffer("rows", torch.from_numpy(np.array(summary.table_np[:5])))
        self.model = predictor.models[_field_model_name(field)]

    def forward(self, permx: torch.Tensor, t_days: torch.Tensor) -> torch.Tensor:
        b, vol = permx.shape[0], permx.shape[1:]
        tcol = t_days.reshape((b,) + (1,) * len(vol))
        chans = [self.grids[0].expand((b,) + vol), self.grids[1].expand((b,) + vol),
                 self.grids[2].expand((b,) + vol), tcol.expand((b,) + vol), permx]
        normed = [stats_mod.normalize(c, self.rows[i], method=self.method, limits=self.limits,
                                      is_log=self.is_log[i]) for i, c in enumerate(chans)]
        return self.model(torch.stack(normed, dim=-1))[..., 0]


def export_surrogate(predictor, out_dir: str, fields: Sequence[str] = ("pressure",),
                     platforms: Tuple[str, ...] = ("cpu", "cuda")) -> Dict[str, Dict[str, str]]:
    """Save serving programs for ``fields`` on ``platforms`` into ``out_dir``.

    Returns ``{field: {platform: artifact_path}}``. The batch dimension is
    symbolic; the grid is fixed to the training reservoir's. A
    ``manifest.json`` records the shapes and the physical meaning of each
    field."""
    for platform in platforms:
        if platform not in ("cpu", "cuda"):
            raise ValueError(f"unknown platform {platform!r}: use 'cpu' or 'cuda'")
        if platform == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("exporting for 'cuda' needs a usable CUDA device; "
                               "export for platforms=('cpu',) on a machine without one")
    os.makedirs(out_dir, exist_ok=True)
    res = predictor.reservoir_config
    # the networks keep the depth axis even when Nz == 1 (input (b, D, H, W, C))
    vol = (int(res["Nz"]), int(res["Ny"]), int(res["Nx"]))
    manifest = {
        "grid": list(vol),
        "channels": list(_CHANNELS),
        "platforms": list(platforms),
        "inputs": {"permx": ["b", *vol], "time_days": ["b"]},
        "fields": {},
    }
    paths: Dict[str, Dict[str, str]] = {}
    batch = torch.export.Dim("b")
    for field in fields:
        served = _ServingModule(predictor, field)
        paths[field] = {}
        for platform in platforms:
            # a copy of the live model (its weights as they are now) on the platform
            module = copy.deepcopy(served).to(platform).eval()
            example = (torch.full((_EXAMPLE_BATCH,) + vol, 1.0, device=platform),
                       torch.zeros((_EXAMPLE_BATCH,), device=platform))
            program = torch.export.export(module, example,
                                          dynamic_shapes=({0: batch}, {0: batch}))
            path = os.path.join(out_dir, f"{field}.{platform}.pt2")
            torch.export.save(program, path)
            paths[field][platform] = path
        manifest["fields"][field] = {
            "artifact": {p: os.path.basename(paths[field][p]) for p in platforms},
            "unit": "psia" if field == "pressure" else "fraction",
            "output": ["b", *vol],
        }
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return paths


class ServingSurrogate:
    """A loaded serving bundle: callables with no model or config code,
    on ``device`` ("cuda" unless the caller asks for "cpu")."""

    def __init__(self, out_dir: str, device: str = "cuda"):
        with open(os.path.join(out_dir, _MANIFEST)) as f:
            self.manifest = json.load(f)
        self.device = torch.device(device)
        platform = self.device.type
        if platform == "cuda" and not torch.cuda.is_available():
            raise RuntimeError('no usable CUDA device: serve with device="cpu" to run on the CPU')
        if platform not in self.manifest["platforms"]:
            raise ValueError(f"the bundle in {out_dir} holds no program for {platform!r} "
                             f"(platforms: {self.manifest['platforms']})")
        self._fns = {field: torch.export.load(
                         os.path.join(out_dir, info["artifact"][platform])).module()
                     for field, info in self.manifest["fields"].items()}

    @property
    def fields(self):
        return sorted(self._fns)

    @torch.no_grad()
    def __call__(self, field: str, permx: np.ndarray, time_days: np.ndarray) -> np.ndarray:
        """Evaluate ``field`` on raw ``(b, *grid)`` permeability (mD) at
        per-sample times (days); returns the physical field ``(b, *grid)``."""
        permx = torch.as_tensor(np.asarray(permx, np.float32), device=self.device)
        time_days = torch.as_tensor(np.asarray(time_days, np.float32), device=self.device)
        return self._fns[field](permx, time_days).cpu().numpy()


def load_surrogate(out_dir: str, device: str = "cuda") -> ServingSurrogate:
    return ServingSurrogate(out_dir, device=device)
