"""Batched rollouts of the trained surrogate.

Port of ``srm_tpu/eval/predictor.py``: :class:`SRMPredictor` evaluates the
pressure (and, for gas condensate, the saturation) model over arbitrary
(permeability realizations × time schedule) grids, the use the surrogate is
trained for: it answers in place of the simulator. The woven features are
built on the host (the numpy weave, then the training statistics'
normalization), padded with the last sample to a multiple of
``batch_size``, copied to the models' device once and evaluated batch by
batch under ``torch.no_grad()``, the modules in eval mode.

On a CUDA device each model's forward at ``batch_size`` is one CUDA graph,
the counterpart of the reference's ``jax.jit`` (``:55``): captured after
eager warm-up calls on a side stream, then replayed for every batch, which
is copied into the graph's static input; the output is cloned out. A
capture that fails raises; nothing falls back to the eager forward or to
the CPU. ``cuda_graph=False`` runs the eager forward on the card (the
replay's reference in the checks); on the CPU there are no graphs, and
``cuda_graph=True`` there raises. Networks with a ``compute_dtype``
(bfloat16 layers over float32 parameters) need nothing more: their casts
are operations of the forward, captured with it, and the output is
float32.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from srm_tpu_torch.config import DEFAULT_GENERAL_CONFIG, DEFAULT_RESERVOIR_CONFIG
from srm_tpu_torch.data.weave import create_positional_grids, weave_tensors


class _Graph:
    """One model's forward at the predictor's batch size, captured."""

    def __init__(self, model: torch.nn.Module, sample: torch.Tensor, warmup: int):
        device = sample.device
        self.x = sample.clone()
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            for _ in range(warmup):
                model(self.x)
        torch.cuda.current_stream(device).wait_stream(stream)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.y = model(self.x)

    def __call__(self, batch: torch.Tensor) -> torch.Tensor:
        self.x.copy_(batch)
        self.graph.replay()
        return self.y.clone()


class SRMPredictor:
    """Pressure / saturation / rate rollouts from the trained models.

    The one difference in signature from the reference's
    ``SRMPredictor(models, params, data_summary, ...)``: there is no
    ``params``, the weights live in the modules (a checkpoint restore writes
    into them in place, which a captured graph then sees)."""

    #: eager forwards before a model's capture
    warmup_calls = 3

    def __init__(self, models: Dict, data_summary, general_config: Optional[Dict] = None,
                 reservoir_config: Optional[Dict] = None, batch_size: int = 256,
                 cuda_graph: Optional[bool] = None):
        self.models = models
        self.data_summary = data_summary
        self.general_config = general_config or DEFAULT_GENERAL_CONFIG
        self.reservoir_config = reservoir_config or DEFAULT_RESERVOIR_CONFIG
        self.batch_size = batch_size
        self.norm_config = self.general_config["data_normalization"]
        self.device = next(models["pressure"].parameters()).device
        on_cuda = self.device.type == "cuda"
        if cuda_graph and not on_cuda:
            raise ValueError(f"cuda_graph=True needs the models on a CUDA device, they are on "
                             f"{self.device}")
        self.cuda_graph = on_cuda if cuda_graph is None else bool(cuda_graph)

        res = self.reservoir_config
        D = [res["length"], res["width"], res["thickness"]]
        N = [res["Nx"], res["Ny"], res["Nz"]]
        x, y, z = create_positional_grids(D, N, indexing="ij", transpose_order=[2, 1, 0])
        self._grids = tuple(np.expand_dims(g, 0).astype(np.float32) for g in (x, y, z))

        self._graphs: Dict[str, _Graph] = {}
        #: graph replays per model name
        self.replays: Dict[str, int] = {}

    # ------------------------------------------------------------------
    def build_features(self, permx: np.ndarray, times: np.ndarray) -> np.ndarray:
        """(K, Nz, Ny, Nx) permeability + (T,) times → normalized woven
        features (K, T, D, H, W, 5) on the host."""
        times = np.asarray(times, np.float32).reshape(-1, 1)
        xg, yg, zg = self._grids
        woven = weave_tensors([permx.astype(np.float32), times, xg, yg, zg],
                              target_trailing_shape=permx.shape[1:])
        stats_idx = np.stack([np.arange(5), np.arange(5)])
        return self.data_summary.normalize(
            torch.from_numpy(woven), norm_config=self.norm_config,
            statistics_index=stats_idx, compute=True).numpy()

    def stage(self, flat: np.ndarray) -> torch.Tensor:
        """(N, *sample) host features → the device, padded with the last
        sample to a multiple of ``batch_size``."""
        pad = (-flat.shape[0]) % self.batch_size
        if pad:
            flat = np.concatenate([flat, np.repeat(flat[-1:], pad, axis=0)], axis=0)
        return torch.from_numpy(np.ascontiguousarray(flat)).to(self.device)

    @torch.no_grad()
    def run_batches(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Model ``name`` over staged features ``x`` (N a multiple of
        ``batch_size``), one batch at a time (on the card, one graph replay
        each); the outputs stay on the device."""
        model = self.models[name].eval()
        bs = self.batch_size
        if x.shape[0] % bs:
            raise ValueError(f"{x.shape[0]} samples are not a multiple of the batch {bs}")
        if not self.cuda_graph:
            return torch.cat([model(x[i:i + bs]) for i in range(0, x.shape[0], bs)])
        if name not in self._graphs:
            self._graphs[name] = _Graph(model, x[:bs], self.warmup_calls)
            self.replays[name] = 0
        graph = self._graphs[name]
        outs = []
        for i in range(0, x.shape[0], bs):
            outs.append(graph(x[i:i + bs]))
            self.replays[name] += 1
        return torch.cat(outs)

    def _batched_apply(self, name: str, flat: np.ndarray) -> np.ndarray:
        out = self.run_batches(name, self.stage(flat))
        return out[:flat.shape[0]].cpu().numpy()

    def _flat_features(self, permx: np.ndarray, times: Sequence[float]):
        feats = self.build_features(permx, np.asarray(times))
        return feats.shape[:2], feats.reshape((-1,) + feats.shape[2:])

    def predict_pressure(self, permx: np.ndarray, times: Sequence[float]) -> np.ndarray:
        """(K, T, D, H, W) pressure fields in psia."""
        (K, T), flat = self._flat_features(permx, times)
        out = self._batched_apply("pressure", flat)
        return out.reshape((K, T) + out.shape[1:])[..., 0]

    def predict_saturation(self, permx: np.ndarray, times: Sequence[float]) -> np.ndarray:
        """(K, T, D, H, W) gas saturation (gas condensate)."""
        (K, T), flat = self._flat_features(permx, times)
        out = self._batched_apply("saturation_model", flat)
        return out.reshape((K, T) + out.shape[1:])[..., 0]

    @torch.no_grad()
    def predict_rates(self, permx: np.ndarray, times: Sequence[float]):
        """Well rates and BHP from the well solver on the predicted
        pressures: (q, pwf) with leading (K, T) axes; for gas condensate q is
        the tuple (qgg, qgo, qoo, qog). As in the reference, the gas
        saturation is not predicted here: gas condensate is evaluated at
        Sg = Sg_max = 1 - Swmin everywhere (the reference's ``Sg_n1=None``)."""
        (K, T), flat = self._flat_features(permx, times)
        x = torch.from_numpy(flat).to(self.device)
        p = torch.from_numpy(self._batched_apply("pressure", flat)).to(self.device)
        well = self.models["well_rate_bhp_model"]
        sg = None
        if well.fluid_type == "GC":
            sg = p.new_tensor(well.relperm.sg_max)
        q, pwf = well.compute_rates_and_bhp(x, p, self.models["pvt_model"], Sg_n1=sg)

        def host(t):
            t = t.cpu().numpy()
            return t.reshape((K, T) + t.shape[1:])

        q = tuple(host(t) for t in q) if isinstance(q, tuple) else host(q)
        return q, host(pwf)
