"""Training-dataset assembly and cache.

Port of ``srm_tpu/data/dataset.py::SRMDataProcessor``: KLE realizations →
per-split time tensors (with shut-in times) → positional midpoint grids →
woven features ``(K, T, D, H, W, 5)`` with channels
``(z, y, x, time, permx)`` → train-split statistics → lnk-linear
normalization → (features, labels) groups. A split's labels come, first,
from simulator output files parsed by ``pipeline.py`` when the split's
``dat_files_{split}_{hash}/dynamic`` directory exists; else, with
``label_source="simulator"``, from the port's FV simulator
(``srm_tpu_torch.sim``, on the processor's ``device``); else they are
zeros. In physics mode (``physics_mode_fraction >= 1``) only the test split
is labelled; in data and mixed mode with simulator labels every split is
(``srm_tpu/data/dataset.py:217-243``), so the label statistics come from
real train labels. ``general_config["array_pipeline"]["slices"]`` re-slices
the labels' time axis (``pipeline.process_array``). The prediction split
takes its labels from the test split's.

The cache files are the reference's: ``training_data_{hash}.npz`` and
``training_statistics_summary_{hash}.json`` under
``static_dynamic/{name}_{hash}/``, keyed by
``srm_tpu_torch.config.generate_full_config_hash``, the port's copy of the
JAX package's: while the two hashes agree (``tests/test_torch_config.py``),
either package reads what the other wrote, and so is the parsed-results
cache ``dynamic/output/combined_results.npz``.
"""

from __future__ import annotations

import copy
import json
import logging
import os
import zipfile
from typing import Dict, List, Optional, Tuple

import numpy as np

from srm_tpu_torch.config import (
    DEFAULT_GENERAL_CONFIG,
    DEFAULT_RESERVOIR_CONFIG,
    DEFAULT_WELLS_CONFIG,
    WORKING_DIRECTORY,
    generate_full_config_hash,
)
from srm_tpu_torch.data.kle import generate_kle_numpy, split_realizations
from srm_tpu_torch.data.pipeline import private_name, process_array, run_pipeline_for_directory
from srm_tpu_torch.data.weave import (align_and_trim_pair_lists, create_positional_grids,
                                      split_tensor_sequence, weave_tensors)
from srm_tpu_torch.utils.stats import DataSummary, compute_statistics, normalize_channels

log = logging.getLogger(__name__)

FEATURE_KEYS = ["z", "y", "x", "time", "permx"]  # woven channel order


class SRMDataProcessor:
    """Builds, normalizes and caches the SRM dataset; simulator
    labels run on ``device`` (None: ``"cuda"``)."""

    def __init__(self, base_dir: Optional[str] = None,
                 general_config: Optional[Dict] = None,
                 reservoir_config: Optional[Dict] = None,
                 wells_config: Optional[Dict] = None, device=None):
        self.device = device
        self.base_dir = base_dir or WORKING_DIRECTORY
        self.general_config = copy.deepcopy(general_config or DEFAULT_GENERAL_CONFIG)
        self.reservoir_config = copy.deepcopy(reservoir_config or DEFAULT_RESERVOIR_CONFIG)
        self.wells_config = copy.deepcopy(wells_config or DEFAULT_WELLS_CONFIG)
        self.dtype = np.float32
        self.split_keys = self.general_config["split_keys"]
        self.split_ratio = self.general_config["split_ratio"]
        self.split_axis = self.general_config["split_axis"]
        self.seed = self.general_config["seed"]
        os.makedirs(self.base_dir, exist_ok=True)

    # -- identity ------------------------------------------------------------
    def config_hash(self) -> Tuple[str, str]:
        return generate_full_config_hash(self.general_config, self.reservoir_config,
                                         self.wells_config)

    def kle_folder(self) -> str:
        name, h = self.config_hash()
        folder = os.path.join(self.base_dir, "static_dynamic", f"{name}_{h}")
        os.makedirs(folder, exist_ok=True)
        return folder

    # -- pieces ---------------------------------------------------------------
    def generate_kle_splits(self) -> Dict[str, np.ndarray]:
        """Permeability realizations split along axis 0: iid log-normal
        fields for ``method="uncorrelated"`` (the 3D cases' sampler), the
        dense KLE sampler for any other method, as in
        ``srm_tpu/data/dataset.py:79-104``."""
        res = self.reservoir_config
        spec = res["realizations"]["permx"]
        if spec.get("method") == "uncorrelated":
            rng = np.random.RandomState(spec.get("seed") or self.seed)
            shape = (spec["number"], res["Nz"], res["Ny"], res["Nx"])
            mu, sig = np.log(spec["mean"]), spec["std"] / spec["mean"]
            fields = np.exp(rng.normal(mu, sig, shape)).astype(self.dtype)
            splits = split_realizations(fields, self.split_ratio[0],
                                        self.general_config["split_sampling_method"],
                                        self.seed)
            return {k: splits[k] for k in self.split_keys}
        fields, num_modes, _ = generate_kle_numpy(
            n_realizations=spec["number"],
            Nx=res["Nx"], Ny=res["Ny"], Nz=res["Nz"],
            Lx=res["length"], Ly=res["width"], Lz=res["thickness"],
            real_mean=spec["mean"], real_std=spec["std"],
            corr_length_fac=spec["correlation_length_factor"],
            energy_threshold=spec["energy_threshold"],
            seed=spec.get("seed") or self.seed,
            reverse_order=spec.get("reverse_order", True),
            cond_values=spec.get("conditional_values"),
            dtype=self.dtype,
        )
        log.info("KLE: %d modes for %d realizations", num_modes, spec["number"])
        splits = split_realizations(fields, self.split_ratio[0],
                                    self.general_config["split_sampling_method"], self.seed)
        return {k: splits[k] for k in self.split_keys}

    def generate_time_tensor(self) -> Dict[str, np.ndarray]:
        """Per-split [N, 1] time tensors: the linspace grid plus well shut-in
        times, split sequentially on the time axis; val/test get all times."""
        g = self.general_config
        num_steps = int((g["srm_end_time"] - g["srm_start_time"]) / g["srm_timestep"]) + 1
        base = np.linspace(g["srm_start_time"], g["srm_end_time"], num_steps, dtype=self.dtype)
        shutins = set()
        for conn in self.wells_config["connections"]:
            for interval in conn.get("shutin_days", []):
                for t in interval:
                    if t <= g["srm_end_time"]:
                        shutins.add(float(t))
        all_times = np.sort(np.unique(np.concatenate([base, np.array(sorted(shutins), self.dtype)])))
        all_times = all_times[all_times <= g["srm_end_time"]].reshape(-1, 1)

        ratios = self.split_ratio[1]
        n = all_times.shape[0]
        ends = [int(n * sum(ratios[: i + 1])) for i in range(len(ratios))]
        starts = [0] + ends[:-1]
        out = {}
        for i, key in enumerate(self.split_keys):
            out[key] = all_times if key in ("val", "test") else all_times[starts[i]: ends[i]]
        return out

    def positional_grids(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        res = self.reservoir_config
        D = [res["length"], res["width"], res["thickness"]]
        N = [res["Nx"], res["Ny"], res["Nz"]]
        x, y, z = create_positional_grids(D, N, indexing="ij", transpose_order=[2, 1, 0])
        add = lambda a: np.expand_dims(a, 0).astype(self.dtype)  # noqa: E731
        return add(x), add(y), add(z)

    def weave_split(self, permx: np.ndarray, times: np.ndarray,
                    grids: Tuple[np.ndarray, np.ndarray, np.ndarray]) -> np.ndarray:
        """Woven features (K, T, D, H, W, 5) with channels (z, y, x, t, k)."""
        x, y, z = grids
        return weave_tensors([permx, times, x, y, z], target_trailing_shape=permx.shape[1:],
                             flatten_first_axes=False, merge_consecutive_singleton_dims=True)

    def label_keys(self) -> List[str]:
        return ["PRESSURE"] if self.general_config["fluid_type"] == "DG" else ["PRESSURE", "SGAS"]

    def simulation_labels(self, split: str, permx: Optional[np.ndarray] = None,
                          times: Optional[np.ndarray] = None) -> Optional[Dict[str, np.ndarray]]:
        """The split's labels in feature grid order ``(K, T, Nz, Ny, Nx)``, or
        None (the caller falls back to zero labels); as
        ``srm_tpu/data/dataset.py:161-205``:

        1. parsed simulator files, if ``dat_files_{split}_{hash}/dynamic``
           exists (``pipeline.run_pipeline_for_directory``, whose Eclipse
           F-order ``(..., Nx, Ny, Nz)`` arrays are transposed here);
        2. the FV simulator, when ``label_source == "simulator"``;

        then re-sliced on the time axis by
        ``general_config["array_pipeline"]["slices"]`` (``process_array``)."""
        _, h = self.config_hash()
        sim_dir = os.path.join(self.kle_folder(), f"dat_files_{split}_{h}", "dynamic")
        data = None
        if os.path.isdir(sim_dir):
            res = self.reservoir_config
            data = run_pipeline_for_directory(sim_dir, shape=(res["Nx"], res["Ny"], res["Nz"]))
            if data is not None:
                data = {k: np.transpose(v, tuple(range(v.ndim - 3))
                                        + (v.ndim - 1, v.ndim - 2, v.ndim - 3))
                        for k, v in data.items()}
        if data is None and self.general_config.get("label_source") == "simulator":
            from srm_tpu_torch.sim import simulate_labels
            data = simulate_labels(self, split, permx=permx, times=times, device=self.device)
        if data is None:
            return None
        ap = self.general_config.get("array_pipeline") or {}
        if ap.get("slices") is not None:
            data = {k: process_array(v, slices=ap["slices"], slice_dim=ap.get("slice_dim", 1),
                                     reshape_dims=None) for k, v in data.items()}
        return data

    # -- full pipeline ----------------------------------------------------------
    def process_data(self):
        kle = self.generate_kle_splits()
        times = self.generate_time_tensor()
        grids = self.positional_grids()
        woven = {s: self.weave_split(kle[s], times[s], grids) for s in self.split_keys}

        # labels: in physics mode only the test split is simulated; in data
        # and mixed mode (physics_mode_fraction < 1) with simulator labels,
        # every split, so that the train labels and their statistics are real
        labels: Dict[str, Dict[str, np.ndarray]] = {}
        g = self.general_config
        sim_splits = (tuple(self.split_keys) if g.get("label_source") == "simulator"
                      and g["physics_mode_fraction"] < 1.0 else ("test",))
        for s in self.split_keys:
            sim = (self.simulation_labels(s, permx=kle[s], times=times[s])
                   if s in sim_splits else None)
            if sim is None:
                labels[s] = {k: np.zeros_like(woven[s][..., 0]) for k in self.label_keys()}
                continue
            # features and labels trimmed to their common (K, T)
            fk, fT = woven[s].shape[:2]
            lk, lT = next(iter(sim.values())).shape[:2]
            if (fk, fT) != (lk, lT):
                log.warning("split %r: aligning features (K=%d,T=%d) with labels (K=%d,T=%d) "
                            "— trimming both to the common extent", s, fk, fT, lk, lT)
            woven[s], labels[s] = align_and_trim_pair_lists(woven[s], sim, dims=(0, 1),
                                                            trim_target="both")

        # prediction split: test permeabilities at the unseen (late) times
        split_ratio_pred = copy.deepcopy(self.split_ratio)
        split_ratio_pred[0] = (0.0, 0.0, 1.0)
        _, _, pred_feats = split_tensor_sequence([woven["test"]], split_ratio_pred,
                                                 self.split_axis)
        _, _, pred_lbls = split_tensor_sequence([labels["test"]], split_ratio_pred,
                                                self.split_axis)

        # statistics from the train features only
        statistics = compute_statistics(woven["train"], FEATURE_KEYS)
        for k in self.label_keys():
            lab = labels["train"][k]
            statistics[k.lower()] = {"min": float(lab.min()), "max": float(lab.max()),
                                     "mean": float(lab.mean()), "std": float(lab.std()),
                                     "shape": list(lab.shape)}
        self.save_statistics(statistics)
        summary = DataSummary([statistics], dtype=self.dtype)
        norm_config = self.general_config["data_normalization"]
        groups = {s: [(normalize_channels(woven[s], summary, norm_config), labels[s])]
                  for s in self.split_keys}
        pred_groups = [(normalize_channels(pred_feats[0], summary, norm_config), pred_lbls[0])]
        return groups["train"], groups["val"], groups["test"], pred_groups

    # -- caching ----------------------------------------------------------------
    def save_statistics(self, statistics: Dict) -> str:
        _, h = self.config_hash()
        path = os.path.join(self.kle_folder(), f"training_statistics_summary_{h}.json")
        tmp = private_name(path)
        with open(tmp, "w") as f:
            json.dump(statistics, f, indent=2)
        os.replace(tmp, path)
        return path

    def load_training_statistics(self) -> Dict:
        _, h = self.config_hash()
        path = os.path.join(self.kle_folder(), f"training_statistics_summary_{h}.json")
        with open(path) as f:
            return json.load(f)

    def _cache_path(self) -> str:
        _, h = self.config_hash()
        return os.path.join(self.kle_folder(), f"training_data_{h}.npz")

    def get_or_generate_training_data(self):
        """(path, train_groups, val_groups, test_groups, pred_groups), cached
        by config hash in the reference's npz layout."""
        path = self._cache_path()
        if os.path.exists(path):
            try:
                # the payload is a pickled dict that this program (or the
                # reference package) wrote into its own cache directory
                with np.load(path, allow_pickle=True) as z:
                    payload = z["payload"].item()
                return (path, payload["train"], payload["val"], payload["test"],
                        payload["pred"])
            except (zipfile.BadZipFile, OSError, KeyError, EOFError) as e:
                log.warning("dataset cache %s unreadable (%s); regenerating", path, e)
                os.remove(path)
        tr, va, te, pr = self.process_data()
        payload = {"train": tr, "val": va, "test": te, "pred": pr}
        tmp = private_name(path, ".npz")    # np.savez appends .npz to other suffixes
        np.savez(tmp, payload=np.array(payload, dtype=object))
        os.replace(tmp, path)        # atomic publish
        return path, tr, va, te, pr
