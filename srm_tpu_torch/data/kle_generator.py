"""KLE realization dataset factory.

Port of ``srm_tpu/data/kle_generator.py``: generates KL permeability
realizations, splits them, and writes the on-disk dataset layout ::

    <base>/static_dynamic/KLE_{Nx}x{Ny}x{Nz}_R{n}_{hash}/
        grid.json, grid_x.npy, grid_y.npy, grid_z.npy
        realizations_{all,train,val,test}.npy  (+ _indices.npy)
        split_info.json, summary_{split}.json
        dat_files_{split}_{hash}/static/PERMX_{nnnn}.dat

The ``PERMX_nnnn.dat`` files are Eclipse-style keyword decks for an
external reservoir simulator, whose outputs the dataset parses into labels
(``dataset.py``, ``pipeline.py``); directory names carry the md5 config
hash, so a physics-config change gives a new dataset. The sampler is the
numpy one (``kle.generate_kle_numpy``, ``np.random.RandomState``) in both
packages, so the same configuration and seed give byte-identical files to
the JAX package's. This is host work in both packages: the on-device
sampler is ``kle.generate_kle_torch``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Dict, Optional, Tuple

import numpy as np

from srm_tpu_torch.config import (
    DEFAULT_GENERAL_CONFIG,
    DEFAULT_RESERVOIR_CONFIG,
    generate_full_config_hash,
)
from srm_tpu_torch.data.kle import generate_kle_numpy, split_realizations

log = logging.getLogger(__name__)


@dataclasses.dataclass
class KLConfig:
    """Generator settings."""

    n_realizations: int = 200
    Nx: int = 39
    Ny: int = 39
    Nz: int = 1
    Lx: float = 2900.0
    Ly: float = 2900.0
    Lz: float = 80.0
    mean: float = 3.0
    std: float = 1.5
    correlation_length_factor: float = 0.2
    energy_threshold: float = 0.95
    seed: int = 2000
    reverse_order: bool = True
    conditional_values: Optional[Dict[Tuple[int, int, int], float]] = None
    split_ratio: Tuple[float, float, float] = (0.3, 0.0, 0.7)
    split_method: str = "random"

    @classmethod
    def from_reservoir_config(cls, reservoir_config=None, general_config=None) -> "KLConfig":
        res = reservoir_config or DEFAULT_RESERVOIR_CONFIG
        g = general_config or DEFAULT_GENERAL_CONFIG
        spec = res["realizations"]["permx"]
        return cls(
            n_realizations=spec["number"], Nx=res["Nx"], Ny=res["Ny"], Nz=res["Nz"],
            Lx=res["length"], Ly=res["width"], Lz=res["thickness"],
            mean=spec["mean"], std=spec["std"],
            correlation_length_factor=spec["correlation_length_factor"],
            energy_threshold=spec["energy_threshold"],
            seed=spec.get("seed") or g["seed"],
            reverse_order=spec.get("reverse_order", True),
            conditional_values=spec.get("conditional_values"),
            split_ratio=tuple(g["split_ratio"][0]),
            split_method=g.get("split_sampling_method", "random"),
        )


def write_permx_dat(field: np.ndarray, path: str, values_per_line: int = 8) -> None:
    """Eclipse keyword deck: PERMX block in Fortran (i-fastest) order."""
    flat = np.transpose(field, (0, 1, 2)).reshape(-1)  # field is (Nz, Ny, Nx) → k,j,i order
    with open(path, "w") as f:
        f.write("PERMX\n")
        for i in range(0, flat.size, values_per_line):
            chunk = flat[i:i + values_per_line]
            f.write(" " + " ".join(f"{v:.6f}" for v in chunk) + "\n")
        f.write("/\n")


def generate_and_save_realizations(config: Optional[KLConfig] = None,
                                   base_dir: Optional[str] = None,
                                   write_dat_files: bool = True) -> str:
    """Generate, split, and persist the KLE dataset; returns the KLE folder."""
    from srm_tpu_torch.config import WORKING_DIRECTORY
    config = config or KLConfig.from_reservoir_config()
    base_dir = base_dir or WORKING_DIRECTORY

    name, h = generate_full_config_hash()
    folder = os.path.join(base_dir, "static_dynamic",
                          f"KLE_{config.Nx}x{config.Ny}x{config.Nz}_"
                          f"R{config.n_realizations}_{h}")
    os.makedirs(folder, exist_ok=True)

    fields, num_modes, grid = generate_kle_numpy(
        config.n_realizations, Nx=config.Nx, Ny=config.Ny, Nz=config.Nz,
        Lx=config.Lx, Ly=config.Ly, Lz=config.Lz,
        real_mean=config.mean, real_std=config.std,
        corr_length_fac=config.correlation_length_factor,
        energy_threshold=config.energy_threshold, seed=config.seed,
        reverse_order=config.reverse_order,
        cond_values=config.conditional_values)

    # grid files
    X, Y, Z = grid
    np.save(os.path.join(folder, "grid_x.npy"), X)
    np.save(os.path.join(folder, "grid_y.npy"), Y)
    np.save(os.path.join(folder, "grid_z.npy"), Z)
    with open(os.path.join(folder, "grid.json"), "w") as f:
        json.dump({"Nx": config.Nx, "Ny": config.Ny, "Nz": config.Nz,
                   "Lx": config.Lx, "Ly": config.Ly, "Lz": config.Lz,
                   "num_modes": int(num_modes)}, f, indent=2)

    # splits + per-split files
    splits = split_realizations(fields, config.split_ratio, config.split_method,
                                config.seed)
    np.save(os.path.join(folder, "realizations_all.npy"), fields)
    split_info = {"ratio": list(config.split_ratio), "method": config.split_method,
                  "seed": config.seed, "counts": {}}
    for split in ("train", "val", "test"):
        data = splits[split]
        idx = splits["indices"][split]
        np.save(os.path.join(folder, f"realizations_{split}.npy"), data)
        np.save(os.path.join(folder, f"realizations_{split}_indices.npy"), idx)
        split_info["counts"][split] = int(data.shape[0])
        with open(os.path.join(folder, f"summary_{split}.json"), "w") as f:
            json.dump({
                "count": int(data.shape[0]),
                "min": float(data.min()) if data.size else None,
                "max": float(data.max()) if data.size else None,
                "mean": float(data.mean()) if data.size else None,
                "std": float(data.std()) if data.size else None,
                "indices": idx.tolist(),
            }, f, indent=2)
        # Eclipse decks per realization
        if write_dat_files and data.size:
            dat_dir = os.path.join(folder, f"dat_files_{split}_{h}", "static")
            os.makedirs(dat_dir, exist_ok=True)
            for n in range(data.shape[0]):
                write_permx_dat(data[n], os.path.join(dat_dir, f"PERMX_{n:04d}.dat"))

    with open(os.path.join(folder, "split_info.json"), "w") as f:
        json.dump(split_info, f, indent=2)
    log.info("KLE dataset written to %s (%d modes)", folder, num_modes)
    return folder
