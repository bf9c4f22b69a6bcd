"""Karhunen–Loève permeability realizations (host, numpy).

Port of the numpy half of ``srm_tpu/data/kle.py``: :func:`generate_kle_numpy`
(``kle.py:49``) and :func:`split_realizations` (``kle.py:153``), carried over
unchanged so that the same seed gives the same fields. A log-normal field
whose log is a Gaussian random field with exponential covariance, sampled
from truncated KL modes and conditioned at observed cells by simple kriging.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def _log_space_params(real_mean: float, real_std: float):
    sigma_log = float(np.sqrt(np.log(1.0 + (real_std / real_mean) ** 2)))
    mu_log = float(np.log(real_mean) - 0.5 * sigma_log**2)
    return mu_log, sigma_log


def _grid_points(Nx, Ny, Nz, Lx, Ly, Lz, dtype=np.float32):
    x = np.linspace(0, Lx, Nx, dtype=dtype)
    y = np.linspace(0, Ly, Ny, dtype=dtype)
    z = np.linspace(0, Lz, Nz, dtype=dtype)
    X, Y, Z = np.meshgrid(x, y, z, indexing="ij")
    pts = np.column_stack([X.ravel(), Y.ravel(), Z.ravel()]).astype(dtype)
    return pts, (X, Y, Z)


def _covariance(points: np.ndarray, corr_length: float, sigma: float) -> np.ndarray:
    d = np.sqrt(((points[:, None, :] - points[None, :, :]) ** 2).sum(-1))
    return (sigma**2) * np.exp(-d / corr_length)


def generate_kle_numpy(n_realizations: int, Nx=39, Ny=39, Nz=1,
                       Lx=2900.0, Ly=2900.0, Lz=80.0,
                       real_mean=3.0, real_std=1.5,
                       corr_length_fac=0.2, energy_threshold=0.95,
                       seed: Optional[int] = 2000, reverse_order=True,
                       cond_values: Optional[Dict[Tuple[int, int, int], float]] = None,
                       dtype=np.float32):
    """KL sampler with the reference's math and RNG stream.

    Returns (fields, num_modes, grid): fields has shape (n, Nx, Ny, Nz), or
    (n, Nz, Ny, Nx) when ``reverse_order``.
    """
    rng = np.random.RandomState(seed)
    mu_log, sigma_log = _log_space_params(real_mean, real_std)
    corr_length = corr_length_fac * max(Lx, Ly, Lz)
    points, (X, Y, Z) = _grid_points(Nx, Ny, Nz, Lx, Ly, Lz, dtype)

    C = _covariance(points.astype(np.float64), corr_length, sigma_log)
    eigvals, eigvecs = np.linalg.eigh(C)
    eigvals = eigvals[::-1]
    eigvecs = eigvecs[:, ::-1]
    energy = np.cumsum(eigvals) / np.sum(eigvals)
    num_modes = int(np.searchsorted(energy, energy_threshold) + 1)
    eigvals = np.clip(eigvals[:num_modes], 0.0, None)
    eigvecs = eigvecs[:, :num_modes]
    sqrt_eig = np.sqrt(eigvals)

    xi = rng.randn(n_realizations, num_modes)
    log_fields = mu_log + xi * sqrt_eig[None, :] @ eigvecs.T  # (n, P)

    if cond_values:
        obs_idx, obs_logv = [], []
        for (i, j, k), val in cond_values.items():
            if 0 <= i < Nx and 0 <= j < Ny and 0 <= k < Nz:
                obs_idx.append(np.ravel_multi_index((i, j, k), dims=X.shape))
                obs_logv.append(np.log(val))
        if obs_idx:
            obs_idx = np.asarray(obs_idx)
            obs_logv = np.asarray(obs_logv)
            C_obs = C[np.ix_(obs_idx, obs_idx)]
            C_obs_inv = np.linalg.pinv(C_obs)
            C_all_obs = C[:, obs_idx]
            resid = obs_logv[None, :] - log_fields[:, obs_idx]       # (n, m)
            log_fields = log_fields + resid @ C_obs_inv.T @ C_all_obs.T

    fields = np.exp(log_fields).reshape(n_realizations, Nx, Ny, Nz).astype(dtype)
    grid = (X, Y, Z)
    if reverse_order:
        fields = np.transpose(fields, (0, 3, 2, 1))  # (n, Nz, Ny, Nx)
        grid = tuple(np.transpose(g, (2, 1, 0)) for g in grid)
    return fields, num_modes, grid


def split_realizations(fields: np.ndarray, split_ratio=(0.3, 0.0, 0.7),
                       method: str = "random", seed: int = 2000):
    """Split realizations into train/val/test along axis 0."""
    n = fields.shape[0]
    idx = np.arange(n)
    if method == "random":
        rng = np.random.RandomState(seed)
        rng.shuffle(idx)
    n_train = int(round(n * split_ratio[0]))
    n_val = int(round(n * split_ratio[1]))
    tr, va, te = idx[:n_train], idx[n_train:n_train + n_val], idx[n_train + n_val:]
    return {
        "train": fields[np.sort(tr)], "val": fields[np.sort(va)], "test": fields[np.sort(te)],
        "indices": {"train": np.sort(tr), "val": np.sort(va), "test": np.sort(te)},
    }
