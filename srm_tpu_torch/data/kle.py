"""Karhunen–Loève permeability realizations.

Port of ``srm_tpu/data/kle.py``. A log-normal field whose log is a Gaussian
random field with exponential covariance, sampled from truncated KL modes
and conditioned at observed cells by simple kriging. Two samplers:

* :func:`generate_kle_numpy` (``kle.py:49``) and :func:`split_realizations`
  (``kle.py:153``), host numpy carried over unchanged, so that the same seed
  gives the same fields as the JAX package's (the dataset caches of the two
  packages are shared);
* :func:`generate_kle_torch`, the counterpart of ``generate_kle_jax``
  (``kle.py:102-150``): the covariance built on the device, its float32
  eigendecomposition there (``torch.linalg.eigh``), the mode count taken on
  the host once, and every realization sampled in one matmul from an
  explicit ``torch.Generator``. Same distribution, another random stream.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


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


def _observed(cond_values, Nx: int, Ny: int, Nz: int):
    """(flat indices, log values) of the conditioning cells inside the grid,
    raveled over (Nx, Ny, Nz) as the samplers' points are."""
    inside = [((i, j, k), v) for (i, j, k), v in (cond_values or {}).items()
              if 0 <= i < Nx and 0 <= j < Ny and 0 <= k < Nz]
    idx = [int(np.ravel_multi_index(ijk, dims=(Nx, Ny, Nz))) for ijk, _ in inside]
    return idx, [float(np.log(v)) for _, v in inside]


def _kle_fields(C: torch.Tensor, sqrt_eig: torch.Tensor, modes: torch.Tensor,
                xi: torch.Tensor, mu_log: float, grid: Tuple[int, int, int],
                cond_values=None, reverse_order: bool = True) -> torch.Tensor:
    """Fields from truncated eigenpairs and standard normals ``xi``
    (n, modes): the log-field ``mu + (xi·√λ) Vᵀ``, the simple-kriging step
    toward ``cond_values`` (pinv of the observed block of ``C``), then
    ``exp``, shaped (n, Nx, Ny, Nz) or (n, Nz, Ny, Nx) with
    ``reverse_order`` (``srm_tpu/data/kle.py:130-150``)."""
    Nx, Ny, Nz = grid
    n = xi.shape[0]
    log_fields = mu_log + (xi * sqrt_eig[None, :]) @ modes.T
    obs_idx, obs_logv = _observed(cond_values, Nx, Ny, Nz)
    if obs_idx:
        idx = torch.tensor(obs_idx, device=C.device)
        logv = torch.tensor(obs_logv, dtype=log_fields.dtype, device=C.device)
        C_obs_inv = torch.linalg.pinv(C[idx][:, idx])
        resid = logv[None, :] - log_fields[:, idx]
        log_fields = log_fields + resid @ C_obs_inv.T @ C[:, idx].T
    fields = torch.exp(log_fields).reshape(n, Nx, Ny, Nz)
    return fields.permute(0, 3, 2, 1) if reverse_order else fields


def _kle_modes(grid, lengths, sigma_log: float, corr_length: float, energy_threshold: float,
               device):
    """(C, √λ, V): the float32 covariance of the grid points on ``device``
    and its leading eigenpairs, as many as the energy threshold keeps
    (``srm_tpu/data/kle.py:117-128``; the count read on the host, once)."""
    points_np, _ = _grid_points(*grid, *lengths, np.float32)
    pts = torch.from_numpy(points_np).to(device)
    d = torch.sqrt(torch.clamp_min(((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1), 0.0))
    C = (sigma_log**2) * torch.exp(-d / corr_length)
    del d
    eigvals, eigvecs = torch.linalg.eigh(C)
    eigvals, eigvecs = eigvals.flip(0), eigvecs.flip(1)
    energy = torch.cumsum(eigvals, 0) / torch.sum(eigvals)
    thr = torch.tensor([energy_threshold], dtype=energy.dtype, device=device)
    num_modes = int(torch.searchsorted(energy, thr)[0]) + 1
    return C, torch.sqrt(torch.clamp_min(eigvals[:num_modes], 0.0)), eigvecs[:, :num_modes]


def generate_kle_torch(n_realizations: int, Nx=39, Ny=39, Nz=1,
                       Lx=2900.0, Ly=2900.0, Lz=80.0,
                       real_mean=3.0, real_std=1.5,
                       corr_length_fac=0.2, energy_threshold=0.95,
                       reverse_order=True,
                       cond_values: Optional[Dict[Tuple[int, int, int], float]] = None,
                       generator: Optional[torch.Generator] = None, seed: int = 0,
                       device=None, dtype=torch.float32):
    """On-device KL sampler; returns ``(fields, num_modes)`` with the fields
    a tensor on ``device``.

    The (P, P) covariance over the P = Nx·Ny·Nz grid points is built and
    eigendecomposed in float32 on ``device`` (None: ``"cuda"``; without a
    usable CUDA device the call raises, pass ``device="cpu"`` for the CPU).
    The mode count comes from the energy threshold, read on the host once.
    ξ is drawn from ``generator`` (a ``torch.Generator`` on ``device``; None:
    one seeded with ``seed``), all realizations in one matmul.
    """
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no usable CUDA device: the KLE sampler runs on the GPU by default; "
                           'pass device="cpu" to run it on the CPU')
    mu_log, sigma_log = _log_space_params(real_mean, real_std)
    C, sqrt_eig, modes = _kle_modes((Nx, Ny, Nz), (Lx, Ly, Lz), sigma_log,
                                    corr_length_fac * max(Lx, Ly, Lz), energy_threshold,
                                    device)
    num_modes = modes.shape[1]
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(int(seed))
    xi = torch.randn((n_realizations, num_modes), generator=generator, device=device,
                     dtype=dtype)
    fields = _kle_fields(C, sqrt_eig, modes, xi, mu_log, (Nx, Ny, Nz), cond_values,
                         reverse_order)
    return fields.to(dtype), num_modes


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
