"""Data generation of the port against the JAX package's: the KLE dataset
factory (byte-identical file trees from the same configuration) and the
on-device KLE sampler ``generate_kle_torch`` against ``generate_kle_jax``
(on the CPU here): the mode count, the truncated covariance operator, the
sampling step fed the JAX package's eigenpairs and ξ, the conditioned
cells and the log-field mean."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srm_tpu.data.kle import generate_kle_jax
from srm_tpu.data.kle_generator import KLConfig as JaxKLConfig
from srm_tpu.data.kle_generator import (
    generate_and_save_realizations as jax_generate_and_save_realizations,
)
from srm_tpu_torch.data import kle
from srm_tpu_torch.data.kle_generator import KLConfig, generate_and_save_realizations

# an 8×6 grid whose 0.95 energy cut falls between eigenvalues 1.3% apart
# (asserted below): no degenerate cluster is split, so the truncated
# operator V diag(λ) Vᵀ is defined by the grid alone
GRID = dict(Nx=8, Ny=6, Nz=1, Lx=100.0, Ly=100.0, Lz=10.0, real_mean=3.0, real_std=1.5)
COND = {(3, 2, 0): 2.0}
# float32 eigendecompositions of LAPACK (torch) and of XLA (jax) on a
# covariance whose largest entry is σ² ≈ 0.22: the operator agrees to
# ~1e-6 of it; the bound leaves room
OPERATOR_REL = 1e-4
# the sampling step alone, both in float32 from the same eigenpairs and ξ:
# matmul orders of two libraries
FIELDS_REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.mark.parametrize("write_dat", [True, False])
def test_dataset_factory_trees_are_byte_identical(tmp_path, write_dat):
    """8×8, 6 realizations, one conditioned cell: grids, splits, summaries,
    split_info and the PERMX decks, byte for byte."""
    kw = dict(n_realizations=6, Nx=8, Ny=8, Nz=1, Lx=100.0, Ly=100.0, Lz=10.0,
              conditional_values={(3, 3, 0): 2.0}, split_ratio=(0.5, 0.0, 0.5))
    ft = generate_and_save_realizations(KLConfig(**kw), base_dir=str(tmp_path / "port"),
                                        write_dat_files=write_dat)
    fj = jax_generate_and_save_realizations(JaxKLConfig(**kw), base_dir=str(tmp_path / "jax"),
                                            write_dat_files=write_dat)
    assert os.path.relpath(ft, tmp_path / "port") == os.path.relpath(fj, tmp_path / "jax")
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(got) == sorted(want)
    assert sum(p.endswith(".dat") for p in want) == (6 if write_dat else 0)
    for path in want:
        assert got[path] == want[path], path


def test_config_from_reservoir_config_matches():
    assert KLConfig.from_reservoir_config() == KLConfig(
        **{f: getattr(JaxKLConfig.from_reservoir_config(), f)
           for f in JaxKLConfig.__dataclass_fields__})


def _jax_modes(**grid):
    """The eigenpairs, covariance and mode count of generate_kle_jax,
    computed by its own operations (srm_tpu/data/kle.py:113-128)."""
    mu_log, sigma_log = kle._log_space_params(grid["real_mean"], grid["real_std"])
    corr = 0.2 * max(grid["Lx"], grid["Ly"], grid["Lz"])
    pts_np, _ = kle._grid_points(grid["Nx"], grid["Ny"], grid["Nz"], grid["Lx"], grid["Ly"],
                                 grid["Lz"], np.float32)
    pts = jnp.asarray(pts_np)
    d = jnp.sqrt(jnp.maximum(((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1), 0.0))
    C = (sigma_log**2) * jnp.exp(-d / corr)
    w, v = jnp.linalg.eigh(C)
    w, v = w[::-1], v[:, ::-1]
    energy = jnp.cumsum(w) / jnp.sum(w)
    m = int(jnp.searchsorted(energy, 0.95)) + 1
    return mu_log, np.array(C), np.array(w), np.array(v), m


def test_mode_count_and_truncated_operator_match():
    """The same mode count as generate_kle_jax, the eigen-gap at the cut
    asserted (float64 eigenvalues), and V diag(λ) Vᵀ within OPERATOR_REL of
    its largest entry (eigenvectors are fixed only up to sign and rotation
    inside a cluster: the operator is not)."""
    _, fm = generate_kle_jax(jax.random.PRNGKey(0), 4, **GRID)
    _, tm = kle.generate_kle_torch(4, device="cpu", **GRID)
    _, C, w, v, m = _jax_modes(**GRID)
    assert tm == fm == m
    w64 = np.linalg.eigvalsh(C.astype(np.float64))[::-1]
    e64 = np.cumsum(w64) / w64.sum()
    assert (w64[m - 1] - w64[m]) / w64[m - 1] > 1e-2          # no cluster at the cut
    assert e64[m - 2] < 0.95 - 1e-3 and e64[m - 1] > 0.95 + 1e-3
    mu_log, sigma_log = kle._log_space_params(3.0, 1.5)
    Ct, sqrt_eig, modes = kle._kle_modes((8, 6, 1), (100.0, 100.0, 10.0), sigma_log, 20.0,
                                         0.95, "cpu")
    np.testing.assert_allclose(Ct.numpy(), C, rtol=0, atol=1e-7)
    got = (modes * sqrt_eig**2) @ modes.T
    want = (v[:, :m] * w[:m]) @ v[:, :m].T
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= OPERATOR_REL * scale


@pytest.mark.parametrize("cond", [None, COND])
def test_sampling_step_fed_jax_eigenpairs_and_xi(cond):
    """The sampling step (fields from eigenpairs and ξ, with the kriging
    step) fed the JAX package's eigenpairs and its jax.random ξ gives
    generate_kle_jax's fields within FIELDS_REL."""
    key = jax.random.PRNGKey(3)
    want, m = generate_kle_jax(key, 16, cond_values=cond, **GRID)
    mu_log, C, w, v, m2 = _jax_modes(**GRID)
    assert m2 == m
    xi = np.array(jax.random.normal(key, (16, m), dtype=jnp.float32))
    sqrt_eig = np.sqrt(np.clip(w[:m], 0.0, None))
    got = kle._kle_fields(torch.from_numpy(C), torch.from_numpy(sqrt_eig),
                          torch.from_numpy(np.ascontiguousarray(v[:, :m])), torch.from_numpy(xi),
                          mu_log, (8, 6, 1), cond, reverse_order=True)
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape == (16, 1, 6, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=FIELDS_REL, atol=0)


def test_conditioned_cells_and_log_mean():
    """Conditioned cells equal their values to float32 rounding; over 4,096
    draws the log-field mean lies within 5 standard errors of μ_log (the
    standard error from the covariance's mean, an upper bound for the
    truncated field's); a seeded generator repeats its draws."""
    f, m = kle.generate_kle_torch(64, cond_values=COND, device="cpu", seed=1, **GRID)
    np.testing.assert_allclose(f[:, 0, 2, 3].numpy(), 2.0, rtol=2 * np.finfo(np.float32).eps)
    n = 4096
    gen = torch.Generator().manual_seed(5)
    f, _ = kle.generate_kle_torch(n, generator=gen, device="cpu", **GRID)
    again, _ = kle.generate_kle_torch(n, generator=torch.Generator().manual_seed(5),
                                      device="cpu", **GRID)
    assert torch.equal(f, again)
    mu_log, sigma_log = kle._log_space_params(3.0, 1.5)
    _, C, _, _, _ = _jax_modes(**GRID)
    se = np.sqrt(C.astype(np.float64).mean() / n)
    assert abs(float(torch.log(f).double().mean()) - mu_log) < 5 * se
    assert bool((f > 0).all()) and f.dtype == torch.float32


def test_generate_kle_torch_runs_on_the_gpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        kle.generate_kle_torch(4, **GRID)
