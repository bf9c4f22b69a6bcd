"""Time and check the on-device KLE sampler (``data.kle.generate_kle_torch``).

    python -m srm_tpu_torch.tools.kle_sampler [--nx 39] [--nz 1] [--realizations 200]
                                              [--reps 2] [--numpy] [--device cuda]

One call builds the (P, P) float32 covariance of the P = nx·nx·nz grid
points on the device, eigendecomposes it (``torch.linalg.eigh``), reads the
mode count on the host and samples every realization in one matmul. Each
of ``--reps`` calls is timed on the host clock (the card synchronised) and
with CUDA events; the first includes the solver's setup. The fields are
checked against their statistics, over every draw and cell of the log
field (no conditioning): the mean within 5 standard errors of μ_log (the
standard error from the float64 covariance's mean) and the pooled
variance within 5 standard errors of the kept energy × σ² (the standard
error from the mean of the squared covariance). ``--numpy`` also runs the
host sampler's float64 eigendecomposition (``generate_kle_numpy``, as the
dataset and ``generate-data`` use it) and reports both mode counts. One
JSON line last, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch


def _host_covariance(nx: int, nz: int, lengths, sigma_log: float, corr: float) -> np.ndarray:
    from srm_tpu_torch.data.kle import _covariance, _grid_points
    pts, _ = _grid_points(nx, nx, nz, *lengths, np.float32)
    return _covariance(pts.astype(np.float64), corr, sigma_log)


def run(nx: int = 39, nz: int = 1, realizations: int = 200, reps: int = 2,
        numpy_modes: bool = False, device="cuda", seed: int = 0) -> dict:
    """The sampler's times, mode count and statistics (see the module)."""
    from srm_tpu_torch.config import DEFAULT_RESERVOIR_CONFIG
    from srm_tpu_torch.data.kle import _log_space_params, generate_kle_numpy, generate_kle_torch

    res = DEFAULT_RESERVOIR_CONFIG
    spec = res["realizations"]["permx"]
    lengths = (res["length"], res["width"], res["thickness"])
    kw = dict(Nx=nx, Ny=nx, Nz=nz, Lx=lengths[0], Ly=lengths[1], Lz=lengths[2],
              real_mean=spec["mean"], real_std=spec["std"],
              corr_length_fac=spec["correlation_length_factor"],
              energy_threshold=spec["energy_threshold"])
    device = torch.device(device)
    cuda = device.type == "cuda"
    host_s, event_ms = [], []
    for r in range(reps):
        gen = torch.Generator(device=device).manual_seed(seed)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
        t0 = time.perf_counter()
        fields, modes = generate_kle_torch(realizations, generator=gen, device=device, **kw)
        if cuda:
            end.record()
            torch.cuda.synchronize()
            event_ms.append(start.elapsed_time(end))
        host_s.append(time.perf_counter() - t0)
        if r == 0:
            first = fields
        elif not torch.equal(fields, first):
            raise AssertionError("two calls from the same seed drew different fields")
    out = {"grid": [nz, nx, nx], "points": nx * nx * nz, "realizations": realizations,
           "num_modes": modes, "host_s": host_s, "event_ms": event_ms or None,
           "peak_alloc_mib": torch.cuda.max_memory_allocated() / 2**20 if cuda else None}
    if tuple(fields.shape) != (realizations, nz, nx, nx) or not bool(torch.isfinite(fields).all()):
        raise AssertionError(f"fields of shape {tuple(fields.shape)}, finite "
                             f"{bool(torch.isfinite(fields).all())}")

    # statistics of the log field against the float64 covariance
    mu_log, sigma_log = _log_space_params(spec["mean"], spec["std"])
    corr = spec["correlation_length_factor"] * max(lengths)
    C = _host_covariance(nx, nz, lengths, sigma_log, corr)
    logf = torch.log(fields.double()).reshape(realizations, -1)
    mean = float(logf.mean())
    pooled_var = float(logf.var(dim=0).mean())
    se_mean = float(np.sqrt(C.mean() / realizations))
    out.update(log_mean=mean, mu_log=mu_log, mean_bound=5 * se_mean)
    if numpy_modes or nz == 1:
        w = np.linalg.eigvalsh(C)[::-1]
        kept = float(w[:modes].sum() / w.sum())
        se_var = float(np.sqrt(2.0 * (C**2).mean() / (realizations - 1)))
        out.update(pooled_var=pooled_var, want_var=kept * sigma_log**2, var_bound=5 * se_var)
        if abs(pooled_var - kept * sigma_log**2) > 5 * se_var:
            raise AssertionError(f"pooled log variance {pooled_var} against {kept * sigma_log**2}"
                                 f" ± {5 * se_var}")
    if abs(mean - mu_log) > 5 * se_mean:
        raise AssertionError(f"log-field mean {mean} against {mu_log} ± {5 * se_mean}")
    if numpy_modes:
        t0 = time.perf_counter()
        _, host_modes, _ = generate_kle_numpy(1, seed=seed, **kw)
        out.update(numpy_modes=host_modes, numpy_s=time.perf_counter() - t0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--nx", type=int, default=39)
    ap.add_argument("--nz", type=int, default=1)
    ap.add_argument("--realizations", type=int, default=200)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--numpy", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    out = run(args.nx, args.nz, args.realizations, args.reps, args.numpy, args.device)
    if args.device == "cuda":
        out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                      "--format=csv,noheader"], capture_output=True,
                                     text=True).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
