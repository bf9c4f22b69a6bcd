"""Time the FV simulator's dense solve under each linear-algebra backend.

    python -m srm_tpu_torch.tools.solve_backends [--reps 5]

The dense path solves one ``(chunk, N, N)`` float32 system per Picard sweep
(dry gas) or Newton iteration (gas condensate) at N = 1521 (39×39), chunk
16 (the JAX package's gas-condensate chunk 8 also timed; the simulator's
``_solve`` takes MAGMA at these sizes), and the 3D check solves one at N =
15,210. This assembles
each system as the simulator does (the default reservoir, log-normal
permeability from a seed, the face operator plus the accumulation on the
diagonal) and times ``torch.linalg.solve`` on it with CUDA events under
PyTorch's backends: its default choice, cuSOLVER, a loop of one-matrix
solves, the simulator's own ``_solve`` and MAGMA (where the build has it;
last, as its solve can fail at the 3D size). At batch 16 each backend also
solves the first 8 systems alone: ``first_8_bitwise`` says whether they
get the bits they get in the batch of 16 (whether the labels can depend on
the chunk). One JSON line per shape and backend, with the card's name and
power limit. GPU only.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess

import numpy as np
import torch


def system(c: int, nx: int, nz: int, seed: int = 0):
    """A dry-gas pressure system of ``c`` realizations, as one Picard sweep
    assembles it at the initial pressure."""
    from srm_tpu_torch.config import (DEFAULT_GENERAL_CONFIG, DEFAULT_RESERVOIR_CONFIG,
                                      DEFAULT_SCAL_CONFIG, DEFAULT_WELLS_CONFIG)
    from srm_tpu_torch.sim.fv_simulator import (_Setup, _split_face_grids, _stencil_diag,
                                                build_problem)

    res = copy.deepcopy(DEFAULT_RESERVOIR_CONFIG)
    res["Nx"] = res["Ny"] = nx
    res["Nz"] = nz
    prob, kscale = build_problem(res, DEFAULT_WELLS_CONFIG, DEFAULT_SCAL_CONFIG,
                                 DEFAULT_GENERAL_CONFIG)
    n = nx * nx * nz
    kx = torch.from_numpy(np.exp(np.random.default_rng(seed).normal(1.0, 0.5, (c, n)))
                          .astype(np.float32)).cuda()
    s = _Setup(prob, kscale, kx, np.array([0.0, 5.0], np.float32))
    Tf = s.G * (prob.krgo * 20.0)                 # a face mobility of the order of the PVT's
    acc = torch.full((c, n), 1e-2, device="cuda")
    diag = acc + _stencil_diag(s.grid(acc), *_split_face_grids(Tf, s.shape)).reshape(c, n)
    return s.assemble(Tf, diag), torch.randn(c, n, device="cuda")


def time_ms(fn, reps: int) -> float:
    fn()
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("solve_backends: no CUDA device; this measures the GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    from srm_tpu_torch.sim.fv_simulator import _solve

    def solver(backend, A_, b_):
        if backend == "looped":
            return lambda: torch.stack([torch.linalg.solve(a, v) for a, v in zip(A_, b_)])
        if backend == "simulator":
            return lambda: _solve(A_, b_)
        return lambda: torch.linalg.solve(A_, b_)

    previous = torch.backends.cuda.preferred_linalg_library()
    try:
        for c, nx, nz in ((16, 39, 1), (8, 39, 1), (1, 39, 10)):
            A, b = system(c, nx, nz)
            torch.backends.cuda.preferred_linalg_library("default")
            want = torch.linalg.solve(A.double(), b.double())
            for backend in ("default", "cusolver", "looped", "simulator", "magma"):
                torch.backends.cuda.preferred_linalg_library(
                    backend if backend in ("cusolver", "magma") else "default")
                fn = solver(backend, A, b)
                try:
                    x = fn()
                    reps = max(1, args.reps // (4 if nz > 1 else 1))
                    ms = time_ms(fn, reps)
                    alone = solver(backend, A[:8], b[:8])() if c == 16 else None
                except RuntimeError as e:         # a backend this build lacks, or fails
                    print(json.dumps({"shape": [c, A.shape[-1]], "backend": backend,
                                      "error": str(e).splitlines()[0]}), flush=True)
                    continue
                err = float(((x.double() - want).norm() / want.norm()))
                rec = {"shape": [c, A.shape[-1]], "backend": backend, "ms": ms,
                       "ms_per_matrix": ms / c, "rel_err_vs_f64": err, "card": card}
                if alone is not None:
                    rec.update(first_8_bitwise=bool(torch.equal(alone, x[:8])),
                               first_8_max_diff=float((alone - x[:8]).abs().max()))
                print(json.dumps(rec), flush=True)
            del A, b, want
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.preferred_linalg_library(previous)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
