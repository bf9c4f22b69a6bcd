"""Time the simulator's labels at several chunk sizes.

    python -m srm_tpu_torch.tools.label_chunks [--fluid GC] [--chunks 8 16]
        [--realizations K] [--times T] [--base-dir DIR]

``simulate_labels`` runs the realizations of a split in chunks
(``SRM_TPU_SIM_CHUNK``, default 16; the JAX package takes 8 for gas
condensate): each dense Picard sweep or Newton iteration solves one
``(chunk, N, N)`` system. This runs
the labels of the default case's test split (200 realizations: 140 test
realizations at 39×39, or its first ``--realizations`` realizations and
first ``--times`` times) once per chunk size under that environment
override, on the card, and prints one JSON line: each chunk's seconds
(host clock around the synchronised call) and whether the labels are
bitwise equal across chunk sizes, with the card's name and power limit.
GPU only.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time


def compare(processor, permx, times, chunks=(8, 16)) -> dict:
    """``simulate_labels`` of ``processor``'s test split on ``permx`` and
    ``times`` under ``SRM_TPU_SIM_CHUNK`` = each of ``chunks``, on the
    processor's device: the seconds of each and whether every label is
    bitwise equal across them."""
    import torch

    from srm_tpu_torch.sim import simulate_labels

    on_cuda = torch.device(processor.device).type == "cuda"
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    before = os.environ.get("SRM_TPU_SIM_CHUNK")
    seconds, labels = {}, {}
    try:
        for chunk in chunks:
            os.environ["SRM_TPU_SIM_CHUNK"] = str(chunk)
            sync()
            t0 = time.perf_counter()
            labels[chunk] = simulate_labels(processor, "test", permx=permx, times=times)
            sync()
            seconds[chunk] = time.perf_counter() - t0
    finally:
        if before is None:
            os.environ.pop("SRM_TPU_SIM_CHUNK", None)
        else:
            os.environ["SRM_TPU_SIM_CHUNK"] = before
    first = labels[chunks[0]]
    bitwise = all(first[k].tobytes() == out[k].tobytes() for out in labels.values() for k in first)
    return {"realizations": int(permx.shape[0]), "times": int(times.size),
            "seconds": {str(c): s for c, s in seconds.items()}, "bitwise_equal": bitwise,
            "shapes": {k: list(v.shape) for k, v in first.items()}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m srm_tpu_torch.tools.label_chunks",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--fluid", default="GC", type=str.upper, choices=["DG", "GC"])
    ap.add_argument("--chunks", type=int, nargs="+", default=[8, 16])
    ap.add_argument("--realizations", type=int, default=None,
                    help="the first K test realizations (default: all)")
    ap.add_argument("--times", type=int, default=None,
                    help="the first T test times (default: all)")
    ap.add_argument("--base-dir", default=None,
                    help="dataset cache directory (default: a temporary one)")
    args = ap.parse_args(argv)

    import copy

    import torch

    from srm_tpu_torch.config import DEFAULT_GENERAL_CONFIG
    from srm_tpu_torch.data.dataset import SRMDataProcessor
    if not torch.cuda.is_available():
        raise SystemExit("label_chunks: no CUDA device is available; it measures a GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    g = copy.deepcopy(DEFAULT_GENERAL_CONFIG)
    g["fluid_type"] = args.fluid
    g["label_source"] = "simulator"
    with tempfile.TemporaryDirectory(prefix="label_chunks_") as tmp:
        proc = SRMDataProcessor(base_dir=args.base_dir or tmp, general_config=g, device="cuda")
        permx = proc.generate_kle_splits()["test"][:args.realizations]
        times = proc.generate_time_tensor()["test"].reshape(-1)[:args.times]
        result = {"card": card, "fluid": args.fluid, "chunks": args.chunks,
                  **compare(proc, permx, times, tuple(args.chunks))}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    sys.exit(0 if main()["bitwise_equal"] else 1)
