"""Per-op breakdown of the FLOP count of one training step.

    python -m srm_tpu_torch.tools.flops_breakdown [--batch 32] [--nx 39]
        [--nz 10] [--realizations 8] [--remat] [--epoch] [--top 15]
        [--device cuda|cpu]

Port of the repo's ``tools/flops_breakdown.py``, which groups the StableHLO
``dot_general`` and ``convolution`` records of a lowered train step by
their type signature (``:27-49``). Here the step is the loss-and-gradient
evaluation that the trainer's step runs (``PhysicsLoss.pinn_batch_sse_grad``,
forward and backward, on the first ``--batch`` samples of the staged train
split), counted with ``torch.utils.flop_counter.FlopCounterMode``: every
operation that it counts (matmuls, convolutions and their backward,
attention) is grouped by its operator and its tensors' shapes and dtypes (a
transposed convolution marked ``T``), and the total and the ``--top``
largest groups are printed; with ``--epoch`` every step of one epoch over
the staged split (the JAX tool lowers its resident-epoch program).
Defaults as the JAX tool's (whose ``--production`` is always on): the DG 3D
production case (``apply_production_overrides``: bfloat16 networks and the
strided Model 2) at 39×39×10, 8 realizations with uncorrelated fields,
batch 32. It runs on the GPU unless ``--device cpu``.

Counting conventions differ from the JAX tool's (``srm_tpu/utils/flops.py``):
a transposed convolution counts its multiplies by the input's cells, where
the StableHLO count includes the zeros of its dilated input; the JAX
package's bilinear resize is a ``dot_general`` (counted there) and
PyTorch's an interpolation (not counted); elementwise work is counted by
neither.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the ``transposed`` argument's position in aten.convolution and
# aten.convolution_backward
_TRANSPOSED_ARG = {"convolution": 6, "convolution_backward": 7}


def _shapes(values) -> str:
    import torch
    dt = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
          torch.float64: "f64"}
    return ", ".join(f"({','.join(map(str, v.shape))}){dt.get(v.dtype, str(v.dtype))}"
                     for v in values if isinstance(v, torch.Tensor))


def signature(func_packet, args, out) -> str:
    """``op (input shapes) -> (output shapes)``, ``T`` after a transposed
    convolution's name."""
    name = func_packet.__name__
    pos = _TRANSPOSED_ARG.get(name)
    if pos is not None and len(args) > pos and args[pos]:
        name += " T"
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return f"{name} {_shapes(args)} -> {_shapes(outs)}"


def counter():
    """A ``FlopCounterMode`` that also keeps the FLOPs (``by_signature``)
    and calls (``calls``) of each :func:`signature`."""
    from torch.utils.flop_counter import FlopCounterMode

    class ByShape(FlopCounterMode):
        def __init__(self):
            super().__init__(display=False)
            self.by_signature = collections.Counter()
            self.calls = collections.Counter()

        def _count_flops(self, func_packet, out, args, kwargs):
            if func_packet in self.flop_registry:
                sig = signature(func_packet, args, out)
                self.by_signature[sig] += self.flop_registry[func_packet](*args, **kwargs,
                                                                         out_val=out)
                self.calls[sig] += 1
            return super()._count_flops(func_packet, out, args, kwargs)

    return ByShape()


def step_flops(loss_fn, x, y, batch=None):
    """The counter after ``pinn_batch_sse_grad`` on ``x, y``, in steps of
    ``batch`` samples (None: one step on all of them)."""
    batch = batch or x.shape[0]
    flops = counter()
    with flops:
        for i in range(0, x.shape[0] - batch + 1, batch):
            loss_fn.pinn_batch_sse_grad(x[i:i + batch], {k: v[i:i + batch] for k, v in y.items()})
    return flops


def breakdown(flops, top: int = 15) -> float:
    """Print the total and the ``top`` groups; returns the total."""
    total = flops.get_total_flops()
    print(f"total counted FLOPs: {total / 1e9:.2f} G")
    for sig, f in flops.by_signature.most_common(top):
        print(f"  {f / 1e9:12.3f} G  x{flops.calls[sig]:<4d} {sig[:160]}")
    return total


def build_case(nx=39, nz=10, realizations=8, remat=False, base_dir=None, device=None):
    """The JAX tool's case: DG production, uncorrelated fields."""
    from srm_tpu_torch.config import DEFAULT_GENERAL_CONFIG, apply_production_overrides
    from srm_tpu_torch.examples.common import setup_case

    g = apply_production_overrides(DEFAULT_GENERAL_CONFIG)
    if remat:
        g["remat_forwards"] = True
    return setup_case("DG", base_dir=base_dir or os.path.join(REPO, "_srm_data"), nx=nx,
                      nz=nz, n_realizations=realizations, kle_method="uncorrelated",
                      general_config=g, device=device)


def first_batch(case, batch=None):
    """The first ``batch`` samples (None: all) of the case's collapsed train
    split, on its device."""
    import torch

    from srm_tpu_torch.data.batching import collapse_groups
    x, y = collapse_groups(case["train_groups"])
    dev = case["device"]
    return (torch.from_numpy(x[:batch]).to(dev),
            {k: torch.from_numpy(v[:batch]).to(dev) for k, v in y.items()})


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(prog="python -m srm_tpu_torch.tools.flops_breakdown",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--nx", type=int, default=39)
    ap.add_argument("--nz", type=int, default=10)
    ap.add_argument("--realizations", type=int, default=8)
    ap.add_argument("--production", action="store_true", default=True,
                    help="the production profile (always on, as in the JAX tool)")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--epoch", action="store_true",
                    help="count every step of one epoch (default: one train step)")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--base-dir", default=None,
                    help="dataset cache directory (default: _srm_data in the checkout)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    case = build_case(args.nx, args.nz, args.realizations, args.remat, args.base_dir,
                      args.device)
    if args.epoch:
        x, y = first_batch(case)
        print(f"epoch of {x.shape[0] // args.batch} steps, batch={args.batch}")
        return breakdown(step_flops(case["loss_fn"], x, y, args.batch), args.top)
    x, y = first_batch(case, args.batch)
    print(f"train step (loss and gradient), batch={x.shape[0]}, features {tuple(x.shape)}")
    return breakdown(step_flops(case["loss_fn"], x, y), args.top)


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
