"""MFU probe: the encoder–decoder's forward and backward alone, under each
candidate lever, with its FLOPs, time and share of the card's named peak.

    python -m srm_tpu_torch.tools.mfu_probe [--nz 10] [--batch 32] [--nx 39]
        [--case NAME ...] [--device cuda|cpu]

Port of the repo's ``tools/mfu_probe.py``, with its levers (each against
the shipped geometry):

* ``base``       — the shipped config (channels 32/48/72/108), float32
* ``bf16``       — ``compute_dtype="bfloat16"``
* ``mixed``      — bfloat16 with a float32 input conv and output head
                   (``f32_io``, the ``precision_policy="mixed"`` networks)
* ``pad40``, ``pad48`` — the input zero-padded 39 → 40 or 48 at the ends of
                   height and width, the output cropped back
* ``pad40_bf16`` — both
* ``wide``       — channels ×2 (64/96/144/216)
* ``wide_bf16``  — both
* ``batch2x``, ``batch2x_bf16`` — twice the batch

One step is the gradient of the sum of squares of the network's output with
respect to its parameters. Its FLOPs are ``torch.utils.flop_counter``'s
count of one step (convolutions and matmuls, forward and backward); its
time is ``profile_step.time_ms`` (CUDA events over back-to-back steps,
median of 5); ``mfu`` is the achieved FLOP/s over ``profile_step._rates``'
named peak: the H100's dense bfloat16 tensor-core rate (989 TFLOP/s) for
the bfloat16 levers, its float32 rate outside the tensor cores (67 TFLOP/s)
otherwise. Prints one JSON line per lever: ``case``, ``ms_per_step``,
``batch``, ``grid``, ``gflops``, ``tflops_per_s``, ``mfu`` and the peak's
name. With ``--device cpu`` it counts the FLOPs only: the time, the rate
and ``mfu`` are null (not measured). On ``cuda`` TF32 is off.

:func:`probe_two_nets` (the JAX tool's; ``main`` does not call it, as
there) asks whether two equal encoder–decoders, such as gas condensate's
pressure and saturation networks, run faster one after the other or as
one batched forward: ``torch.func.vmap`` over their parameters stacked by
``torch.func.stack_module_state``. Either way one step is the gradient of
the sum of both outputs' squares.
"""

from __future__ import annotations

import argparse
import json
import sys

BASE_WIDTH = (32, 1.5)
WIDE = (64, 1.5)


def levers(batch: int):
    """Each lever's keyword arguments of :func:`probe`, in the JAX tool's order."""
    bf16 = {"compute_dtype": "bfloat16"}
    return {
        "base": {},
        "bf16": bf16,
        "mixed": dict(bf16, f32_io=True),
        "pad40": {"pad_to": 40},
        "pad48": {"pad_to": 48},
        "pad40_bf16": dict(bf16, pad_to=40),
        "wide": {"width": WIDE},
        "wide_bf16": dict(bf16, width=WIDE),
        "batch2x": {"batch": 2 * batch},
        "batch2x_bf16": dict(bf16, batch=2 * batch),
    }


def network_config(nx: int = 39, nz: int = 1, width=BASE_WIDTH, compute_dtype=None,
                   f32_io: bool = False) -> dict:
    """The encoder–decoder config of a lever, as the JAX tool builds it."""
    from srm_tpu_torch.config import get_configuration
    cfg = get_configuration("encoder_decoder", input_shape=(1, nz, nx, nx, 1) if nz > 1 else None)
    cfg["spatial_dims"] = 3 if nz > 1 else 2
    cfg["temporal"] = False
    cfg["width"] = {"Bottom_Size": width[0], "Growth_Rate": width[1]}
    cfg["compute_dtype"] = compute_dtype
    cfg["f32_io"] = f32_io
    return cfg


def step_fn(model, x, nx: int, nz: int, pad_to=None):
    """The step: parameter gradients of sum(fwd(x)²), where fwd pads the
    input's height and width to ``pad_to`` (at their ends) and crops the
    output back."""
    import torch
    import torch.nn.functional as F

    params = [p for p in model.parameters() if p.requires_grad]

    def fwd(xx):
        if pad_to is None:
            return model(xx)
        d = pad_to - nx
        pads = (0, 0, 0, d, 0, d, 0, 0) if nz > 1 else (0, 0, 0, d, 0, d)
        y = model(F.pad(xx, pads))
        return y[:, :, :nx, :nx] if nz > 1 else y[:, :nx, :nx]

    def step():
        return torch.autograd.grad(torch.square(fwd(x)).sum(), params)

    return step


def step_flops(step) -> float:
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as flops:
        step()
    return float(flops.get_total_flops())


def probe(case_name: str, *, batch: int = 32, nx: int = 39, nz: int = 1, width=BASE_WIDTH,
          compute_dtype=None, f32_io: bool = False, pad_to=None, reps: int = 20,
          device="cuda") -> dict:
    """One lever: builds the network (weights from a seed), counts one
    step's FLOPs and, on a CUDA device, times it; prints and returns its
    JSON line (with the raw ``flops``)."""
    import torch

    from srm_tpu_torch.nn.encoder_decoder import EncoderDecoder
    from srm_tpu_torch.tools.profile_step import _rates, time_ms

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError('no usable CUDA device; pass device="cpu" to count FLOPs only')
    cfg = network_config(nx, nz, width, compute_dtype, f32_io)
    grid = (nz, nx, nx) if nz > 1 else (nx, nx)
    if pad_to is not None:
        grid = grid[:-2] + (pad_to, pad_to)
    model = EncoderDecoder.from_config(cfg, 5, generator=torch.Generator().manual_seed(1),
                                       grid=grid).to(dev)
    shape = (batch, nz, nx, nx, 5) if nz > 1 else (batch, nx, nx, 5)
    x = (torch.rand(shape, generator=torch.Generator().manual_seed(0)) * 2 - 1).to(dev)
    step = step_fn(model, x, nx, nz, pad_to)
    flops = step_flops(step)
    out = {"case": case_name, "ms_per_step": None, "batch": batch, "grid": f"{nx}x{nx}x{nz}",
           "gflops": round(flops / 1e9, 2), "tflops_per_s": None, "mfu": None,
           "peak": None, "flops": flops, "device": str(dev)}
    if dev.type == "cuda":
        ms = time_ms(step, repeats=5, calls=reps)
        rates = _rates(flops, 1e3 / ms, compute_dtype == "bfloat16")
        out.update(ms_per_step=round(ms, 3),
                   tflops_per_s=round(rates["achieved_flop_per_s"] / 1e12, 2),
                   mfu=round(rates["achieved_share_of_peak"], 4), peak=rates["peak_name"],
                   device=torch.cuda.get_device_name(dev))
    print(json.dumps(out), flush=True)
    return out


def two_nets(*, batch: int = 32, nx: int = 39, nz: int = 1, compute_dtype=None,
             device="cuda"):
    """Two encoder–decoders of the default config (weights from seeds 1
    and 2) and an input batch (seed 0) on ``device``."""
    import torch

    from srm_tpu_torch.nn.encoder_decoder import EncoderDecoder
    dev = torch.device(device)
    cfg = network_config(nx, nz, compute_dtype=compute_dtype)
    grid = (nz, nx, nx) if nz > 1 else (nx, nx)
    nets = [EncoderDecoder.from_config(cfg, 5, generator=torch.Generator().manual_seed(seed),
                                       grid=grid).to(dev) for seed in (1, 2)]
    shape = (batch, nz, nx, nx, 5) if nz > 1 else (batch, nx, nx, 5)
    x = (torch.rand(shape, generator=torch.Generator().manual_seed(0)) * 2 - 1).to(dev)
    return nets, x


def two_nets_step(nets, x, stacked: bool):
    """The step of :func:`probe_two_nets`: a function returning the
    gradients of the sum of both networks' squared outputs, stacked as
    (2, ...) per parameter (in ``nets[0].parameters()``' order) either way,
    so that the two designs compare entry by entry."""
    import copy

    import torch
    if stacked:
        params, buffers = torch.func.stack_module_state(nets)
        leaves = [params[name].requires_grad_() for name, _ in nets[0].named_parameters()]
        template = copy.deepcopy(nets[0]).to("meta")

        def one(p, b, xx):
            return torch.func.functional_call(template, (p, b), (xx,))

        def step():
            y = torch.func.vmap(one, in_dims=(0, 0, None))(params, buffers, x)
            return torch.autograd.grad(torch.square(y).sum(), leaves)
    else:
        leaves = [list(net.parameters()) for net in nets]

        def step():
            loss = torch.square(nets[0](x)).sum() + torch.square(nets[1](x)).sum()
            grads = torch.autograd.grad(loss, leaves[0] + leaves[1])
            n = len(leaves[0])
            return tuple(torch.stack([a, b]) for a, b in zip(grads[:n], grads[n:]))
    return step


def probe_two_nets(case_name: str, *, batch: int = 32, nx: int = 39, nz: int = 1,
                   compute_dtype=None, stacked: bool = False, reps: int = 20,
                   device="cuda") -> dict:
    """Two equal encoder–decoders (:func:`two_nets`), one after the other or,
    with ``stacked``, as one ``vmap`` over their stacked parameters
    (:func:`two_nets_step`); on a CUDA device ``ms_per_step`` from CUDA
    events over back-to-back steps (median of 5), as :func:`probe` times;
    null on the CPU (not measured). Prints and returns its JSON line."""
    import torch

    from srm_tpu_torch.tools.profile_step import time_ms

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError('no usable CUDA device; pass device="cpu"')
    nets, x = two_nets(batch=batch, nx=nx, nz=nz, compute_dtype=compute_dtype, device=dev)
    step = two_nets_step(nets, x, stacked)
    step()
    out = {"case": case_name, "ms_per_step": None, "batch": batch, "grid": f"{nx}x{nx}x{nz}",
           "stacked": bool(stacked), "device": str(dev)}
    if dev.type == "cuda":
        out.update(ms_per_step=round(time_ms(step, repeats=5, calls=reps), 3),
                   device=torch.cuda.get_device_name(dev))
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(prog="python -m srm_tpu_torch.tools.mfu_probe",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--nz", type=int, default=1)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--nx", type=int, default=39)
    ap.add_argument("--case", action="append", choices=list(levers(1)),
                    help="the levers to run (default: all, in order)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    table = levers(args.batch)
    return [probe(name, **{"batch": args.batch, **table[name]}, nx=args.nx, nz=args.nz,
                  device=args.device)
            for name in args.case or table]


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
