"""One rank of a data-parallel run of the port on the CPU, for
``tests/test_torch_parallel.py`` and ``tests/test_torch_isolation.py``.

    python tests/torch_parallel_ranks.py SPEC.json

Environment: ``RANK``, ``WORLD_SIZE`` and ``STORE`` (a file path: the gloo
group meets through a ``file://`` store, never a TCP port). ``SPEC.json``
holds ``out`` (a directory) and ``runs``, a list of scenarios (a function
of this module by name, and its inputs) that the rank runs in turn in one
process group; it writes their results, in order, to ``<out>/rank<r>.pt``.
Imports torch, numpy and the port only.
"""

from __future__ import annotations

import copy
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from srm_tpu_torch.config import (DEFAULT_GENERAL_CONFIG,  # noqa: E402
                                  apply_production_overrides)
from srm_tpu_torch.data.batching import collapse_groups  # noqa: E402
from srm_tpu_torch.examples.common import setup_case  # noqa: E402
from srm_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from srm_tpu_torch.training.trainer import Trainer, train_combined_models_unified  # noqa: E402


def _case(spec):
    """The spec's case on the CPU (with ``production``, the production
    preset; ``config``, settings over the default general config; with
    ``nz``, the 3D case of uncorrelated fields): its weights
    loaded (a file of state dicts by model name), its loss attributes set,
    in float64 if asked."""
    g = spec.get("general_config")
    if spec.get("production"):
        # the production preset, made here: its config's int keys do not
        # survive the spec's JSON
        g = apply_production_overrides(DEFAULT_GENERAL_CONFIG)
    if spec.get("config"):
        # settings over the default config, for the same reason
        g = {**copy.deepcopy(g or DEFAULT_GENERAL_CONFIG), **spec["config"]}
    case = setup_case(spec["fluid"], base_dir=spec["base_dir"], nx=spec["nx"],
                      n_realizations=spec["realizations"], general_config=g,
                      well_solver_kwargs=spec.get("well_solver_kwargs"), device="cpu",
                      nz=spec.get("nz"), kle_method="uncorrelated" if spec.get("nz") else None)
    if spec.get("weights"):
        for name, sd in torch.load(spec["weights"], weights_only=True).items():
            case["models"][name].load_state_dict(sd)
    for k, v in spec.get("loss_attrs", {}).items():
        setattr(case["loss_fn"], k, v)
    if spec.get("float64"):
        for name in ("pressure", "time_step", "saturation_model", "pvt_model"):
            if name in case["models"]:
                case["models"][name].double()
    return case


def _mesh(spec):
    """The spec's mesh: ``spatial`` (default 1) ranks of each space group."""
    return make_mesh(spatial=spec.get("spatial", 1))


def _weights(trainer):
    return {k: [p.detach().clone() for p in trainer.optimizers[k].params]
            for k in trainer.optimizer_keys}


def step(spec):
    """One train_step on the spec's global batch (an npz of ``x`` and
    ``y_<label>``; without one, the first ``batch_size`` training samples):
    the metrics, the gradients summed over the ranks, the updated weights
    and the well model's log directory, if any."""
    case = _case(spec)
    trainer = Trainer(case["loss_fn"], mesh=_mesh(spec))
    dtype = torch.float64 if spec.get("float64") else torch.float32
    if spec.get("batch"):
        with np.load(spec["batch"]) as z:
            x = torch.from_numpy(z["x"])
            y = {k[2:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("y_")}
    else:
        x, y = collapse_groups(case["train_groups"])
        bs = spec["batch_size"]
        x, y = torch.from_numpy(x[:bs]), {k: torch.from_numpy(v[:bs]) for k, v in y.items()}
    x, y = x.to(dtype), {k: v.to(dtype) for k, v in y.items()}
    metrics = {k: float(v) for k, v in trainer.train_step(x, y).items()}
    grads = {k: [g.clone() for g in v] for k, v in trainer._grad_views.items()}
    return {"metrics": metrics, "grads": grads, "weights": _weights(trainer),
            "logs": (spec.get("well_solver_kwargs") or {}).get("log_dir")}


def epochs(spec):
    """Two resident epochs at ``batch_size`` (seed 3; their first
    ``steps`` steps, where given), then the JAX trainer's host-batched train
    and eval epochs on as many staged batches in order (the staged data in
    float64 with a float64 case): each one's per-step metrics, and the
    weights after all."""
    case = _case(spec)
    trainer = Trainer(case["loss_fn"], seed=3, mesh=_mesh(spec))
    trainer.stage_dataset("train", case["train_groups"], spec["batch_size"])
    x_all, y_all, nb, bs = trainer._resident["train"]
    if spec.get("float64"):
        x_all, y_all = x_all.double(), {k: v.double() for k, v in y_all.items()}
        trainer._resident["train"] = (x_all, y_all, nb, bs)
    nb = min(nb, spec.get("steps", nb))
    out = {"resident": [trainer.train_epoch_resident("train", steps=nb) for _ in range(2)]}
    # the host epochs take the whole batches (each rank its block of them)
    x_np, y_np = collapse_groups(case["train_groups"])
    dtype = x_all.dtype
    xs = torch.from_numpy(x_np[:nb * bs]).to(dtype).reshape((nb, bs) + x_np.shape[1:])
    ys = {k: torch.from_numpy(v[:nb * bs]).to(dtype).reshape((nb, bs) + v.shape[1:])
          for k, v in y_np.items()}
    out["host"] = trainer.train_epoch(xs, ys)
    out["eval"] = trainer.eval_epoch(xs, ys)
    out["weights"] = _weights(trainer)
    return out


def net_module(c):
    """A case's network in float64 with its state dict, if any: a model of the
    model map (``pressure``, ``time_step``; ``general_config``), or an
    ``encoder_decoder`` (built from ``config``) or a ``residual`` net (the
    constructor's ``config``) on the sample shape's channels."""
    from srm_tpu_torch.nn.encoder_decoder import EncoderDecoder
    from srm_tpu_torch.nn.modules import build_pressure_model, build_time_step_model
    from srm_tpu_torch.nn.residual import ResidualNetwork
    shape = tuple(c["sample_shape"])
    if c["model"] == "encoder_decoder":
        model = EncoderDecoder.from_config(c["config"], shape[-1], grid=shape[1:-1])
    elif c["model"] == "residual":
        model = ResidualNetwork(shape[-1], **c["config"])
    else:
        res = {"Nz": shape[1] if len(shape) == 5 else 1, "initialization": {"Pi": 5000.0}}
        g = {"maximum_srm_timestep": 10.0, **c.get("general_config", {})}
        model = (build_pressure_model(shape, g, res) if c["model"] == "pressure"
                 else build_time_step_model(shape, g))
    model = model.double()
    if c.get("state"):
        model.load_state_dict(c["state"])
    return model


def nets(spec):
    """The networks of ``spec["file"]`` (``torch.save``d cases: a network of
    :func:`net_module`, its sample shape, its state dict, an input batch,
    an output cotangent, in float64, and the forward's keyword arguments
    ``kwargs``; with ``seeds``, a generator seeded with this space rank's
    seed) on this rank's rows of H, over a space axis of ``spatial`` ranks:
    each case's output rows, input-gradient rows and parameter gradients
    (this rank's part of their sum)."""
    from srm_tpu_torch.parallel.halo import Rows
    mesh = _mesh(spec)
    out = []
    for c in torch.load(spec["file"], weights_only=False):
        model = net_module(c)
        kwargs = dict(c.get("kwargs", {}))
        if c.get("seeds"):
            kwargs["generator"] = torch.Generator().manual_seed(c["seeds"][mesh.space_rank])
        h = c["x"].dim() - 3
        rows = Rows.split(mesh, c["x"].shape[h])
        sl = (slice(None),) * h + (slice(rows.lo, rows.hi),)
        x = c["x"][sl].clone().requires_grad_()
        y = model(x, rows=rows, **kwargs)
        (y * c["w"][sl]).sum().backward()
        out.append({"rows": (rows.lo, rows.hi), "y": y.detach(), "gx": x.grad,
                    "gp": [p.grad for p in model.parameters()]})
    return out


def pads(spec):
    """The ghost-cell pads of ``spec["file"]``'s fields (a (B, H, W) or
    (B, D, H, W) float64 field ``f`` and five per-cell weight fields ``w``)
    on this rank's rows of H over a space axis of ``spatial`` ranks: each
    field's padded block, the 5-point combination of it that the test takes
    of ``jnp.pad`` on the whole grid, and the gradient of its sum, twice."""
    from srm_tpu_torch.ops.stencil import pad_symmetric, pad_symmetric_3d
    from srm_tpu_torch.parallel.halo import Rows
    mesh = _mesh(spec)
    out = []
    for c in torch.load(spec["file"], weights_only=False):
        f, w = c["f"], c["w"]
        rows = Rows.split(mesh, f.shape[-2])
        f, w = f[..., rows.lo:rows.hi, :], w[..., rows.lo:rows.hi, :]
        pad = pad_symmetric_3d if f.dim() == 4 else pad_symmetric
        inner = (slice(1, -1),) * (f.dim() - 3)

        def cells(p):
            def at(dj, di):
                return p[(slice(None),) + inner + (slice(1 + dj, p.shape[-2] - 1 + dj),
                                                  slice(1 + di, p.shape[-1] - 1 + di))]
            return (at(0, 0) * w[0] + at(1, 0) * w[1] + at(-1, 0) * w[2] + at(0, 1) * w[3]
                    + at(0, -1) * w[4])

        grads = []
        for _ in range(2):
            x = f.clone().requires_grad_()
            padded = pad(x, rows)
            y = cells(padded)
            y.sum().backward()
            grads.append(x.grad)
        out.append({"rows": (rows.lo, rows.hi), "padded": padded.detach(),
                    "cells": y.detach(), "grad": grads[0], "grad_again": grads[1]})
    return out


class _Crash(Exception):
    pass


def _crash_after_first_epoch(epoch):
    if epoch == 0:
        raise _Crash


def resume(spec):
    """Three epochs with a checkpoint each, crashed after the first and
    resumed, and three uninterrupted ones, from the same weights."""
    def run(ckpt, **kw):
        case = _case(spec)
        trainer, history, _ = train_combined_models_unified(
            case["train_groups"], case["val_groups"], case["loss_fn"],
            training_batch_size=spec["batch_size"], epochs=3, verbose=0,
            checkpoint_dir=os.path.join(spec["dir"], ckpt), **kw)
        return _weights(trainer), history["step_total_loss"]

    try:
        run("ckpt", callbacks=[_crash_after_first_epoch])
    except _Crash:
        pass
    resumed, resumed_losses = run("ckpt", resume=True)
    whole, whole_losses = run("whole")
    return {"resumed": resumed, "whole": whole, "losses": (resumed_losses, whole_losses),
            "files": sorted(os.listdir(os.path.join(spec["dir"], "ckpt")))}


def crash(spec):
    """Two epochs whose callback raises after the first, on every rank, and
    nothing catches it: the rank leaves through the driver's clean-up and
    the group's end with the error."""
    case = _case(spec)
    train_combined_models_unified(case["train_groups"], case["val_groups"], case["loss_fn"],
                                  training_batch_size=spec["batch_size"], epochs=2, verbose=0,
                                  callbacks=[_crash_after_first_epoch])


def setup(spec):
    """Set up a case in an uncached ``base_dir``: every split's arrays."""
    case = setup_case(spec["fluid"], base_dir=spec["base_dir"], nx=spec["nx"],
                      n_realizations=spec["realizations"], device="cpu")
    return {s: case[f"{s}_groups"] for s in ("train", "val", "test")}


def loaded(spec):
    """The modules of JAX or of the JAX package that this process loaded."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "srm_tpu"))


def main() -> int:
    torch.set_num_threads(1)
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group("gloo", init_method=f"file://{os.environ['STORE']}",
                            rank=rank, world_size=world)
    try:
        if make_mesh().size != world:
            raise AssertionError(f"the mesh is not the {world} ranks' group")
        out = [globals()[run["scenario"]](run) for run in spec["runs"]]
        torch.save(out, os.path.join(spec["out"], f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
