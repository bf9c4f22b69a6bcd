"""Why the gas-condensate saturation head pins at the predict-Sgi floor.

    python -m srm_tpu_torch.tools.sg_head_probe [--epochs 10] [--batch 32]
        [--sat-act abs|softplus] [--base-dir DIR] [--device cuda|cpu]

Port of the repo's ``tools/sg_head_probe.py``. The hypothesis: the
saturation model's HardLayer squashes the network's output through its
input activation (``Sg = Sgi − alpha·softplus(net)`` by default); if
training drives the pre-activation far negative, softplus and its gradient
both vanish and the head is dead, whatever the label weighting.

It builds the GC drawdown case (FV labels on every split, mixed training
at a physics fraction of 0.5, balanced td errors, Pi 4,300 psia, BHP floor
2,000 psia; ``--sat-act`` sets the saturation HardLayer's activation),
trains it ``--epochs`` epochs through the graphed ``Trainer`` with every
enabled decay at 250 steps, then reports on 32 mid-trajectory test samples,
as one JSON object: the prediction's departure from Sgi, the
pre-activation (the HardLayer's input, read with a forward hook on the
saturation model's inner network) and its softplus, the L1 norm per
parameter of the gradient of the Sg label SSE, that SSE and the SSE of
predicting Sgi. :func:`probe` runs the same on a case built elsewhere. It
runs on the GPU unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def build_case(sat_act=None, base_dir=None, device=None, **kwargs):
    """The reference tool's drawdown case (its ``main``), through
    ``rmse_experiment.build_case``; ``kwargs`` resize it (``nx``,
    ``realizations``)."""
    from srm_tpu_torch.tools.rmse_experiment import build_case as rmse_case
    return rmse_case(fluid="GC", physics_fraction=0.5, td_norm="balance", sat_act=sat_act,
                     pi=4300.0, min_bhp=2000.0, device=device, base_dir=base_dir, **kwargs)


def _stats(t, keys=("min", "mean", "max")) -> dict:
    return {k: float(getattr(t, k)()) for k in keys}


def probe(case, epochs: int = 10, batch: int = 32, device=None) -> dict:
    """Train ``case`` (its models in place) and report on its test split;
    ``device`` is where the models live (None: the case's)."""
    import torch
    import torch.nn.functional as F

    from srm_tpu_torch.tools.rmse_experiment import optimizer_configs
    from srm_tpu_torch.training.trainer import Trainer

    dev = torch.device(device if device is not None else case["device"])
    sat = case["models"]["saturation_model"]
    if next(sat.parameters()).device.type != dev.type:
        raise ValueError(f"the case's models are on {next(sat.parameters()).device}, not {dev}")
    trainer = Trainer(case["loss_fn"], optimizer_configs=optimizer_configs(decay_steps=250))
    trainer.stage_dataset("train", case["train_groups"], batch)
    for epoch in range(epochs):
        m = trainer.train_epoch_resident("train")           # host metrics: synchronised
        print(f"  epoch {epoch + 1}/{epochs} loss {float(m['total'][-1]):.4g}",
              file=sys.stderr, flush=True)

    xte, yte = case["test_groups"][0]
    xte = np.asarray(xte)
    # (K, T, D, H, W, C) -> a batch of 32 mid-trajectory samples
    xb = torch.from_numpy(xte.reshape((-1,) + xte.shape[2:])[50:82]).to(dev)
    lab = torch.from_numpy(np.asarray(yte["SGAS"]).reshape(
        (-1,) + xte.shape[2:-1] + (1,))[50:82]).to(dev)
    sgi = float(case["loss_fn"].Sgi)
    sat_act = case["general_config"].get("sat_input_activation")

    seen = []
    hook = sat.network.register_forward_hook(lambda m, i, out: seen.append(out.detach()))
    try:
        with torch.no_grad():
            out = sat(xb)
    finally:
        hook.remove()
    pre = seen[0].float()
    report = {"sat_act": sat_act or "softplus (default)", "Sgi": sgi,
              "sg_pred_minus_sgi": _stats(out - sgi),
              "pre_activation": _stats(pre),
              "softplus_pre": _stats(F.softplus(pre), ("mean", "max"))}

    params = list(sat.parameters())
    sse = torch.square(sat(xb) - lab).sum()
    grads = torch.autograd.grad(sse, params)
    nparam = sum(p.numel() for p in params)
    report["sg_label_grad_l1_per_param"] = float(sum(g.abs().sum() for g in grads)) / max(nparam, 1)
    report["sg_label_sse"] = float(sse.detach())
    report["trivial_sse"] = float(torch.square(sgi - lab).sum())
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m srm_tpu_torch.tools.sg_head_probe",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--sat-act", default=None,
                    help="saturation-model input_activation override (e.g. 'abs'); default "
                         "keeps the shipped softplus")
    ap.add_argument("--base-dir", default=None,
                    help="dataset cache directory (default: _srm_data in the checkout)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    case = build_case(args.sat_act, args.base_dir, args.device)
    report = probe(case, args.epochs, args.batch, args.device)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
