"""The port's tools against the repo's JAX-side tools, on the CPU.

* ``rmse_report`` and ``salvage_rmse_log`` (copies of pure-Python tools):
  the same JSON as the repo's ``tools/`` scripts (loaded by file path here)
  on the same seeded trajectories and logs, the logs written with the port's
  own ``rmse_experiment.eval_line``; the salvaged record names the port as
  its framework.
* ``flops_breakdown`` on a DG 3D production step at 9×9×9, batch 2, against
  ``srm_tpu/utils/flops.py``'s count of the JAX package's train step with
  the same flax weights: equal, exactly, once each of the port's
  convolution records is counted by the StableHLO counter's convention and
  the JAX package's resize is added (FLOP counts are integers; tolerance
  0). Per op:
  - a forward convolution, a matmul, the spline PVT's φ-matmul and its
    derivative (both packages, (m, 37) @ (37, 2) and back), and a weight
    gradient of an ordinary convolution count the same in both;
  - a Dense layer is a ``dot_general`` in the JAX package and a 1×1
    convolution in the port: the same count;
  - a transposed convolution: the StableHLO count includes the zeros of
    its dilated input, 2·K·B·Y (Y the output's cells, K the kernel's
    size), in its forward and its weight gradient, where PyTorch counts
    2·K·B·X (X the input's cells);
  - the input gradient of a convolution: 2·K·B·X in StableHLO (its
    cotangent dilated by the stride), 2·K·B·Y in PyTorch;
  - the decoder's bilinear resize of its 15×15 planes to 9×9: four
    ``dot_general``\\ s with the (15, 9) interpolation matrix in the JAX
    package (forward and backward), an interpolation PyTorch does not count.
* ``mfu_probe``: each lever's FLOPs equal ``FlopCounterMode``'s count of the
  same step on the network built from the JAX package's config with the JAX
  tool's recipe and filled with its flax weights (so that its geometry is
  flax's).
* ``probe_two_nets``: the two equal encoder–decoders' gradients, one after
  the other and as one ``vmap`` over their stacked parameters, each within
  float32 rounding of the other and, with the JAX tool's weights and input,
  of ``jax.grad`` of the JAX tool's stacked loss (GRAD_REL).
* ``EpochTimer``'s ``summary()`` equals the JAX class's on the same clock;
  ``trace`` writes a trace file on the CPU.
"""

import collections
import importlib.util
import json
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srm_tpu.config import DEFAULT_GENERAL_CONFIG as J_GENERAL
from srm_tpu.config import apply_production_overrides as jax_production
from srm_tpu.config import get_configuration as jax_get_configuration
from srm_tpu.examples.common import setup_case as jax_setup_case
from srm_tpu.nn.encoder_decoder import EncoderDecoderModel
from srm_tpu.training.trainer import Trainer as JaxTrainer
from srm_tpu.utils import flops as jax_flops
from srm_tpu.utils import profiling as jax_profiling
from srm_tpu_torch.nn.convert import load_flax_module, load_flax_params
from srm_tpu_torch.nn.encoder_decoder import EncoderDecoder
from srm_tpu_torch.tools import flops_breakdown, mfu_probe, rmse_report, salvage_rmse_log
from srm_tpu_torch.tools.rmse_experiment import eval_line
from srm_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def repo_tool(name):
    """The repo's ``tools/<name>.py``, loaded by its path."""
    spec = importlib.util.spec_from_file_location(f"repo_tool_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def trajectory(rng, n, steps_per_epoch, start):
    """Seeded (wall_s, rmse) points, the RMSE falling with noise."""
    rmse = start * np.exp(-0.3 * np.arange(n)) * rng.uniform(0.9, 1.1, n)
    wall = np.cumsum(rng.uniform(5.0, 50.0, n))
    return [{"wall_s": round(float(w), 2), "epoch": 5 * (i + 1),
             "steps": 5 * (i + 1) * steps_per_epoch, "step": 5 * (i + 1) * steps_per_epoch,
             "rmse_psia": round(float(r), 3)} for i, (w, r) in enumerate(zip(wall, rmse))]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rmse_report_matches_the_repo_tool(seed, tmp_path, capsys):
    rng = np.random.RandomState(seed)
    srm = {"rmse_predict_pi": 263.4, "trajectory": trajectory(rng, 12, 9, 200.0)}
    tf = {"trajectory": trajectory(rng, 8, 95, 150.0)}
    paths = []
    for name, rec in (("srm", srm), ("tf", tf)):
        paths.append(str(tmp_path / f"{name}.json"))
        with open(paths[-1], "w") as f:
            json.dump(rec, f)
    repo_tool("rmse_report").main(paths)
    want = json.loads(capsys.readouterr().out)
    got = rmse_report.main(paths)
    assert json.loads(capsys.readouterr().out) == got == want
    assert any(r["speedup"] is not None for r in got["matched_rmse_rows"])


@pytest.mark.parametrize("fluid", ["DG", "GC"])
def test_salvage_matches_the_repo_tool_on_the_ports_log(fluid, tmp_path, capsys):
    rng = np.random.RandomState(3)
    lines = ["setup: labels", "  epoch 1/20 done in 3.2s loss 1.234e+05"]
    for epoch in range(5, 25, 5):
        sg = float(rng.uniform(0.01, 0.1)) if fluid == "GC" else None
        lines += [eval_line(epoch, float(rng.uniform(1, 900)), float(rng.uniform(10, 300)), sg),
                  f"  epoch {epoch + 1}/20 done in 2.9s loss 9.1e+04"]
    log = tmp_path / "run.log"
    log.write_text("\n".join(lines) + "\n")
    flags = ["--fluid", fluid, "--physics-fraction", "0.5", "--pi", "4300", "--min-bhp",
             "2000", "--td-norm", "balance", "--rmse-predict-pi", "223.4",
             "--steps-per-epoch", "9"]
    repo_tool("salvage_rmse_log").main([str(log), "--out", str(tmp_path / "jax.json")] + flags)
    got = salvage_rmse_log.main([str(log), "--out", str(tmp_path / "port.json")] + flags)
    capsys.readouterr()
    want = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == got
    assert got["framework"] == "srm_tpu_torch" and want["framework"] == "srm_tpu"
    assert {**got, "framework": "srm_tpu"} == want
    assert len(got["trajectory"]) == 4 and ("rmse_sg" in got["trajectory"][0]) == (fluid == "GC")


# -- flops_breakdown -------------------------------------------------------------
_SHAPE = re.compile(r"\(([\d,]*)\)\w+")
# the decoder's resize at 9x9x9: its 15x15 planes to 9x9
RESIZE_MATRIX = "tensor<15x9x"


def _shapes(text):
    return [tuple(int(v) for v in m.group(1).split(",") if v) for m in _SHAPE.finditer(text)]


def stablehlo_convention(sig: str, flops: float, calls: int) -> float:
    """A port record's FLOPs as ``srm_tpu/utils/flops.py`` counts the same
    convolutions (module docstring); other ops unchanged. Checks the
    record's own count against PyTorch's convention on the way."""
    name, rest = sig.split(" (", 1)
    ins, outs = (_shapes(part) for part in ("(" + rest).split(" -> "))
    op, transposed = name.split()[0], name.endswith(" T")
    if op not in ("convolution", "convolution_backward"):
        return flops
    if op == "convolution":
        x, w, y = ins[0], ins[1], outs[0]
        has_dx, has_dw, fwd = False, False, True
    else:
        y, x, w = ins[0], ins[1], ins[2]
        has_dx, has_dw, fwd = x in outs, w in outs, False
    k2b = 2 * math.prod(w) * x[0]
    cells_x, cells_y = math.prod(x[2:]), math.prod(y[2:])
    torch_small = cells_x if transposed else cells_y
    torch_count = k2b * torch_small * (1 if fwd else has_dx + has_dw)
    assert torch_count * calls == flops, (sig, torch_count * calls, flops)
    jax_count = k2b * cells_y if fwd else k2b * (cells_x * has_dx + cells_y * has_dw)
    return jax_count * calls


def test_flops_breakdown_matches_the_jax_count(tmp_path, capsys):
    g = jax_production(J_GENERAL)
    jcase = jax_setup_case("DG", base_dir=str(tmp_path / "jax"), nx=9, nz=9, n_realizations=6,
                           kle_method="uncorrelated", general_config=g)
    trainer = JaxTrainer(jcase["loss_fn"], jcase["params"])
    trainer.stage_dataset("train", jcase["train_groups"], 2)
    x_all, y_all, _, _ = trainer._resident["train"]
    x = jnp.asarray(x_all[:2])
    y = jax.tree_util.tree_map(lambda a: jnp.asarray(a[:2]), y_all)
    text = trainer._train_step.lower(trainer.params, trainer.opt_state, x, y).as_text()
    jax_total = jax_flops.stablehlo_matmul_flops(text)
    resize = sum(jax_flops._dot_flops(r) for r in jax_flops._op_records(text)
                 if "stablehlo.dot_general" in r and RESIZE_MATRIX in r)
    pvt_jax = sum(jax_flops._dot_flops(r) for r in jax_flops._op_records(text)
                  if "stablehlo.dot_general" in r and "x37x" in r)

    case = flops_breakdown.build_case(9, 9, 6, base_dir=str(tmp_path / "port"), device="cpu")
    load_flax_params(case["models"], jax.tree_util.tree_map(np.asarray, jcase["params"]))
    xb, yb = flops_breakdown.first_batch(case, 2)
    assert tuple(xb.shape) == tuple(x.shape) == (2, 1, 9, 9, 9, 5)
    counted = flops_breakdown.step_flops(case["loss_fn"], xb, yb)
    total = flops_breakdown.breakdown(counted, top=5)
    out = capsys.readouterr().out
    assert f"total counted FLOPs: {total / 1e9:.2f} G" in out and len(out.splitlines()) == 6
    assert sum(counted.by_signature.values()) == total
    kinds = collections.Counter()
    for sig, f in counted.by_signature.items():
        kinds[sig.split(" (")[0]] += stablehlo_convention(sig, f, counted.calls[sig])
    pvt_port = sum(f for sig, f in counted.by_signature.items()
                   if sig.startswith("mm ") and ",37)" in sig)
    assert resize == 24_883_200 and pvt_jax == pvt_port > 0
    assert sum(kinds.values()) + resize == jax_total, (kinds, resize, jax_total)


# -- mfu_probe ---------------------------------------------------------------------
@pytest.mark.parametrize("lever", list(mfu_probe.levers(2)))
def test_mfu_probe_flops_match_the_jax_geometry_network(lever, capsys):
    nx, nz, batch = 13, 1, 2
    kw = {"batch": batch, **mfu_probe.levers(batch)[lever]}
    got = mfu_probe.probe(lever, nx=nx, nz=nz, device="cpu", **kw)
    assert json.loads(capsys.readouterr().out) == got
    assert got["mfu"] is None and got["ms_per_step"] is None     # no time on the CPU

    # the network as the JAX tool builds it, with its flax weights
    width = kw.get("width", mfu_probe.BASE_WIDTH)
    cfg = jax_get_configuration("encoder_decoder")
    cfg["spatial_dims"], cfg["temporal"] = 2, False
    cfg["width"] = {"Bottom_Size": width[0], "Growth_Rate": width[1]}
    cfg["compute_dtype"] = kw.get("compute_dtype")
    cfg["f32_io"] = kw.get("f32_io", False)
    n = kw.get("pad_to") or nx
    params = EncoderDecoderModel.from_config(cfg).init(
        jax.random.PRNGKey(1), jnp.zeros((kw["batch"], n, n, 5), jnp.float32))
    net = EncoderDecoder.from_config(cfg, 5, grid=(n, n))
    load_flax_module(net, jax.tree_util.tree_map(np.asarray, params))
    x = torch.rand((kw["batch"], nx, nx, 5), generator=torch.Generator().manual_seed(0)) * 2 - 1
    step = mfu_probe.step_fn(net, x, nx, nz, kw.get("pad_to"))
    assert got["flops"] == mfu_probe.step_flops(step) > 0
    if lever in ("pad40", "pad48"):
        base = mfu_probe.probe("base", batch=batch, nx=nx, nz=nz, device="cpu")
        assert got["flops"] > base["flops"]


GRAD_REL = 1e-4


def _rel_l2(got, want) -> float:
    num = math.sqrt(sum(float(((g.double() - w.double()) ** 2).sum()) for g, w in zip(got, want)))
    return num / math.sqrt(sum(float((w.double() ** 2).sum()) for w in want))


@pytest.mark.parametrize("stacked", [False, True])
def test_probe_two_nets_on_the_cpu(stacked, capsys):
    """The JSON line of either design on the CPU: its keys, no time."""
    got = mfu_probe.probe_two_nets("two", batch=2, nx=13, stacked=stacked, device="cpu")
    assert json.loads(capsys.readouterr().out) == got
    assert (got["ms_per_step"], got["stacked"], got["grid"]) == (None, stacked, "13x13x1")


def test_probe_two_nets_designs_give_the_jax_tools_gradients():
    """At 13×13 with the JAX tool's weights (keys 1 and 2) and input: the
    stacked design's gradients equal the sequential one's within float32
    rounding, and both are ``jax.grad`` of the JAX tool's stacked loss
    within GRAD_REL, net by net."""
    nx, batch = 13, 2
    cfg = jax_get_configuration("encoder_decoder")
    cfg["spatial_dims"], cfg["temporal"], cfg["compute_dtype"] = 2, False, None
    model = EncoderDecoderModel.from_config(cfg)
    x = jax.random.uniform(jax.random.PRNGKey(0), (batch, nx, nx, 5), jnp.float32, -1, 1)
    p1, p2 = (model.init(jax.random.PRNGKey(k), x) for k in (1, 2))
    stacked = jax.tree_util.tree_map(lambda a, b: jnp.stack([a, b]), p1, p2)
    want = jax.grad(lambda p: jnp.sum(jnp.square(
        jax.vmap(model.apply, in_axes=(0, None))(p, x))))(stacked)
    nets, _ = mfu_probe.two_nets(batch=batch, nx=nx, device="cpu")
    for net, params in zip(nets, (p1, p2)):
        load_flax_module(net, jax.tree_util.tree_map(np.asarray, params))
    xt = torch.from_numpy(np.array(x))
    seq = mfu_probe.two_nets_step(nets, xt, stacked=False)()
    vm = mfu_probe.two_nets_step(nets, xt, stacked=True)()
    for a, b in zip(vm, seq):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))
    for i in range(2):
        holder = EncoderDecoder.from_config(cfg, 5, grid=(nx, nx))
        load_flax_module(holder, jax.tree_util.tree_map(lambda a: np.asarray(a)[i], want))
        ref = [p.detach() for p in holder.parameters()]
        for got in (seq, vm):
            assert _rel_l2([g[i] for g in got], ref) <= GRAD_REL


# -- profiling --------------------------------------------------------------------
def test_epoch_timer_matches_the_jax_class(monkeypatch):
    clock = iter([0.0, 1.25, 2.0, 2.5, 10.0, 13.75])
    stamps = list(clock)
    timers = []
    for mod in (jax_profiling, profiling):
        ticks = iter(stamps)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(ticks))
        timer = mod.EpochTimer()
        assert timer.summary() == {"count": 0, "mean_ms": 0.0, "total_s": 0.0}
        for steps in (9, 0, 4):
            timer.start()
            timer.stop(steps)
        timers.append(timer)
    assert timers[1].epoch_times_ms == timers[0].epoch_times_ms == [1250.0, 500.0, 3750.0]
    assert timers[1].summary() == timers[0].summary()


def test_trace_writes_a_trace_on_the_cpu(tmp_path, monkeypatch):
    with profiling.trace(str(tmp_path), device="cpu") as d:
        torch.ones(64).cumsum(0).sum()
    files = os.listdir(d)
    assert d == str(tmp_path) and len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(d, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        with profiling.trace(str(tmp_path)):
            pass
