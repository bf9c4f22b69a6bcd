"""Data-parallel training of the port (``srm_tpu_torch/parallel/mesh.py`` and
the trainer's one all-reduce a step) on the CPU, held to the JAX package's
multi-device mesh (the 8 virtual CPU devices of ``tests/conftest.py``).

The port's ranks are processes (``tests/torch_parallel_ranks.py``) in a
gloo group that meets through a ``file://`` store in the test's directory,
never a TCP port; each run starts its ranks at once and reads what each
wrote. The world-4 and world-2 runs each serve several tests (one process
group per world size), small cases only: DG 9×9 and GC 13×13.

Tolerances:
- TOTAL_RTOL: a step's total and metrics over the ranks against one
  process's and the JAX mesh's, float32 sums in another order;
- ADAM_RTOL, ADAM_ATOL: weights after Adam steps, the bound of
  ``tests/test_spatial_sharding.py:150-157`` (a weight whose gradient is
  ~0 may move by up to the learning rate either way); it holds any update
  of one step, so
- UPDATE_RTOL: the pressure net's update of one step (its weights after
  less before) against the JAX mesh's, as the L2 distance over the norm
  (measured 9.2e-4; a model that did not move, or moved the other way, is
  1 or more off; the Δt net's update follows its float32 gradient, which
  is rounding noise, ROADMAP C2: 0.67 apart, not held);
- GRAD_RTOL: the gradients summed over 4 ranks against one process's, in
  float64 (in float32 Model 2's gradient is rounding noise, ROADMAP C2),
  as the L2 distance per model over its norm; an average over the ranks
  would be 0.75 off;
- EPOCH_RTOL: the per-step metrics of six float64 training steps and an
  eval epoch over the ranks against one process's (float64 sums in another
  order, each metric rounded to float32 as the trainer keeps it).
"""

import copy
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from srm_tpu.config import get_optimizer_model_mapping
from srm_tpu.losses.physics_loss import PhysicsLoss as JaxLoss
from srm_tpu.parallel.mesh import make_mesh as jax_make_mesh
from srm_tpu.parallel.mesh import shard_batch as jax_shard_batch
from srm_tpu.training.trainer import Trainer as JaxTrainer
from srm_tpu_torch.config import DEFAULT_GENERAL_CONFIG
from srm_tpu_torch.data.batching import collapse_groups
from srm_tpu_torch.examples.common import setup_case
from srm_tpu_torch.nn.convert import load_flax_params
from srm_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch
from srm_tpu_torch.training.trainer import Trainer

ROOT = Path(__file__).resolve().parents[1]
TOTAL_RTOL = 1e-4
ADAM_RTOL, ADAM_ATOL = 5e-3, 2.5e-2
GRAD_RTOL = 1e-5
UPDATE_RTOL = 1e-2
EPOCH_RTOL = 1e-6
DG_BATCH = 8
GC_MIXED = dict(physics_mode_fraction=0.5, td_normalization="balance", sg_td_focus=8.0)
NEWTON_LOG = dict(use_non_iterative=False, max_iters=3, log_iterations=True)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def start_ranks(directory: Path, world: int, runs, timeout: float = 300):
    """Start ``world`` ranks on ``runs`` at once and wait for them (a rank
    still running after ``timeout`` s fails the test); their exit codes and
    the ends of their error output."""
    directory.mkdir(parents=True, exist_ok=True)
    spec = directory / "spec.json"
    spec.write_text(json.dumps({"out": str(directory), "runs": runs}))
    env = {**os.environ, "WORLD_SIZE": str(world), "STORE": str(directory / "store"),
           "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_parallel_ranks.py"),
                               str(spec)], env={**env, "RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    errors = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            errors.append(err[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], errors


def run_ranks(directory: Path, world: int, runs, timeout: float = 300):
    """Start ``world`` ranks on ``runs`` at once; each rank's results."""
    codes, errors = start_ranks(directory, world, runs, timeout)
    assert codes == [0] * world, errors
    return [torch.load(directory / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _rel(got, want) -> float:
    num = torch.sqrt(sum(((g.double() - w.double()) ** 2).sum() for g, w in zip(got, want)))
    return float(num / torch.sqrt(sum((w.double() ** 2).sum() for w in want)))


def _assert_adam_close(got, want):
    for k in want:
        for a, b in zip(got[k], want[k]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=ADAM_RTOL, atol=ADAM_ATOL)


def _assert_ranks_equal(outs, key="weights"):
    for other in outs[1:]:
        for k, ws in outs[0][key].items():
            assert all(torch.equal(a, b) for a, b in zip(ws, other[key][k])), k


def _jax_weights_as_port(tcase, params, names):
    """The JAX package's parameters as the port's parameter lists."""
    holder = {n: copy.deepcopy(tcase["models"][n]) for n in names}
    load_flax_params(holder, {n: jax.tree_util.tree_map(np.asarray, params[n]) for n in names})
    return {n: [p.detach() for p in holder[n].parameters()] for n in names}


# -- (1) shard_batch ----------------------------------------------------------

@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("batch_axis", [0, 1])
def test_shard_batch_gives_each_rank_the_jax_meshs_shard(world, batch_axis):
    """Rank r's block is device r's shard of the JAX package's
    ``shard_batch`` on ``make_mesh(world)``, for numpy and torch arrays;
    an array without the batch axis is kept whole, as JAX replicates it."""
    rng = np.random.RandomState(world)
    x = rng.standard_normal((3, 8, 5, 4) if batch_axis else (8, 5, 4)).astype(np.float32)
    flat = rng.standard_normal(3).astype(np.float32)
    mesh_j = jax_make_mesh(world)
    sharded = jax_shard_batch(jnp.asarray(x), mesh_j, batch_axis=batch_axis)
    shards = {s.device: np.asarray(s.data) for s in sharded.addressable_shards}
    for r, device in enumerate(mesh_j.devices.reshape(-1)):
        tree = {"x": x, "t": [torch.from_numpy(x)], "scalar": np.float32(2.0)}
        if batch_axis:
            tree["flat"] = flat                   # no axis 1
        got = shard_batch(tree, Mesh(size=world, rank=r), batch_axis=batch_axis)
        np.testing.assert_array_equal(got["x"], shards[device])
        np.testing.assert_array_equal(got["t"][0].numpy(), shards[device])
        assert got["scalar"] == 2.0
        assert got.get("flat") is tree.get("flat")


def test_shard_batch_splits_an_uneven_batch_as_array_split():
    """B = 6 over 4 ranks: blocks of 2, 2, 1, 1 rows in rank order (the
    JAX package replicates such an array instead; the summed loss is the
    same either way), and a batch with fewer rows than ranks raises."""
    x = np.arange(6 * 3, dtype=np.float32).reshape(6, 3)
    blocks = [shard_batch(x, Mesh(size=4, rank=r)) for r in range(4)]
    for got, want in zip(blocks, np.array_split(x, 4)):
        np.testing.assert_array_equal(got, want)
    jax_shards = jax_shard_batch(jnp.asarray(x), jax_make_mesh(4)).addressable_shards
    assert all(np.array_equal(np.asarray(s.data), x) for s in jax_shards)
    with pytest.raises(ValueError, match="without a row"):
        shard_batch(x[:3], Mesh(size=4, rank=0))


def test_make_mesh_without_a_group_and_the_space_axis():
    """Without a process group the mesh is this process alone (no group,
    no collective); a space axis, like more ranks than one, needs a group
    started by torchrun and raises without one; a device count that the
    space axis does not divide raises as the JAX package's does."""
    mesh = make_mesh()
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    assert jax_make_mesh(4).axis_names == (mesh.axis_name,)
    with pytest.raises(ValueError, match="torchrun"):
        make_mesh(2, spatial=2)
    with pytest.raises(ValueError, match="torchrun"):
        make_mesh(4)
    for make in (make_mesh, jax_make_mesh):
        with pytest.raises(ValueError, match="not divisible by spatial=2"):
            make(3, spatial=2)


def test_a_one_rank_group_is_bitwise_one_process(dg):
    """A process group of one rank (gloo, in this process) runs the
    all-reduce of the flat buffer that the step without a group fills too,
    and the metrics' division by the whole batch's counts: three train
    steps and an eval epoch give bitwise the per-step metrics and weights
    of the trainer without a group."""
    import torch.distributed as dist

    def run(mesh):
        loss = copy.copy(dg["tcase"]["loss_fn"])
        loss.models = {**loss.models, **{k: copy.deepcopy(loss.models[k])
                                         for k in ("pressure", "time_step")}}
        trainer = Trainer(loss, mesh=mesh)
        trainer.stage_dataset("train", dg["tcase"]["train_groups"], 16)
        return trainer, [trainer.train_epoch_resident("train", steps=3),
                         trainer.eval_epoch_resident("train")]

    plain, want = run(None)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh()
        assert (mesh.size, mesh.backend) == (1, "gloo")
        grouped, got = run(mesh)
    finally:
        dist.destroy_process_group()
    assert grouped.mesh.group is not None and plain.mesh.group is None
    for g, w in zip(got, want):
        for name in w:
            np.testing.assert_array_equal(g[name], w[name], err_msg=name)
    for k in plain.optimizer_keys:
        assert all(torch.equal(a, b) for a, b in zip(grouped.optimizers[k].params,
                                                     plain.optimizers[k].params)), k


# -- the shared cases and their runs -------------------------------------------

@pytest.fixture(scope="module")
def dg(dg9_case, tmp_path_factory):
    """The port's DG 9×9 case with the JAX package's shared dg9 weights,
    and one 8-sample batch of its training split (zero labels)."""
    base = tmp_path_factory.mktemp("parallel_dg")
    tcase = setup_case("DG", base_dir=str(base / "data"), nx=9, n_realizations=6, device="cpu")
    load_flax_params(tcase["models"], jax.tree_util.tree_map(np.asarray, dg9_case["params"]))
    torch.save({k: tcase["models"][k].state_dict() for k in ("pressure", "time_step")},
               base / "weights.pt")
    x_all, y_all = collapse_groups(dg9_case["train_groups"])
    x, y = x_all[:DG_BATCH], {k: v[:DG_BATCH] for k, v in y_all.items()}
    np.savez(base / "batch.npz", x=x, **{f"y_{k}": v for k, v in y.items()})
    n = collapse_groups(tcase["train_groups"])[0].shape[0]
    spec = dict(fluid="DG", base_dir=str(base / "data"), nx=9, realizations=6,
                weights=str(base / "weights.pt"))
    # the epochs run in float64: in float32 Model 2's gradient and the tde
    # term are rounding noise (ROADMAP C1, C2), which no two summation
    # orders share, so that each Adam step moves Δt and the metrics apart
    epochs = dict(spec, scenario="epochs", float64=True)
    return dict(tcase=tcase, jcase=dg9_case, base=base, x=x, y=y, spec=spec, n=n,
                epochs=epochs)


@pytest.fixture(scope="module")
def gc(gc13_case, tmp_path_factory):
    """The port's GC 13×13 case with the shared gc13 weights, in mixed
    mode with balanced td errors and the Sg focus, and a 4-sample batch
    whose labels differ by halves (pressures 0-50 psia below Pi in the first,
    250-300 in the second; Sg at Sgi or 0.2 below it in the first, 0.1-0.2
    below in the second), so that each half's label std and mean of the Sg
    departure are far from the whole batch's."""
    base = tmp_path_factory.mktemp("parallel_gc")
    g = copy.deepcopy(DEFAULT_GENERAL_CONFIG)
    g["label_source"] = "files"
    tcase = setup_case("GC", base_dir=str(base / "data"), nx=13, n_realizations=4,
                       general_config=g, device="cpu")
    load_flax_params(tcase["models"], jax.tree_util.tree_map(np.asarray, gc13_case["params"]))
    torch.save({k: tcase["models"][k].state_dict()
                for k in ("pressure", "time_step", "saturation_model")}, base / "weights.pt")
    x_all, _ = collapse_groups(gc13_case["train_groups"])
    x = x_all[:4]
    rng = np.random.RandomState(5)
    shape = (4,) + x.shape[1:-1]
    drop = np.concatenate([rng.uniform(0.0, 50.0, (2,) + shape[1:]),
                           rng.uniform(250.0, 300.0, (2,) + shape[1:])])
    sg = 0.78 - np.concatenate([np.where(rng.uniform(size=(2,) + shape[1:]) < 0.5, 0.0, 0.2),
                                rng.uniform(0.1, 0.2, (2,) + shape[1:])])
    y = {"PRESSURE": (5000.0 - drop).astype(np.float32), "SGAS": sg.astype(np.float32)}
    np.savez(base / "batch.npz", x=x, **{f"y_{k}": v for k, v in y.items()})
    jloss = JaxLoss(gc13_case["models"], gc13_case["ds"],
                    optimizer_model_names_map=get_optimizer_model_mapping("GC"),
                    general_config=gc13_case["g"],
                    reservoir_config=gc13_case["proc"].reservoir_config,
                    wells_config=gc13_case["proc"].wells_config, fluid_type="GC")
    for k, v in GC_MIXED.items():
        setattr(jloss, k, v)
    spec = dict(fluid="GC", base_dir=str(base / "data"), nx=13, realizations=4,
                general_config=g, weights=str(base / "weights.pt"), loss_attrs=GC_MIXED)
    return dict(tcase=tcase, jcase=gc13_case, jloss=jloss, x=x, y=y, spec=spec,
                batch=str(base / "batch.npz"))


@pytest.fixture(scope="module")
def world4(dg, tmp_path_factory):
    """Four ranks: a DG train_step on the 8-sample batch in float32 and in
    float64, and epochs of two steps at an uneven batch (B = 6)."""
    batch = str(dg["base"] / "batch.npz")
    runs = [dict(dg["spec"], scenario="step", batch=batch),
            dict(dg["spec"], scenario="step", batch=batch, float64=True),
            dict(dg["epochs"], batch_size=6, steps=2)]
    return run_ranks(tmp_path_factory.mktemp("world4"), 4, runs)


def _even_half(n):
    """A batch that gives two even batches of the staged split."""
    return 2 * (n // 4)


@pytest.fixture(scope="module")
def world2(dg, gc, tmp_path_factory):
    """Two ranks: the GC mixed-mode train_step, two resident DG epochs of
    two batches, checkpoint and resume, one uncached case set up by both
    ranks at once, and a DG train_step whose Newton BHP logs its
    iterations."""
    out = tmp_path_factory.mktemp("world2")
    bs = _even_half(dg["n"])
    runs = [dict(gc["spec"], scenario="step", batch=gc["batch"]),
            dict(dg["epochs"], batch_size=bs),
            dict(dg["spec"], scenario="resume", batch_size=bs, dir=str(out / "ckpt")),
            dict(scenario="setup", fluid="DG", base_dir=str(out / "fresh"), nx=9,
                 realizations=6),
            dict(dg["spec"], scenario="step", batch=str(dg["base"] / "batch.npz"),
                 well_solver_kwargs=dict(NEWTON_LOG, log_dir=str(out / "logs")))]
    return run_ranks(out / "ranks", 2, runs)


# -- (2) DG at world 4 against the JAX mesh ------------------------------------

def test_dg_step_at_world_4_matches_the_jax_mesh(dg, world4):
    """One train_step on 8 samples over 4 ranks (2 rows each) against the
    JAX Trainer's on ``make_mesh(4)``: the total within TOTAL_RTOL, the
    updated weights within the Adam-step bound and the pressure net's
    update within UPDATE_RTOL of the JAX mesh's, every rank's weights the
    same bits."""
    jcase = dg["jcase"]
    trainer = JaxTrainer(jcase["loss_fn"], jcase["params"], mesh=jax_make_mesh(4),
                         donate_params=False)
    metrics = trainer.train_step(dg["x"], dg["y"])
    outs = [r[0] for r in world4]
    np.testing.assert_allclose(outs[0]["metrics"]["total"], float(metrics["total"]),
                               rtol=TOTAL_RTOL)
    want = _jax_weights_as_port(dg["tcase"], trainer.params, ("pressure", "time_step"))
    _assert_adam_close(outs[0]["weights"], want)
    start = [p.detach() for p in dg["tcase"]["models"]["pressure"].parameters()]
    gap = _rel([a - b for a, b in zip(outs[0]["weights"]["pressure"], start)],
               [a - b for a, b in zip(want["pressure"], start)])
    assert gap <= UPDATE_RTOL, gap
    _assert_ranks_equal(outs)


def test_dg_gradients_are_summed_over_the_ranks(dg, world4):
    """In float64 the gradients that the 4 ranks' all-reduce leaves are one
    process's gradients of the whole batch within GRAD_RTOL for every
    model; an average would be 0.75 off."""
    loss = copy.copy(dg["tcase"]["loss_fn"])
    loss.models = {**loss.models, **{k: copy.deepcopy(loss.models[k]).double()
                                     for k in ("pressure", "time_step", "pvt_model")}}
    x = torch.from_numpy(dg["x"]).double()
    y = {k: torch.from_numpy(v).double() for k, v in dg["y"].items()}
    _, want, total = loss.pinn_batch_sse_grad(x, y)
    got = world4[0][1]["grads"]
    for k in want:
        assert _rel(got[k], want[k]) <= GRAD_RTOL, k
        assert _rel([g / 4 for g in got[k]], want[k]) > 0.5
    np.testing.assert_allclose(world4[0][1]["metrics"]["total"], float(total.detach()),
                               rtol=1e-6)


# -- (3) GC's whole-batch label statistics -------------------------------------

def test_gc_label_statistics_are_the_whole_batchs(gc, world2):
    """GC in mixed mode with "balance" and the Sg focus: the step's total
    and td terms over 2 ranks equal one process's on the whole batch and
    the JAX mesh's (``make_mesh(2)``) within TOTAL_RTOL. Per-rank label
    stds or focus means (each half's statistics) would move the oil td
    term far beyond that, as the check of this batch shows."""
    outs = [r[0] for r in world2]
    loss = gc["tcase"]["loss_fn"]
    lf = copy.copy(loss)
    for k, v in GC_MIXED.items():
        setattr(lf, k, v)
    x = torch.from_numpy(gc["x"])
    y = {k: torch.from_numpy(v) for k, v in gc["y"].items()}
    with torch.no_grad():
        total, aux = lf.loss_and_metrics(x, y)
        halves = [lf.weighted_sse(x[i:i + 2], {k: v[i:i + 2] for k, v in y.items()})
                  for i in (0, 2)]
    jtrainer = JaxTrainer(gc["jloss"], gc["jcase"]["params"], mesh=jax_make_mesh(2),
                          donate_params=False)
    jm = jtrainer.eval_step(gc["x"], gc["y"])
    got = outs[0]["metrics"]
    for name, want, jwant in (("total", float(total), float(jm["total"])),
                              ("gas/td", float(aux["gas"]["td"]), float(jm["gas"]["td"])),
                              ("oil/td", float(aux["oil"]["td"]), float(jm["oil"]["td"]))):
        np.testing.assert_allclose(got[name], want, rtol=TOTAL_RTOL, err_msg=name)
        np.testing.assert_allclose(got[name], jwant, rtol=TOTAL_RTOL, err_msg=name)
    per_rank = sum(float(h[1]["oil"]["td"]) for h in halves) / float(y["SGAS"].numel())
    assert abs(per_rank / got["oil/td"] - 1.0) > 100 * TOTAL_RTOL
    _assert_ranks_equal(outs)


# -- (4) resident epochs --------------------------------------------------------

def _epochs_match(outs, spec):
    """Each rank's epochs (``torch_parallel_ranks.epochs``) against the
    same run in this process, alone."""
    want = ranks.epochs(spec)
    for out in outs:
        pairs = [*zip(out["resident"], want["resident"]), (out["host"], want["host"]),
                 (out["eval"], want["eval"])]
        for got, ref in pairs:
            assert set(got) == set(ref)
            for name in ref:
                np.testing.assert_allclose(got[name], ref[name], rtol=EPOCH_RTOL, atol=1e-9,
                                           err_msg=name)
    _assert_adam_close(outs[0]["weights"], want["weights"])
    _assert_ranks_equal(outs)


def test_resident_epochs_at_world_2_match_world_1(dg, world2):
    """Two resident epochs of two batches (every rank drawing the same
    permutation, taking its block), then the host-batched train and eval
    epochs, over 2 ranks against one process, in float64: per-step metrics
    within EPOCH_RTOL, the weights within the Adam-step bound, and both
    ranks' weights the same bits."""
    _epochs_match([r[1] for r in world2], dict(dg["epochs"], batch_size=_even_half(dg["n"])))


def test_resident_epochs_with_an_uneven_batch_at_world_4(dg, world4):
    """The same at B = 6 over 4 ranks (blocks of 2, 2, 1, 1 rows), two
    steps of each epoch."""
    _epochs_match([r[2] for r in world4], dict(dg["epochs"], batch_size=6, steps=2))


# -- (5) checkpoint and resume ---------------------------------------------------

def test_resume_at_world_2_gives_an_uninterrupted_runs_weights(world2):
    """Crashed after epoch 1 and resumed to 3, the ranks end on the bits
    of an uninterrupted 3-epoch run (each rank restoring the same step and
    generator state); rank 0 wrote the checkpoints (the last three kept:
    epochs 2 and 3 and the best-epoch restore)."""
    outs = [r[2] for r in world2]
    for out in outs:
        for k, ws in out["whole"].items():
            assert all(torch.equal(a, b) for a, b in zip(out["resumed"][k], ws)), k
        resumed, whole = out["losses"]
        assert resumed == whole[-len(resumed):]
    _assert_ranks_equal(outs, "resumed")
    assert outs[0]["files"] == ["ckpt_00000001.pt", "ckpt_00000002.pt", "ckpt_00000003.pt"]


def test_an_error_under_a_group_ends_the_ranks(dg, tmp_path):
    """A callback that raises after the first epoch, on both ranks of a
    gloo group: the driver releases its trainer's graphs on the way out
    (on the card the NCCL group's end waits for graphs that hold its
    kernels; the CPU has none, so this shows the path runs), and each rank
    ends its group and exits non-zero with the error, well within the
    timeout."""
    run = dict(dg["spec"], scenario="crash", batch_size=_even_half(dg["n"]))
    codes, errors = start_ranks(tmp_path, 2, [run], timeout=120)
    assert all(c not in (0, None) for c in codes), codes
    assert all("_Crash" in e for e in errors), errors
    assert not list(tmp_path.glob("rank*.pt"))


# -- (6) one uncached case set up by two ranks ---------------------------------

def test_two_ranks_set_up_one_uncached_case(world2):
    """Rank 0 builds the dataset cache while rank 1 waits, then loads it:
    both hold the same arrays."""
    a, b = (r[3] for r in world2)
    for split in ("train", "val", "test"):
        for (xa, ya), (xb, yb) in zip(a[split], b[split]):
            np.testing.assert_array_equal(xa, xb)
            for k in ya:
                np.testing.assert_array_equal(ya[k], yb[k])


# -- the well solver's iteration logs ------------------------------------------

def _log_lines(directory):
    (name,) = os.listdir(directory)
    return (directory / name).read_text().splitlines()


def test_iteration_logs_hold_the_whole_batch(dg, world2, tmp_path):
    """Under the JAX package's mesh, ``jax.debug.callback`` receives the
    global arrays, once; so under the port's, rank 0 writes one history
    file of the whole batch (each rank's block gathered), the file that
    one process writes for that batch (numbers within 1e-5: each rank's
    Newton trips round on its own block)."""
    seen = []
    mesh = jax_make_mesh(2)

    @jax.jit
    def f(a):
        jax.debug.callback(lambda h: seen.append(np.shape(h)), a)
        return a.sum()

    jax.block_until_ready(f(jax_shard_batch(jnp.zeros((8, 3)), mesh)))
    jax.effects_barrier()
    assert seen == [(8, 3)]
    case = setup_case("DG", base_dir=dg["spec"]["base_dir"], nx=9, n_realizations=6,
                      well_solver_kwargs=dict(NEWTON_LOG, log_dir=str(tmp_path)), device="cpu")
    load_flax_params(case["models"], jax.tree_util.tree_map(np.asarray,
                                                            dg["jcase"]["params"]))
    with torch.no_grad():
        case["loss_fn"].loss_and_metrics(torch.from_numpy(dg["x"]),
                                         {k: torch.from_numpy(v) for k, v in dg["y"].items()})
    want = _log_lines(tmp_path)
    got = _log_lines(Path(world2[0][4]["logs"]))
    assert got[0] == want[0] and f"[3, {DG_BATCH}," in got[0]
    assert len(got) == len(want) == NEWTON_LOG["max_iters"] + 2
    for g, w in zip(got[1:], want[1:]):
        assert g.split('"')[0] == w.split('"')[0]
        np.testing.assert_allclose([float(v) for v in g.split('"')[1].split()],
                                   [float(v) for v in w.split('"')[1].split()], rtol=1e-5)


# -- (7) the CLI under torchrun ---------------------------------------------------

def test_cli_trains_under_two_ranks(tmp_path):
    """``torchrun --nproc-per-node=2 -m srm_tpu_torch train --device cpu``
    (a rendezvous on a free port of this host): a gloo group of 2, rank 0
    alone printing and writing the checkpoint."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node=2",
         "-m", "srm_tpu_torch", "train", "--device", "cpu", "--nx", "9", "--realizations", "6",
         "--epochs", "1", "--batch-size", "16", "--base-dir", str(tmp_path / "data"),
         "--checkpoint-dir", str(tmp_path / "ckpt")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.count("data-parallel over 2 ranks (gloo)") == 1, proc.stdout
    assert proc.stdout.count("final total train loss") == 1, proc.stdout
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["ckpt_00000000.pt", "ckpt_00000001.pt"]


def test_data_parallel_tool_on_the_cpu(tmp_path):
    """``srm_tpu_torch.tools.data_parallel`` under torchrun on the CPU: two
    gloo ranks of 8 rows against one rank of 16, its JSON line last, the
    first step's total within the tool's FIRST_RTOL, its gradients (summed
    over the ranks) within the tool's GRAD_RTOL of one rank's for the
    pressure net and their average over the ranks not, no device number
    (not measured on the CPU)."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node=2",
         "-m", "srm_tpu_torch.tools.data_parallel", "--device", "cpu", "--nx", "9",
         "--realizations", "6", "--batch", "16", "--epochs", "2", "--base-dir",
         str(tmp_path)], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert (line["world"], line["batch"], line["rows"], line["device"]) == (2, 16, 8, "cpu")
    assert len(line["steps_per_s"]) == len(line["alone_steps_per_s"]) == 2
    assert line["first_step_rtol"] <= 1e-5 and line["all_reduce_us_median"] is None
    gap = line["grad_gaps"]["pressure"]           # the Δt net's is noise (C2)
    assert gap["summed"] <= line["grad_rtol"] < 0.4 < gap["averaged"]



def test_data_parallel_tool_with_remat_on_a_space_axis_on_the_cpu(tmp_path):
    """The tool's ``--remat`` over a space axis of two gloo ranks on the CPU
    (each rank 5 or 4 of the 9 rows of H, the recompute's halo exchanges
    inside the backward): its JSON line names the option and the space
    axis, the first step's total is within the tool's FIRST_RTOL and the
    pressure net's gradients (summed over the ranks) within its bound of
    the rank alone's (which has ``remat_forwards`` too)."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node=2",
         "-m", "srm_tpu_torch.tools.data_parallel", "--device", "cpu", "--nx", "9",
         "--realizations", "6", "--batch", "8", "--epochs", "1", "--spatial", "2", "--remat",
         "--base-dir", str(tmp_path)], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert (line["world"], line["spatial"], line["remat"], line["rows"], line["h_rows"]) == (
        2, 2, True, 8, 5)
    assert line["first_step_rtol"] <= 1e-5
    assert line["grad_gaps"]["pressure"]["summed"] <= line["grad_rtol"]
