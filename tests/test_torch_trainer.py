"""The port's trainer layer against the JAX package's, on the CPU: the
optimizers' device-tensor schedules and their staircase and AdaBelief
variants against optax, the best-epoch selection against the JAX driver's
on the same loss history, and checkpoint/resume (bitwise the weights,
moments and count of an uninterrupted run, and the CLI's flags).

On the CPU the trainer runs its step function eagerly; on a GPU the same
function is captured as a CUDA graph (``tests/test_torch_cuda.py``)."""

import copy
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import srm_tpu.training.trainer as jax_trainer
import srm_tpu_torch.training.trainer as port_trainer
from srm_tpu.config import DEFAULT_GENERAL_CONFIG, get_optimizer_config
from srm_tpu.training.optimizers import build_optimizer_from_config
from srm_tpu_torch.examples.common import setup_case
from srm_tpu_torch.training.optimizers import build_optimizer_from_config as build_port_optimizer
from srm_tpu_torch.utils.checkpoint import CheckpointManager

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def _config(name):
    """The optimizer configs under test: the three roles' defaults and
    variants with staircase decay (every 2 steps, so that it shows within
    three steps) and AdaBelief."""
    if name in ("pressure", "time_step", "saturation"):
        return get_optimizer_config(name)
    cfg = copy.deepcopy(get_optimizer_config("pressure" if name == "staircase_adamw"
                                             else "saturation"))
    if name == "adabelief":
        cfg["type"] = "adabelief"
    else:
        cfg["exponential_decay"]["staircase"] = True
        cfg["exponential_decay"]["learning_rate"]["decay_steps"] = 2
    return cfg


@pytest.mark.parametrize("name", ["pressure", "saturation", "staircase_adamw"])
def test_schedules_equal_optax_in_float32(name):
    """For steps 0-300 the learning rate, the decayed weight-decay
    coefficient and both bias corrections, computed as float32 device
    tensors from the step count, equal optax's bit for bit, as the
    reference's compiled step computes them (a traced count: ``β**count``
    is ``lax.pow``; on a concrete count JAX would multiply instead)."""
    cfg = _config(name)
    decay = cfg["exponential_decay"]
    steps = decay["learning_rate"]["decay_steps"]
    stair = decay.get("staircase", False)
    lr_sched = optax.exponential_decay(cfg["learning_rate"], steps,
                                       decay["learning_rate"]["decay_rate"], staircase=stair)
    wd_on = decay["weight_decay"]["enabled"]
    ratio = optax.exponential_decay(1.0, steps, decay["weight_decay"]["decay_rate"],
                                    staircase=stair)
    b1, b2 = cfg["beta_1"], cfg["beta_2"]

    @jax.jit
    def reference(count):
        return {"lr": lr_sched(count), "bc1": 1 - b1 ** (count + 1), "bc2": 1 - b2 ** (count + 1),
                "wd": cfg["weight_decay"] * (ratio(count) if wd_on else 1.0)}

    opt = build_port_optimizer([torch.zeros(3)], cfg)
    for k in range(301):
        opt.count.fill_(k)
        s = opt.schedules()
        for key, w in reference(jnp.asarray(k, jnp.int32)).items():
            got = s[key].numpy()
            assert got.dtype == np.float32 and got == np.asarray(w), (k, key, got, w)


@pytest.mark.parametrize("name", ["time_step", "staircase", "staircase_adamw", "adabelief"])
def test_optimizer_variants_match_optax(name):
    """Three steps on the same gradients (numpy seed 0, magnitudes over
    five decades) land on the parameters of optax's update compiled, as the
    reference's step runs it: measured bit for bit over these three steps
    (later, XLA's fused update can round an element one ulp apart)."""
    cfg = _config(name)
    rng = np.random.RandomState(0)
    p0 = [rng.randn(5, 3).astype(np.float32), rng.randn(7).astype(np.float32)]
    grads = [[(rng.randn(*p.shape) * 10.0 ** rng.uniform(-4, 1, p.shape)).astype(np.float32)
              for p in p0] for _ in range(3)]
    opt = build_optimizer_from_config(cfg)
    params = [jnp.asarray(p) for p in p0]
    state = opt.init(params)
    ported = [torch.from_numpy(p.copy()) for p in p0]
    port_opt = build_port_optimizer(ported, cfg)
    update = jax.jit(opt.update)
    for g in grads:
        upd, state = update([jnp.asarray(a) for a in g], state, params)
        params = optax.apply_updates(params, upd)
        port_opt.step([torch.from_numpy(a) for a in g])
    for want, got in zip(params, ported):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    assert int(port_opt.count) == 3


# -- best-epoch selection, fed the same loss history to both drivers --------
PHASES = ("gas", "oil")
TERMS = ("dom", "dbc", "nbc", "ibc", "ic", "mbc", "cmbc", "tde", "td")


class _Loss:
    """The attributes of a PhysicsLoss that the drivers read."""
    loss_keys = {ph: [f"{t}_{ph[0]}" for t in TERMS] for ph in PHASES}
    trainable_models_keys = ["pressure"]
    physics_mode_fraction = 1.0

    @staticmethod
    def logical_name(key):
        return key


def _history(seed, epochs):
    """Per-epoch mean losses: random for most terms, constant zero for the
    boundary terms (the min-max branch where max == min)."""
    rng = np.random.RandomState(seed)
    return [{f"{ph}/{t}": (0.0 if t in ("dbc", "nbc", "cmbc") else float(rng.lognormal()))
             for ph in PHASES for t in TERMS} for _ in range(epochs)]


class _JaxTrainer:
    """The JAX driver's Trainer, replaying a loss history; its parameters
    name the epoch."""

    def __init__(self, loss_fn, params, optimizer_configs=None, mesh=None, losses=None):
        self.losses, self.epoch = losses, -1
        self.params, self.opt_state = {"pressure": np.float32(-1)}, {}
        self.optimizer_keys = ["pressure"]

    def stage_dataset(self, name, groups, batch_size):
        return (1, 1) if name == "train" else (0, 0)

    def train_epoch_resident(self, name, key):
        self.epoch += 1
        self.params["pressure"] = np.float32(self.epoch)
        row = self.losses[self.epoch]
        return {**{ph: {t: np.array([row[f"{ph}/{t}"]]) for t in TERMS} for ph in PHASES},
                "tstep_mean": np.array([1.0])}


class _PortTrainer:
    """The port driver's Trainer, replaying the same history."""

    def __init__(self, loss_fn, optimizer_configs=None, seed=0, mesh=None, losses=None):
        self.losses, self.epoch, self.restored = losses, -1, None

    def stage_dataset(self, name, groups, batch_size):
        return (1, 1) if name == "train" else (0, 0)

    def train_epoch_resident(self, name):
        self.epoch += 1
        row = self.losses[self.epoch]
        return {**{k: np.array([v]) for k, v in row.items()},
                "total": np.array([0.0]), "tstep_mean": np.array([1.0])}

    def snapshot(self):
        return {"pressure": self.epoch}

    def load_snapshot(self, snap):
        self.restored = snap


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_best_epoch_matches_the_jax_driver(monkeypatch, seed):
    """On the same per-epoch losses (12 epochs, the last half watched) the
    port's driver restores the epoch that the JAX driver's min-max
    normalized selection restores."""
    epochs, losses = 12, _history(seed, 12)
    monkeypatch.setattr(jax_trainer, "Trainer",
                        lambda *a, **k: _JaxTrainer(*a, **k, losses=losses))
    monkeypatch.setattr(port_trainer, "Trainer",
                        lambda *a, **k: _PortTrainer(*a, **k, losses=losses))
    groups = [(np.zeros((1, 1)), {})]
    g = DEFAULT_GENERAL_CONFIG
    _, _, jax_best = jax_trainer.train_combined_models_unified(
        groups, [], loss_fn=_Loss(), epochs=epochs, general_config=g, verbose=0,
        log_epoch_percentage=0.5)
    trainer, _, port_best = port_trainer.train_combined_models_unified(
        groups, [], _Loss(), epochs=epochs, general_config=g, verbose=0,
        log_epoch_percentage=0.5)
    assert int(jax_best["pressure"]) == port_best["pressure"] == trainer.restored["pressure"]
    assert 6 <= port_best["pressure"] < epochs


# -- checkpoint and resume on the dg9 case ---------------------------------
@pytest.fixture(scope="module")
def dg9(tmp_path_factory):
    return setup_case("DG", base_dir=str(tmp_path_factory.mktemp("dg9")), nx=9,
                      n_realizations=6, device="cpu")


def _fresh_loss(case):
    loss_fn = copy.copy(case["loss_fn"])
    loss_fn.models = {**case["models"], **{k: copy.deepcopy(case["models"][k])
                                           for k in ("pressure", "time_step")}}
    return loss_fn


class _Crash(Exception):
    pass


def _crash_after_first_epoch(epoch):
    if epoch == 0:
        raise _Crash


def test_resume_gives_the_weights_of_an_uninterrupted_run(dg9, tmp_path):
    """Two epochs straight, and one epoch, a checkpoint and a crash, then a
    new trainer resumed for the second: bitwise the same weights, Adam
    moments and step counts (the generator's state is saved with them)."""
    kw = dict(training_batch_size=32, epochs=2, general_config=dg9["general_config"],
              verbose=0)
    args = (dg9["train_groups"], dg9["val_groups"])
    straight, _, _ = port_trainer.train_combined_models_unified(*args, _fresh_loss(dg9), **kw)
    with pytest.raises(_Crash):
        port_trainer.train_combined_models_unified(
            *args, _fresh_loss(dg9), checkpoint_dir=str(tmp_path),
            callbacks=[_crash_after_first_epoch], **kw)
    assert CheckpointManager(str(tmp_path)).latest_step() == 0
    resumed, history, _ = port_trainer.train_combined_models_unified(
        *args, _fresh_loss(dg9), checkpoint_dir=str(tmp_path), resume=True, **kw)
    assert len(history["total_train_loss"]) == 1          # only the second epoch ran
    for key in straight.optimizer_keys:
        a, b = straight.optimizers[key], resumed.optimizers[key]
        for x, y in zip(a.params + a.mu + a.nu + [a.count], b.params + b.mu + b.nu + [b.count]):
            assert torch.equal(x, y), key
        assert int(b.count) == 2 * straight._resident["train"][2]


def test_checkpoint_manager_keeps_the_last_three(dg9, tmp_path):
    """Saves are atomic renames; the manager keeps max_to_keep=3 and a
    restore writes into the live models in place."""
    loss_fn = _fresh_loss(dg9)
    trainer = port_trainer.Trainer(loss_fn)
    mgr = CheckpointManager(str(tmp_path))
    models = trainer.trained_models()
    for step in range(5):
        with torch.no_grad():
            next(models["pressure"].parameters()).fill_(float(step))
        mgr.save(step, models, trainer.optimizers, history={"total_train_loss": [float(step)]},
                 rng_state=trainer.generator.get_state())
    assert mgr.steps() == [2, 3, 4]
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    param = next(models["pressure"].parameters())
    ptr = param.data_ptr()
    _, _, history, step = mgr.restore(2, params=models, opt_state=trainer.optimizers)
    assert step == 2 and history == {"total_train_loss": [2.0]}
    assert param.data_ptr() == ptr and bool((param == 2.0).all())


def test_cli_checkpoint_and_resume_on_the_cpu(tmp_path):
    """``python -m srm_tpu_torch train --device cpu --checkpoint-dir ...``
    saves after each epoch and, at ``epochs``, after the best-epoch restore
    (as the JAX driver does); ``--resume`` with more epochs continues after
    the latest checkpoint."""
    base = ["--fluid", "DG", "--nx", "9", "--realizations", "6", "--device", "cpu",
            "--base-dir", str(tmp_path / "data"), "--checkpoint-dir", str(tmp_path / "ckpt")]
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "2"}

    def run(*extra):
        proc = subprocess.run([sys.executable, "-m", "srm_tpu_torch", "train", *base, *extra],
                              cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-4000:]
        return proc

    run("--epochs", "1")
    assert CheckpointManager(str(tmp_path / "ckpt")).steps() == [0, 1]
    proc = run("--epochs", "3", "--resume")
    assert "Resumed from checkpoint at epoch 2" in proc.stderr
    assert "final total train loss" in proc.stdout
