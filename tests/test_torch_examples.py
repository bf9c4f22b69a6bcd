"""The port's example drivers and the saturation-head probe, on the CPU.

Each driver's ``main([...])`` runs at 9×9 with 6 realizations for one
epoch, and its train loss matches the JAX driver's at the same size, with
the same flax weights, within ``tests/test_torch_slice.py``'s tolerance
(rtol 1e-3, the losses of both packages' unfused residuals on the CPU).
The batch size is larger than the train split, so that both drivers clamp
it to the split and take one step: the epoch's loss is then the loss of
the initial weights on every training sample, which does not depend on the
order the two packages' generators draw (a longer epoch's steps would see
other batches in each package).
"""

import jax
import numpy as np
import pytest
import torch

import srm_tpu.examples.training_case_dry_gas as jax_dg
import srm_tpu.examples.training_case_gas_condensate as jax_gc
import srm_tpu_torch.examples.training_case_dry_gas as port_dg
import srm_tpu_torch.examples.training_case_gas_condensate as port_gc
from srm_tpu_torch.nn.convert import load_flax_params
from srm_tpu_torch.tools import sg_head_probe

SLICE_RTOL = 1e-3
ONE_STEP = "100000"           # larger than any 9×9 train split: clamped to it

DRIVERS = {"DG": (jax_dg, port_dg, "setup_dry_gas_case"),
           "GC": (jax_gc, port_gc, "setup_gas_condensate_case")}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize("fluid", ["DG", "GC"])
def test_driver_trains_like_the_jax_driver(fluid, tmp_path, monkeypatch, capsys):
    jax_mod, port_mod, setup = DRIVERS[fluid]
    flax = {}
    jax_setup, port_setup = getattr(jax_mod, setup), getattr(port_mod, setup)

    def jax_case(*a, **kw):
        case = jax_setup(*a, **kw)
        flax["params"] = jax.tree_util.tree_map(np.asarray, case["params"])
        return case

    def port_case(*a, **kw):
        case = port_setup(*a, **kw)
        load_flax_params(case["models"], flax["params"])
        return case

    monkeypatch.setattr(jax_mod, setup, jax_case)
    monkeypatch.setattr(port_mod, setup, port_case)
    args = ["--nx", "9", "--realizations", "6", "--epochs", "1", "--batch-size", ONE_STEP]
    _, want, _ = jax_mod.main(args + ["--base-dir", str(tmp_path / "jax")])
    trainer, got, best = port_mod.main(args + ["--base-dir", str(tmp_path / "port"),
                                              "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Final total train loss:" in out
    assert trainer.device.type == "cpu" and best is not None
    assert len(got["step_total_loss"]) == 1, got["step_total_loss"]
    np.testing.assert_allclose(got["total_train_loss"][0], want["total_train_loss"][0],
                               rtol=SLICE_RTOL)


def test_driver_maps_the_stencil_switch(tmp_path):
    """``use_cuda_stencil`` (the JAX keyword ``use_pallas_stencil``) sets the
    loss's switch; a per-cell porosity or 3D gas condensate keeps it off."""
    on = port_dg.setup_dry_gas_case(base_dir=str(tmp_path), nx=9, n_realizations=6,
                                    use_cuda_stencil=True, device="cpu")
    off = port_dg.setup_dry_gas_case(base_dir=str(tmp_path), nx=9, n_realizations=6,
                                     use_cuda_stencil=False, device="cpu")
    default = port_dg.setup_dry_gas_case(base_dir=str(tmp_path), nx=9, n_realizations=6,
                                         device="cpu")
    assert (on["loss_fn"].use_cuda_stencil, off["loss_fn"].use_cuda_stencil,
            default["loss_fn"].use_cuda_stencil) == (True, False, False)


def test_drivers_refuse_the_cpu_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (port_dg, port_gc):
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main(["--nx", "9", "--realizations", "6", "--epochs", "1"])


def test_sg_head_probe_reports_finite_values(tmp_path):
    """The drawdown case at 9×9 (6 realizations, every split labelled by the
    simulator), one epoch: every key of the JAX tool's report, finite."""
    case = sg_head_probe.build_case(base_dir=str(tmp_path), device="cpu", nx=9, realizations=6)
    report = sg_head_probe.probe(case, epochs=1, batch=32, device="cpu")
    keys = {"sg_pred_minus_sgi": ("min", "mean", "max"), "pre_activation": ("min", "mean", "max"),
            "softplus_pre": ("mean", "max")}
    for key, stats in keys.items():
        assert set(report[key]) == set(stats)
        assert all(np.isfinite(report[key][s]) for s in stats), report
    for key in ("sg_label_grad_l1_per_param", "sg_label_sse", "trivial_sse", "Sgi"):
        assert np.isfinite(report[key]), report
    assert report["sat_act"] == "softplus (default)"
    assert report["sg_label_grad_l1_per_param"] > 0 and report["trivial_sse"] > 0
