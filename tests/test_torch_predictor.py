"""The port's predictor (``srm_tpu_torch/eval/predictor.py``) against the JAX
package's ``SRMPredictor`` on the same flax weights and inputs: the woven
features, the pressure and saturation rollouts (batch 16, so the last batch
is padded) and the well rates, on the shared dg13 and gc13 cases; and the
CLI's ``predict`` on the weights that ``train --checkpoint-dir`` saved.

The port's cases are built with ``label_source="files"`` (none present:
zero labels), so no simulator runs: in physics mode the statistics come
from the train split's features and its zero labels in both packages."""

import copy

import jax
import numpy as np
import pytest
import torch

from srm_tpu.eval.predictor import SRMPredictor as JaxPredictor
from srm_tpu_torch.config import DEFAULT_GENERAL_CONFIG
from srm_tpu_torch.eval.predictor import SRMPredictor
from srm_tpu_torch.examples.common import setup_case
from srm_tpu_torch.nn.convert import load_flax_params

TIMES = [0.0, 10.0, 50.0]
# the bound of tests/test_serving.py:48-49
RTOL, ATOL_PSIA = 1e-5, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def port_case(base_dir, fluid, nx, n_realizations):
    g = copy.deepcopy(DEFAULT_GENERAL_CONFIG)
    g["label_source"] = "files"
    return setup_case(fluid, base_dir=str(base_dir), nx=nx, n_realizations=n_realizations,
                      general_config=g, device="cpu")


def perturbed(params, seed=0, scale=0.02, gain=1e4):
    """The flax weights plus seeded noise, and the pressure network's output
    projection times ``gain``: the initial pressure network's output is
    ~1e-3, which would leave every rollout within 0.01 psia of Pi."""
    rng = np.random.RandomState(seed)

    def leaf(path, a):
        a = np.asarray(a) + scale * rng.standard_normal(np.shape(a))
        names = [getattr(k, "key", None) for k in path]
        if names[0] == "pressure" and "output_proj" in names:
            a = a * gain
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


def pair(jmodels, jparams, jsummary, jg, jres, tcase, batch_size=16):
    """(the JAX package's predictor, the port's) on the same flax weights,
    perturbed."""
    jparams = perturbed(jparams)
    load_flax_params(tcase["models"], jparams)
    jp = JaxPredictor(jmodels, jparams, jsummary, general_config=jg, reservoir_config=jres,
                      batch_size=batch_size)
    tp = SRMPredictor(tcase["models"], tcase["data_summary"],
                      general_config=tcase["general_config"],
                      reservoir_config=tcase["processor"].reservoir_config,
                      batch_size=batch_size)
    return jp, tp


@pytest.fixture(scope="module")
def dg(dg13_case, tmp_path_factory):
    tcase = port_case(tmp_path_factory.mktemp("torch_dg13"), "DG", 13, 8)
    proc = dg13_case["processor"]
    jp, tp = pair(dg13_case["models"], dg13_case["params"], dg13_case["data_summary"],
                  dg13_case["general_config"], proc.reservoir_config, tcase)
    permx = proc.generate_kle_splits()["test"][:2]
    return jp, tp, permx


@pytest.fixture(scope="module")
def gc(gc13_case, tmp_path_factory):
    tcase = port_case(tmp_path_factory.mktemp("torch_gc13"), "GC", 13, 4)
    proc = gc13_case["proc"]
    jp, tp = pair(gc13_case["models"], gc13_case["params"], gc13_case["ds"], gc13_case["g"],
                  proc.reservoir_config, tcase)
    permx = proc.generate_kle_splits()["test"][:2]
    return jp, tp, permx


def test_same_permeability_and_statistics(dg, gc):
    for jp, tp, permx in (dg, gc):
        np.testing.assert_array_equal(
            tp.data_summary.table_np[:5], np.asarray(jp.data_summary.table_np[:5]))
        assert permx.shape[0] == 2 and permx.shape[1:] == (1, 13, 13)


def test_build_features_matches_reference(dg):
    jp, tp, permx = dg
    want = jp.build_features(permx, np.asarray(TIMES))
    got = tp.build_features(permx, np.asarray(TIMES))
    assert got.shape == want.shape == (2, 3, 1, 13, 13, 5)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fluid", ["DG", "GC"])
def test_predict_pressure_matches_reference(fluid, dg, gc):
    """2 realizations × 3 times = 6 fields in one padded batch of 16."""
    jp, tp, permx = dg if fluid == "DG" else gc
    want = jp.predict_pressure(permx, TIMES)
    got = tp.predict_pressure(permx, TIMES)
    assert got.shape == want.shape == (2, 3, 1, 13, 13)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_PSIA)
    # the hard initial condition: Pi at t = 0
    np.testing.assert_array_equal(got[:, 0], 5000.0)
    assert np.abs(got[:, 1:] - 5000.0).max() > 10.0


def test_predict_saturation_matches_reference(gc):
    jp, tp, permx = gc
    want = jp.predict_saturation(permx, TIMES)
    got = tp.predict_saturation(permx, TIMES)
    assert got.shape == want.shape == (2, 3, 1, 13, 13)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_PSIA)


def reference_rates(jp, permx, times):
    """The reference's ``predict_rates`` (srm_tpu/eval/predictor.py:100-115)
    up to its reshape: ``Sg_n1=None``, so gas condensate is evaluated at
    Sg_max; (q, pwf) flat over (K·T)."""
    import jax.numpy as jnp
    flat = jp.build_features(permx, np.asarray(times))
    flat = flat.reshape((-1,) + flat.shape[2:])
    p = jp._batched_apply("pressure", flat)
    pvt, pvt_params = jp.models["pvt_model"], jp.params["pvt_model"]
    return jp.models["well_rate_bhp_model"].compute_rates_and_bhp(
        jnp.asarray(flat), jnp.asarray(p), None, model_PVT=lambda pp: pvt.apply(pvt_params, pp))


@pytest.mark.parametrize("fluid", ["DG", "GC"])
def test_predict_rates_matches_reference(fluid, dg, gc):
    """DG: (q, pwf). GC: ((qgg, qgo, qoo, qog), pwf) at Sg = Sg_max
    everywhere, as the reference evaluates it with ``Sg_n1=None``; the
    reference's own ``predict_rates`` then fails to reshape the 4-tuple
    (ROADMAP C12), so GC is held to its well solve directly."""
    jp, tp, permx = dg if fluid == "DG" else gc
    tq, tpwf = tp.predict_rates(permx, TIMES)
    if fluid == "DG":
        jq, jpwf = jp.predict_rates(permx, TIMES)
        jq, tq = (jq,), (tq,)
    else:
        with pytest.raises(ValueError, match="reshape"):
            jp.predict_rates(permx, TIMES)
        jq, jpwf = reference_rates(jp, permx, TIMES)
        assert isinstance(tq, tuple) and len(tq) == len(jq) == 4
    for got, want in zip(tq + (tpwf,), tuple(jq) + (jpwf,)):
        want = np.asarray(want).reshape(got.shape)
        assert got.shape[:2] == (2, 3) and got.shape[2:] == (1, 13, 13, 1)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    assert np.abs(tpwf).max() > 1000.0 and np.abs(tq[0]).max() > 0.0


def test_predictor_refuses_a_graph_on_the_cpu(dg):
    _, tp, _ = dg
    assert tp.device.type == "cpu" and not tp.cuda_graph
    with pytest.raises(ValueError, match="CUDA device"):
        SRMPredictor(tp.models, tp.data_summary, cuda_graph=True)
    with pytest.raises(ValueError, match="multiple of the batch"):
        tp.run_batches("pressure", torch.zeros((5, 1, 13, 13, 5)))


def test_cli_predict_restores_the_trained_weights(tmp_path, capsys):
    """One epoch of ``train --checkpoint-dir`` at 9×9, then ``predict
    --checkpoint-dir --out``: the saved arrays are the predictor's on the
    restored weights, which are not the initial ones."""
    from srm_tpu_torch.__main__ import main
    from srm_tpu_torch.utils.checkpoint import CheckpointManager

    base, ckpt, out = str(tmp_path), str(tmp_path / "ckpt"), str(tmp_path / "x.npz")
    flags = ["--fluid", "DG", "--nx", "9", "--realizations", "6", "--base-dir", base,
             "--device", "cpu"]
    assert main(["train", *flags, "--epochs", "1", "--batch-size", "32",
                 "--checkpoint-dir", ckpt]) == 0
    assert main(["predict", *flags, "--checkpoint-dir", ckpt, "--times", "0,10,50",
                 "--out", out]) == 0
    printed = capsys.readouterr().out
    assert "restored checkpoint step 1" in printed and "pressure rollout" in printed
    with np.load(out) as z:
        got = {k: z[k] for k in z.files}
    assert set(got) == {"pressure", "times"}
    np.testing.assert_array_equal(got["times"], TIMES)

    case = setup_case("DG", base_dir=base, nx=9, n_realizations=6, device="cpu")
    permx = case["processor"].generate_kle_splits()["test"][:4]
    fresh = SRMPredictor(case["models"], case["data_summary"], case["general_config"],
                         case["processor"].reservoir_config).predict_pressure(permx, TIMES)
    trained = {k: case["models"][k] for k in ("pressure", "time_step")}
    assert CheckpointManager(ckpt).restore(params=trained)[3] == 1
    want = SRMPredictor(case["models"], case["data_summary"], case["general_config"],
                        case["processor"].reservoir_config).predict_pressure(permx, TIMES)
    assert got["pressure"].shape == want.shape == (4, 3, 1, 9, 9)
    np.testing.assert_array_equal(got["pressure"], want)
    assert not np.array_equal(want, fresh)


@pytest.mark.parametrize("command", [["predict"], ["export", "--out-dir", "bundle"]])
def test_cli_refuses_drawdown(command, tmp_path, monkeypatch):
    """The ``--drawdown`` preset (ported, A11) runs on the card by default:
    without one and without ``--device cpu`` it is refused before anything
    is built (tests/test_torch_production.py runs it on the CPU)."""
    from srm_tpu_torch.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main([*command, "--drawdown", "--base-dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())
