"""The port's evaluation helpers against the JAX package's: the time-step
recorder and log parser (``eval/timestep_log.py``), ``ModelPlotter``'s
prediction and times (``eval/plotting.py``) on the same flax weights; the
plots each write a file; and ``tools/infer_vs_sim`` on the CPU prints the
reference's keys (``bench.py::measure_inference``)."""

import json

import numpy as np
import pytest
import torch

from srm_tpu.eval.plotting import ModelPlotter as JaxPlotter
from srm_tpu.eval.timestep_log import TimestepRecorder as JaxRecorder
from srm_tpu.eval.timestep_log import parse_timestep_log as jax_parse
from srm_tpu_torch.eval import ModelPlotter, TimestepRecorder, parse_timestep_log, plot_timesteps
from test_torch_predictor import TIMES, dg  # noqa: F401  (shared fixture)

LOG = """\
step 0
  tensor_name: "tstep"
  values: "[1.5 2.25 3.0]"
step 1
  values: "[4.0e-1 -2.5E+0 7]"
unrelated: "[9 9]"
  values: ""
  values: "[0.125 1e-3]"
"""

# bench.py:289-301
REFERENCE_KEYS = {"grid", "realizations", "timesteps", "surrogate_s", "simulator_s",
                  "surrogate_s_e2e", "surrogate_reps", "simulator_reps",
                  "surrogate_spread_pct", "simulator_spread_pct", "surrogate_fields_per_sec",
                  "speedup_vs_simulator", "time_saving_pct"}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def test_timestep_recorder_matches_reference():
    rng = np.random.RandomState(0)
    batches = [rng.uniform(0.1, 10.0, (4, 1)).astype(np.float32) for _ in range(5)]
    got, want = TimestepRecorder(), JaxRecorder()
    for step, b in enumerate(batches):
        got.record(step, torch.from_numpy(b))         # a tensor, as the trainer has it
        want.record(step, b)
    assert (got.steps, got.means, got.mins, got.maxs) == \
        (want.steps, want.means, want.mins, want.maxs)
    assert got.summary() == want.summary() and got.summary()["steps"] == 5


def test_parse_timestep_log_matches_reference(tmp_path):
    path = tmp_path / "tensor_log.txt"
    path.write_text(LOG)
    got, want = parse_timestep_log(str(path)), jax_parse(str(path))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[1], [0.4, -2.5, 7.0])


@pytest.fixture(scope="module")
def plotters(dg):  # noqa: F811
    """Both packages' ModelPlotter over the same (A=2, B=3) test group on
    the same (perturbed) flax weights."""
    jp, tp, permx = dg
    feats = tp.build_features(permx, np.asarray(TIMES))
    labels = {"PRESSURE": np.full(feats.shape[:-1], 4990.0, np.float32)}
    norm = tp.norm_config
    got = ModelPlotter(tp.models, [(feats, labels)], data_summary=tp.data_summary,
                       norm_config=norm, batch_size=4)
    want = JaxPlotter(jp.models, jp.params, [(feats, labels)], data_summary=jp.data_summary,
                      norm_config=norm, batch_size=4)
    return got, want, feats


def test_model_plotter_predict_and_times_match_reference(plotters):
    got, want, feats = plotters
    p, q = got.predict(feats), want.predict(feats)
    assert p.shape == q.shape == (2, 3, 1, 13, 13, 1)
    np.testing.assert_allclose(p, q, rtol=1e-5, atol=1e-3)
    t, u = got.extract_times(feats), want.extract_times(feats)
    assert t.shape == u.shape == (2, 3)
    np.testing.assert_allclose(t, u, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(t, np.tile(TIMES, (2, 1)), atol=1e-3)


def test_plots_write_files(plotters, tmp_path):
    got, _, _ = plotters
    got.set_unit_labels("(days)", "(psia)")
    got.plot_line(save_path=str(tmp_path / "line.png"))
    figs = got.plot_images(per_page=2, save_path=str(tmp_path / "img.png"))
    assert len(figs) == 1
    rec = TimestepRecorder()
    for step in range(12):
        rec.record(step, np.linspace(1.0, 2.0, 4) + 0.1 * step)
    plot_timesteps(rec, save_path=str(tmp_path / "dt.png"), window=3)
    for name in ("line.png", "img_p0.png", "dt.png"):
        assert (tmp_path / name).stat().st_size > 1000, name


def test_infer_vs_sim_on_the_cpu(tmp_path, capsys):
    """The reference's workload at 9×9 cut to 2 test realizations × 74
    times, one repeat of the simulator."""
    from srm_tpu_torch.tools import infer_vs_sim

    result = infer_vs_sim.main(["--device", "cpu", "--nx", "9", "--realizations", "2",
                                "--reps", "2", "--sim-reps", "1", "--base-dir", str(tmp_path)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(result))
    assert REFERENCE_KEYS <= set(line)
    assert line["grid"] == "9x9x1" and line["realizations"] == 2 and line["timesteps"] == 74
    assert line["device"] == "cpu" and line["surrogate_reps"] == 2
    assert line["simulator_reps"] == 1 and len(line["simulator_reps_s"]) == 1
    assert line["surrogate_s"] > 0 and line["simulator_s"] > 0
    assert line["surrogate_fields_per_sec"] == pytest.approx(2 * 74 / line["surrogate_s"])
    assert line["speedup_vs_simulator"] == pytest.approx(line["simulator_s"] / line["surrogate_s"])
