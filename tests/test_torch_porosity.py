"""Per-cell porosity in the port's loss (ROADMAP A2) against the JAX
package's, on dry gas 2D and 3D and gas condensate 2D and 3D (9×9 and
9×9×9, 6 realizations, the same weights and batch):

* a constant field gives the scalar-porosity loss at rtol 1e-5, the JAX
  package's own criterion (``tests/test_loss_training.py:200-237``);
* a two-zone field (the western half at a quarter of the porosity, as
  there) gives the JAX package's loss terms at rtol 1e-3, as the slices
  hold them, and moves the porosity-proportional terms;
* a field of the wrong cell count raises, as the simulator's
  ``_phi_from_config`` does;
* with a field the fused stencil is off on the card too (the kernels take
  a scalar porosity), as the JAX package turns its Pallas stencil off.

Dry gas runs at the default tde weight (tde carries φ in its exact part);
gas condensate at tde weight 0, as its slices, since its tde is float32
noise (ROADMAP C1): there the tank balances, φ-proportional, show the field.
"""

import copy
import logging

import jax
import numpy as np
import pytest
import torch

from srm_tpu.config import DEFAULT_GENERAL_CONFIG, get_optimizer_model_mapping
from srm_tpu.examples.common import setup_case as jax_setup_case
from srm_tpu.losses.physics_loss import PhysicsLoss as JaxPhysicsLoss
from srm_tpu.sim.fv_simulator import _phi_from_config
from srm_tpu_torch.data.batching import collapse_groups
from srm_tpu_torch.examples.common import setup_case
from srm_tpu_torch.losses.physics_loss import PhysicsLoss, fused_stencil_selected
from srm_tpu_torch.nn.convert import load_flax_params
from test_torch_slice import _j, _t
from test_torch_slice_gc3d import FIELD_REL

_3D = dict(nz=9, kle_method="uncorrelated")
PATHS = {"dg2d": ("DG", {}), "dg3d": ("DG", _3D), "gc2d": ("GC", {}), "gc3d": ("GC", _3D)}
# away from t0, where the HardLayers pin the fields and the accumulations vanish
BATCH = [5, 30, 64, 101]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module", params=list(PATHS))
def case(request, tmp_path_factory):
    name = request.param
    fluid, kw = PATHS[name]
    g = copy.deepcopy(DEFAULT_GENERAL_CONFIG)
    g["label_source"] = "files"
    if fluid == "GC":
        for ph in ("gas", "oil"):
            g["default_weights"][ph]["tde"] = 0.0
    kw = dict(nx=9, n_realizations=6, general_config=g, **kw)
    jcase = jax_setup_case(fluid, base_dir=str(tmp_path_factory.mktemp(f"jax_{name}")), **kw)
    tcase = setup_case(fluid, base_dir=str(tmp_path_factory.mktemp(f"torch_{name}")),
                       device="cpu", **kw)
    load_flax_params(tcase["models"], jax.tree_util.tree_map(np.asarray, jcase["params"]))
    x_all, y_all = collapse_groups(jcase["train_groups"])
    batch = (x_all[BATCH], {k: v[BATCH] for k, v in y_all.items()})
    return dict(name=name, fluid=fluid, jcase=jcase, tcase=tcase, batch=batch)


def two_zone(res) -> np.ndarray:
    """The case's porosity on (Nz, Ny, Nx), its western half at a quarter."""
    phi = np.full((res["Nz"], res["Ny"], res["Nx"]), res["porosity"], np.float32)
    phi[:, :, : res["Nx"] // 2] *= 0.25
    return phi


def port_loss(case, porosity) -> PhysicsLoss:
    tcase = case["tcase"]
    proc = tcase["processor"]
    res = copy.deepcopy(proc.reservoir_config)
    res["porosity"] = porosity
    return PhysicsLoss(tcase["models"], tcase["data_summary"],
                       optimizer_model_names_map=get_optimizer_model_mapping(case["fluid"]),
                       general_config=tcase["general_config"], reservoir_config=res,
                       wells_config=proc.wells_config, fluid_type=case["fluid"])


def jax_loss(case, porosity) -> JaxPhysicsLoss:
    jcase = case["jcase"]
    proc = jcase["processor"]
    res = copy.deepcopy(proc.reservoir_config)
    res["porosity"] = porosity
    return JaxPhysicsLoss(jcase["models"], jcase["data_summary"],
                          optimizer_model_names_map=get_optimizer_model_mapping(case["fluid"]),
                          general_config=jcase["general_config"], reservoir_config=res,
                          wells_config=proc.wells_config, fluid_type=case["fluid"])


def terms(lf, batch):
    with torch.no_grad():
        total, aux = lf.loss_and_metrics(*_t(batch))
    return float(total), {(ph, t): float(aux[ph][t]) for ph in lf.phases for t in aux[ph]}


def test_constant_field_gives_the_scalar_loss(case):
    res = case["tcase"]["processor"].reservoir_config
    lf = port_loss(case, np.full((res["Nz"], res["Ny"], res["Nx"]), res["porosity"], np.float32))
    assert tuple(lf.phi_field.shape) == (res["Nz"], res["Ny"], res["Nx"])
    total_f, aux_f = terms(lf, case["batch"])
    total_s, aux_s = terms(case["tcase"]["loss_fn"], case["batch"])
    np.testing.assert_allclose(total_f, total_s, rtol=1e-5)
    for k, v in aux_s.items():
        np.testing.assert_allclose(aux_f[k], v, rtol=1e-5, atol=1e-12 * total_s, err_msg=str(k))


def _distances(case, porosity):
    """Each weighted term's and the total's relative distance between the
    two packages, and the JAX package's total."""
    jlf = jax_loss(case, porosity)
    total_j, aux_j = jax.jit(jlf.loss_and_metrics)(case["jcase"]["params"], *_j(case["batch"]))
    total_t, aux_t = terms(port_loss(case, porosity), case["batch"])
    rel = {k: abs(v - float(aux_j[k[0]][k[1]])) / max(abs(float(aux_j[k[0]][k[1]])),
                                                      1e-6 * float(total_j))
           for k, v in aux_t.items()}
    rel["total"] = abs(total_t - float(total_j)) / float(total_j)
    return rel, jlf


def test_two_zone_field_matches_the_reference(case):
    """Every weighted term within 1e-3 of the JAX package's (relative, or of
    1e-6 of the total for a vanishing term), and the total; a term that
    the scalar porosity already leaves further apart on this batch (gas
    condensate 2D's gas tank balance, 1.3e-3: the balances magnify the
    networks' float32 rounding, ROADMAP C4) within twice that distance. Gas
    condensate in 3D at FIELD_REL, the bound of its residual fields in
    tests/test_torch_slice_gc3d.py (the z faces' weight and the upstream
    choice magnify the networks' rounding; measured: dom 1.0e-3 apart, 4.4e-4
    with the scalar porosity)."""
    phi = two_zone(case["tcase"]["processor"].reservoir_config)
    rel, jlf = _distances(case, phi)
    assert jlf.phi_field is not None and not jlf.use_pallas_stencil
    scalar, _ = _distances(case, case["tcase"]["processor"].reservoir_config["porosity"])
    bound = FIELD_REL if case["name"] == "gc3d" else 1e-3
    for k, d in rel.items():
        assert d <= max(bound, 2 * scalar[k]), (k, d, scalar[k])


def test_two_zone_field_moves_the_porosity_terms(case):
    """The two-zone field changes what porosity scales: tde for dry gas, as
    the JAX package's test checks it, and each phase's tank balance for gas
    condensate, by more than 1e-2."""
    res = case["tcase"]["processor"].reservoir_config
    _, aux_f = terms(port_loss(case, two_zone(res)), case["batch"])
    _, aux_s = terms(case["tcase"]["loss_fn"], case["batch"])
    moved = [("gas", "tde")] if case["fluid"] == "DG" else [("gas", "mbc"), ("oil", "mbc")]
    for k in moved:
        assert np.isfinite(aux_f[k]) and not np.isclose(aux_f[k], aux_s[k], rtol=1e-2), (
            k, aux_f[k], aux_s[k])


def test_wrong_cell_count_raises(case):
    """As the simulator's ``_phi_from_config``, with its message."""
    res = copy.deepcopy(case["tcase"]["processor"].reservoir_config)
    res["porosity"] = np.full(res["Nz"] * res["Ny"] * res["Nx"] + 1, 0.2, np.float32)
    with pytest.raises(ValueError) as want:
        _phi_from_config(res)
    with pytest.raises(ValueError) as got:
        port_loss(case, res["porosity"])
    assert str(got.value) == str(want.value)


def test_fused_stencil_is_off_with_a_field(case, caplog):
    """On the card the loss would take the fused op with a scalar porosity
    and the unfused residual with a field, logging the choice; on the CPU
    it is off either way, and the field lives on the loss's device as
    (Nz, Ny, Nx) with phi0 its mean."""
    res = case["tcase"]["processor"].reservoir_config
    phi = two_zone(res)
    cuda = torch.device("cuda")
    assert fused_stencil_selected(cuda) is True
    with caplog.at_level(logging.INFO, logger="srm_tpu_torch.losses.physics_loss"):
        assert fused_stencil_selected(cuda, torch.from_numpy(phi)) is False
    assert "per-cell porosity" in caplog.text
    assert fused_stencil_selected(torch.device("cpu"), torch.from_numpy(phi)) is False
    lf = port_loss(case, phi)
    assert not lf.use_cuda_stencil and lf.phi_field.device == lf.device
    np.testing.assert_array_equal(lf.phi_field.numpy(), phi)
    assert lf.phi0 == float(np.asarray(phi).mean()) == jax_loss(case, phi).phi0
