"""The port's space axis (``make_mesh(n, spatial=k)``: H split in row blocks
over the ranks of a space group, ``parallel/halo.py``'s exchanges) on the
CPU, held to the whole grid and to the JAX package's
``make_mesh(8, spatial=2)`` (the 8 virtual CPU devices of
``tests/conftest.py``; the cases of ``tests/test_spatial_sharding.py``).

The ranks are gloo processes of ``tests/torch_parallel_ranks.py`` meeting
through a ``file://`` store, started by ``test_torch_parallel.run_ranks``:
one group of 2 ranks and one of 4 (2 × 2), each serving several tests.

Tolerances (``test_torch_parallel``'s where they apply):
- TOTAL_RTOL: a step's total over the ranks against the JAX mesh's and
  one process's, float32 sums in another order;
- ADAM_RTOL, ADAM_ATOL: weights after an Adam step (a weight whose
  gradient is ~0 may move by up to the learning rate either way);
- GRAD_RTOL: the float64 gradients summed over the 4 ranks against one
  process's, as the L2 distance per model over its norm;
- EPOCH_RTOL: the per-step metrics of float64 epochs against one
  process's; on a space axis SPACE_EPOCH_RTOL: Model 1's resize at 12×12
  computes in float32 (as the reference's) and sums its backward in
  another order over blocks (1e-8 of the gradient), which the next Adam
  steps carry into the metrics (1.2e-6 measured on the Δt mean);
- NET_RTOL: a network's parameter and input gradients over row blocks
  against the whole grid's, in float64: the decoder's resize computes in
  float32 (as the reference's), and its backward sums in another order
  over blocks (1e-8 measured); the outputs are within 1e-12;
- PAD_TOL: the halo pads' float64 VJP against ``jax.vjp`` of
  ``jnp.pad(mode="symmetric")`` on the whole grid (sums in another order);
- MBC_RTOL: the kernels' plain versions' per-sample balances over two
  blocks against the whole grid's, float32 sums in another order;
- ADJ_TOL: the plain backward versions' gradients over blocks, the halo
  rows' cotangents added to their owners, against the whole grid's, in
  float64, of each gradient's largest magnitude;
- PRESET_RTOL: the production preset (bf16 networks) over 2 ranks against
  one process: its convolutions round in bfloat16 on windows of another
  shape (1.5e-3 measured on the total);
- FLAX_RTOL: a network's output rows over a space axis against the flax
  module's on the whole grid: float32 convolutions in two libraries
  (``tests/test_torch_knobs.py``'s RTOL); for the ``latent_flatten`` and
  VAE cases also as an absolute bound of the output's largest magnitude,
  as ``tests/test_torch_nn_options.py`` holds these modules (the
  encoder–decoder's outputs cross zero, where float32's rounding is of the
  output's scale: 3.4e-4 relative on 4 of 722 entries at 19×19);
- SLICE3D_RTOL: the DG 3D step's total against the JAX mesh's
  (``tests/test_torch_slice_3d.py``'s bound: the float32 7-point stencil
  rounds ~1e-3 of its scale in either package; 5.2e-4 measured), beside
  TOTAL_RTOL against the port's one process;
- the production preset over 2 × 2 ranks against the JAX mesh: the two
  libraries round bfloat16 apart, so the total is held within twice the
  JAX package's own bfloat16-to-float32 distance on the same weights and
  batch plus BF16_TOTAL_RTOL (``tests/test_torch_knobs.py``'s rule for a
  bf16 step), the weights within the Adam-step bound;
- LOG_RTOL: the well solver's iteration logs (six significant digits) of
  a float64 step against the JAX package's float32 step on the same
  weights and batch (``tests/test_torch_parallel.py``'s bound for logs in
  another rounding).

``remat_forwards`` recomputes the same operations in the same order, so a
step with it is held to the same step without it bit for bit.
"""

import copy
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srm_tpu.config import DEFAULT_GENERAL_CONFIG as JAX_GENERAL_CONFIG
from srm_tpu.config import DEFAULT_RESERVOIR_CONFIG as JAX_RESERVOIR_CONFIG
from srm_tpu.config import apply_production_overrides as jax_production_overrides
from srm_tpu.config import get_configuration as jax_configuration
from srm_tpu.examples.common import setup_case as jax_setup_case
from srm_tpu.nn import modules as jmod
from srm_tpu.nn.encoder_decoder import EncoderDecoderModel
from srm_tpu.nn.residual import ResidualNetworkLayer
from srm_tpu.parallel.mesh import make_mesh as jax_make_mesh
from srm_tpu.parallel.mesh import shard_batch as jax_shard_batch
from srm_tpu.training.trainer import Trainer as JaxTrainer
from srm_tpu_torch.config import (DEFAULT_GENERAL_CONFIG, apply_production_overrides,
                                  get_configuration)
from srm_tpu_torch.examples.common import setup_case
from srm_tpu_torch.kernels import stencil as st
from srm_tpu_torch.nn.convert import load_flax_module, load_flax_params
from srm_tpu_torch.parallel.halo import Rows
from srm_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch
from srm_tpu_torch.training.trainer import Trainer
from test_torch_cuda import gc_inputs
from test_torch_kernels import _make_inputs as dg_inputs
from test_torch_kernels_3d_bwd import _inputs as dg3d_inputs
from test_torch_parallel import (EPOCH_RTOL, GRAD_RTOL, TOTAL_RTOL, _assert_adam_close,
                                 _assert_ranks_equal, _jax_weights_as_port, _rel, run_ranks)
import torch_parallel_ranks as ranks

NET_RTOL = 1e-6
PAD_TOL = 1e-12
MBC_RTOL = 1e-5
ADJ_TOL = 1e-10
PRESET_RTOL = 1e-2
SPACE_EPOCH_RTOL = 1e-5
FLAX_RTOL = 1e-4
SLICE3D_RTOL = 1e-3
BF16_TOTAL_RTOL = 1e-3
LOG_RTOL = 1e-5
NEWTON_LOG = dict(use_non_iterative=False, max_iters=3)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def _assert_ranks_agree(outs):
    """Every rank's weights finite, and the same bits as rank 0's; a
    parameter that differs is named with its first differing entry."""
    for r, out in enumerate(outs):
        for k, ws in out["weights"].items():
            for j, w in enumerate(ws):
                assert torch.isfinite(w).all(), f"rank {r}: {k} parameter {j} is not finite"
    for r, other in enumerate(outs[1:], 1):
        for k, ws in outs[0]["weights"].items():
            for j, (a, b) in enumerate(zip(ws, other["weights"][k])):
                if not torch.equal(a, b):
                    at = tuple((a != b).nonzero()[0].tolist())
                    raise AssertionError(f"rank {r}: {k} parameter {j} differs from rank 0's "
                                         f"at {at}: {b[at].item()!r} against {a[at].item()!r}")
    _assert_ranks_equal(outs)


# -- (1) the layout ------------------------------------------------------------

@pytest.mark.parametrize("batch_axis", [0, 1])
def test_layout_is_the_jax_space_meshs_shard(batch_axis):
    """Rank r of 8 at ``spatial=2`` (data index r // 2, space index r % 2)
    holds device r's shard of the JAX package's ``shard_batch`` on
    ``make_mesh(8, spatial=2)``, where H (12 rows) divides: its block of
    the batch and its 6 rows; an array of rank < batch_axis + 4 gets no H
    split, as ``_spec_for_rank`` gives it none."""
    rng = np.random.RandomState(3)
    lead = (3,) if batch_axis else ()
    x = rng.standard_normal(lead + (8, 1, 12, 12, 5)).astype(np.float32)
    flat = rng.standard_normal(lead + (8, 4)).astype(np.float32)
    mesh_j = jax_make_mesh(8, spatial=2)
    assert mesh_j.devices.shape == (4, 2)
    for arr in (x, flat):
        sharded = jax_shard_batch(jnp.asarray(arr), mesh_j, batch_axis=batch_axis)
        shards = {s.device: np.asarray(s.data) for s in sharded.addressable_shards}
        for r, device in enumerate(mesh_j.devices.reshape(-1)):
            mesh = Mesh(size=8, rank=r, space_size=2)
            assert (mesh.data_rank, mesh.space_rank) == (r // 2, r % 2)
            got = shard_batch({"a": arr, "t": torch.from_numpy(arr)}, mesh, batch_axis=batch_axis)
            np.testing.assert_array_equal(got["a"], shards[device])
            np.testing.assert_array_equal(got["t"].numpy(), shards[device])


def test_an_uneven_h_is_split_as_array_split():
    """13 rows over 2 space ranks: blocks of 7 and 6 (``np.array_split``),
    where the JAX package replicates the array; ``Mesh.rows`` and
    ``Rows.split`` give the same blocks, and an H thinner than the space
    axis raises."""
    x = np.arange(4 * 13 * 3, dtype=np.float32).reshape(4, 1, 13, 3)
    jax_shards = jax_shard_batch(jnp.asarray(x), jax_make_mesh(8, spatial=2)).addressable_shards
    assert all(np.array_equal(np.asarray(s.data), x) for s in jax_shards)
    for r in range(4):
        mesh = Mesh(size=4, rank=r, space_size=2)
        block = np.array_split(np.array_split(x, 2)[r // 2], 2, axis=2)[r % 2]
        np.testing.assert_array_equal(shard_batch(x, mesh), block)
        assert mesh.rows(13) == [(0, 7), (7, 13)][r % 2]
        assert Rows.split(mesh, 13).blocks == ((0, 7), (7, 13))
    with pytest.raises(ValueError, match="without a row"):
        Mesh(size=4, rank=0, space_size=4).rows(3)


def test_space_rank_layout_of_a_group_mesh():
    """``make_mesh(spatial=k)`` refuses a world that k does not divide, as
    the JAX package's ``make_mesh`` does (``mesh.py:39-40``)."""
    with pytest.raises(ValueError, match="not divisible by spatial=2"):
        make_mesh(3, spatial=2)
    with pytest.raises(ValueError, match="not divisible by spatial=2"):
        jax_make_mesh(3, spatial=2)


# -- (2) the plain versions of B1-B3 over halo-padded blocks --------------------

def _kernel_case(kind, dtype):
    """(inputs, cfg, reference, backward reference, names of the padded
    inputs) of a kernel at an uneven H (13 rows; 9 in 3D)."""
    if kind == "dg":
        args, cfg = dg_inputs(B=3, H=13, W=7)
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dtype) for a in args]
        return (args, st.StencilConfig(**cfg), st.dg_stencil_residual_reference,
                st.dg_stencil_residual_backward_reference,
                {n for n in st.DG_ARGS if n.endswith("p")})
    if kind == "dg3d":
        args, cfg = dg3d_inputs(dtype, 2, 3, 9, 6)
        return (args, cfg, st.dg3d_stencil_residual_reference,
                st.dg3d_stencil_residual_backward_reference,
                {n for n in st.DG3D_ARGS if n.endswith("p")})
    args, cfg = gc_inputs(3, 13, 7)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dtype) for a in args]
    return (args, st.GCStencilConfig(**cfg), st.gc_stencil_residual_reference,
            st.gc_stencil_residual_backward_reference, set(st.GC_PADDED))


def _names(kind):
    return {"dg": st.DG_ARGS, "dg3d": st.DG3D_ARGS,
            "gc": st.GC_ARGS + ("qwell", "tsteps")}[kind]


def _block_args(kind, args, padded, lo, hi):
    """A block's inputs: the padded fields' rows [lo, hi + 2) (its halo
    rows being its neighbours' rows, the ghost rows only at the domain's
    ends: exactly what ``pad_symmetric`` over blocks gives), the centred
    fields' and qwell's rows [lo, hi), tsteps whole."""
    out = []
    for n, a in zip(_names(kind), args):
        if n == "tsteps":
            out.append(a)
        elif n in padded:
            out.append(a[..., lo:hi + 2, :].contiguous())
        else:
            out.append(a[..., lo:hi, :].contiguous())
    return out


@pytest.mark.parametrize("kind", ["dg", "dg3d", "gc"])
def test_plain_versions_over_blocks_reassemble_the_whole_grid(kind):
    """B1's, B2's and B3's plain versions on the two halo-padded row blocks
    of an uneven H give the whole grid's cell fields bitwise (concatenated)
    and its per-sample balances within MBC_RTOL (summed over the blocks)."""
    args, cfg, ref, _, padded = _kernel_case(kind, torch.float32)
    H = args[-2].shape[-2]
    whole = ref(*args, cfg)
    parts = [ref(*_block_args(kind, args, padded, lo, hi), cfg)
             for lo, hi in ((0, (H + 1) // 2), ((H + 1) // 2, H))]
    for i, w in enumerate(whole):
        if w.dim() >= 3:
            assert torch.equal(torch.cat([p[i] for p in parts], dim=-2), w), i
        else:
            np.testing.assert_allclose(sum(p[i] for p in parts).numpy(), w.numpy(),
                                       rtol=MBC_RTOL)


@pytest.mark.parametrize("kind", ["dg", "dg3d", "gc"])
def test_plain_backward_over_blocks_sums_to_the_whole_grids(kind):
    """The plain backward versions on each block, for the block's rows of
    the cell cotangents and the whole per-sample ones: each block's padded
    gradients (its halo rows' cotangents included) added into their owners'
    rows give the whole grid's gradients within ADJ_TOL, in float64."""
    args, cfg, ref, bwd, padded = _kernel_case(kind, torch.float64)
    H = args[-2].shape[-2]
    outs = ref(*args, cfg)
    rng = np.random.RandomState(4)
    cots = [torch.from_numpy(rng.standard_normal(tuple(o.shape))) for o in outs]
    want = bwd(*args, *cots, cfg)
    got = [None if w is None else torch.zeros_like(w) for w in want]
    for lo, hi in ((0, (H + 1) // 2), ((H + 1) // 2, H)):
        block = _block_args(kind, args, padded, lo, hi)
        bc = [c[..., lo:hi, :] if c.dim() >= 3 else c for c in cots]
        for n, g, acc in zip(_names(kind), bwd(*block, *bc, cfg), got):
            if g is None or n == "tsteps":
                if g is not None:
                    acc += g
                continue
            acc[..., lo:hi + (2 if n in padded else 0), :] += g
    for n, g, w in zip(_names(kind), got, want):
        if w is None:
            continue
        err = (g - w).abs().max() / w.abs().max().clamp_min(1e-300)
        assert float(err) <= ADJ_TOL, (n, float(err))


# -- the shared cases and their runs -------------------------------------------

@pytest.fixture(scope="module")
def dg12(tmp_path_factory):
    """The JAX package's DG case at nx = 12 (``test_spatial_sharding``'s
    sp_case), the port's case with its weights, and its 8-sample batch."""
    from srm_tpu.examples.training_case_dry_gas import setup_dry_gas_case
    base = tmp_path_factory.mktemp("spatial_dg")
    jcase = setup_dry_gas_case(base_dir=str(base / "jdata"), nx=12, n_realizations=8)
    tcase = setup_case("DG", base_dir=str(base / "data"), nx=12, n_realizations=8,
                       device="cpu")
    load_flax_params(tcase["models"], jax.tree_util.tree_map(np.asarray, jcase["params"]))
    torch.save({k: tcase["models"][k].state_dict() for k in ("pressure", "time_step")},
               base / "weights.pt")
    x, y = jcase["train_groups"][0]
    xb = x[:2, :4].reshape((-1,) + x.shape[2:])
    yb = {k: v[:2, :4].reshape((-1,) + v.shape[2:]) for k, v in y.items()}
    np.savez(base / "batch.npz", x=xb, **{f"y_{k}": v for k, v in yb.items()})
    spec = dict(fluid="DG", base_dir=str(base / "data"), nx=12, realizations=8,
                weights=str(base / "weights.pt"), batch=str(base / "batch.npz"))
    return dict(jcase=jcase, tcase=tcase, x=xb, y=yb, spec=spec, base=base)


@pytest.fixture(scope="module")
def gc12(tmp_path_factory):
    """The JAX package's GC case at nx = 12 (sp_case_gc) and the port's."""
    from srm_tpu.examples.training_case_gas_condensate import setup_gas_condensate_case
    base = tmp_path_factory.mktemp("spatial_gc")
    jcase = setup_gas_condensate_case(base_dir=str(base / "jdata"), nx=12, n_realizations=8)
    g = copy.deepcopy(DEFAULT_GENERAL_CONFIG)
    g["label_source"] = "files"
    tcase = setup_case("GC", base_dir=str(base / "data"), nx=12, n_realizations=8,
                       general_config=g, device="cpu")
    names = ("pressure", "time_step", "saturation_model")
    load_flax_params(tcase["models"], jax.tree_util.tree_map(np.asarray, jcase["params"]))
    torch.save({k: tcase["models"][k].state_dict() for k in names}, base / "weights.pt")
    x, y = jcase["train_groups"][0]
    xb = x[:2, :4].reshape((-1,) + x.shape[2:])
    yb = {k: v[:2, :4].reshape((-1,) + v.shape[2:]) for k, v in y.items()}
    np.savez(base / "batch.npz", x=xb, **{f"y_{k}": v for k, v in yb.items()})
    spec = dict(fluid="GC", base_dir=str(base / "data"), nx=12, realizations=8,
                general_config=g, weights=str(base / "weights.pt"),
                batch=str(base / "batch.npz"))
    return dict(jcase=jcase, tcase=tcase, x=xb, y=yb, spec=spec)


def _shared_case(jcase, tcase, base, spec):
    """The port's case ``tcase`` with the JAX package's weights saved, and
    the JAX case's first 4 training samples as the batch of a rank spec."""
    load_flax_params(tcase["models"], jax.tree_util.tree_map(np.asarray, jcase["params"]))
    torch.save({k: tcase["models"][k].state_dict() for k in ("pressure", "time_step")},
               base / "weights.pt")
    x, y = jcase["train_groups"][0]
    xb = x.reshape((-1,) + x.shape[2:])[:4]
    yb = {k: v.reshape((-1,) + v.shape[2:])[:4] for k, v in y.items()}
    np.savez(base / "batch.npz", x=xb, **{f"y_{k}": v for k, v in yb.items()})
    spec = dict(spec, base_dir=str(base / "data"), realizations=4,
                weights=str(base / "weights.pt"), batch=str(base / "batch.npz"))
    return dict(jcase=jcase, tcase=tcase, x=xb, y=yb, spec=spec)


@pytest.fixture(scope="module")
def dg3d9(tmp_path_factory):
    """Both packages' DG 3D case at 9 × 9 × 9 (uncorrelated fields, 4
    realizations), the port's with the JAX package's weights, and a
    4-sample batch."""
    base = tmp_path_factory.mktemp("spatial_dg3d")
    kw = dict(nx=9, nz=9, n_realizations=4, kle_method="uncorrelated")
    return _shared_case(jax_setup_case("DG", base_dir=str(base / "jdata"), **kw),
                        setup_case("DG", base_dir=str(base / "data"), device="cpu", **kw),
                        base, dict(fluid="DG", nx=9, nz=9))


@pytest.fixture(scope="module")
def preset13(tmp_path_factory):
    """Both packages' DG case at 13 × 13 under the production preset
    (bfloat16 networks, Model 2 on every 2nd row and column), the port's
    with the JAX package's weights, a 4-sample batch, and the JAX
    package's float32 twin of the case (the preset without its compute
    dtype) for its own bfloat16 distance."""
    base = tmp_path_factory.mktemp("spatial_preset")
    jg = jax_production_overrides(JAX_GENERAL_CONFIG)
    assert (jg["compute_dtype"], jg["dt_input_stride"]) == ("bfloat16", 2)
    kw = dict(nx=13, n_realizations=4)
    case = _shared_case(
        jax_setup_case("DG", base_dir=str(base / "jdata"), general_config=jg, **kw),
        setup_case("DG", base_dir=str(base / "data"), device="cpu",
                   general_config=apply_production_overrides(DEFAULT_GENERAL_CONFIG), **kw),
        base, dict(fluid="DG", nx=13, production=True))
    case["j32"] = jax_setup_case("DG", base_dir=str(base / "jdata32"),
                                 general_config=dict(jg, compute_dtype=None), **kw)
    return case


def _logged(spec, directory, **kwargs):
    """``spec`` with the well solver logging its iterations into ``directory``."""
    return dict(spec, well_solver_kwargs=dict(kwargs, log_iterations=True,
                                              log_dir=str(directory)))


@pytest.fixture(scope="module")
def world4(dg12, gc12, dg3d9, preset13, tmp_path_factory):
    """Four ranks as 2 × 2 (data × space): the DG step in float32 and in
    float64 and the GC step, each on its 8-sample batch; the DG 3D step and
    the production preset's step on their 4-sample batches; then the DG
    step with ``remat_forwards`` in float32 (its direct BHP solve logging
    λ) and in float64, and in float64 with the direct solve's λ log and the
    Newton solve's pwf log."""
    out = tmp_path_factory.mktemp("spatial_world4")
    remat = dict(dg12["spec"], scenario="step", spatial=2, config={"remat_forwards": True})
    step64 = dict(dg12["spec"], scenario="step", spatial=2, float64=True)
    runs = [dict(dg12["spec"], scenario="step", spatial=2), step64,
            dict(gc12["spec"], scenario="step", spatial=2),
            dict(dg3d9["spec"], scenario="step", spatial=2),
            dict(preset13["spec"], scenario="step", spatial=2),
            _logged(remat, out / "logs_remat"), dict(remat, float64=True),
            _logged(step64, out / "logs_lambda"),
            _logged(step64, out / "logs_pwf", **NEWTON_LOG)]
    return run_ranks(out / "ranks", 4, runs)


def _padded_flax_models():
    """The JAX package's Models 1 and 2 at 13×13 with ``spatial_pad_to=16``
    (seed 9): {name: (flax model, params)}."""
    g = copy.deepcopy(JAX_GENERAL_CONFIG)
    g["spatial_pad_to"] = 16
    res = copy.deepcopy(JAX_RESERVOIR_CONFIG)
    res["Nx"] = res["Ny"] = 13
    res["Nz"] = 1
    sample = jnp.zeros((1, 1, 13, 13, 5), jnp.float32)
    out = {}
    for (name, build), key in zip((("pressure", jmod.build_pressure_model),
                                   ("time_step", jmod.build_time_step_model)),
                                  jax.random.split(jax.random.PRNGKey(9))):
        model = build(general_config=g, reservoir_config=res)
        out[name] = (model, model.init(key, sample))
    return out


def _flatten_config(jax_side: bool):
    """The encoder–decoder's default config with ``latent_flatten`` (its
    Dense 128 wide), on (B, T, H, W, C) inputs."""
    cfg = (jax_configuration if jax_side else get_configuration)("encoder_decoder")
    cfg["temporal"] = True
    cfg["residual_params"]["Latent_Layer"].update(Flatten=True, Width=128)
    return cfg


VAE = dict(num_blocks=2, filters=8, output_filters=1, latent_a=0.1, latent_b=10.0,
           temporal=True)


def _flax_vae(model, params, eps):
    """The flax VAE head's output for a given ε: its ``z_mean`` and
    ``z_log_var`` (captured; its own draw unused) through the head's
    formula, broadcast over the grid."""
    def apply(x):
        _, state = model.apply(params, jnp.asarray(x, jnp.float32),
                               rngs={"sample": jax.random.PRNGKey(0)},
                               capture_intermediates=True)
        inter = state["intermediates"]
        z_mean = np.asarray(inter["z_mean"]["__call__"][0], np.float64)
        z_log_var = np.asarray(inter["z_log_var"]["__call__"][0], np.float64)
        z = z_mean + np.exp(0.5 * z_log_var) * eps
        z = (VAE["latent_b"] - VAE["latent_a"]) / (1.0 + np.exp(-z)) + VAE["latent_a"]
        return np.broadcast_to(z.reshape(x.shape[:2] + (1, 1, -1)), x.shape[:-1] + (1,))
    return apply


def _net_cases(dg12, dg13_case):
    """The networks of the rank scenario ``nets``: Model 1 (encoder-decoder
    and HardLayer) with the JAX package's weights at 12×12 (its decoder
    lands on 15 and resizes) and 13×13 (uneven blocks), Model 2 (the
    residual net) at 13×13, both at 9×9×9 (seeded; H 5/4), both at
    13×13 with ``spatial_pad_to=16`` (the JAX package's, seeded), the
    encoder–decoder with ``latent_flatten`` at 13×13 (its encoded level, 1
    row, whole on every rank) and 19×19 (2 rows, split) and the residual
    net with the VAE head at 13×13, given ε, each with the JAX package's
    weights (seeded), and last that VAE net drawing ε from each space
    rank's own generator (seeds 11 and 12); each with a float64 input batch
    and output cotangent; and a function of the input giving the JAX
    package's whole-grid output, for each case that has one, by index."""
    from srm_tpu_torch.nn.modules import build_pressure_model, build_time_step_model
    g = {"maximum_srm_timestep": 10.0}
    res2, res3 = ({"Nz": nz, "initialization": {"Pi": 5000.0}} for nz in (1, 9))
    m13 = {"pressure": build_pressure_model((1, 13, 13, 5), g, res2),
           "time_step": build_time_step_model((1, 13, 13, 5), g)}
    load_flax_params(m13, {k: jax.tree_util.tree_map(np.asarray, dg13_case["params"][k])
                           for k in m13})
    rng = np.random.RandomState(6)
    gen = torch.Generator().manual_seed(9)
    pad = dict(g, spatial_pad_to=16)
    padded = _padded_flax_models()
    m16 = {"pressure": build_pressure_model((1, 13, 13, 5), pad, res2),
           "time_step": build_time_step_model((1, 13, 13, 5), pad)}
    load_flax_params(m16, {k: jax.tree_util.tree_map(np.asarray, padded[k][1]) for k in m16})
    models = [("pressure", dg12["tcase"]["models"]["pressure"], (1, 12, 12, 5), g),
              ("pressure", m13["pressure"], (1, 13, 13, 5), g),
              ("time_step", m13["time_step"], (1, 13, 13, 5), g),
              ("pressure", build_pressure_model((1, 9, 9, 9, 5), g, res3, gen), (1, 9, 9, 9, 5), g),
              ("time_step", build_time_step_model((1, 9, 9, 9, 5), g, gen), (1, 9, 9, 9, 5), g),
              ("pressure", m16["pressure"], (1, 13, 13, 5), pad),
              ("time_step", m16["time_step"], (1, 13, 13, 5), pad)]

    def applied(model, params):
        return lambda x: np.asarray(model.apply(params, jnp.asarray(x, jnp.float32)))

    flax = {0: applied(dg12["jcase"]["models"]["pressure"], dg12["jcase"]["params"]["pressure"]),
            1: applied(dg13_case["models"]["pressure"], dg13_case["params"]["pressure"]),
            2: applied(dg13_case["models"]["time_step"], dg13_case["params"]["time_step"]),
            5: applied(*padded["pressure"]), 6: applied(*padded["time_step"])}
    cases = []
    for name, model, shape, config in models:
        x = torch.from_numpy(rng.uniform(-1, 1, (2,) + shape))
        cases.append({"model": name, "sample_shape": shape, "general_config": config,
                      "state": {k: v.double() for k, v in model.state_dict().items()},
                      "x": x, "w": torch.from_numpy(rng.standard_normal((2,) + shape[:-1] + (1,)))})
    # latent_flatten and the VAE head, the JAX package's weights carried across
    vae_flax = ResidualNetworkLayer(latent_output=True, **VAE)
    sample13 = jnp.zeros((1, 1, 13, 13, 5), jnp.float32)
    vae_params = vae_flax.init({"params": jax.random.PRNGKey(12),
                                "sample": jax.random.PRNGKey(0)}, sample13)
    options = []
    for n, key in ((13, 10), (19, 11)):
        jm = EncoderDecoderModel.from_config(_flatten_config(True))
        params = jm.init(jax.random.PRNGKey(key), jnp.zeros((1, 1, n, n, 5), jnp.float32))
        options.append(("encoder_decoder", _flatten_config(False), jm, params, (1, n, n, 5)))
    options.append(("residual", dict(VAE, latent_output=True), vae_flax, vae_params,
                    (1, 13, 13, 5)))
    for kind, config, jm, params, shape in options:
        case = {"model": kind, "sample_shape": shape, "config": config, "state": {},
                "x": torch.from_numpy(rng.uniform(-1, 1, (2,) + shape)),
                "w": torch.from_numpy(rng.standard_normal((2,) + shape[:-1] + (1,)))}
        module = ranks.net_module(case)
        load_flax_module(module, jax.tree_util.tree_map(np.asarray, params))
        case["state"] = module.state_dict()
        if kind == "residual":
            eps = rng.standard_normal((2, 1))
            case["kwargs"] = {"eps": torch.from_numpy(eps)}
            flax[len(cases)] = _flax_vae(jm, params, eps)
        else:
            flax[len(cases)] = applied(jm, params)
        cases.append(case)
    drawn = {k: v for k, v in cases[-1].items() if k != "kwargs"}
    cases.append(dict(drawn, seeds=[11, 12]))
    return cases, flax


@pytest.fixture(scope="module")
def world2(dg12, dg13_case, tmp_path_factory):
    """Two ranks: the networks over a space axis of 2, the halo pads, the
    resident epochs at 2 × 1 and at 1 × 2, a production-preset step at
    13 × 13, a float64 DG 3D step at 9 × 9 × 9, the strided Δt input's
    step and the DG 3D step again with ``remat_forwards``, each over a
    space axis of 2."""
    out = tmp_path_factory.mktemp("spatial_world2")
    cases, flax = _net_cases(dg12, dg13_case)
    torch.save(cases, out / "nets.pt")
    pads = _pad_inputs()
    torch.save(pads, out / "pads.pt")
    epochs = dict(dg12["spec"], scenario="epochs", float64=True, batch_size=8, steps=2)
    epochs.pop("batch")
    preset = dict(fluid="DG", base_dir=str(out / "preset"), nx=13, realizations=4,
                  production=True, scenario="step", batch_size=4, spatial=2)
    dg3d = dict(fluid="DG", base_dir=str(out / "dg3d"), nx=9, nz=9, realizations=4,
                scenario="step", batch_size=4, spatial=2, float64=True)
    stride = dict(fluid="DG", base_dir=str(out / "stride"), nx=13, realizations=4,
                  config={"dt_input_stride": 2}, scenario="step", batch_size=4, spatial=2,
                  float64=True)
    runs = [dict(scenario="nets", file=str(out / "nets.pt"), spatial=2),
            dict(scenario="pads", file=str(out / "pads.pt"), spatial=2),
            dict(epochs, spatial=1), dict(epochs, spatial=2), preset, dg3d, stride,
            dict(dg3d, config={"remat_forwards": True})]
    return dict(cases=cases, flax=flax, pads=pads, epochs=epochs, preset=preset, dg3d=dg3d,
                stride=stride, outs=run_ranks(out / "ranks", 2, runs))


# -- (3) the halo pads ----------------------------------------------------------

def _pad_inputs():
    """A 2D (B, H, W) and a 3D (B, D, H, W) float64 field at an uneven H,
    and five per-cell weight fields of a 5-point combination."""
    rng = np.random.RandomState(8)
    return [{"f": torch.from_numpy(rng.standard_normal(shape)),
             "w": torch.from_numpy(rng.standard_normal((5,) + shape))}
            for shape in ((3, 13, 7), (2, 4, 13, 5))]


def _jax_cells(f, w):
    """The whole grid: ``jnp.pad(mode="symmetric")`` of width 1 on the last
    two (2D) or three (3D) axes, then the per-cell 5-point combination
    that the rank scenario ``pads`` takes of the block's pad."""
    nd = f.ndim - 1
    p = jnp.pad(f, [(0, 0)] + [(1, 1)] * nd, mode="symmetric")
    inner = (slice(1, -1),) * (nd - 2)

    def at(dj, di):
        return p[(slice(None),) + inner + (slice(1 + dj, p.shape[-2] - 1 + dj),
                                          slice(1 + di, p.shape[-1] - 1 + di))]

    return (at(0, 0) * w[0] + at(1, 0) * w[1] + at(-1, 0) * w[2] + at(0, 1) * w[3]
            + at(0, -1) * w[4])


def test_halo_pads_equal_the_whole_grids_pad_and_its_vjp(world2):
    """``pad_symmetric`` and ``pad_symmetric_3d`` over the two ranks' row
    blocks (13 rows: 7 and 6) give the whole grid's padded rows bitwise
    (the neighbours' rows at the blocks' interior edges, the symmetric
    ghost rows at the domain's), and the VJP of a 5-point combination of
    them, summed over the blocks, is ``jax.vjp``'s of ``jnp.pad`` on the
    whole grid within PAD_TOL in float64; the halo cotangents are added in
    a fixed order: two backward passes give the same bits."""
    for case, *rank_out in zip(world2["pads"], *(o[1] for o in world2["outs"])):
        f, w = case["f"].numpy(), case["w"].numpy()
        with jax.enable_x64(True):
            cells, vjp = jax.vjp(lambda a: _jax_cells(a, jnp.asarray(w)), jnp.asarray(f))
            (want_grad,) = vjp(jnp.ones_like(cells))
            want_pad = np.pad(f, [(0, 0)] + [(1, 1)] * (f.ndim - 1), mode="symmetric")
        got_grad = np.zeros_like(f)
        for r in rank_out:
            lo, hi = r["rows"]
            np.testing.assert_array_equal(r["padded"].numpy(), want_pad[..., lo:hi + 2, :])
            np.testing.assert_allclose(r["cells"].numpy(), np.asarray(cells)[..., lo:hi, :],
                                       rtol=PAD_TOL, atol=PAD_TOL)
            assert torch.equal(r["grad"], r["grad_again"])
            got_grad[..., lo:hi, :] = r["grad"].numpy()
        np.testing.assert_allclose(got_grad, np.asarray(want_grad), rtol=PAD_TOL, atol=PAD_TOL)


# -- (4) the networks -------------------------------------------------------------

OPTION_IDS = ["ed13_latent_flatten", "ed19_latent_flatten", "res13_vae"]
NET_IDS = ["ed12", "ed13", "res13", "ed9x9x9", "res9x9x9", "ed13_pad16", "res13_pad16",
           *OPTION_IDS]


@pytest.mark.parametrize("i", range(len(NET_IDS)), ids=NET_IDS)
def test_networks_over_row_blocks_match_the_whole_grid(world2, i):
    """Model 1 (encoder-decoder, HardLayer) and Model 2 (residual net) on
    each rank's rows of H over a space axis of 2, with the JAX package's
    weights at 12×12 (the resize path) and 13×13 (uneven blocks) and seeded
    ones at 9×9×9 (H split 5/4, D and W whole) and at 13×13 with
    ``spatial_pad_to=16`` (the padding's rows past H read as zeros, then
    cropped); the encoder–decoder with ``latent_flatten`` at 13×13 (the
    encoded level, one row, whole on every rank) and at 19×19 (two rows,
    one a rank: the Dense on the gathered level, each rank keeping its
    row) and the residual net's VAE head at 13×13 (the whole grid's mean,
    one ε given to every rank), each with the JAX package's weights: the
    output rows within 1e-12 of the whole grid's module, the input
    gradients' rows and the parameter gradients summed over the two ranks
    within NET_RTOL, in float64 (the latent Dense's gradient counted once,
    not once a rank); and, where the case has the JAX package's weights,
    the output rows put together within FLAX_RTOL of the flax module's on
    the whole grid (the VAE head's from flax's z_mean and z_log_var with
    the same ε; the option cases also of the output's scale)."""
    case = world2["cases"][i]
    model = ranks.net_module(case)
    x = case["x"].clone().requires_grad_()
    y = model(x, **case.get("kwargs", {}))
    (y * case["w"]).sum().backward()
    outs = [o[0][i] for o in world2["outs"]]
    h = x.dim() - 3
    for o in outs:
        lo, hi = o["rows"]
        sl = (slice(None),) * h + (slice(lo, hi),)
        np.testing.assert_allclose(o["y"].numpy(), y.detach()[sl].numpy(), rtol=1e-12,
                                   atol=1e-9)
        assert _rel([o["gx"]], [x.grad[sl]]) <= NET_RTOL
    summed = [a + b for a, b in zip(outs[0]["gp"], outs[1]["gp"])]
    assert _rel(summed, [p.grad for p in model.parameters()]) <= NET_RTOL
    if i in world2["flax"]:
        got = torch.cat([o["y"] for o in outs], dim=h).numpy()
        want = world2["flax"][i](case["x"].numpy())
        scale = np.abs(want).max() if NET_IDS[i] in OPTION_IDS else 0.0
        np.testing.assert_allclose(got, want, rtol=FLAX_RTOL, atol=FLAX_RTOL * scale)


def test_vae_head_draws_one_noise_over_a_space_axis(world2):
    """The VAE head drawing ε from a generator over a space axis of 2, the
    two ranks' generators seeded apart (11 and 12): the first rank's draw
    is broadcast, so both ranks' rows are one process's output with the
    first rank's generator within 1e-12 (and far from one with the
    second's), and its parameter gradients, summed over the ranks, within
    NET_RTOL."""
    case = world2["cases"][-1]
    outs = [o[0][len(world2["cases"]) - 1] for o in world2["outs"]]
    got = torch.cat([o["y"] for o in outs], dim=2)
    model = ranks.net_module(case)
    want = model(case["x"], generator=torch.Generator().manual_seed(11))
    (want * case["w"]).sum().backward()
    np.testing.assert_allclose(got.numpy(), want.detach().numpy(), rtol=1e-12, atol=0)
    summed = [a + b for a, b in zip(outs[0]["gp"], outs[1]["gp"])]
    assert _rel(summed, [p.grad for p in model.parameters()]) <= NET_RTOL
    with torch.no_grad():
        second = model(case["x"], generator=torch.Generator().manual_seed(12))
    assert _rel([got], [second]) > 1e-3


# -- (5) one train step against the JAX mesh ---------------------------------------

def _jax_step(case, mesh):
    trainer = JaxTrainer(case["jcase"]["loss_fn"], case["jcase"]["params"], mesh=mesh,
                         donate_params=False)
    return trainer, trainer.train_step(case["x"], case["y"])


@pytest.mark.parametrize("fluid,run", [("DG", 0), ("GC", 2)])
def test_step_at_2x2_matches_the_jax_space_mesh(dg12, gc12, world4, fluid, run):
    """One train_step at nx = 12 over 4 ranks as 2 × 2 (each rank 4 samples
    by 6 rows) against the JAX Trainer's on ``make_mesh(8, spatial=2)``:
    the total within TOTAL_RTOL, the updated weights within the Adam-step
    bound, every rank's weights the same bits."""
    case = dg12 if fluid == "DG" else gc12
    names = ("pressure", "time_step") + (("saturation_model",) if fluid == "GC" else ())
    trainer, metrics = _jax_step(case, jax_make_mesh(8, spatial=2))
    outs = [r[run] for r in world4]
    np.testing.assert_allclose(outs[0]["metrics"]["total"], float(metrics["total"]),
                               rtol=TOTAL_RTOL)
    want = _jax_weights_as_port(case["tcase"], trainer.params, names)
    got = {k: v for k, v in outs[0]["weights"].items()}
    got = {n: got[k] for n, k in zip(names, ("pressure", "time_step", "saturation"))}
    _assert_adam_close(got, want)
    _assert_ranks_agree(outs)


def test_dg3d_step_at_2x2_matches_the_jax_space_mesh(dg3d9, world4):
    """One float32 DG 3D train_step at 9 × 9 × 9 (Conv3d networks, the
    7-point residual; H split 5/4, D and W whole) over 4 ranks as 2 × 2
    against the JAX Trainer's on ``make_mesh(8, spatial=2)`` on the same
    weights and 4 samples: the total within TOTAL_RTOL of the port's one
    process and within SLICE3D_RTOL of the JAX mesh's, the updated weights
    within the Adam-step bound of the JAX mesh's, every rank's weights the
    same bits."""
    trainer, metrics = _jax_step(dg3d9, jax_make_mesh(8, spatial=2))
    outs = [r[3] for r in world4]
    one = ranks.step(dict(dg3d9["spec"], spatial=1))
    np.testing.assert_allclose(outs[0]["metrics"]["total"], one["metrics"]["total"],
                               rtol=TOTAL_RTOL)
    np.testing.assert_allclose(outs[0]["metrics"]["total"], float(metrics["total"]),
                               rtol=SLICE3D_RTOL)
    _assert_adam_close(outs[0]["weights"], _jax_weights_as_port(
        dg3d9["tcase"], trainer.params, ("pressure", "time_step")))
    _assert_ranks_agree(outs)


def test_production_preset_at_2x2_matches_the_jax_space_mesh(preset13, world4):
    """One train_step of the production preset at 13×13 (bfloat16
    networks; Model 2 on every 2nd row and column, so the space rank whose
    block starts at the odd row 7 starts its strided rows at 1) over 4
    ranks as 2 × 2 against the JAX Trainer's on ``make_mesh(8, spatial=2)``
    on the same weights and 4 samples: the total and the Δt mean (Model
    2's bfloat16 output on the strided rows) each within twice the JAX
    package's own bfloat16-to-float32 distance plus BF16_TOTAL_RTOL, the
    updated weights within the Adam-step bound, every rank's weights
    finite and the same bits."""
    mesh = jax_make_mesh(8, spatial=2)
    trainer, metrics = _jax_step(preset13, mesh)
    _, metrics32 = _jax_step(dict(preset13, jcase=preset13["j32"]), mesh)
    outs = [r[4] for r in world4]
    for name in ("total", "tstep_mean"):
        want, want32 = float(metrics[name]), float(metrics32[name])
        own = abs(want - want32) / abs(want32)
        got = outs[0]["metrics"][name]
        assert abs(got - want) / abs(want) <= 2 * own + BF16_TOTAL_RTOL, (name, got, want,
                                                                          want32)
    _assert_adam_close(outs[0]["weights"], _jax_weights_as_port(
        preset13["tcase"], trainer.params, ("pressure", "time_step")))
    _assert_ranks_agree(outs)


def _one_process_grads(dg12, extra_mbc: float = 0.0):
    """One process's float64 gradients of the whole batch's total (plus
    ``extra_mbc`` times its mbc term), by optimizer key, and the total."""
    loss = copy.copy(dg12["tcase"]["loss_fn"])
    loss.models = {**loss.models, **{k: copy.deepcopy(loss.models[k]).double()
                                     for k in ("pressure", "time_step", "pvt_model")}}
    x = torch.from_numpy(dg12["x"]).double()
    y = {k: torch.from_numpy(v).double() for k, v in dg12["y"].items()}
    total, wsse, _, _ = loss.weighted_sse(x, y)
    return loss.gradients(total + extra_mbc * wsse["gas"]["mbc"]), float(total.detach())


def test_gradients_are_summed_over_data_and_space_counting_mbc_once(dg12, world4):
    """In float64 the gradients that the 2 × 2 ranks' all-reduce leaves are
    one process's within GRAD_RTOL, and so is the total; an average over
    the ranks would be 0.75 off, and mbc² counted on both ranks of each
    space group (one more whole-batch mbc term) would be off by far more
    than GRAD_RTOL: the rule that counts it on space rank 0 alone shows."""
    want, total = _one_process_grads(dg12)
    doubled, _ = _one_process_grads(dg12, extra_mbc=1.0)
    got = world4[0][1]["grads"]
    for k in want:
        assert _rel(got[k], want[k]) <= GRAD_RTOL, k
        assert _rel([g / 4 for g in got[k]], want[k]) > 0.5
    assert max(_rel(got[k], doubled[k]) for k in want) > 100 * GRAD_RTOL
    np.testing.assert_allclose(world4[0][1]["metrics"]["total"], total, rtol=1e-6)


# -- (6) resident epochs --------------------------------------------------------------

def test_resident_epochs_at_2x1_and_1x2_match_one_process(world2):
    """Two resident epochs of two steps, then the host-batched train and
    eval epochs, in float64, over 2 ranks as 2 × 1 (data) and as 1 × 2
    (space: each rank 6 of the 12 rows of every sample) against one
    process: per-step metrics within EPOCH_RTOL (SPACE_EPOCH_RTOL on the
    space axis), the weights within the Adam-step bound, both ranks'
    weights the same bits."""
    want = ranks.epochs(world2["epochs"])
    for run, rtol in ((2, EPOCH_RTOL), (3, SPACE_EPOCH_RTOL)):
        outs = [o[run] for o in world2["outs"]]
        for out in outs:
            pairs = [*zip(out["resident"], want["resident"]), (out["host"], want["host"]),
                     (out["eval"], want["eval"])]
            for got, ref in pairs:
                for name in ref:
                    np.testing.assert_allclose(got[name], ref[name], rtol=rtol, atol=1e-9,
                                               err_msg=name)
        _assert_adam_close(outs[0]["weights"], want["weights"])
        _assert_ranks_agree(outs)


# -- (7) the production preset ----------------------------------------------------------

def test_production_preset_over_a_space_axis_matches_one_process(world2):
    """The production preset (bf16 networks, Model 2 on every 2nd row and
    column) at 13×13 over a space axis of 2 (rank 1's block starts at the
    odd row 7, so its strided rows start at its local row 1) against one
    process on the same 4 samples: the total and the Δt mean within
    PRESET_RTOL, both ranks' weights the same bits."""
    spec = world2["preset"]
    want = ranks.step(dict(spec, spatial=1))
    outs = [o[4] for o in world2["outs"]]
    for name in ("total", "tstep_mean"):
        np.testing.assert_allclose(outs[0]["metrics"][name], want["metrics"][name],
                                   rtol=PRESET_RTOL, err_msg=name)
    _assert_ranks_agree(outs)


def test_strided_dt_input_keeps_its_global_phase_over_a_space_axis(world2):
    """In float64 with ``dt_input_stride=2`` at 13 rows over a space axis of
    2, rank 1's block starts at the odd row 7, so its strided Δt input
    starts at its local row 1 (global rows 8, 10, 12): the total within
    TOTAL_RTOL and the gradients summed over the two ranks within GRAD_RTOL
    of one process's per model (a stride started at the block's first row
    reads rows 7, 9, 11 and moves every gradient far past GRAD_RTOL)."""
    spec = world2["stride"]
    want = ranks.step(dict(spec, spatial=1))
    outs = [o[6] for o in world2["outs"]]
    np.testing.assert_allclose(outs[0]["metrics"]["total"], want["metrics"]["total"],
                               rtol=TOTAL_RTOL)
    for k in want["grads"]:
        assert _rel(outs[0]["grads"][k], want["grads"][k]) <= GRAD_RTOL, k
    _assert_ranks_agree(outs)


def test_dg3d_step_over_a_space_axis_matches_one_process(world2):
    """A float64 DG 3D train_step at 9 × 9 × 9 (Conv3d networks, the
    7-point residual with its vertical permeability; H split 5/4, D and W
    whole) over a space axis of 2 against one process on the same 4
    samples: the total within TOTAL_RTOL, the gradients summed over the two
    ranks within GRAD_RTOL per model (0.5 off if averaged), both ranks'
    weights the same bits."""
    spec = world2["dg3d"]
    want = ranks.step(dict(spec, spatial=1))
    outs = [o[5] for o in world2["outs"]]
    np.testing.assert_allclose(outs[0]["metrics"]["total"], want["metrics"]["total"],
                               rtol=TOTAL_RTOL)
    for k in want["grads"]:
        assert _rel(outs[0]["grads"][k], want["grads"][k]) <= GRAD_RTOL, k
        assert _rel([g / 2 for g in outs[0]["grads"][k]], want["grads"][k]) > 0.4, k
    _assert_ranks_agree(outs)


# -- (8) spatial=1 ---------------------------------------------------------------------------

def test_spatial_1_is_bitwise_one_process(dg12):
    """``make_mesh(spatial=1)`` in a one-rank group is the data-parallel
    mesh of before (no space group, no rows): three steps and an eval
    epoch give bitwise the metrics and weights of the trainer without a
    group."""
    import torch.distributed as dist

    def run(mesh):
        loss = copy.copy(dg12["tcase"]["loss_fn"])
        loss.models = {**loss.models, **{k: copy.deepcopy(loss.models[k])
                                         for k in ("pressure", "time_step")}}
        trainer = Trainer(loss, mesh=mesh)
        trainer.stage_dataset("train", dg12["tcase"]["train_groups"], 8)
        assert loss.rows is None
        return trainer, [trainer.train_epoch_resident("train", steps=3),
                         trainer.eval_epoch_resident("train")]

    plain, want = run(None)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh(spatial=1)
        assert (mesh.space_size, mesh.space_group) == (1, None)
        grouped, got = run(mesh)
    finally:
        dist.destroy_process_group()
    for g, w in zip(got, want):
        for name in w:
            np.testing.assert_array_equal(g[name], w[name], err_msg=name)
    for k in plain.optimizer_keys:
        assert all(torch.equal(a, b) for a, b in zip(grouped.optimizers[k].params,
                                                     plain.optimizers[k].params)), k


# -- (9) remat_forwards and the iteration logs on a space axis -------------------------

def _assert_same_step(a, b):
    """Two ranks' steps with the same bits: metrics, gradients, weights."""
    assert a["metrics"] == b["metrics"]
    for key in ("grads", "weights"):
        for k in b[key]:
            assert all(torch.equal(p, q) for p, q in zip(a[key][k], b[key][k])), (key, k)


@pytest.mark.parametrize("kind", ["dg2d_2x2", "dg3d_1x2"])
def test_remat_step_over_a_space_axis_is_the_step_without(dg12, world2, world4, kind):
    """A float64 step with ``remat_forwards`` over a space axis (DG 2D at
    12×12 on 2 × 2 ranks; DG 3D at 9×9×9 on a space axis of 2): the backward
    pass recomputes every network's forward, its halo exchanges with it,
    and gives on every rank the bits of the same step without remat; and
    one process's total within TOTAL_RTOL and gradients within GRAD_RTOL
    per model."""
    if kind == "dg2d_2x2":
        pairs = [(r[6], r[1]) for r in world4]
        want, total = _one_process_grads(dg12)
    else:
        pairs = [(r[7], r[5]) for r in world2["outs"]]
        one = ranks.step(dict(world2["dg3d"], spatial=1))
        want, total = one["grads"], one["metrics"]["total"]
    for remat, plain in pairs:
        _assert_same_step(remat, plain)
    got = pairs[0][0]
    np.testing.assert_allclose(got["metrics"]["total"], total, rtol=TOTAL_RTOL)
    for k in want:
        assert _rel(got["grads"][k], want[k]) <= GRAD_RTOL, k


def _jax_logged_case(dg12, directory, **kwargs):
    """The JAX package's DG case at nx = 12 (dg12's data and weights) with
    its well solver logging into ``directory``."""
    jcase = jax_setup_case("DG", base_dir=str(dg12["base"] / "jdata"), nx=12, n_realizations=8,
                           well_solver_kwargs=dict(kwargs, log_iterations=True,
                                                   log_dir=str(directory)))
    return dict(dg12, jcase=dict(jcase, params=dg12["jcase"]["params"]))


def _log_file(directory):
    """The lines of the one file in ``directory``."""
    (name,) = os.listdir(directory)
    return (directory / name).read_text().splitlines()


def _assert_logs_close(got, want, rtol):
    """Two iteration logs: the same header and rows, each row's numbers
    within ``rtol``."""
    assert got[0] == want[0] and len(got) == len(want)
    for g, w in zip(got[1:], want[1:]):
        assert g.split('"')[0] == w.split('"')[0]
        np.testing.assert_allclose([float(v) for v in g.split('"')[1].split()],
                                   [float(v) for v in w.split('"')[1].split()], rtol=rtol)


def test_remat_step_at_2x2_matches_the_jax_space_mesh(dg12, world4, tmp_path):
    """The float32 DG step at 12×12 with ``remat_forwards`` over 4 ranks as
    2 × 2 against the JAX Trainer's on ``make_mesh(8, spatial=2)`` with
    ``remat_forwards`` (``jax.checkpoint`` around each network): the total
    within TOTAL_RTOL, the updated weights within the Adam-step bound,
    every rank's weights the same bits; rank 0's λ log (the direct BHP
    solve's) of that step is the JAX step's within LOG_RTOL."""
    case = _jax_logged_case(dg12, tmp_path)
    jloss = copy.copy(case["jcase"]["loss_fn"])
    jloss.remat_forwards = True
    trainer, metrics = _jax_step(dict(case, jcase=dict(case["jcase"], loss_fn=jloss)),
                                 jax_make_mesh(8, spatial=2))
    jax.effects_barrier()
    outs = [r[5] for r in world4]
    np.testing.assert_allclose(outs[0]["metrics"]["total"], float(metrics["total"]),
                               rtol=TOTAL_RTOL)
    _assert_adam_close(outs[0]["weights"], _jax_weights_as_port(
        dg12["tcase"], trainer.params, ("pressure", "time_step")))
    _assert_ranks_agree(outs)
    got = _log_file(Path(outs[0]["logs"]))
    assert got[0] == f"# lambda_opt, shape [1, {len(dg12['x'])}, 1, 12, 12, 1]"
    _assert_logs_close(got, _log_file(tmp_path), LOG_RTOL)


@pytest.mark.parametrize("solve,run", [("lambda", 7), ("pwf", 8)])
def test_iteration_logs_over_a_space_axis_hold_the_whole_grid(dg12, world4, tmp_path,
                                                              solve, run):
    """The well solver's iteration logs (the direct solve's λ, the Newton
    solve's pwf history) of a float64 DG step at 12×12 over 4 ranks as
    2 × 2: the ranks' rows of H gathered over each space group, then the
    blocks of the batch over the data axis, and one file written, by rank
    0 alone; its lines are one process's on the same batch bit for bit,
    and the JAX package's float32 step's on ``make_mesh(8, spatial=2)``
    (its callback receives the mesh's global arrays) within LOG_RTOL."""
    kwargs = NEWTON_LOG if solve == "pwf" else {}
    got = _log_file(Path(world4[0][run]["logs"]))
    one = tmp_path / "one"
    ranks.step(_logged(dict(dg12["spec"], float64=True), one, **kwargs))
    assert got == _log_file(one)
    jax_dir = tmp_path / "jax"
    _jax_step(_jax_logged_case(dg12, jax_dir, **kwargs), jax_make_mesh(8, spatial=2))
    jax.effects_barrier()
    want = _log_file(jax_dir)
    assert f"[{3 if solve == 'pwf' else 1}, {len(dg12['x'])}, 1, 12, 12, 1]" in got[0]
    _assert_logs_close(got, want, LOG_RTOL)
