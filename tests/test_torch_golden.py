"""The port's plain stencil math against the TF reference's own residuals.

``tests/golden/tf_dg_residual.npz`` and ``tests/golden/tf_gc_residual.npz``
hold fixed synthetic fields and what the executed TF reference computed on
them (``physics_error_gas_2D`` and ``physics_error_gas_oil_2D``).
``tests/test_tf_golden.py`` holds the JAX package's unfused residuals to
them; here the same fields go through the port's plain versions of kernels
B1 and B3 (the functions its CPU path runs and its CUDA kernels are held
to), at the same tolerances: 1e-4 relative, and 1e-4 of each field's
largest value absolute.
"""

import os

import numpy as np
import pytest
import torch

from srm_tpu_torch.kernels import stencil as st
from srm_tpu_torch.ops.stencil import pad_symmetric

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def _load(name):
    with np.load(os.path.join(GOLDEN, name)) as z:
        return {k: z[k] for k in z.files}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def test_dg_plain_stencil_matches_tf_reference():
    g = _load("tf_dg_residual.npz")
    p0, p1, kx, q1 = _t(g["p0"]), _t(g["p1"]), _t(g["kx"]), _t(g["q1"])
    c0, c1, d0, d1 = (float(g[k]) for k in ("c0", "c1", "d0", "d1"))
    invBg0, invBg1 = c0 + c1 * p0, c0 + c1 * p1
    invug1 = d0 + d1 * p1
    qwell = (q1[0] > 0).float()
    tsteps = torch.cat([_t(g["t1"]).reshape(-1, 1), _t(g["t2"]).reshape(-1, 1)], dim=1)
    cfg = st.StencilConfig(C=0.001127, D=5.6145833334, dx=float(g["dx"]), dy=float(g["dy"]),
                           dz=float(g["dz"]), Sgi=float(g["Sgi"]), krgo=float(g["krgo"]),
                           phi=float(g["phi"]))
    dom, ibc, tde, mbc = st.dg_stencil_residual_reference(
        pad_symmetric(p0), pad_symmetric(p1), pad_symmetric(kx), pad_symmetric(invBg1 * invug1),
        invBg0, invBg1, torch.full_like(p0, c1), q1, qwell, tsteps, cfg)
    # the reference folds the truncation error into dom; the port keeps it apart
    for name, got, want in (("dom", dom + tde, g["dom"]), ("ibc", ibc, g["ibc"])):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(), err_msg=name)
    np.testing.assert_allclose(mbc.numpy(), g["mbc"], rtol=1e-4)


def test_gc_plain_stencil_matches_tf_reference():
    """Two-phase parity (upstream relperm, the four fluxes, chord-slope
    dS/dp, per-phase accumulation and tank balance). The TF reference
    returns dom, mbc and cmbc summed over the phases."""
    g = _load("tf_gc_residual.npz")
    p0, p1, sg0, sg1, kx = (_t(g[k]) for k in ("p0", "p1", "sg0", "sg1", "kx"))
    lin = g["pvt_lin"]                       # rows (invBg, invBo, invug, invuo, Rs, Rv)

    def prop(i, p):
        return float(lin[i, 0]) + float(lin[i, 1]) * p

    q = [_t(g[k]) for k in ("qfg1", "qdg1", "qfo1", "qvo1")]
    qwell = (q[0][0] > 0).float()
    t1, t2 = _t(g["t1"]), _t(g["t2"])
    tsteps = torch.cat([t1.reshape(-1, 1), t2.reshape(-1, 1)], dim=1)
    full = lambda i: torch.full_like(p0, float(lin[i, 1]))  # noqa: E731
    pad = pad_symmetric
    fields = (p0, pad(p1), pad(kx), sg0, sg1, pad(_t(g["krgo1"])), pad(_t(g["krog1"])),
              prop(0, p0), prop(1, p0), prop(4, p0), prop(5, p0), full(0), full(1), full(4),
              full(5), pad(prop(0, p1)), pad(prop(1, p1)), pad(prop(2, p1)), pad(prop(3, p1)),
              pad(prop(4, p1)), pad(prop(5, p1)), *q)
    swmin = float(g["Swmin"])
    cfg = st.GCStencilConfig(C=0.001127, D=5.6145833334, dx=float(g["dx"]), dy=float(g["dy"]),
                             dz=float(g["dz"]), Swmin=swmin, phi=float(g["phi"]))
    dom_g, dom_o, ibc, trn_g, trn_o, mbc_g, mbc_o = st.gc_stencil_residual_reference(
        *fields, qwell, tsteps, cfg)
    for name, got, want in (("dom", dom_g + dom_o, g["dom"]), ("ibc", ibc, g["ibc"])):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(), err_msg=name)
    np.testing.assert_allclose((mbc_g + mbc_o).numpy(), g["mbc"], rtol=1e-4)

    # cmbc, the truncation error: float32 cancellation noise around the
    # exact rte/t1 part, held to the noise floor tests/test_tf_golden.py uses
    dv = float(g["dx"]) * float(g["dy"]) * float(g["dz"])
    phi = float(g["phi"])
    invBg1, invBo1, Rs1, Rv1 = prop(0, p1), prop(1, p1), prop(4, p1), prop(5, p1)
    mg_scale = float((phi * (invBg1 * sg1 + Rs1 * invBo1 * (1 - swmin - sg1))).abs().max())
    mo_scale = float((phi * (invBo1 * (1 - swmin - sg1) + Rv1 * invBg1 * sg1)).abs().max())
    denom_min = float((t1 * t2 + t2**2).min())
    noise = (8.0 * np.finfo(np.float32).eps * (dv / 5.6145833334)
             * float((t1 + t2).max()) * (mg_scale + mo_scale) / denom_min)
    np.testing.assert_allclose((trn_g + trn_o).numpy(), g["cmbc"], atol=noise)
