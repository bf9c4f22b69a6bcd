"""PVT: fluid properties and their pressure derivatives.

Port of ``srm_tpu/physics/pvt.py``: the trainable polynomial backend
(:class:`PolynomialPVT`) and the polyharmonic-spline backend
(:class:`SplinePVT`), built from a PVT config by :func:`make_pvt_layer`, for
the dry-gas properties (invBg, invug) and the seven gas-condensate ones
(invBg, invBo, invug, invuo, Rs, Rv, Vro). The
interpolant ``f(x) = Σ w_i φ(|x − c_i|²) + v1·x + v0`` is solved once on the
host in float64 (:func:`solve_spline_weights`, the reference's
``pvt.py:83-105``) and evaluated as one ``(m, n)`` matmul.

The reference takes d/dP with ``jax.jvp`` through the pressure clamp
(``pvt.py:201-210``). Here the same forward-mode derivative is written out:
the clamp's tangent (1 inside the band, 0 outside, 0.5 on a bound, as
JAX's ``maximum``/``minimum`` give it), then φ's derivative, then the same
matmul. The result is itself an ordinary tensor expression of the pressure,
so autograd differentiates it — ``dinvBg0`` enters the loss.

The polynomial backend holds one float32 ``nn.Parameter`` per property,
``{prop}_coefficients`` (c[0] the constant term), evaluated by Horner at
the clamped pressure (``pvt.py:179-188``); its d/dP is the same forward-mode
derivative written out, Horner's tangent recurrence seeded with the clamp's
tangent, so that autograd reaches the coefficients through the values and
through the derivatives.

Output layout is the reference's ``[2, n_props, *p.shape]`` with axis 0 =
(value, d/dP). The contraction must run in full float32: TF32 loses ~5% on
this badly scaled system (``pvt.py:117-121``), so callers on a GPU keep
``torch.backends.cuda.matmul.allow_tf32`` off.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

EPSILON = 1e-10

DG_PROPERTIES: Tuple[str, ...] = ("invBg", "invug")
GC_PROPERTIES: Tuple[str, ...] = ("invBg", "invBo", "invug", "invuo", "Rs", "Rv", "Vro")


def properties_for(fluid_type: str) -> Tuple[str, ...]:
    """The PVT model's output rows for a fluid (srm_tpu/physics/pvt.py:45-51)."""
    ft = fluid_type.upper()
    if ft == "DG":
        return DG_PROPERTIES
    if ft == "GC":
        return GC_PROPERTIES
    raise ValueError(f"Unknown fluid type: {fluid_type}. Use 'DG' or 'GC'.")


def _phi_np(s: np.ndarray, order: int) -> np.ndarray:
    s = np.maximum(s, EPSILON)
    if order == 1:
        return np.sqrt(s)
    if order == 2:
        return 0.5 * s * np.log(s)
    raise ValueError(f"spline order {order} is not ported")


def solve_spline_weights(train_points: np.ndarray, train_values: np.ndarray,
                         order: int = 2, regularization_weight: float = 0.0):
    """Solve the polyharmonic interpolation system once (float64):

        [A + λI   B] [w]   [f]
        [B^T      0] [v] = [0],  B = [c, 1]

    Returns (w [n], v [2]) as float32."""
    c = np.asarray(train_points, np.float64).reshape(-1, 1)
    f = np.asarray(train_values, np.float64).reshape(-1, 1)
    n = c.shape[0]
    A = _phi_np((c - c.T) ** 2, order)
    if regularization_weight > 0:
        A = A + regularization_weight * np.eye(n)
    B = np.concatenate([c, np.ones((n, 1))], axis=1)
    lhs = np.block([[A, B], [B.T, np.zeros((2, 2))]])
    rhs = np.concatenate([f, np.zeros((2, 1))], axis=0)
    sol = np.linalg.solve(lhs, rhs)
    return sol[:n, 0].astype(np.float32), sol[n:, 0].astype(np.float32)


def _clip_tangent(p: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """d/dp of ``minimum(maximum(p, lo), hi)`` as JAX's jvp gives it."""
    g1 = 0.5 * ((p >= lo).to(p.dtype) + (p > lo).to(p.dtype))
    y = torch.clamp_min(p, lo)
    g2 = 0.5 * ((y <= hi).to(p.dtype) + (y < hi).to(p.dtype))
    return g1 * g2


class PolynomialPVT(nn.Module):
    """Fluid properties and d/dP from a pressure field, from trainable
    polynomial coefficients (the reference's ``PVTLayer`` with
    ``fitting_method="polynomial"``)."""

    fitting_method = "polynomial"

    def __init__(self, polynomial_config: Dict[str, Sequence[float]],
                 properties: Sequence[str] = DG_PROPERTIES,
                 min_input_threshold: float = 14.7, max_input_threshold: float = 10000.0):
        super().__init__()
        self.properties = tuple(properties)
        self.lo = float(min_input_threshold)
        self.hi = float(max_input_threshold)
        for prop in self.properties:
            if prop not in polynomial_config:
                raise ValueError(f"Polynomial coefficients missing for property: {prop}")
            coeffs = torch.tensor(np.asarray(polynomial_config[prop], np.float32))
            self.register_parameter(f"{prop}_coefficients", nn.Parameter(coeffs))

    def coefficients(self, prop: str) -> torch.Tensor:
        return getattr(self, f"{prop}_coefficients")

    def forward(self, p: torch.Tensor) -> torch.Tensor:
        """→ [2, P, *p.shape]: values and d/dP at the clamped pressure."""
        lo, hi = p.new_full((), self.lo), p.new_full((), self.hi)
        q = torch.minimum(torch.maximum(p, lo), hi)
        dq = _clip_tangent(p, self.lo, self.hi)
        values, derivs = [], []
        for prop in self.properties:
            c = self.coefficients(prop)
            acc = torch.zeros_like(q)
            dacc = torch.zeros_like(q)
            for i in range(c.shape[0] - 1, -1, -1):      # Horner, and its tangent
                dacc = dacc * q + acc * dq
                acc = acc * q + c[i]
            values.append(acc)
            derivs.append(dacc)
        return torch.stack([torch.stack(values), torch.stack(derivs)])


class SplinePVT(nn.Module):
    """Fluid properties and d/dP from a pressure field (no trainable params).

    ``knots`` are the table pressures; ``values`` one vector per property.
    """

    fitting_method = "spline"

    def __init__(self, knots: Sequence[float], values: Sequence[Sequence[float]],
                 order: int = 2, regularization_weight: float = 0.0,
                 min_input_threshold: float = 14.7, max_input_threshold: float = 10000.0):
        super().__init__()
        if order not in (1, 2):
            raise ValueError(f"spline order {order} is not ported")
        self.order = order
        self.lo = float(min_input_threshold)
        self.hi = float(max_input_threshold)
        knots = np.asarray(knots, np.float32)
        ws, vs = zip(*(solve_spline_weights(knots, np.asarray(v, np.float32), order,
                                            regularization_weight) for v in values))
        self.register_buffer("knots", torch.from_numpy(knots))
        self.register_buffer("w", torch.from_numpy(np.stack(ws)))    # [P, n]
        self.register_buffer("v", torch.from_numpy(np.stack(vs)))    # [P, 2]

    def forward(self, p: torch.Tensor) -> torch.Tensor:
        """→ [2, P, *p.shape]: values and d/dP at the clamped pressure."""
        shape = tuple(p.shape)
        pf = p.reshape(-1)
        lo, hi = pf.new_full((), self.lo), pf.new_full((), self.hi)
        q = torch.minimum(torch.maximum(pf, lo), hi)                  # [m]
        dq = _clip_tangent(pf, self.lo, self.hi)                      # [m]
        diff = q[:, None] - self.knots[None, :]                       # [m, n]
        s = diff * diff
        s_c = torch.clamp_min(s, EPSILON)
        ds = torch.where(s > EPSILON, 2.0 * diff * dq[:, None], torch.zeros_like(s))
        if self.order == 1:
            phi = torch.sqrt(s_c)
            dphi = ds * (0.5 / phi)
        else:
            log_s = torch.log(s_c)
            phi = 0.5 * s_c * log_s
            dphi = (0.5 * ds) * log_s + (0.5 * s_c) * (ds / s_c)
        v0, v1 = self.v[:, 0][None, :], self.v[:, 1][None, :]
        values = phi @ self.w.T + q[:, None] * v0 + v1                # [m, P]
        derivs = dphi @ self.w.T + dq[:, None] * v0
        out = torch.stack([values, derivs], dim=0)                    # [2, m, P]
        return out.reshape((2,) + shape + (self.w.shape[0],)).movedim(-1, 1)


def make_spline_pvt(pvt_config: Dict, table: Dict[str, np.ndarray],
                    properties: Sequence[str] = DG_PROPERTIES,
                    order: Optional[int] = None) -> SplinePVT:
    """Build the spline PVT from a PVT config and the PVT table columns
    (the reference's ``make_pvt_layer`` with ``fitting_method='spline'``)."""
    return SplinePVT(
        knots=table["pre"],
        values=[table[prop.lower()] for prop in properties],
        order=pvt_config.get("spline_order", 2) if order is None else order,
        regularization_weight=pvt_config.get("regularization_weight", 0.0),
        min_input_threshold=pvt_config.get("min_input_threshold", 14.7),
        max_input_threshold=pvt_config.get("max_input_threshold", 10000.0),
    )


def make_pvt_layer(pvt_config: Dict, table: Optional[Dict[str, np.ndarray]] = None,
                   properties: Optional[Sequence[str]] = None,
                   order: Optional[int] = None) -> nn.Module:
    """The PVT of a PVT config, dispatched on its ``fitting_method`` as the
    reference's ``make_pvt_layer`` (``pvt.py:213-239``): "polynomial" from
    its ``polynomial_config``, "spline" from the PVT table columns
    (``table``). ``properties`` default to the config's fluid's."""
    props = properties or properties_for(pvt_config.get("fluid_type", "DG"))
    fitting = pvt_config.get("fitting_method", "polynomial").lower()
    if fitting == "polynomial":
        if pvt_config.get("polynomial_config") is None:
            raise ValueError("polynomial_config required for polynomial fitting")
        return PolynomialPVT(pvt_config["polynomial_config"], properties=props,
                             min_input_threshold=pvt_config.get("min_input_threshold", 14.7),
                             max_input_threshold=pvt_config.get("max_input_threshold", 10000.0))
    if fitting == "spline":
        if table is None:
            raise ValueError("spline fitting needs the PVT table")
        return make_spline_pvt(pvt_config, table, properties=props, order=order)
    raise ValueError(f"Unknown fitting method: {fitting}")
