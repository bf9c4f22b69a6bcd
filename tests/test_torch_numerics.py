"""``srm_tpu_torch/utils/numerics.py`` against ``srm_tpu/utils/numerics.py``
on the cases of ``tests/test_aux.py`` (float32 inputs; each result within
1e-6 of the JAX package's, relative to 1, and the JAX tests' own bounds
on the analytic values)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srm_tpu.utils import numerics as jnum
from srm_tpu_torch.utils import numerics as tnum


def _fd_cases():
    x = np.linspace(0.5, 2.0, 7).astype(np.float32)
    return {
        "square_central": (x, (lambda v: v ** 2, lambda v: v ** 2), {"grid_spacing": 1e-3},
                           2 * x, 1e-3),
        "pair_forward": (x, (lambda v: (v ** 2, jnp.sin(v)), lambda v: (v ** 2, torch.sin(v))),
                         {"diff_type": "forward", "grid_spacing": 1e-4}, None, None),
        "inverse_at_zero": (np.asarray([0.0], np.float32), (lambda v: 1.0 / v, lambda v: 1.0 / v),
                            {"grid_spacing": 1.0}, None, None),
    }


@pytest.mark.parametrize("case", list(_fd_cases()))
def test_finite_difference_derivative_matches(case):
    x, (fj, ft), kw, analytic, rtol = _fd_cases()[case]
    want = np.asarray(jnum.finite_difference_derivative(jnp.asarray(x), fj, **kw))
    got = tnum.finite_difference_derivative(torch.from_numpy(x), ft, **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.isfinite(got).all()
    if analytic is not None:
        np.testing.assert_allclose(got, analytic, rtol=rtol)
    if case == "pair_forward":
        assert got.shape == (2, 7)
        np.testing.assert_allclose(got[1], np.cos(x), atol=1e-3)


@pytest.mark.parametrize("axis", [1, -1])
def test_l1_normalize_excluding_index_matches(axis):
    t = np.array([[1.0, -2.0, 3.0], [0.0, 0.0, 5.0]], np.float32)
    want = np.asarray(jnum.l1_normalize_excluding_index(t, axis=axis, exclude_index=2))
    got = tnum.l1_normalize_excluding_index(torch.from_numpy(t), axis=axis,
                                            exclude_index=2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got[0], [1 / 3, -2 / 3, 3.0], rtol=1e-6)
    np.testing.assert_allclose(got[1], [0.0, 0.0, 5.0])


def test_l1_normalize_excluding_index_on_a_seeded_tensor():
    t = np.random.RandomState(0).normal(size=(3, 5, 4)).astype(np.float32)
    for axis, idx in ((0, 1), (1, 4), (-1, 0)):
        want = np.asarray(jnum.l1_normalize_excluding_index(t, axis=axis, exclude_index=idx))
        got = tnum.l1_normalize_excluding_index(torch.from_numpy(t), axis, idx).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
