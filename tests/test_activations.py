"""Activation parity vs the C reference + hand-VJP checks vs autodiff."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from big_linear_algebra.ops import relu, softmax, softmax_row_wise
from tests import oracle

needs_ref = pytest.mark.skipif(
    not oracle.reference_available(), reason="no reference"
)


@needs_ref
def test_relu_matches_reference(rng):
    a = rng.standard_normal((13, 7))
    np.testing.assert_allclose(np.asarray(relu(a)), oracle.c_relu(a))


@needs_ref
def test_softmax_matches_reference(rng):
    a = rng.standard_normal((10, 6)) * 4
    np.testing.assert_allclose(
        np.asarray(softmax(a)), oracle.c_softmax(a), rtol=1e-12, atol=1e-14
    )
    cols = np.asarray(softmax(a)).sum(axis=0)
    np.testing.assert_allclose(cols, np.ones(6), rtol=1e-12)


@needs_ref
def test_softmax_row_wise_matches_reference(rng):
    a = rng.standard_normal((6, 10)) * 4
    np.testing.assert_allclose(
        np.asarray(softmax_row_wise(a)),
        oracle.c_softmax_row_wise(a),
        rtol=1e-12,
        atol=1e-14,
    )


def test_relu_vjp(rng):
    x = jnp.asarray(rng.standard_normal((5, 5)))
    g = jnp.asarray(rng.standard_normal((5, 5)))
    _, vjp = jax.vjp(relu, x)
    (dx,) = vjp(g)
    np.testing.assert_allclose(np.asarray(dx), np.where(x > 0, g, 0))


@pytest.mark.parametrize("fn", [softmax, softmax_row_wise])
def test_softmax_vjp_matches_autodiff(rng, fn):
    x = jnp.asarray(rng.standard_normal((7, 9)))
    g = jnp.asarray(rng.standard_normal((7, 9)))
    axis = 0 if fn is softmax else -1

    def ref(x):
        e = jnp.exp(x - jnp.max(x, axis=axis, keepdims=True))
        return e / jnp.sum(e, axis=axis, keepdims=True)

    _, vjp = jax.vjp(fn, x)
    _, ref_vjp = jax.vjp(ref, x)
    np.testing.assert_allclose(
        np.asarray(vjp(g)[0]), np.asarray(ref_vjp(g)[0]), rtol=1e-9, atol=1e-12
    )


@pytest.mark.parametrize("fn", [softmax, softmax_row_wise])
def test_softmax_vjp_matches_finite_differences(rng, fn):
    """Finite-difference cross-check (SURVEY.md §8.2: parity means parity with
    the math, verified independently of both implementations)."""
    x = jnp.asarray(rng.standard_normal((4, 5)))
    g = jnp.asarray(rng.standard_normal((4, 5)))
    _, vjp = jax.vjp(fn, x)
    (dx,) = vjp(g)
    eps = 1e-6
    for idx in [(0, 0), (1, 3), (3, 4)]:
        e = jnp.zeros_like(x).at[idx].set(eps)
        fd = (jnp.vdot(g, fn(x + e)) - jnp.vdot(g, fn(x - e))) / (2 * eps)
        np.testing.assert_allclose(float(dx[idx]), float(fd), rtol=1e-4)


def test_softmax_stability():
    x = jnp.asarray([[1000.0, -1000.0], [1001.0, -999.0]])
    out = np.asarray(softmax(x))
    assert np.all(np.isfinite(out))
    np.testing.assert_allclose(out.sum(axis=0), [1.0, 1.0], rtol=1e-12)
