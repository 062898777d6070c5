"""group_norm parity vs the C reference (compat mode) + textbook-mode checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from big_linear_algebra.nn.norm import group_norm
from tests import oracle

needs_ref = pytest.mark.skipif(
    not oracle.reference_available(), reason="no reference"
)

CASES = [
    (8, 4, 5, 5),    # channels, group_size, H, W
    (6, 2, 4, 7),
    (7, 3, 4, 4),    # ragged last group (lib/norm.c:8-11)
    (4, 4, 8, 8),    # single group
]


@needs_ref
@pytest.mark.parametrize("case", CASES)
def test_forward_matches_c_reference_compat(rng, case):
    c, gs, h, w = case
    x = rng.standard_normal((c, h, w)) * 2 + 0.5
    ours = np.asarray(group_norm(jnp.asarray(x), gs, reference_compat=True))
    theirs, _, _ = oracle.c_group_norm(x, gs)
    np.testing.assert_allclose(ours, theirs, rtol=1e-9, atol=1e-9)


@needs_ref
@pytest.mark.parametrize("case", CASES)
def test_backward_matches_c_reference_compat(rng, case):
    c, gs, h, w = case
    x = rng.standard_normal((c, h, w)) * 2 + 0.5
    g = rng.standard_normal((c, h, w))
    _, means, stdevs = oracle.c_group_norm(x, gs)
    want = oracle.c_group_norm_ddx(g, x, means, stdevs, gs)
    _, vjp = jax.vjp(
        lambda x_: group_norm(x_, gs, reference_compat=True), jnp.asarray(x))
    (dx,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(np.asarray(dx), want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("case", CASES[:2])
def test_textbook_vjp_matches_autodiff(rng, case):
    c, gs, h, w = case
    x = jnp.asarray(rng.standard_normal((c, h, w)))
    g = jnp.asarray(rng.standard_normal((c, h, w)))

    def plain(x):
        xg = x.reshape(c // gs, gs, h, w)
        mean = xg.mean(axis=(1, 2, 3), keepdims=True)
        var = ((xg - mean) ** 2).mean(axis=(1, 2, 3), keepdims=True)
        return ((xg - mean) / jnp.sqrt(var + 1e-8)).reshape(c, h, w)

    _, vjp = jax.vjp(lambda x_: group_norm(x_, gs), x)
    _, ref_vjp = jax.vjp(plain, x)
    np.testing.assert_allclose(np.asarray(vjp(g)[0]),
                               np.asarray(ref_vjp(g)[0]),
                               rtol=1e-7, atol=1e-9)


def test_textbook_normalization_properties(rng):
    x = jnp.asarray(rng.standard_normal((8, 6, 6)) * 3 + 1)
    out = np.asarray(group_norm(x, 4))
    # each group of 4 channels is ~zero-mean unit-variance
    grouped = out.reshape(2, 4 * 36)
    np.testing.assert_allclose(grouped.mean(axis=1), 0, atol=1e-6)
    np.testing.assert_allclose(grouped.std(axis=1), 1, atol=1e-4)


def test_batched_leading_dims(rng):
    x = rng.standard_normal((2, 8, 5, 5))
    batched = np.asarray(group_norm(jnp.asarray(x), 4))
    for b in range(2):
        single = np.asarray(group_norm(jnp.asarray(x[b]), 4))
        np.testing.assert_allclose(batched[b], single, rtol=1e-9, atol=1e-9)
