"""Parity tests: ops/matrix.py vs the compiled C reference (lib/matrix.c)."""

import numpy as np
import pytest

import big_linear_algebra.ops as ops
from tests import oracle

pytestmark = pytest.mark.skipif(
    not oracle.reference_available(), reason="reference tree not mounted"
)

SHAPES = [(3, 3), (5, 7), (64, 33), (1, 9), (128, 1)]


@pytest.mark.parametrize("shape", SHAPES)
def test_scale(rng, shape):
    a = rng.standard_normal(shape)
    np.testing.assert_allclose(
        np.asarray(ops.matrix_scale(a, 2.5)), oracle.c_scale(a, 2.5), rtol=1e-12
    )


@pytest.mark.parametrize("shape", SHAPES)
def test_add(rng, shape):
    a, b = rng.standard_normal(shape), rng.standard_normal(shape)
    np.testing.assert_allclose(
        np.asarray(ops.matrix_add(a, b)), oracle.c_add(a, b), rtol=1e-12
    )


@pytest.mark.parametrize("shape", SHAPES)
def test_multiply_elementwise(rng, shape):
    a, b = rng.standard_normal(shape), rng.standard_normal(shape)
    np.testing.assert_allclose(
        np.asarray(ops.matrix_multiply_elementwise(a, b)),
        oracle.c_multiply_elementwise(a, b),
        rtol=1e-12,
    )


@pytest.mark.parametrize("shape", SHAPES)
def test_transpose(rng, shape):
    a = rng.standard_normal(shape)
    np.testing.assert_allclose(
        np.asarray(ops.matrix_transpose(a)), oracle.c_transpose(a), rtol=1e-15
    )


@pytest.mark.parametrize("shape", SHAPES)
def test_row_sum(rng, shape):
    a = rng.standard_normal(shape)
    np.testing.assert_allclose(
        np.asarray(ops.matrix_row_sum(a)), oracle.c_row_sum(a), rtol=1e-12,
        atol=1e-12,
    )


@pytest.mark.parametrize("n", [3, 8, 17])
def test_col_sum_square_matches_reference(rng, n):
    # The reference col_sum is only correct for square matrices
    # (lib/matrix.c:144, SURVEY.md §7.6); parity is checked where it is right.
    a = rng.standard_normal((n, n))
    np.testing.assert_allclose(
        np.asarray(ops.matrix_col_sum(a)), oracle.c_col_sum(a), rtol=1e-12,
        atol=1e-12,
    )


def test_col_sum_intended_semantics(rng):
    # Non-square: we implement the intent (true per-row sum, reference
    # naming), a documented deviation from the reference's index bug.
    a = rng.standard_normal((4, 9))
    np.testing.assert_allclose(
        np.asarray(ops.matrix_col_sum(a)), a.sum(axis=1, keepdims=True),
        rtol=1e-12, atol=1e-12,
    )


@pytest.mark.parametrize("shape", SHAPES)
def test_frobenius(rng, shape):
    a = rng.standard_normal(shape)
    np.testing.assert_allclose(
        float(ops.frobenius_norm(a)), oracle.c_frobenius(a), rtol=1e-12
    )


@pytest.mark.parametrize("shape", SHAPES)
def test_max_value(rng, shape):
    a = rng.standard_normal(shape)
    assert float(ops.max_value(a)) == oracle.c_max_value(a)


@pytest.mark.parametrize("shape", [(4, 4), (16, 5)])
def test_z_score_normalize(rng, shape):
    a = rng.standard_normal(shape) * 3 + 1
    # Reference uses sqrtf (float32 sqrt) on doubles (lib/matrix.c:179),
    # so parity is float32-level only.
    np.testing.assert_allclose(
        np.asarray(ops.matrix_z_score_normalize(a)),
        oracle.c_z_score_normalize(a),
        rtol=2e-7,
    )


def test_add_tile_columns(rng):
    a = rng.standard_normal((6, 11))
    col = rng.standard_normal((6, 1))
    np.testing.assert_allclose(
        np.asarray(ops.matrix_add_tile_columns(a, col)),
        oracle.c_add_tile_columns(a, col),
        rtol=1e-15,
    )


def test_add_tile_rows(rng):
    a = rng.standard_normal((6, 11))
    row = rng.standard_normal((1, 11))
    np.testing.assert_allclose(
        np.asarray(ops.matrix_add_tile_rows(a, row)),
        oracle.c_add_tile_rows(a, row),
        rtol=1e-15,
    )


def test_shape_mismatch_raises(rng):
    a, b = rng.standard_normal((3, 4)), rng.standard_normal((4, 3))
    with pytest.raises(ValueError):
        ops.matrix_add(a, b)
    with pytest.raises(ValueError):
        ops.matrix_multiply_elementwise(a, b)
