"""The reference matrix-core surface (``lib/matrix.h:7-32``) as functional ops.

Every function in the reference's ``Matrix`` API gets a dtype-polymorphic
equivalent over ``jax.Array``. These ops are memory-bound elementwise /
reduction / broadcast ops: the right implementation is plain XLA HLO, which
the compiler fuses into neighbouring ops (often into a matmul's epilogue) —
a dedicated kernel per op would *prevent* fusion and add launch overhead.
The matmuls live in
``ops/matmul.py``; fused multi-pass kernels (softmax, group-norm, attention)
live in ``ops/activations.py`` and ``nn/``.

Intended-semantics policy (SURVEY.md §7): where the reference has an indexing
bug we implement the evident intent and document the deviation — see
``matrix_col_sum``.

Reference mapping:
- ``make_matrix``/``clone_matrix``/``free_matrix`` (lib/matrix.c:6,14,~) — not
  needed: JAX arrays are immutable values; "clone" is identity, "free" is GC.
- ``print_matrix``/``print_matrix_dim`` (lib/matrix.c:71,91) — ``print_matrix``
  below.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def matrix_scale(m: jax.Array, scalar) -> jax.Array:
    """Elementwise scale. ≈ ``matrix_scale`` (lib/matrix.c:59)."""
    return m * jnp.asarray(scalar, dtype=m.dtype)


def matrix_add(a: jax.Array, b: jax.Array) -> jax.Array:
    """Elementwise add with exact-shape check. ≈ ``matrix_add`` (lib/matrix.c:65).

    The reference exits on any shape mismatch; broadcasting is deliberately
    rejected here too (use the explicit tile-add ops for bias broadcasts).
    """
    if a.shape != b.shape:
        raise ValueError(f"matrix_add: shape mismatch {a.shape} vs {b.shape}")
    return a + b


def matrix_multiply_elementwise(a: jax.Array, b: jax.Array) -> jax.Array:
    """Hadamard product. ≈ ``matrix_multiply_elementwise`` (lib/matrix.c:95)."""
    if a.shape != b.shape:
        raise ValueError(
            f"matrix_multiply_elementwise: shape mismatch {a.shape} vs {b.shape}"
        )
    return a * b


def matrix_transpose(m: jax.Array) -> jax.Array:
    """Transpose. ≈ ``matrix_transpose`` (lib/matrix.c:105), which clones the
    whole matrix; XLA treats this as a layout change and usually fuses it away.
    Prefer ``matmul_nt``/``matmul_tn`` over transpose-then-matmul."""
    return m.T


def matrix_row_sum(m: jax.Array) -> jax.Array:
    """Sum *along* the rows (values in the same column) → (1, cols).
    ≈ ``matrix_row_sum`` (lib/matrix.c:123)."""
    return jnp.sum(m, axis=0, keepdims=True)


def matrix_col_sum(m: jax.Array) -> jax.Array:
    """Sum *along* the columns (values in the same row) → (rows, 1).

    ≈ the *intent* of ``matrix_col_sum`` (lib/matrix.c:138). The reference
    indexes ``data[i * rows + j]`` instead of ``i * cols + j``
    (lib/matrix.c:144), which is only correct for square matrices
    (SURVEY.md §7.6) — its mnist_nn bias gradients (model/mnist_nn.c:271,282,
    293) therefore sum in-bounds garbage on non-square inputs.
    Intended-semantics policy: we implement the correct per-row sum.
    """
    return jnp.sum(m, axis=1, keepdims=True)


def frobenius_norm(m: jax.Array) -> jax.Array:
    """Frobenius norm. ≈ ``frobenius_norm`` (lib/matrix.c:150)."""
    return jnp.sqrt(jnp.sum(m * m))


def max_value(m: jax.Array) -> jax.Array:
    """Maximum element. ≈ ``max_value`` (lib/matrix.c:160)."""
    return jnp.max(m)


def matrix_z_score_normalize(m: jax.Array) -> jax.Array:
    """Whole-matrix z-score normalization: (m - mean) / std over all entries.

    ≈ ``matrix_z_score_normalize`` (lib/matrix.c:170). The reference computes a
    population std via ``sqrtf`` on doubles (lib/matrix.c:179, SURVEY.md §7.14);
    we use full-precision sqrt (intended semantics).
    """
    mean = jnp.mean(m)
    var = jnp.mean((m - mean) ** 2)
    return (m - mean) / jnp.sqrt(var)


def matrix_add_tile_columns(m: jax.Array, col: jax.Array) -> jax.Array:
    """Add a (rows, 1) column vector to every column of ``m`` (bias broadcast
    across a column-major batch). ≈ ``matrix_add_tile_columns``
    (lib/matrix.c:189), used for biases in model/mnist_nn.c:222-233."""
    if col.shape != (m.shape[0], 1):
        raise ValueError(
            f"matrix_add_tile_columns: expected {(m.shape[0], 1)}, got {col.shape}"
        )
    return m + col


def matrix_add_tile_rows(m: jax.Array, row: jax.Array) -> jax.Array:
    """Add a (1, cols) row vector to every row of ``m``.
    ≈ ``matrix_add_tile_rows`` (lib/matrix.c:199), used for the attention
    output bias in model/cifar_unet.c:1020."""
    if row.shape != (1, m.shape[1]):
        raise ValueError(
            f"matrix_add_tile_rows: expected {(1, m.shape[1])}, got {row.shape}"
        )
    return m + row


def print_matrix(m: jax.Array, name: str = "") -> None:
    """Host-side debug print. ≈ ``print_matrix`` (lib/matrix.c:71)."""
    import numpy as np

    arr = np.asarray(m)
    if name:
        print(f"{name} ({arr.shape[0]}x{arr.shape[1] if arr.ndim > 1 else 1}):")
    for row in arr.reshape(arr.shape[0], -1):
        print(" ".join(f"{v: .6f}" for v in row))
