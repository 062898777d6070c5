"""Matrix products with hand-written VJPs.

Rebuild of the reference's dense matmul (``lib/matrix.c:35``
``matrix_multiply`` → ``:47`` ``matrix_multiply_inplace``, the j-i-k triple
loop that is the hot loop of the entire reference repo).

Three variants cover the forward pass and both backward GEMMs without ever
materializing a transpose (the reference clones the whole matrix to
transpose it, ``lib/matrix.c:105``):

- ``matmul(a, b)``      : ``a @ b``       — forward
- ``matmul_nt(a, b)``   : ``a @ b.T``     — used for dA = g @ B.T
- ``matmul_tn(a, b)``   : ``a.T @ b``     — used for dB = A.T @ g

Each is one ``lax.dot_general`` whose dimension numbers carry the transpose,
so XLA hands it to cuBLAS on the GPU with float32 accumulation. The optional
bias + ReLU epilogue (``nn/dense.py``) is plain jnp that XLA fuses into the
GEMM's output. A hand-written GEMM kernel would have to beat cuBLAS to earn
a place here; see PERF.md for the measurement.

The gradients are hand-written (``jax.custom_vjp``): this library treats
explicit backward passes as a first-class feature, mirroring the reference's
hand-derived backprop (e.g. ``model/mnist_nn.c:259-293``); JAX autodiff is
used only as a test oracle.
"""

from __future__ import annotations

import functools
from typing import Literal

import jax
import jax.numpy as jnp

from big_linear_algebra.ops.precision import matmul_precision

Variant = Literal["nn", "nt", "tn"]

# Per-variant dot_general dimension numbers and contraction-dim shape check.
_VARIANTS = {
    # C[M,N] = A[M,K] @ B[K,N]
    "nn": dict(
        dims=(((1,), (0,)), ((), ())),
        check=lambda a, b: a.shape[1] == b.shape[0],
    ),
    # C[M,N] = A[M,P] @ B[N,P].T   (contract over last dims)
    "nt": dict(
        dims=(((1,), (1,)), ((), ())),
        check=lambda a, b: a.shape[1] == b.shape[1],
    ),
    # C[M,N] = A[P,M].T @ B[P,N]   (contract over first dims)
    "tn": dict(
        dims=(((0,), (0,)), ((), ())),
        check=lambda a, b: a.shape[0] == b.shape[0],
    ),
}


def _xla_mm(a, b, variant: Variant, out_dtype, bias=None, activation=None):
    dims = _VARIANTS[variant]["dims"]
    out = jax.lax.dot_general(
        a, b, dimension_numbers=dims,
        preferred_element_type=jnp.float32
        if jnp.dtype(out_dtype).itemsize <= 4 else jnp.float64,
        precision=matmul_precision(jnp.result_type(a.dtype, b.dtype)),
    )
    if bias is not None:
        out = out + bias[None, :].astype(out.dtype)
    if activation == "relu":
        out = jnp.maximum(out, 0.0)
    return out.astype(out_dtype)


def _dispatch(a, b, variant: Variant, out_dtype, bias=None, activation=None):
    """Validate the operands, then ``_xla_mm``. ``out_dtype=None`` means the
    promoted operand dtype."""
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(
            f"matmul_{variant} expects 2-D operands, got {a.shape} and {b.shape}"
        )
    if not _VARIANTS[variant]["check"](a, b):
        # Reference behavior: dimension mismatch is a hard error
        # (lib/matrix.c:36-39 printf + exit(1)); here it is a trace-time error.
        raise ValueError(
            f"matmul_{variant}: incompatible shapes {a.shape} and {b.shape}"
        )
    if activation not in (None, "relu"):
        raise ValueError(f"unsupported fused activation {activation!r}")
    if out_dtype is None:
        out_dtype = jnp.result_type(a.dtype, b.dtype)
    return _xla_mm(a, b, variant, out_dtype, bias, activation)


# ---------------------------------------------------------------------------
# Public ops with hand-written VJPs.
# dC = g for C = f(A, B):
#   nn: C = A @ B     → dA = g @ B.T  = nt(g, B);   dB = A.T @ g = tn(A, g)
#   nt: C = A @ B.T   → dA = g @ B    = nn(g, B);   dB = g.T @ A = tn(g, A)
#   tn: C = A.T @ B   → dA = B @ g.T  = nt(B, g);   dB = A @ g   = nn(A, g)
# (matches the reference's dense backward, model/mnist_nn.c:267-289, which
#  materializes matrix_transpose clones; here the transposes live in the
#  dot's dimension numbers.)
# ---------------------------------------------------------------------------


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def _matmul_base(a, b, variant: Variant):
    return _dispatch(a, b, variant, None)


def _matmul_fwd(a, b, variant):
    return _dispatch(a, b, variant, None), (a, b)


def _matmul_bwd(variant, res, g):
    a, b = res
    g = g.astype(jnp.result_type(a.dtype, b.dtype))
    if variant == "nn":
        da = _dispatch(g, b, "nt", a.dtype)
        db = _dispatch(a, g, "tn", b.dtype)
    elif variant == "nt":
        da = _dispatch(g, b, "nn", a.dtype)
        db = _dispatch(g, a, "tn", b.dtype)
    else:  # tn
        da = _dispatch(b, g, "nt", a.dtype)
        db = _dispatch(a, g, "nn", b.dtype)
    return da, db


_matmul_base.defvjp(_matmul_fwd, _matmul_bwd)


def matmul(a: jax.Array, b: jax.Array) -> jax.Array:
    """``a @ b``. Rebuilds ``matrix_multiply`` (lib/matrix.c:35)."""
    return _matmul_base(a, b, "nn")


def matmul_nt(a: jax.Array, b: jax.Array) -> jax.Array:
    """``a @ b.T`` without materializing the transpose.

    Covers the reference pattern ``matrix_multiply(dz, matrix_transpose(act))``
    (model/mnist_nn.c:267-269) in one dot.
    """
    return _matmul_base(a, b, "nt")


def matmul_tn(a: jax.Array, b: jax.Array) -> jax.Array:
    """``a.T @ b`` without materializing the transpose.

    Covers the reference pattern ``matrix_multiply(matrix_transpose(W), dz)``
    (model/mnist_nn.c:273-275) in one dot.
    """
    return _matmul_base(a, b, "tn")
