"""Dense (fully-connected) layer with the reference's hand-derived backward.

The reference computes ``z = W @ x + b`` on column-major batches
(model/mnist_nn.c:221-233) and backprops by hand:
``dW = dz @ actᵀ``, ``db = col_sum(dz)``, ``dx = Wᵀ @ dz``
(model/mnist_nn.c:259-293, with the corrected col-sum — SURVEY.md §7.6).

Design: batch-major ``z = x @ W + b`` with ``x``: (batch, in), ``W``:
(in, out) — the batch dimension leads, so data-parallel sharding of the
batch axis falls out naturally. The VJP is explicit (``jax.custom_vjp``) and
routes both backward GEMMs through the transposed matmul variants
(ops/matmul.py) so no transpose is materialized.

The bias add — and optionally the ReLU that always follows it in the
reference's hidden layers (model/mnist_nn.c:224,229) — is written as plain
jnp after the dot, which XLA fuses into the GEMM's output. The backward
applies the ReLU mask to the cotangent (``out > 0`` ⇔ pre-activation > 0)
before the two GEMMs, exactly the reference's ``relu'(raw) ⊙ dz``
(model/mnist_nn.c:273-278).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from big_linear_algebra.ops.matmul import _dispatch


@functools.partial(jax.custom_vjp, nondiff_argnums=(3,))
def dense(x: jax.Array, w: jax.Array, b: jax.Array,
          activation: Optional[str] = None) -> jax.Array:
    """``act(x @ w + b)``. x: (B, in), w: (in, out), b: (out,);
    ``activation``: None or "relu"."""
    return _dispatch(x, w, "nn", None, bias=b, activation=activation)


def _dense_fwd(x, w, b, activation):
    out = _dispatch(x, w, "nn", None, bias=b, activation=activation)
    return out, (x, w, out if activation == "relu" else None)


def _dense_bwd(activation, res, g):
    x, w, out = res
    g = g.astype(x.dtype)
    if activation == "relu":
        g = g * (out > 0).astype(g.dtype)
    dx = _dispatch(g, w, "nt", x.dtype)      # g @ wᵀ
    dw = _dispatch(x, g, "tn", w.dtype)      # xᵀ @ g
    db = jnp.sum(g, axis=0)                        # col-sum over the batch
    return dx, dw, db


dense.defvjp(_dense_fwd, _dense_bwd)
