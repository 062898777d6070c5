"""Activations with hand-written VJPs (≈ reference ``lib/util.c``).

- ``relu``              ≈ ``relu``             (lib/util.c:7)
- ``softmax``           ≈ ``softmax``          (lib/util.c:15, column-wise,
                                                max-subtracted for stability)
- ``softmax_row_wise``  ≈ ``softmax_row_wise`` (lib/util.c:36, used by the
                                                U-Net attention scores)

Backward passes are explicit ``jax.custom_vjp``s mirroring the reference's
hand derivations:

- ReLU': ``g * (x > 0)`` — as applied in model/mnist_nn.c:273-278 on the
  pre-activation ("raw") values.
- Softmax backward uses the full Jacobian ``dx = y ⊙ (g − ⟨g, y⟩)`` per
  softmax vector — the derivation the U-Net attention backward carries out
  explicitly in ``_softmax_ddx`` (model/cifar_unet.c:1246-1258). (The *legacy*
  ``model/mnist.c:37`` used a diagonal-only Jacobian and forgot the exp in the
  forward — SURVEY.md §7.7; intended-semantics policy applies.)

These are elementwise / small-reduction ops: XLA emits fused code for them,
and keeping them as HLO lets them fuse into adjacent matmul epilogues. The flash-attention Pallas kernel (nn/attention.py) fuses its own
online softmax and does not call these.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@jax.custom_vjp
def relu(x: jax.Array) -> jax.Array:
    """max(x, 0). ≈ ``relu`` (lib/util.c:7)."""
    return jnp.maximum(x, 0)


def _relu_fwd(x):
    return jnp.maximum(x, 0), (x > 0)


def _relu_bwd(mask, g):
    return (jnp.where(mask, g, 0).astype(g.dtype),)


relu.defvjp(_relu_fwd, _relu_bwd)


def _softmax_fwd_impl(x: jax.Array, axis: int) -> jax.Array:
    # Numerically-stable: subtract the per-vector max, as the reference does
    # (lib/util.c:15-33 tracks the column max before exponentiating).
    m = jnp.max(x, axis=axis, keepdims=True)
    e = jnp.exp(x - jax.lax.stop_gradient(m))
    return e / jnp.sum(e, axis=axis, keepdims=True)


def _softmax_bwd_impl(y: jax.Array, g: jax.Array, axis: int) -> jax.Array:
    # Full Jacobian: dx_i = y_i * (g_i - sum_j g_j y_j)
    # (model/cifar_unet.c:1246-1258).
    inner = jnp.sum(g * y, axis=axis, keepdims=True)
    return (y * (g - inner)).astype(g.dtype)


@functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def _softmax(x: jax.Array, axis: int) -> jax.Array:
    return _softmax_fwd_impl(x, axis)


def _softmax_vjp_fwd(x, axis):
    y = _softmax_fwd_impl(x, axis)
    return y, y


def _softmax_vjp_bwd(axis, y, g):
    return (_softmax_bwd_impl(y, g, axis),)


_softmax.defvjp(_softmax_vjp_fwd, _softmax_vjp_bwd)


def softmax(x: jax.Array) -> jax.Array:
    """Column-wise softmax (each column sums to 1) for (classes, batch)
    layouts. ≈ ``softmax`` (lib/util.c:15)."""
    return _softmax(x, 0)


def softmax_row_wise(x: jax.Array) -> jax.Array:
    """Row-wise softmax (each row sums to 1), as used on attention score rows.
    ≈ ``softmax_row_wise`` (lib/util.c:36)."""
    return _softmax(x, -1)
