"""Losses with the reference's hand-derived gradients.

- ``softmax_cross_entropy``: fused softmax + CE. The reference never
  differentiates its softmax in mnist_nn — it backprops the fused form with
  the classic seed ``dz = softmax(z) − onehot`` (model/mnist_nn.c:263-268).
  The CE value uses the reference's ``log(p + 1e-15)`` epsilon
  (model/mnist_nn.c:15,83-90).
- ``mse_loss``: seed ``2·(pred − target)`` (lib/layer.c:86-88 and the U-Net's
  ``dL/dY = 2(pred − noise)``, model/cifar_unet.c:1353-1364). Sum-of-squares
  (not mean), matching both reference call sites.
- ``hinge_loss``: one-vs-rest hinge with subgradient ``−y·x`` on margin
  violations (model/mnist_hinge.c:137-149, intended sign semantics —
  SURVEY.md §7.9).

All losses support an optional per-example ``mask`` so jit-compiled steps can
handle the reference's ragged last batch (model/mnist_nn.c:194-195) with a
single compiled shape.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from big_linear_algebra.ops.precision import matmul_precision as _matmul_precision

LOSS_EPSILON = 1e-15  # model/mnist_nn.c:15


def _masked(x: jax.Array, mask: Optional[jax.Array], axis=None):
    if mask is not None:
        x = x * mask
    return jnp.sum(x, axis=axis)


@jax.custom_vjp
def softmax_cross_entropy(logits: jax.Array, onehot: jax.Array,
                          mask: Optional[jax.Array] = None) -> jax.Array:
    """Σ_examples CE(softmax(logits), onehot). logits: (B, C), row-major
    batch; returns the summed loss (callers divide, as the reference does
    per-epoch at model/mnist_nn.c:339-340)."""
    p = jax.nn.softmax(logits, axis=-1)
    ce = -jnp.sum(onehot * jnp.log(p + LOSS_EPSILON), axis=-1)
    return _masked(ce, mask)


def _sce_fwd(logits, onehot, mask):
    p = jax.nn.softmax(logits, axis=-1)
    ce = -jnp.sum(onehot * jnp.log(p + LOSS_EPSILON), axis=-1)
    return _masked(ce, mask), (p, onehot, mask)


def _sce_bwd(res, g):
    p, onehot, mask = res
    dz = (p - onehot) * g
    if mask is not None:
        dz = dz * mask[:, None]
    return dz.astype(p.dtype), None, None


softmax_cross_entropy.defvjp(_sce_fwd, _sce_bwd)


def _example_mask(mask, ndim):
    """(B,) mask broadcast over an example's trailing dims."""
    return mask.reshape((-1,) + (1,) * (ndim - 1))


@jax.custom_vjp
def mse_loss(pred: jax.Array, target: jax.Array,
             mask: Optional[jax.Array] = None) -> jax.Array:
    """Sum of squared errors (≈ compute_mse_loss, model/cifar_unet.c:1858,
    which averages; the gradient seed 2·(pred−target) at :1353-1364 implies
    the sum — we return the sum and let callers normalize, recording the
    deviation). ``mask``: optional (B,) per-example validity for ragged
    batches."""
    d = pred - target
    sq = d * d
    if mask is not None:
        sq = sq * _example_mask(mask, sq.ndim).astype(sq.dtype)
    return jnp.sum(sq)


def _mse_fwd(pred, target, mask):
    d = pred - target
    if mask is not None:
        # weight the SQUARES by m (matching the primal Σ m·d²) and seed
        # 2·m·d — premasking d would compute Σ(m·d)² = Σ m²·d², which
        # silently disagrees with the primal for fractional weights
        m = _example_mask(mask, d.ndim).astype(d.dtype)
        return jnp.sum(m * d * d), m * d
    return jnp.sum(d * d), d


def _mse_bwd(md, g):
    seed = (2.0 * md * g).astype(md.dtype)
    return seed, -seed, None


mse_loss.defvjp(_mse_fwd, _mse_bwd)


def cross_entropy_loss(probs: jax.Array, onehot: jax.Array) -> jax.Array:
    """CE given probabilities (≈ cross_entropy_loss, model/mnist_nn.c:83):
    −Σ y·log(p + ε). Metric-only helper (no custom VJP needed)."""
    return -jnp.sum(onehot * jnp.log(probs + LOSS_EPSILON))


@jax.custom_vjp
def hinge_loss(w: jax.Array, x: jax.Array, y: jax.Array,
               mask: Optional[jax.Array] = None) -> jax.Array:
    """One-vs-rest linear hinge: Σ_i max(0, 1 − y_i·(x_i @ w)).

    w: (features,), x: (B, features), y: (B,) in {−1, +1};
    ``mask``: optional (B,) per-example validity for ragged batches.
    Subgradient w.r.t. w is ``−Σ_{margin<1} y_i·x_i``
    (model/mnist_hinge.c:137-149, intended descent semantics).
    """
    prec = _matmul_precision(jnp.result_type(x.dtype, w.dtype))
    margins = y * jnp.matmul(x, w, precision=prec)
    return _masked(jnp.maximum(0.0, 1.0 - margins), mask)


def _hinge_fwd(w, x, y, mask):
    prec = _matmul_precision(jnp.result_type(x.dtype, w.dtype))
    margins = y * jnp.matmul(x, w, precision=prec)
    return (_masked(jnp.maximum(0.0, 1.0 - margins), mask),
            (x, y, margins, mask))


def _hinge_bwd(res, g):
    x, y, margins, mask = res
    viol = (margins < 1.0).astype(x.dtype)
    if mask is not None:
        viol = viol * mask.astype(x.dtype)
    # explicit precision: a bare @ may run f32 in TF32 on the GPU
    # and margins near the 1.0 threshold flip the violation set
    dw = -jnp.matmul(viol * y, x,
                     precision=_matmul_precision(x.dtype)) * g
    return dw.astype(x.dtype), None, None, None


hinge_loss.defvjp(_hinge_fwd, _hinge_bwd)
