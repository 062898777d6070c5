"""Optimizers as pure pytree functions (hand-rolled, from-scratch flavor).

The reference's optimizers are inline: plain SGD via scale-then-add
(model/mnist_nn.c:303-315, lib/layer.c:72-73) and an *intended* Adam in
cifar_unet — first/second-moment buffers are allocated (``gm``/``gsm``,
model/cifar_unet.c:1887-1888) but never touched (SURVEY.md §7.11). This
module finishes that intent: SGD and Adam (Kingma & Ba 2015 defaults) as
(init, update) pairs over arbitrary pytrees, jit-friendly and
donation-friendly.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp


def sgd_update(params: Any, grads: Any, lr) -> Any:
    """θ ← θ − lr·g (model/mnist_nn.c:303-315's negative-scale + add)."""
    return jax.tree.map(lambda p, g: p - lr * g, params, grads)


class AdamState(NamedTuple):
    step: jax.Array   # scalar int32
    m: Any            # first moments  (the reference's unused ``gm``)
    v: Any            # second moments (the reference's unused ``gsm``)


def _acc_dtype(dtype):
    """Moment/update-arithmetic dtype for a param leaf: at least f32.

    bf16-resident params (Config.param_dtype="bfloat16") keep full-precision
    optimizer state — the f32 "master" lives only in the moments and the
    update math, never as a stored second copy of the weights. f32/f64
    params are untouched (identity promote), so the classic paths are
    bit-identical to the pre-mixed-precision optimizer."""
    return jnp.promote_types(dtype, jnp.float32)


def adam_init(params: Any) -> AdamState:
    zeros = lambda t: jax.tree.map(
        lambda p: jnp.zeros(jnp.shape(p), _acc_dtype(jnp.asarray(p).dtype)),
        t)
    return AdamState(step=jnp.zeros((), jnp.int32), m=zeros(params),
                     v=zeros(params))


def _fmix32(h):
    """murmur3 32-bit finalizer (modular uint32 arithmetic) — full-avalanche
    mixing in 5 fusible elementwise ops."""
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h * jnp.uint32(0xC2B2AE35)
    return h ^ (h >> 16)


def stochastic_round_bf16(x32: jax.Array, seed) -> jax.Array:
    """f32 → bf16 with stochastic rounding: add dither to the 16 low
    mantissa bits and truncate, so E[rounded] = x. Round-to-nearest bf16
    writes put a quantization *floor* under training (updates below ~½ ulp
    of the weight are systematically lost — a 0.078-vs-0.058 16-epoch loss
    floor on the reference-scale U-Net); stochastic rounding
    keeps the small updates alive in expectation.

    ``seed``: uint32 scalar (vary it per step/leaf). The dither is an
    INLINE counter hash (murmur3 finalizer over element index ⊕ seed), not
    an RNG op: XLA cannot fuse RngBitGenerator, so drawing real random
    bits materializes a uint32 tree in device memory. The hash is
    pure iota/xor/mul elementwise work that fuses INTO the Adam update
    pass (zero extra memory traffic), and rounding dither only needs
    uniformity and value-independence, not cryptographic quality."""
    x32 = x32.astype(jnp.float32)
    u = jax.lax.bitcast_convert_type(x32, jnp.uint32)
    idx = jnp.arange(x32.size, dtype=jnp.uint32).reshape(x32.shape)
    r = _fmix32(idx * jnp.uint32(2654435761)
                ^ jnp.asarray(seed, jnp.uint32)) & jnp.uint32(0xFFFF)
    trunc = (u + r) & jnp.uint32(0xFFFF0000)
    # the truncated f32 is exactly representable in bf16 — the final
    # astype is a lossless narrowing, not a second rounding
    return jax.lax.bitcast_convert_type(trunc, jnp.float32).astype(
        jnp.bfloat16)


def adam_update(params: Any, grads: Any, state: AdamState, lr,
                b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8, sr_key=None):
    """One Adam step with bias correction. Returns (params, state).

    All moment/update arithmetic runs in the moment dtype (≥ f32,
    ``_acc_dtype``); the updated value is rounded back to each param
    leaf's own dtype on write. For bf16-resident params this is the
    "f32 masters confined to the optimizer" scheme: grads upcast once,
    the Adam step happens in f32, and only the final subtraction
    round-trips through bf16 — no standing f32 weight copy exists for
    the forward pass to re-read.

    ``sr_key``: when given (pass a per-step PRNG key), bf16 leaves are
    written with *stochastic* rounding — the key's raw words seed an
    inline counter-hash dither, one derived seed per leaf
    (``stochastic_round_bf16``). f32/f64 leaves and the ``sr_key=None``
    path are untouched."""
    step = state.step + 1
    t = step.astype(jnp.float32)
    m = jax.tree.map(
        lambda m_, g: b1 * m_ + (1 - b1) * g.astype(m_.dtype),
        state.m, grads)
    v = jax.tree.map(
        lambda v_, g: b2 * v_ + (1 - b2) * jnp.square(g.astype(v_.dtype)),
        state.v, grads)
    bc1 = 1 - b1 ** t
    bc2 = 1 - b2 ** t

    def write(p, m_, v_, k_):
        new = (p.astype(m_.dtype)
               - lr * (m_ / bc1) / (jnp.sqrt(v_ / bc2) + eps))
        if k_ is not None and p.dtype == jnp.bfloat16:
            return stochastic_round_bf16(new, k_)
        return new.astype(p.dtype)

    if sr_key is None:
        params = jax.tree.map(lambda p, m_, v_: write(p, m_, v_, None),
                              params, m, v)
    else:
        # per-leaf dither seeds from the key's raw words — scalar hash
        # derivations, no split/threefry work, no bits materialized
        kd = jax.random.key_data(sr_key).ravel()
        base = kd[0].astype(jnp.uint32) ^ kd[-1].astype(jnp.uint32)
        leaves, treedef = jax.tree.flatten(params)
        seeds = jax.tree.unflatten(treedef, [
            _fmix32(base ^ jnp.uint32((0x9E3779B9 * i) & 0xFFFFFFFF))
            for i in range(len(leaves))])
        params = jax.tree.map(write, params, m, v, seeds)
    return params, AdamState(step=step, m=m, v=v)
