"""Attention tests: dense reference math, flash kernel parity (Pallas
interpret mode on the CPU), VJPs."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from big_linear_algebra.nn.attention import (
    FlashBlocks,
    attention,
    attention_dense,
    flash_attention,
    flash_blocks,
    self_attention_block,
)


def _blocks(bq, bk):
    return FlashBlocks(bq, bk, bq, bk, 4)


def _np_attention(q, k, v):
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = np.einsum("bnd,bmd->bnm", q, k) * scale
    s = s - s.max(-1, keepdims=True)
    p = np.exp(s)
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bnm,bmd->bnd", p, v)


def test_dense_forward(rng):
    q = rng.standard_normal((2, 7, 5))
    k = rng.standard_normal((2, 9, 5))
    v = rng.standard_normal((2, 9, 5))
    out = np.asarray(attention_dense(*map(jnp.asarray, (q, k, v))))
    np.testing.assert_allclose(out, _np_attention(q, k, v), rtol=1e-9,
                               atol=1e-12)


def test_dense_vjp_matches_autodiff(rng):
    q, k, v = (jnp.asarray(rng.standard_normal((2, 6, 4))) for _ in range(3))
    g = jnp.asarray(rng.standard_normal((2, 6, 4)))

    def plain(q, k, v):
        s = jnp.einsum("bnd,bmd->bnm", q, k) / math.sqrt(q.shape[-1])
        return jnp.einsum("bnm,bmd->bnd", jax.nn.softmax(s, axis=-1), v)

    _, vjp = jax.vjp(attention_dense, q, k, v)
    _, ref_vjp = jax.vjp(plain, q, k, v)
    for got, want in zip(vjp(g), ref_vjp(g)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("n,d,bq,bk", [
    (256, 16, 128, 128),
    (300, 16, 128, 128),   # non-aligned N → padding + masking
    (256, 64, 128, 256),
])
def test_flash_forward_matches_dense(rng, n, d, bq, bk):
    q = jnp.asarray(rng.standard_normal((2, n, d)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((2, n, d)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((2, n, d)), jnp.float32)
    out = np.asarray(flash_attention(q, k, v, _blocks(bq, bk)))
    want = np.asarray(attention_dense(q, k, v))
    np.testing.assert_allclose(out, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("n", [256, 300])
def test_flash_backward_matches_dense(rng, n):
    q = jnp.asarray(rng.standard_normal((1, n, 16)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((1, n, 16)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((1, n, 16)), jnp.float32)
    g = jnp.asarray(rng.standard_normal((1, n, 16)), jnp.float32)
    _, vjp_f = jax.vjp(lambda *a: flash_attention(*a, _blocks(128, 128)),
                       q, k, v)
    _, vjp_d = jax.vjp(attention_dense, q, k, v)
    for got, want in zip(vjp_f(g), vjp_d(g)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=3e-4, atol=3e-5)


def test_self_attention_block_shape_and_grad(rng):
    c, kd = 12, 4
    params = {
        "q": jnp.asarray(rng.standard_normal((c, kd)), jnp.float32) * 0.1,
        "k": jnp.asarray(rng.standard_normal((c, kd)), jnp.float32) * 0.1,
        "v": jnp.asarray(rng.standard_normal((c, kd)), jnp.float32) * 0.1,
        "w": jnp.asarray(rng.standard_normal((kd, c)), jnp.float32) * 0.1,
        "b": jnp.zeros((c,), jnp.float32),
    }
    x = jnp.asarray(rng.standard_normal((2, c, 4, 4)), jnp.float32)
    out = self_attention_block(x, params)
    assert out.shape == x.shape
    grads = jax.grad(
        lambda p: jnp.sum(self_attention_block(x, p) ** 2))(params)
    for leaf in jax.tree.leaves(grads):
        assert np.isfinite(np.asarray(leaf)).all()
        assert np.abs(np.asarray(leaf)).max() > 0


def test_flash_unequal_blocks_pad_to_largest(rng):
    """block_q=64, block_k=16, n=300: the sequence pads to the largest
    block (320), the 20-row tail is masked, and every key still counts."""
    n, d = 300, 16
    q = jnp.asarray(rng.standard_normal((1, n, d)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((1, n, d)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((1, n, d)), jnp.float32)
    g = jnp.asarray(rng.standard_normal((1, n, d)), jnp.float32)
    out, vjp_f = jax.vjp(
        lambda *a: flash_attention(*a, FlashBlocks(64, 16, 16, 64, 4)),
        q, k, v)
    want, vjp_d = jax.vjp(attention_dense, q, k, v)
    np.testing.assert_allclose(np.asarray(out), np.asarray(want),
                               rtol=2e-4, atol=2e-5)
    for got, wantg in zip(vjp_f(g), vjp_d(g)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(wantg),
                                   rtol=3e-4, atol=3e-5)


def test_flash_rejects_non_pow2_blocks():
    """Triton tiles are powers of two of at least 16 rows: a 384-row or an
    8-row block is refused at trace time, not on the card."""
    spec = jax.ShapeDtypeStruct((1, 300, 16), jnp.float32)
    for blocks in (_blocks(384, 256), _blocks(8, 16)):
        with pytest.raises(ValueError, match="powers of two"):
            jax.eval_shape(lambda q: flash_attention(q, q, q, blocks), spec)


@pytest.mark.parametrize("n,bq,bk", [
    (256, 64, 64),
    (300, 32, 64),    # non-aligned N → padding + masking
    (300, 64, 16),    # a fully padded tail key block exists
])
def test_flash_fwd_bwd_block_shapes(rng, n, bq, bk):
    """Forward and all three grads match dense for several tilings,
    including tails that are masked in the forward and dq kernels."""
    d = 16
    q = jnp.asarray(rng.standard_normal((1, n, d)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((1, n, d)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((1, n, d)), jnp.float32)
    g = jnp.asarray(rng.standard_normal((1, n, d)), jnp.float32)
    out, vjp_f = jax.vjp(
        lambda *a: flash_attention(*a, _blocks(bq, bk)), q, k, v)
    want, vjp_d = jax.vjp(attention_dense, q, k, v)
    np.testing.assert_allclose(np.asarray(out), np.asarray(want),
                               rtol=2e-4, atol=2e-5)
    for got, wantg in zip(vjp_f(g), vjp_d(g)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(wantg),
                                   rtol=3e-4, atol=3e-5)


def test_flash_long_sequence_traces():
    """Nothing in the kernel is row-resident beyond one block, so long
    sequences trace: N=64k forward and a 24k backward at d=128 f32."""
    n, d = 65536, 128
    spec = jax.ShapeDtypeStruct((1, n, d), jnp.float32)
    out = jax.eval_shape(flash_attention, spec, spec, spec)
    assert out.shape == (1, n, d)

    def bwd(q, k, v):
        return jax.grad(lambda a: jnp.sum(flash_attention(a, k, v)))(q)

    spec_b = jax.ShapeDtypeStruct((1, 24576, 128), jnp.float32)
    assert jax.eval_shape(bwd, spec_b, spec_b, spec_b).shape == spec_b.shape


def test_flash_blocks_rule():
    """Default tiling: powers of two in [16, 128], at most 64 rows for
    wide f32 rows and for the backward, padding below one block."""
    for n in (1, 7, 16, 20, 100, 300, 1024, 4096, 16384):
        for d, dtype in ((16, jnp.bfloat16), (16, jnp.float32),
                         (128, jnp.bfloat16), (128, jnp.float32)):
            b = flash_blocks(n, d, dtype)
            for x in b[:4]:
                assert 16 <= x <= 128 and x & (x - 1) == 0, (n, d, b)
            assert max(b.bwd_q, b.bwd_k) <= 64
            if d == 128 and dtype == jnp.float32:
                assert b.fwd_k <= 64
            pad = -(-n // max(b[:4])) * max(b[:4]) - n
            assert pad < max(b[:4])
            assert b.num_warps == (4 if d <= 64 else 8)


def test_attention_cross_shapes_use_dense(rng):
    """Mismatched q/k lengths must route to the dense path (the flash
    kernel's validity mask comes from q alone and would silently attend
    phantom zero keys) and flash itself must reject them loudly."""
    q = jnp.asarray(rng.standard_normal((1, 2048, 64)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((1, 1024, 64)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((1, 1024, 64)), jnp.float32)
    got = np.asarray(attention(q, k, v))
    want = np.asarray(attention_dense(q, k, v))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="self-attention-shaped"):
        jax.eval_shape(flash_attention,
                       jax.ShapeDtypeStruct((1, 2048, 64), jnp.float32),
                       jax.ShapeDtypeStruct((1, 1024, 64), jnp.float32),
                       jax.ShapeDtypeStruct((1, 1024, 64), jnp.float32))
