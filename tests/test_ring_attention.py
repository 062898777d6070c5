"""Ring attention on the 8-virtual-device mesh vs the dense reference math."""

import jax
import jax.numpy as jnp
import numpy as np

from big_linear_algebra.nn.attention import attention_dense
from big_linear_algebra.parallel import make_mesh
from big_linear_algebra.parallel.ring_attention import ring_attention


def test_ring_matches_dense(rng):
    mesh = make_mesh({"seq": 8})
    b, n, d = 2, 64, 16
    q = jnp.asarray(rng.standard_normal((b, n, d)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((b, n, d)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((b, n, d)), jnp.float32)
    got = np.asarray(ring_attention(q, k, v, mesh))
    want = np.asarray(attention_dense(q, k, v))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


def test_ring_gradients_match_dense(rng):
    mesh = make_mesh({"seq": 4, "data": 2})
    b, n, d = 1, 32, 8
    q = jnp.asarray(rng.standard_normal((b, n, d)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((b, n, d)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((b, n, d)), jnp.float32)
    g = jnp.asarray(rng.standard_normal((b, n, d)), jnp.float32)

    _, vjp_ring = jax.vjp(lambda *a: ring_attention(*a, mesh, "seq"), q, k, v)
    _, vjp_dense = jax.vjp(attention_dense, q, k, v)
    for got, want in zip(vjp_ring(g), vjp_dense(g)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=5e-5, atol=5e-6)


def test_ring_blocks_sublane_aligned():
    """Every tiling a ring shard gets is legal for the Triton kernel:
    powers of two of at least 16 rows (the CPU interpret-mode tests would
    not catch an illegal block; the GPU compiler would), with the shard
    padded by less than one block."""
    from big_linear_algebra.nn.attention import flash_blocks

    for n_local in (1, 7, 8, 20, 24, 100, 500, 513, 600, 1024, 2048):
        blocks = flash_blocks(n_local, 16, jnp.float32)
        for b in blocks[:4]:
            assert b >= 16 and b & (b - 1) == 0, (n_local, blocks)
        big = max(blocks[:4])
        assert -(-n_local // big) * big - n_local < big, (n_local, blocks)


def test_ring_unaligned_shard(rng):
    """n_local=20 (not a power of two): the 32-row block pads the shard
    and masks the tail; fwd and grads still match dense."""
    mesh = make_mesh({"seq": 4, "data": 2})
    b, n, d = 1, 80, 8   # 80/4 = 20 rows per shard
    q = jnp.asarray(rng.standard_normal((b, n, d)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((b, n, d)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((b, n, d)), jnp.float32)
    g = jnp.asarray(rng.standard_normal((b, n, d)), jnp.float32)

    got = np.asarray(ring_attention(q, k, v, mesh, "seq"))
    want = np.asarray(attention_dense(q, k, v))
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=5e-6)

    _, vjp_ring = jax.vjp(lambda *a: ring_attention(*a, mesh, "seq"), q, k, v)
    _, vjp_dense = jax.vjp(attention_dense, q, k, v)
    for got, want in zip(vjp_ring(g), vjp_dense(g)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=5e-5, atol=5e-6)


def test_ring_non_pow2_shard(rng):
    """Non-power-of-two local shards (n_local=24 here) pad to one block
    only — fwd and grads still match dense."""
    mesh = make_mesh({"seq": 4, "data": 2})
    b, n, d = 1, 96, 8   # 96/4 = 24 rows per shard
    q = jnp.asarray(rng.standard_normal((b, n, d)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((b, n, d)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((b, n, d)), jnp.float32)
    g = jnp.asarray(rng.standard_normal((b, n, d)), jnp.float32)

    got = np.asarray(ring_attention(q, k, v, mesh, "seq"))
    want = np.asarray(attention_dense(q, k, v))
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=5e-6)

    _, vjp_ring = jax.vjp(lambda *a: ring_attention(*a, mesh, "seq"), q, k, v)
    _, vjp_dense = jax.vjp(attention_dense, q, k, v)
    for got, want in zip(vjp_ring(g), vjp_dense(g)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=5e-5, atol=5e-6)
