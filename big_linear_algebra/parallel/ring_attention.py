"""Sequence-parallel ring attention over a mesh axis.

The reference's attention is single-host, full O(N²) with the N×N scores
materialized (model/cifar_unet.c:999-1022, SURVEY.md §5 "Long-context").
This module shards the sequence axis over a mesh axis, keeps q local, and
rotates k/v blocks around the ring with ``jax.lax.ppermute`` — the
distributed form of the flash kernel (nn/attention.py), which it reuses:

- **forward**: each rotation runs the flash forward kernel on (local q,
  visiting k/v) producing a block (o_r, lse_r); partials are merged with the
  numerically-stable logsumexp combination. The (N/P)² score block never
  reaches device memory.
- **backward**: an explicit VJP (the library-wide stance — autodiff is a
  test oracle only). Each rotation calls the flash backward kernels with
  the *global* (o, lse) residuals and the visiting k/v block, which yields
  exactly that block's (dq, dk, dv) contributions; dk/dv accumulate in
  buffers that travel around the ring *with* their k/v block and take one
  final hop home.

Comm cost is P−1 permutes of the local k/v shard forward (P backward: P−1
in-loop hops + the final homing hop), which XLA's scheduler can overlap
with the per-block kernels; on one host XLA hands them to NCCL over NVLink.

Single-head (B, N, d) shapes like nn/attention.py; N must divide evenly by
the axis size.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from big_linear_algebra.nn.attention import (_flash_bwd_kernels,
                                             _flash_bwd_prepare, _flash_fwd,
                                             flash_blocks)


def _merge(o, lse, o_r, lse_r):
    """Stable merge of two flash partials (o f32, lse natural-log domain)."""
    new_lse = jnp.logaddexp(lse, lse_r)
    o = (o * jnp.exp(lse - new_lse)[..., None]
         + o_r.astype(jnp.float32) * jnp.exp(lse_r - new_lse)[..., None])
    return o, new_lse


@functools.partial(jax.custom_vjp, nondiff_argnums=(3,))
def _ring_flash(q, k, v, axis_name):
    return _ring_flash_fwd(q, k, v, axis_name)[0]


def _ring_flash_fwd(q, k, v, axis_name):
    n_dev = jax.lax.axis_size(axis_name)
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    blocks = flash_blocks(q.shape[1], q.shape[2], q.dtype)

    o_r, lse = _flash_fwd(q, k, v, blocks)
    o = o_r.astype(jnp.float32)
    kr, vr = k, v
    # Python loop (static trip count) so XLA can overlap permute & compute
    for _ in range(n_dev - 1):
        kr = jax.lax.ppermute(kr, axis_name, perm)
        vr = jax.lax.ppermute(vr, axis_name, perm)
        o_r, lse_r = _flash_fwd(q, kr, vr, blocks)
        o, lse = _merge(o, lse, o_r, lse_r)
    o = o.astype(q.dtype)
    return o, (q, k, v, o, lse)


def _ring_flash_bwd(axis_name, res, g):
    q, k, v, o, lse = res
    n_dev = jax.lax.axis_size(axis_name)
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    blocks = flash_blocks(q.shape[1], q.shape[2], q.dtype)

    dq = jnp.zeros(q.shape, jnp.float32)
    kr, vr = k, v
    dkr = jnp.zeros(k.shape, jnp.float32)
    dvr = jnp.zeros(v.shape, jnp.float32)
    # rotation-invariant residual prep (padded q/g, lse/delta rows) done
    # ONCE — only the visiting k/v change per rotation
    prepared = _flash_bwd_prepare(q, g, o, lse, blocks)
    for r in range(n_dev):
        if r > 0:
            kr, vr, dkr, dvr = (jax.lax.ppermute(x, axis_name, perm)
                                for x in (kr, vr, dkr, dvr))
        # Flash backward on (local q, visiting k/v) with the GLOBAL o/lse
        # residuals: p = exp(s − lse_global) is exactly this block's slice
        # of the softmax, so the returned grads are the block's exact
        # contributions.
        dq_r, dk_r, dv_r = _flash_bwd_kernels(prepared, kr, vr, q.shape,
                                              blocks)
        dq = dq + dq_r.astype(jnp.float32)
        dkr = dkr + dk_r.astype(jnp.float32)
        dvr = dvr + dv_r.astype(jnp.float32)
    # after P−1 in-loop hops each (k, dk, dv) bundle sits one device short
    # of its owner; one final hop brings the accumulated grads home
    dkr = jax.lax.ppermute(dkr, axis_name, perm)
    dvr = jax.lax.ppermute(dvr, axis_name, perm)
    return dq.astype(q.dtype), dkr.astype(k.dtype), dvr.astype(v.dtype)


_ring_flash.defvjp(_ring_flash_fwd, _ring_flash_bwd)


def ring_attention(q: jax.Array, k: jax.Array, v: jax.Array, mesh: Mesh,
                   axis_name: str = "seq") -> jax.Array:
    """Sequence-sharded attention: q/k/v (B, N, d) with N sharded over
    ``axis_name``. Exact (up to fp) match of attention_dense."""
    from big_linear_algebra.parallel.spmd import shard_map_fn

    spec = P(None, axis_name, None)
    fn = shard_map_fn(
        lambda q, k, v: _ring_flash(q, k, v, axis_name),
        mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=spec,
    )
    sharding = NamedSharding(mesh, spec)
    q, k, v = (jax.device_put(x, sharding) for x in (q, k, v))
    return fn(q, k, v)
