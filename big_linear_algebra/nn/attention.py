"""Scaled dot-product attention: dense reference math + a flash kernel.

Reference semantics (model/cifar_unet.c:999-1022 ``_forward_attention``):
single-head, unmasked: ``S = QKᵀ/√d`` → row-softmax (lib/util.c:36) → ``PV``.
The reference materializes the full N×N score matrix
(``_allocate_self_attention_block_data``, :409-417) and hand-derives the
backward incl. the softmax Jacobian (``_backward_attention`` :1261-1335,
``_softmax_ddx`` :1246).

Design (SURVEY.md §5 "Long-context"):
- ``attention_dense``: exact reference math with an explicit VJP (the
  reference's derivation in matrix form). It materializes B·N² scores and
  saves the probabilities for the backward, which is fine for the U-Net's
  N ≤ 256 tokens at 32×32 and impossible at N = 16384.
- ``flash_attention``: a blockwise online-softmax Pallas kernel compiled
  through Triton on the GPU (interpreted on the CPU, ops/pallas_utils.py).
  The forward returns ``(o, lse)``; the backward is a ``dq`` kernel and a
  ``dk/dv`` kernel that recompute the scores block by block from the saved
  per-row logsumexp, so N×N never reaches device memory. It is also the
  per-shard body of ``parallel/ring_attention.py``.
- ``attention`` dispatches between them by sequence length.

Shapes: q, k, v are (B, N, d) (single head; for multi-head fold heads into B).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from big_linear_algebra.ops.pallas_utils import (interpret_mode, next_pow2,
                                                 round_up)
from big_linear_algebra.ops.precision import matmul_precision as _matmul_precision

# Sequence length from which ``attention`` takes the flash kernel; measured
# on the card (PERF.md, "Kernel decisions").
_FLASH_MIN_N = 1024


# ---------------------------------------------------------------------------
# Dense path: exact reference math, explicit VJP
# ---------------------------------------------------------------------------


def _dense_fwd_impl(q, k, v):
    scale = 1.0 / math.sqrt(q.shape[-1])
    acc_t = jnp.float64 if q.dtype == jnp.float64 else jnp.float32
    prec = _matmul_precision(q.dtype)  # f32 → HIGHEST, never TF32
    s = jnp.einsum("bnd,bmd->bnm", q, k,
                   preferred_element_type=acc_t, precision=prec) * scale
    m = jnp.max(s, axis=-1, keepdims=True)
    p = jnp.exp(s - m)
    l = jnp.sum(p, axis=-1, keepdims=True)
    p = p / l
    o = jnp.einsum("bnm,bmd->bnd", p, v.astype(p.dtype), precision=prec)
    return o.astype(q.dtype), p


@jax.custom_vjp
def attention_dense(q: jax.Array, k: jax.Array, v: jax.Array) -> jax.Array:
    """softmax(QKᵀ/√d)V with the N×N matrix materialized (the reference's
    exact formulation, model/cifar_unet.c:999-1022)."""
    return _dense_fwd_impl(q, k, v)[0]


def _attention_dense_fwd(q, k, v):
    o, p = _dense_fwd_impl(q, k, v)
    return o, (q, k, v, p)


def _attention_dense_bwd(res, g):
    q, k, v, p = res
    scale = 1.0 / math.sqrt(q.shape[-1])
    prec = _matmul_precision(q.dtype)
    g = g.astype(p.dtype)
    dv = jnp.einsum("bnm,bnd->bmd", p, g, precision=prec)
    dp = jnp.einsum("bnd,bmd->bnm", g, v.astype(p.dtype), precision=prec)
    # softmax Jacobian per row: ds = p ⊙ (dp − Σ_j dp_j p_j)
    # (model/cifar_unet.c:1246-1258,1307-1308)
    ds = p * (dp - jnp.sum(dp * p, axis=-1, keepdims=True))
    dq = jnp.einsum("bnm,bmd->bnd", ds, k.astype(ds.dtype),
                    precision=prec) * scale
    dk = jnp.einsum("bnm,bnd->bmd", ds, q.astype(ds.dtype),
                    precision=prec) * scale
    return dq.astype(q.dtype), dk.astype(k.dtype), dv.astype(v.dtype)


attention_dense.defvjp(_attention_dense_fwd, _attention_dense_bwd)


# ---------------------------------------------------------------------------
# Flash path: Pallas kernels through Triton
# ---------------------------------------------------------------------------


_LOG2E = math.log2(math.e)
# Finite mask value for padded key columns: exp2 of it underflows to 0, and
# unlike -inf it cannot turn the running max into a NaN.
_MASK = -1e30


class FlashBlocks(NamedTuple):
    """Kernel tiling. Every block is a power of two ≥ 16 (Triton's tiles are
    powers of two, and its dot needs 16 rows and columns); the sequence is
    padded to the largest block, so padding stays below one block."""
    fwd_q: int
    fwd_k: int
    bwd_q: int
    bwd_k: int
    num_warps: int


def flash_blocks(n: int, d: int, dtype) -> FlashBlocks:
    """Blocks for a sequence of ``n`` rows of width ``d``. A forward block
    holds a q tile and two pipeline stages of k and v tiles in shared memory
    (≤ 227 KB a block on Hopper): at most 128 rows of 128 bf16 columns, 64
    rows of f32. The backward kernels keep two f32 accumulators and four
    score-sized tiles live, so they take 64-row blocks."""
    d_pad = max(16, next_pow2(d))
    wide = d_pad * jnp.dtype(dtype).itemsize > 256
    cap = max(16, next_pow2(n))
    fwd_q = min(128, cap)
    fwd_k = min(64 if wide else 128, cap)
    bwd = min(64, cap)
    return FlashBlocks(fwd_q, fwd_k, bwd, bwd, 4 if d_pad <= 64 else 8)


def _dot(a, b, contract, prec):
    """2-D dot with float32 accumulation; ``contract`` = (a_dim, b_dim)."""
    return jax.lax.dot_general(
        a, b, (((contract[0],), (contract[1],)), ((), ())),
        preferred_element_type=jnp.float32, precision=prec)


def _col_mask(s, start, n_valid):
    col = start + jnp.arange(s.shape[1])
    return jnp.where((col < n_valid)[None, :], s, _MASK)


def _flash_fwd_kernel(q_ref, k_ref, v_ref, o_ref, lse_ref, *,
                      scale, block_k, n_valid):
    """One q block; the loop walks the key blocks with an online softmax in
    the exp2 domain (1/√d·log2 e folded into the scores)."""
    q = q_ref[...]
    in_dtype = q.dtype
    prec = _matmul_precision(in_dtype)
    n_pad = k_ref.shape[0]

    def body(j, carry):
        acc, m, l = carry
        kb = k_ref[pl.ds(j * block_k, block_k), :]
        vb = v_ref[pl.ds(j * block_k, block_k), :]
        s = _dot(q, kb, (1, 1), prec) * (scale * _LOG2E)
        if n_valid != n_pad:
            s = _col_mask(s, j * block_k, n_valid)
        m_new = jnp.maximum(m, jnp.max(s, axis=-1))
        p = jnp.exp2(s - m_new[:, None])
        alpha = jnp.exp2(m - m_new)
        l = l * alpha + jnp.sum(p, axis=-1)
        acc = acc * alpha[:, None] + _dot(p.astype(in_dtype), vb, (1, 0),
                                          prec)
        return acc, m_new, l

    bq, d = q.shape
    acc0 = jnp.zeros((bq, d), jnp.float32)
    m0 = jnp.full((bq,), -jnp.inf, jnp.float32)
    l0 = jnp.zeros((bq,), jnp.float32)
    acc, m, l = jax.lax.fori_loop(0, n_pad // block_k, body, (acc0, m0, l0))
    o_ref[...] = (acc / l[:, None]).astype(o_ref.dtype)
    lse_ref[...] = (m + jnp.log2(l)) / _LOG2E   # natural-log domain


def _flash_bwd_dq_kernel(q_ref, k_ref, v_ref, g_ref, lse_ref, delta_ref,
                         dq_ref, *, scale, block_k, n_valid):
    """One q block; the loop walks the key blocks, recomputing p from the
    saved log2-domain lse."""
    q = q_ref[...]
    g = g_ref[...]
    lse2 = lse_ref[...]
    delta = delta_ref[...]
    in_dtype = q.dtype
    prec = _matmul_precision(in_dtype)
    n_pad = k_ref.shape[0]

    def body(j, dq):
        kb = k_ref[pl.ds(j * block_k, block_k), :]
        vb = v_ref[pl.ds(j * block_k, block_k), :]
        s = _dot(q, kb, (1, 1), prec) * (scale * _LOG2E)
        if n_valid != n_pad:
            s = _col_mask(s, j * block_k, n_valid)
        p = jnp.exp2(s - lse2[:, None])
        dp = _dot(g, vb, (1, 1), prec)
        ds = (p * (dp - delta[:, None])).astype(in_dtype)
        return dq + _dot(ds, kb, (1, 0), prec)

    dq = jax.lax.fori_loop(0, n_pad // block_k, body,
                           jnp.zeros(q.shape, jnp.float32))
    dq_ref[...] = (dq * scale).astype(dq_ref.dtype)


def _flash_bwd_dkv_kernel(q_ref, k_ref, v_ref, g_ref, lse_ref, delta_ref,
                          dk_ref, dv_ref, *, scale, block_q):
    """One key block; the loop walks the q blocks. Padded q rows carry a
    zero cotangent and zero delta, so they add nothing to dk or dv."""
    kb = k_ref[...]
    vb = v_ref[...]
    in_dtype = kb.dtype
    prec = _matmul_precision(in_dtype)
    n_pad = q_ref.shape[0]

    def body(i, carry):
        dk, dv = carry
        rows = pl.ds(i * block_q, block_q)
        q = q_ref[rows, :]
        g = g_ref[rows, :]
        lse2 = lse_ref[rows]
        delta = delta_ref[rows]
        s = _dot(q, kb, (1, 1), prec) * (scale * _LOG2E)
        p = jnp.exp2(s - lse2[:, None])
        dv = dv + _dot(p.astype(in_dtype), g, (0, 0), prec)
        dp = _dot(g, vb, (1, 1), prec)
        ds = (p * (dp - delta[:, None])).astype(in_dtype)
        dk = dk + _dot(ds, q, (0, 0), prec)
        return dk, dv

    zeros = jnp.zeros(kb.shape, jnp.float32)
    dk, dv = jax.lax.fori_loop(0, n_pad // block_q, body, (zeros, zeros))
    dk_ref[...] = (dk * scale).astype(dk_ref.dtype)
    dv_ref[...] = dv.astype(dv_ref.dtype)


def _check_blocks(blocks: FlashBlocks):
    for b in blocks[:4]:
        if b < 16 or b & (b - 1):
            raise ValueError(
                f"flash blocks must be powers of two >= 16, got {blocks}")


def _pad_to(x, n_pad, d_pad):
    pad = [(0, 0)] * x.ndim
    pad[1] = (0, n_pad - x.shape[1])
    if x.ndim == 3:
        pad[2] = (0, d_pad - x.shape[2])
    return jnp.pad(x, pad) if any(p[1] for p in pad) else x


def _geometry(n, d, blocks: FlashBlocks):
    d_pad = max(16, next_pow2(d))
    return round_up(n, max(blocks[:4])), d_pad


def _params(blocks: FlashBlocks):
    return plgpu.CompilerParams(num_warps=blocks.num_warps, num_stages=2)


def _flash_fwd(q, k, v, blocks: FlashBlocks | None = None):
    """Forward kernel: returns ``(o, lse)`` at the unpadded shapes, with lse
    (B, N) float32 in the natural-log domain."""
    b, n, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        # the kernel derives its padding and validity mask from q alone —
        # shorter k/v would be zero-padded into ATTENDED phantom keys
        # (silently wrong softmax); use attention_dense for cross-attention
        raise ValueError(
            f"flash_attention is self-attention-shaped: q {q.shape}, "
            f"k {k.shape}, v {v.shape} must match (attention_dense "
            f"supports differing key/query lengths)")
    blocks = blocks or flash_blocks(n, d, q.dtype)
    _check_blocks(blocks)
    n_pad, d_pad = _geometry(n, d, blocks)
    qp, kp, vp = (_pad_to(x, n_pad, d_pad) for x in (q, k, v))
    bq = blocks.fwd_q
    full = pl.BlockSpec((None, n_pad, d_pad), lambda b_, i: (b_, 0, 0))
    o, lse = pl.pallas_call(
        functools.partial(_flash_fwd_kernel, scale=1.0 / math.sqrt(d),
                          block_k=blocks.fwd_k, n_valid=n),
        grid=(b, n_pad // bq),
        in_specs=[pl.BlockSpec((None, bq, d_pad), lambda b_, i: (b_, i, 0)),
                  full, full],
        out_specs=[pl.BlockSpec((None, bq, d_pad), lambda b_, i: (b_, i, 0)),
                   pl.BlockSpec((None, bq), lambda b_, i: (b_, i))],
        out_shape=[jax.ShapeDtypeStruct((b, n_pad, d_pad), q.dtype),
                   jax.ShapeDtypeStruct((b, n_pad), jnp.float32)],
        backend="triton",
        compiler_params=_params(blocks),
        interpret=interpret_mode(),
        name="flash_fwd",
    )(qp, kp, vp)
    return o[:, :n, :d], lse[:, :n]


class _BwdResiduals(NamedTuple):
    """The rotation-invariant backward inputs, padded once: q, the
    cotangent, lse in the log2 domain and delta = rowsum(o·g). Ring
    attention prepares these once and reuses them for every visiting k/v."""
    qp: jax.Array
    gp: jax.Array
    lse2: jax.Array
    delta: jax.Array


def _flash_bwd_prepare(q, g, o, lse, blocks: FlashBlocks) -> _BwdResiduals:
    b, n, d = q.shape
    n_pad, d_pad = _geometry(n, d, blocks)
    delta = jnp.sum(g.astype(jnp.float32) * o.astype(jnp.float32), axis=-1)
    return _BwdResiduals(_pad_to(q, n_pad, d_pad),
                         _pad_to(g.astype(q.dtype), n_pad, d_pad),
                         _pad_to(lse * _LOG2E, n_pad, d_pad),
                         _pad_to(delta, n_pad, d_pad))


def _flash_bwd_kernels(res: _BwdResiduals, k, v, q_shape,
                       blocks: FlashBlocks):
    """dq, dk, dv of one (q, k/v) pair from prepared residuals; ``k``/``v``
    unpadded. With the global lse and delta of a ring, these are exactly
    this k/v block's contributions."""
    b, n, d = q_shape
    n_pad, d_pad = res.qp.shape[1], res.qp.shape[2]
    kp, vp = (_pad_to(x, n_pad, d_pad) for x in (k, v))
    scale = 1.0 / math.sqrt(d)
    bq, bk = blocks.bwd_q, blocks.bwd_k
    args = (res.qp, kp, vp, res.gp, res.lse2, res.delta)

    rows_q = pl.BlockSpec((None, bq, d_pad), lambda b_, i: (b_, i, 0))
    vec_q = pl.BlockSpec((None, bq), lambda b_, i: (b_, i))
    full = pl.BlockSpec((None, n_pad, d_pad), lambda b_, i: (b_, 0, 0))
    full_vec = pl.BlockSpec((None, n_pad), lambda b_, i: (b_, 0))
    rows_k = pl.BlockSpec((None, bk, d_pad), lambda b_, j: (b_, j, 0))

    dq = pl.pallas_call(
        functools.partial(_flash_bwd_dq_kernel, scale=scale, block_k=bk,
                          n_valid=n),
        grid=(b, n_pad // bq),
        in_specs=[rows_q, full, full, rows_q, vec_q, vec_q],
        out_specs=rows_q,
        out_shape=jax.ShapeDtypeStruct(res.qp.shape, res.qp.dtype),
        backend="triton",
        compiler_params=_params(blocks),
        interpret=interpret_mode(),
        name="flash_bwd_dq",
    )(*args)
    dk, dv = pl.pallas_call(
        functools.partial(_flash_bwd_dkv_kernel, scale=scale, block_q=bq),
        grid=(b, n_pad // bk),
        in_specs=[full, rows_k, rows_k, full, full_vec, full_vec],
        out_specs=[rows_k, rows_k],
        out_shape=[jax.ShapeDtypeStruct(kp.shape, kp.dtype),
                   jax.ShapeDtypeStruct(vp.shape, vp.dtype)],
        backend="triton",
        compiler_params=_params(blocks),
        interpret=interpret_mode(),
        name="flash_bwd_dkv",
    )(*args)
    return dq[:, :n, :d], dk[:, :n, :d], dv[:, :n, :d]


@functools.partial(jax.custom_vjp, nondiff_argnums=(3,))
def flash_attention(q: jax.Array, k: jax.Array, v: jax.Array,
                    blocks: FlashBlocks | None = None) -> jax.Array:
    """Blockwise online-softmax attention; N×N never reaches device memory.
    ``blocks`` overrides the tiling (``flash_blocks`` picks it by default).
    """
    return _flash_fwd(q, k, v, blocks)[0]


def _flash_attention_fwd(q, k, v, blocks):
    o, lse = _flash_fwd(q, k, v, blocks)
    return o, (q, k, v, o, lse)


def _flash_attention_bwd(blocks, res, g):
    q, k, v, o, lse = res
    blocks = blocks or flash_blocks(q.shape[1], q.shape[2], q.dtype)
    prepared = _flash_bwd_prepare(q, g, o, lse, blocks)
    return _flash_bwd_kernels(prepared, k, v, q.shape, blocks)


flash_attention.defvjp(_flash_attention_fwd, _flash_attention_bwd)


def attention(q: jax.Array, k: jax.Array, v: jax.Array) -> jax.Array:
    """Dispatch: dense for short sequences (and cross-attention shapes,
    which the flash kernel rejects), flash for long self-attention."""
    if (q.shape == k.shape == v.shape and q.shape[1] >= _FLASH_MIN_N
            and q.dtype != jnp.float64):
        return flash_attention(q, k, v)
    return attention_dense(q, k, v)


# ---------------------------------------------------------------------------
# The U-Net's self-attention block
# ---------------------------------------------------------------------------


def self_attention_block(x: jax.Array, params) -> jax.Array:
    """(B, C, H, W) → (B, C, H, W). ≈ ``_forward_attention``
    (model/cifar_unet.c:999-1022): reshape to (HW, C), project Q/K/V to
    key_dim, attend, dense back to C with bias, reshape.

    ``params``: dict with q/k/v (C, key_dim), w (key_dim, C), b (C,).
    """
    b, c, h, w = x.shape
    tokens = x.reshape(b, c, h * w).transpose(0, 2, 1)   # (B, HW, C)
    out = _attention_core(tokens, params)
    return out.transpose(0, 2, 1).reshape(b, c, h, w)


def self_attention_block_nhwc(x: jax.Array, params) -> jax.Array:
    """(B, H, W, C) → (B, H, W, C): the channels-last twin. Tokens are a
    plain reshape (no transpose — C already trails), so the block is two
    fewer HBM-sweep transposes than the NCHW version."""
    b, h, w, c = x.shape
    tokens = x.reshape(b, h * w, c)                      # (B, HW, C)
    return _attention_core(tokens, params).reshape(b, h, w, c)


def _attention_core(tokens: jax.Array, params) -> jax.Array:
    """(B, N, C) → (B, N, C): q/k/v projections → attention → output dense
    with bias. The shared body of both layout wrappers — explicit matmul
    precision so f32 mode never silently truncates to bf16."""
    prec = _matmul_precision(tokens.dtype)
    q = jnp.einsum("bnc,ck->bnk", tokens, params["q"], precision=prec)
    k = jnp.einsum("bnc,ck->bnk", tokens, params["k"], precision=prec)
    v = jnp.einsum("bnc,ck->bnk", tokens, params["v"], precision=prec)
    att = attention(q, k, v)                             # (B, N, key_dim)
    return jnp.einsum("bnk,kc->bnc", att, params["w"],
                      precision=prec) + params["b"]
