"""Group normalization fwd/bwd with explicit VJP (≈ lib/norm.c).

Reference semantics (lib/norm.c:5-49): per channel-group mean/second-moment
over (group_channels × H × W), normalize, keep the statistics for backward;
backward centers the gradient and removes its projection onto the normalized
value (lib/norm.c:52-91). No learned scale/offset (γ/β) — the reference has
none.

Intended-semantics deviations (SURVEY.md §7.5, policy §7):
- the reference's ``epsilon`` is ``const int = 1e-8`` → 0, and its "stdev" is
  the *variance*, never sqrt'd, so it normalizes by σ² instead of σ. The
  forward/backward pair is self-consistent, but it is not group norm.
- default mode here is textbook: divide by ``sqrt(σ² + 1e-8)``; the matching
  standard backward is ``(g − mean(g) − x̂·mean(g·x̂)) / sqrt(σ²+ε)``.
- ``reference_compat=True`` reproduces the reference's variance-normalizing
  math exactly (ε=0) — used by the oracle parity tests.

Ragged groups (channels not divisible by group_size) follow the reference's
``num_in_this_group`` clamp (lib/norm.c:8-11).

This is a bandwidth-bound op; XLA fuses the normalized three-pass into
two HBM sweeps, and keeping it HLO lets it fuse with the adjacent relu/conv
in the U-Net resnet blocks.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _masked_stats(xg, mask, axes, counts, with_var):
    """The one place the group mean/variance formulas live: reduce ``xg``
    over ``axes`` with an optional ragged-group ``mask`` (1 = real channel)
    and precomputed valid-element ``counts``. Every layout/direction helper
    (fwd stats, bwd means, NCHW and NHWC) routes through this, so the
    backward's mean convention is the forward's by construction."""
    if mask is None:
        mean = xg.mean(axis=axes, keepdims=True)
        var = (((xg - mean) ** 2).mean(axis=axes, keepdims=True)
               if with_var else None)
    else:
        mean = (xg * mask).sum(axis=axes, keepdims=True) / counts
        var = ((((xg - mean) ** 2) * mask).sum(axis=axes, keepdims=True)
               / counts if with_var else None)
    return mean, var


def _group_reduce(x, group_size, with_var, nhwc):
    """Per-channel-group stats broadcast back per channel.

    NCHW (``nhwc=False``): x (..., C, H, W) → stats (..., C, 1, 1).
    NHWC (``nhwc=True``):  x (..., H, W, C) → stats (..., 1, 1, C).
    Ragged groups (C not divisible by group_size) follow the reference's
    ``num_in_this_group`` clamp (lib/norm.c:8-11). Returns (mean, var);
    ``var`` is None when ``with_var`` is False (the backward's mean-only
    sweeps must not pay a discarded variance)."""
    if nhwc:
        *lead, h, w, c = x.shape
    else:
        *lead, c, h, w = x.shape
    n_groups = -(-c // group_size)
    pad_c = n_groups * group_size - c
    mask = counts = None
    if pad_c:
        flags = jnp.concatenate(
            [jnp.ones((c,), x.dtype), jnp.zeros((pad_c,), x.dtype)])
    if nhwc:
        xp = jnp.pad(x, [(0, 0)] * len(lead) + [(0, 0), (0, 0), (0, pad_c)])
        xg = xp.reshape(*lead, h, w, n_groups, group_size)
        axes = (-4, -3, -1)
        if pad_c:
            mask = flags.reshape(1, 1, n_groups, group_size)
            counts = mask.sum(axis=-1, keepdims=True) * h * w
        bshape = (*lead, 1, 1, n_groups, group_size)
        unpad = lambda s: s.reshape(*lead, 1, 1, n_groups * group_size)[..., :c]  # noqa: E731,E501
    else:
        xp = jnp.pad(x, [(0, 0)] * len(lead) + [(0, pad_c), (0, 0), (0, 0)])
        xg = xp.reshape(*lead, n_groups, group_size, h, w)
        axes = (-3, -2, -1)
        if pad_c:
            mask = flags.reshape(n_groups, group_size, 1, 1)
            counts = mask.sum(axis=1, keepdims=True) * h * w
        bshape = (*lead, n_groups, group_size, 1, 1)
        unpad = lambda s: s.reshape(*lead, n_groups * group_size, 1, 1)[..., :c, :, :]  # noqa: E731,E501
    mean, var = _masked_stats(xg, mask, axes, counts, with_var)
    bmean = unpad(jnp.broadcast_to(mean, bshape))
    bvar = unpad(jnp.broadcast_to(var, bshape)) if with_var else None
    return bmean, bvar


def _group_stats(x, channels, group_size):
    """Per-group mean/variance. x: (..., C, H, W) → stats (..., C, 1, 1)
    broadcast per channel."""
    assert x.shape[-3] == channels
    return _group_reduce(x, group_size, True, False)


def _denom(var, eps, reference_compat):
    if reference_compat:
        return var  # the reference divides by variance with ε=0 (§7.5)
    return jnp.sqrt(var + eps)


def _stat_dtype(dtype):
    """Statistics accumulate in ≥f32 (bf16 mean/variance loses too much)."""
    return dtype if jnp.dtype(dtype).itemsize >= 4 else jnp.float32


def _gn_fwd_impl(x, group_size, eps, reference_compat):
    xs = x.astype(_stat_dtype(x.dtype))
    mean, var = _group_stats(xs, x.shape[-3], group_size)
    denom = _denom(var, eps, reference_compat)
    return ((xs - mean) / denom).astype(x.dtype), mean, var


def _group_mean(t, group_size):
    """Mean over each channel group's (gs, H, W) block, broadcast back —
    mean ONLY (the backward calls this twice per GN and must not pay a
    discarded variance sweep)."""
    return _group_reduce(t, group_size, False, False)[0]


@functools.partial(jax.custom_vjp, nondiff_argnums=(1, 2, 3))
def group_norm(x: jax.Array, group_size: int, eps: float = 1e-8,
               reference_compat: bool = False) -> jax.Array:
    """x: (..., C, H, W) → same shape. ≈ ``group_norm`` (lib/norm.c:5)."""
    return _gn_fwd_impl(x, group_size, eps, reference_compat)[0]


def _group_norm_fwd(x, group_size, eps, reference_compat):
    out, mean, var = _gn_fwd_impl(x, group_size, eps, reference_compat)
    return out, (x, mean, var)


def _group_norm_bwd(group_size, eps, reference_compat, res, g):
    x, mean, var = res
    g = g.astype(_stat_dtype(x.dtype))
    denom = _denom(var, eps, reference_compat)
    xhat = (x.astype(g.dtype) - mean) / denom
    g_mean = _group_mean(g, group_size)
    gx_mean = _group_mean(g * xhat, group_size)
    dx = (g - g_mean - xhat * gx_mean) / denom
    return (dx.astype(x.dtype),)


group_norm.defvjp(_group_norm_fwd, _group_norm_bwd)


# ---------------------------------------------------------------------------
# Channels-last (NHWC) twin (C innermost; group stats reduce over
# (H, W, gs) blocks). Same reference semantics and explicit VJP as
# group_norm.
# ---------------------------------------------------------------------------


def _group_stats_nhwc(x, channels, group_size):
    """x: (..., H, W, C) → per-channel broadcast stats (..., 1, 1, C)."""
    assert x.shape[-1] == channels
    return _group_reduce(x, group_size, True, True)


def _gn_nhwc_fwd_impl(x, group_size, eps, reference_compat):
    xs = x.astype(_stat_dtype(x.dtype))
    mean, var = _group_stats_nhwc(xs, x.shape[-1], group_size)
    denom = _denom(var, eps, reference_compat)
    return ((xs - mean) / denom).astype(x.dtype), mean, var


@functools.partial(jax.custom_vjp, nondiff_argnums=(1, 2, 3))
def group_norm_nhwc(x: jax.Array, group_size: int, eps: float = 1e-8,
                    reference_compat: bool = False) -> jax.Array:
    """x: (..., H, W, C) → same shape. ≈ ``group_norm`` (lib/norm.c:5),
    channels-last."""
    return _gn_nhwc_fwd_impl(x, group_size, eps, reference_compat)[0]


def _group_norm_nhwc_fwd(x, group_size, eps, reference_compat):
    out, mean, var = _gn_nhwc_fwd_impl(x, group_size, eps, reference_compat)
    return out, (x, mean, var)


def _group_mean_nhwc(t, group_size):
    """Mean-only twin of ``_group_mean`` for (..., H, W, C)."""
    return _group_reduce(t, group_size, False, True)[0]


def _group_norm_nhwc_bwd(group_size, eps, reference_compat, res, g):
    x, mean, var = res
    g = g.astype(_stat_dtype(x.dtype))
    denom = _denom(var, eps, reference_compat)
    xhat = (x.astype(g.dtype) - mean) / denom
    g_mean = _group_mean_nhwc(g, group_size)
    gx_mean = _group_mean_nhwc(g * xhat, group_size)
    dx = (g - g_mean - xhat * gx_mean) / denom
    return (dx.astype(x.dtype),)


group_norm_nhwc.defvjp(_group_norm_nhwc_fwd, _group_norm_nhwc_bwd)
