"""2-D convolution with the reference's "same" padding and a hand-written VJP.

Reference semantics (lib/conv.c): correlation (no kernel flip) over
channels-first maps with TF-style "SAME" padding — total pad
``(ceil(in/s)−1)·s + k − in`` split floor(lo)/ceil(hi) (lib/conv.c:13-24),
output ``ceil(in/s) × ceil(in/s)``; no bias. Forward is im2col → GEMM →
reshape (lib/conv.c:205-212); backward is ``del_K = im2colᵀ @ del_Q`` and
``del_X = col2im(del_Q @ Kᵀ)`` (lib/conv.c:214-227, with the intended
source→dest reshape semantics — the reference's channel-reshape helpers have
swapped bodies, SURVEY.md §7.1).

Design: XLA's native conv lowers to an implicit-GEMM library call (cuDNN on
the GPU) with fused padding — materializing im2col in HBM (as the reference does) would
only add bandwidth. The backward passes are still *hand-written* (explicit
``jax.custom_vjp``): the gradient convs below are the exact GEMM-equivalent
formulations of the reference's backward, expressed as dilated convolutions
with numerically-derived paddings, validated against the compiled C oracle
and autodiff in tests/test_conv.py.

Layouts: x (B, C, H, W); kernels (F, C, kh, kw) — the reference's
(out_channels, in_channels, height, width) kernel array (lib/conv.c:206).
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import jax
import jax.numpy as jnp

DIMS = ("NCHW", "OIHW", "NCHW")


# Shared matmul input-precision policy (ops/precision.py): f32 conv operands
# use HIGHEST (the GPU default would run them in TF32, breaking the 1e-5
# parity contract); bf16 takes the native fast path. Models that prefer speed cast to bf16 (cifar_unet
# ``compute_dtype``).
from big_linear_algebra.ops.precision import matmul_precision as _conv_precision  # noqa: E501


def same_padding(in_size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """The reference's pad split (lib/conv.c:13-24): total =
    (ceil(in/s)−1)·s + k − in, lo = floor(total/2), hi = ceil(total/2)."""
    total = (math.ceil(in_size / stride) - 1) * stride + kernel - in_size
    total = max(total, 0)
    return total // 2, (total + 1) // 2


def out_size(in_size: int, stride: int) -> int:
    """out = ceil(in/stride) (lib/conv.c:56-57)."""
    return math.ceil(in_size / stride)


def _acc_type(dtype):
    """Accumulate in ≥f32 (f64 inputs accumulate in f64 for oracle parity)."""
    return jnp.float64 if dtype == jnp.float64 else jnp.float32


def _dx_pads(in_size: int, k: int, stride: int,
             g_size: int) -> Tuple[int, int]:
    """Transpose-conv padding for del_X along one dim: solve for the pads
    that make the stride-dilated gradient, convolved with the flipped
    kernel, produce exactly ``in_size`` outputs."""
    lo, _ = same_padding(in_size, k, stride)
    dil = (g_size - 1) * stride + 1
    pad_lo = k - 1 - lo
    pad_hi = in_size + k - 1 - dil - pad_lo
    return pad_lo, pad_hi


def _fwd_conv(x, k, stride):
    (kh, kw) = k.shape[-2:]
    pad = (same_padding(x.shape[-2], kh, stride),
           same_padding(x.shape[-1], kw, stride))
    return jax.lax.conv_general_dilated(
        x, k, window_strides=(stride, stride), padding=pad,
        dimension_numbers=DIMS,
        preferred_element_type=_acc_type(x.dtype),
        precision=_conv_precision(x.dtype),
    ).astype(x.dtype)


def _dx_conv(g, k, stride, in_shape):
    """del_X: transpose-convolution of the upstream gradient with the
    spatially-flipped, channel-transposed kernels — the conv formulation of
    the reference's ``col2im(del_Q @ Kᵀ)`` (lib/conv.c:225-226)."""
    (kh, kw) = k.shape[-2:]
    k_t = jnp.flip(k, axis=(-2, -1)).transpose(1, 0, 2, 3)  # (C, F, kh, kw)
    return jax.lax.conv_general_dilated(
        g, k_t, window_strides=(1, 1),
        padding=(_dx_pads(in_shape[-2], kh, stride, g.shape[-2]),
                 _dx_pads(in_shape[-1], kw, stride, g.shape[-1])),
        lhs_dilation=(stride, stride),
        dimension_numbers=DIMS,
        preferred_element_type=_acc_type(g.dtype),
        precision=_conv_precision(g.dtype),
    ).astype(g.dtype)


def _dk_conv(x, g, stride, k_shape):
    """del_K: batched correlation of the (padded) input with the upstream
    gradient — the conv formulation of ``im2colᵀ @ del_Q``
    (lib/conv.c:221-223). Expressed by treating channels as the conv batch
    and the example batch as the contraction (feature) dim."""
    (kh, kw) = k_shape[-2:]
    pad = (same_padding(x.shape[-2], kh, stride),
           same_padding(x.shape[-1], kw, stride))
    # lhs: (C, B, H, W); rhs "kernels": (F, B, oh, ow); out: (C, F, kh', kw')
    out = jax.lax.conv_general_dilated(
        x.transpose(1, 0, 2, 3),
        g.transpose(1, 0, 2, 3),
        window_strides=(1, 1),
        padding=pad,
        rhs_dilation=(stride, stride),
        dimension_numbers=DIMS,
        preferred_element_type=_acc_type(x.dtype),
        precision=_conv_precision(x.dtype),
    )
    # When "same" padding clamps to 0 (kernel smaller than stride), the
    # correlation yields kh − raw_total > kh taps; pad lo is 0 there, so the
    # true gradient is exactly the leading kh×kw taps. No-op otherwise.
    out = out[..., :kh, :kw]
    return out.transpose(1, 0, 2, 3).astype(x.dtype)  # (F, C, kh, kw)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def conv2d(x: jax.Array, kernels: jax.Array, stride: int = 1) -> jax.Array:
    """Correlation with reference "same" padding.
    x: (B, C, H, W), kernels: (F, C, kh, kw) → (B, F, ⌈H/s⌉, ⌈W/s⌉).
    ≈ ``conv`` (lib/conv.c:205)."""
    return _fwd_conv(x, kernels, stride)


def _conv2d_fwd(x, kernels, stride):
    return _fwd_conv(x, kernels, stride), (x, kernels)


def _conv2d_bwd(stride, res, g):
    x, kernels = res
    g = g.astype(x.dtype)
    dx = _dx_conv(g, kernels, stride, x.shape)
    dk = _dk_conv(x, g, stride, kernels.shape)
    return dx, dk


conv2d.defvjp(_conv2d_fwd, _conv2d_bwd)


def conv2d_single(x: jax.Array, kernels: jax.Array, stride: int = 1):
    """Unbatched (C, H, W) convenience wrapper matching the reference's
    single-example signature (lib/conv.c:205)."""
    return conv2d(x[None], kernels, stride)[0]


# ---------------------------------------------------------------------------
# Channels-last (NHWC) twin (feature dim innermost). Same reference "same"-padding semantics and hand-written
# VJP; kernels keep the reference (F, C, kh, kw) array layout
# (lib/conv.c:206) and are reoriented to HWIO inside (a ≤1 MB transpose XLA
# fuses into the conv's weight load).
# ---------------------------------------------------------------------------

DIMS_NHWC = ("NHWC", "HWIO", "NHWC")


def _fwd_conv_nhwc(x, k, stride):
    (kh, kw) = k.shape[-2:]
    pad = (same_padding(x.shape[1], kh, stride),
           same_padding(x.shape[2], kw, stride))
    k_hwio = k.transpose(2, 3, 1, 0)                   # (kh, kw, C, F)
    return jax.lax.conv_general_dilated(
        x, k_hwio, window_strides=(stride, stride), padding=pad,
        dimension_numbers=DIMS_NHWC,
        preferred_element_type=_acc_type(x.dtype),
        precision=_conv_precision(x.dtype),
    ).astype(x.dtype)


def _dx_conv_nhwc(g, k, stride, in_shape):
    """del_X, NHWC: transpose-convolution with flipped, channel-transposed
    kernels (the lib/conv.c:225-226 formulation; same pad algebra as the
    NCHW `_dx_conv`)."""
    (kh, kw) = k.shape[-2:]
    # (F, C, kh, kw) → flip spatial → HWIO with I=F, O=C: (kh, kw, F, C)
    k_t = jnp.flip(k, axis=(-2, -1)).transpose(2, 3, 0, 1)
    return jax.lax.conv_general_dilated(
        g, k_t, window_strides=(1, 1),
        padding=(_dx_pads(in_shape[1], kh, stride, g.shape[1]),
                 _dx_pads(in_shape[2], kw, stride, g.shape[2])),
        lhs_dilation=(stride, stride),
        dimension_numbers=DIMS_NHWC,
        preferred_element_type=_acc_type(g.dtype),
        precision=_conv_precision(g.dtype),
    ).astype(g.dtype)


def _dk_conv_nhwc(x, g, stride, k_shape):
    """del_K, NHWC: batched correlation with channels as the conv batch and
    the example batch as the contraction dim (lib/conv.c:221-223)."""
    (kh, kw) = k_shape[-2:]
    pad = (same_padding(x.shape[1], kh, stride),
           same_padding(x.shape[2], kw, stride))
    out = jax.lax.conv_general_dilated(
        x.transpose(3, 1, 2, 0),        # lhs  (C, H, W, B)   as NHWC
        g.transpose(1, 2, 0, 3),        # rhs  (oh, ow, B, F) as HWIO
        window_strides=(1, 1),
        padding=pad,
        rhs_dilation=(stride, stride),
        dimension_numbers=DIMS_NHWC,
        preferred_element_type=_acc_type(x.dtype),
        precision=_conv_precision(x.dtype),
    )                                    # (C, kh', kw', F)
    # clamped-"same" case (kernel < stride): true gradient = leading kh×kw
    # taps (pad lo is 0 there); no-op otherwise — see _dk_conv
    out = out[:, :kh, :kw, :]
    return out.transpose(3, 0, 1, 2).astype(x.dtype)  # (F, C, kh, kw)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def conv2d_nhwc(x: jax.Array, kernels: jax.Array, stride: int = 1):
    """Correlation with reference "same" padding, channels-last.
    x: (B, H, W, C), kernels: (F, C, kh, kw) → (B, ⌈H/s⌉, ⌈W/s⌉, F)."""
    return _fwd_conv_nhwc(x, kernels, stride)


def _conv2d_nhwc_fwd(x, kernels, stride):
    return _fwd_conv_nhwc(x, kernels, stride), (x, kernels)


def _conv2d_nhwc_bwd(stride, res, g):
    x, kernels = res
    g = g.astype(x.dtype)
    dx = _dx_conv_nhwc(g, kernels, stride, x.shape)
    dk = _dk_conv_nhwc(x, g, stride, kernels.shape)
    return dx, dk


conv2d_nhwc.defvjp(_conv2d_nhwc_fwd, _conv2d_nhwc_bwd)
