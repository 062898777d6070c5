"""conv2d parity vs the C reference core (im2col/GEMM/col2im) + autodiff."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from big_linear_algebra.nn.conv import (
    conv2d,
    conv2d_single,
    out_size,
    same_padding,
)
from tests import oracle

needs_ref = pytest.mark.skipif(
    not oracle.reference_available(), reason="no reference"
)

CASES = [
    # (C, H, W, F, k, stride)
    (3, 8, 8, 4, 3, 1),
    (2, 9, 7, 5, 3, 2),
    (4, 8, 8, 8, 1, 1),   # 1x1 conv (the U-Net residual path)
    (3, 10, 10, 6, 4, 2), # even kernel → asymmetric pad
    (1, 5, 5, 2, 5, 3),
]


def test_same_padding_formula():
    # out = ceil(in/s); pad split floor/ceil (lib/conv.c:13-24,56-57)
    assert same_padding(8, 3, 1) == (1, 1)
    assert same_padding(9, 3, 2) == (1, 1)
    assert same_padding(10, 4, 2) == (1, 1)
    assert same_padding(5, 5, 3) == (1, 2)
    assert same_padding(4, 1, 1) == (0, 0)
    assert out_size(9, 2) == 5


@needs_ref
@pytest.mark.parametrize("case", CASES)
def test_forward_matches_c_reference(rng, case):
    c, h, w, f, k, stride = case
    x = rng.standard_normal((c, h, w))
    kernels = rng.standard_normal((f, c, k, k))
    ours = np.asarray(conv2d_single(jnp.asarray(x), jnp.asarray(kernels),
                                    stride))
    theirs = oracle.c_conv_forward(x, kernels, stride)
    assert ours.shape == theirs.shape == (f, out_size(h, stride),
                                          out_size(w, stride))
    np.testing.assert_allclose(ours, theirs, rtol=1e-9, atol=1e-9)


@needs_ref
@pytest.mark.parametrize("case", CASES)
def test_backward_matches_c_reference(rng, case):
    c, h, w, f, k, stride = case
    x = rng.standard_normal((c, h, w))
    kernels = rng.standard_normal((f, c, k, k))
    g = rng.standard_normal((f, out_size(h, stride), out_size(w, stride)))

    _, vjp = jax.vjp(
        lambda x_, k_: conv2d_single(x_, k_, stride),
        jnp.asarray(x), jnp.asarray(kernels),
    )
    dx, dk = vjp(jnp.asarray(g))
    want_dk, want_dx = oracle.c_conv_backward(x, kernels, g, stride)
    np.testing.assert_allclose(np.asarray(dk), want_dk, rtol=1e-9, atol=1e-9)
    if want_dx is not None:  # stride > 1: reference _col2im is broken
        np.testing.assert_allclose(np.asarray(dx), want_dx, rtol=1e-9,
                                   atol=1e-9)


def _np_conv_same(x, kernels, stride):
    """float64 numpy "same" correlation, (C, H, W) × (F, C, k, k), written
    from the definition (lib/conv.c semantics): pad floor/ceil, slide,
    contract over (C, k, k)."""
    c, h, w = x.shape
    f, _, k, _ = kernels.shape
    (pt, pb), (pl, pr) = same_padding(h, k, stride), same_padding(w, k, stride)
    xp = np.pad(x, ((0, 0), (pt, pb), (pl, pr)))
    oh, ow = out_size(h, stride), out_size(w, stride)
    out = np.zeros((f, oh, ow))
    for i in range(oh):
        for j in range(ow):
            patch = xp[:, i * stride:i * stride + k, j * stride:j * stride + k]
            out[:, i, j] = np.tensordot(kernels, patch, axes=3)
    return out, xp, (pt, pl)


def _np_conv_same_vjp(x, kernels, g, stride):
    """The true gradients of ``_np_conv_same`` (the reference's intended
    backward, SURVEY.md §7.1): dK accumulates g·patch, dX scatters Kᵀg
    back into the padded input and crops."""
    _, xp, (pt, pl) = _np_conv_same(x, kernels, stride)
    c, h, w = x.shape
    k = kernels.shape[-1]
    dk = np.zeros_like(kernels)
    dxp = np.zeros_like(xp)
    for i in range(g.shape[1]):
        for j in range(g.shape[2]):
            rows = slice(i * stride, i * stride + k)
            cols = slice(j * stride, j * stride + k)
            dk += np.einsum("f,cab->fcab", g[:, i, j], xp[:, rows, cols])
            dxp[:, rows, cols] += np.einsum("f,fcab->cab", g[:, i, j],
                                            kernels)
    return dxp[:, pt:pt + h, pl:pl + w], dk


@pytest.mark.parametrize("case", CASES)
def test_forward_matches_float64_definition(rng, case):
    """In-repo float64 reference of the conv (runs without the C tree)."""
    c, h, w, f, k, stride = case
    x = rng.standard_normal((c, h, w))
    kernels = rng.standard_normal((f, c, k, k))
    ours = np.asarray(conv2d_single(jnp.asarray(x), jnp.asarray(kernels),
                                    stride))
    want, _, _ = _np_conv_same(x, kernels, stride)
    np.testing.assert_allclose(ours, want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("case", CASES)
def test_backward_matches_float64_definition(rng, case):
    """The hand-written conv VJP against the float64 definition of both
    gradients, every stride (the C tree's dX is broken for stride > 1)."""
    c, h, w, f, k, stride = case
    x = rng.standard_normal((c, h, w))
    kernels = rng.standard_normal((f, c, k, k))
    g = rng.standard_normal((f, out_size(h, stride), out_size(w, stride)))
    _, vjp = jax.vjp(lambda x_, k_: conv2d_single(x_, k_, stride),
                     jnp.asarray(x), jnp.asarray(kernels))
    dx, dk = vjp(jnp.asarray(g))
    want_dx, want_dk = _np_conv_same_vjp(x, kernels, g, stride)
    np.testing.assert_allclose(np.asarray(dx), want_dx, rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(dk), want_dk, rtol=1e-10,
                               atol=1e-10)


@pytest.mark.parametrize("case", CASES[:3])
def test_vjp_matches_autodiff(rng, case):
    """Hand-written VJP vs autodiff through the plain XLA conv."""
    c, h, w, f, k, stride = case
    x = jnp.asarray(rng.standard_normal((2, c, h, w)))
    kernels = jnp.asarray(rng.standard_normal((f, c, k, k)))
    g = jnp.asarray(rng.standard_normal(
        (2, f, out_size(h, stride), out_size(w, stride))))

    def plain(x, k):
        pad = (same_padding(h, kernels.shape[-2], stride),
               same_padding(w, kernels.shape[-1], stride))
        return jax.lax.conv_general_dilated(
            x, k, (stride, stride), pad,
            dimension_numbers=("NCHW", "OIHW", "NCHW"))

    _, vjp = jax.vjp(lambda a, b: conv2d(a, b, stride), x, kernels)
    _, ref_vjp = jax.vjp(plain, x, kernels)
    for got, want in zip(vjp(g), ref_vjp(g)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-8, atol=1e-9)


@pytest.mark.parametrize("case", [
    # kernel smaller than stride: "same" padding clamps to 0 and the dk
    # correlation yields extra taps — regression for the silent
    # wrong-shaped kernel gradient (sliced to the true leading kh×kw)
    (1, 1, 2, 6, 6),
    (2, 2, 3, 7, 5),
    (1, 3, 2, 6, 8),   # clamped on one dim only
])
def test_vjp_clamped_same_padding(rng, case):
    from big_linear_algebra.nn.conv import conv2d_nhwc

    kh, kw, stride, h, w = case
    x = jnp.asarray(rng.standard_normal((2, 3, h, w)))
    kernels = jnp.asarray(rng.standard_normal((4, 3, kh, kw)))
    g = jnp.asarray(rng.standard_normal(
        (2, 4, out_size(h, stride), out_size(w, stride))))

    def plain(x, k):
        pad = (same_padding(h, kh, stride), same_padding(w, kw, stride))
        return jax.lax.conv_general_dilated(
            x, k, (stride, stride), pad,
            dimension_numbers=("NCHW", "OIHW", "NCHW"))

    _, vjp = jax.vjp(lambda a, b: conv2d(a, b, stride), x, kernels)
    _, ref_vjp = jax.vjp(plain, x, kernels)
    (dx, dk), (dx_ref, dk_ref) = vjp(g), ref_vjp(g)
    assert dk.shape == kernels.shape
    np.testing.assert_allclose(np.asarray(dx), np.asarray(dx_ref),
                               rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(np.asarray(dk), np.asarray(dk_ref),
                               rtol=1e-8, atol=1e-9)

    _, vjp_h = jax.vjp(lambda a, b: conv2d_nhwc(a, b, stride),
                       x.transpose(0, 2, 3, 1), kernels)
    dxh, dkh = vjp_h(g.transpose(0, 2, 3, 1))
    assert dkh.shape == kernels.shape
    np.testing.assert_allclose(np.asarray(dkh), np.asarray(dk_ref),
                               rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(np.asarray(dxh.transpose(0, 3, 1, 2)),
                               np.asarray(dx_ref), rtol=1e-8, atol=1e-9)


def test_batched_matches_single(rng):
    x = rng.standard_normal((3, 2, 6, 6))
    kernels = rng.standard_normal((4, 2, 3, 3))
    batched = np.asarray(conv2d(jnp.asarray(x), jnp.asarray(kernels), 1))
    for b in range(3):
        single = np.asarray(
            conv2d_single(jnp.asarray(x[b]), jnp.asarray(kernels), 1))
        np.testing.assert_allclose(batched[b], single, rtol=1e-9)
