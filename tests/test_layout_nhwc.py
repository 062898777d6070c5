"""Channels-last (NHWC) twins vs the canonical NCHW ops.

The NHWC variants (conv2d_nhwc, group_norm_nhwc, self_attention_block_nhwc,
cifar_unet layout="NHWC") exist purely for layout performance — they must
be bit-for-math identical to the NCHW path on transposed inputs. These tests
pin that equivalence in f64 (ops) and f32 (full U-Net), both values and
hand-written VJPs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from big_linear_algebra.models import cifar_unet as cu
from big_linear_algebra.nn import (
    conv2d,
    conv2d_nhwc,
    group_norm,
    group_norm_nhwc,
    self_attention_block,
    self_attention_block_nhwc,
)


def to_nhwc(x):
    return jnp.transpose(x, (0, 2, 3, 1))


def to_nchw(x):
    return jnp.transpose(x, (0, 3, 1, 2))


@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("shape", [(2, 5, 9, 7, 4, 3, 3),
                                   (1, 3, 8, 8, 6, 1, 1),
                                   (2, 4, 10, 6, 5, 3, 5)])
def test_conv2d_nhwc_matches_nchw(rng, stride, shape):
    b, c, h, w, f, kh, kw = shape
    x = jnp.asarray(rng.standard_normal((b, c, h, w)))
    k = jnp.asarray(rng.standard_normal((f, c, kh, kw)))

    out_ref = conv2d(x, k, stride)
    out = conv2d_nhwc(to_nhwc(x), k, stride)
    np.testing.assert_allclose(np.asarray(to_nchw(out)), np.asarray(out_ref),
                               rtol=1e-12, atol=1e-12)

    g = jnp.asarray(rng.standard_normal(out_ref.shape))
    _, vjp_ref = jax.vjp(lambda a, kk: conv2d(a, kk, stride), x, k)
    dx_ref, dk_ref = vjp_ref(g)
    _, vjp = jax.vjp(lambda a, kk: conv2d_nhwc(a, kk, stride), to_nhwc(x), k)
    dx, dk = vjp(to_nhwc(g))
    np.testing.assert_allclose(np.asarray(to_nchw(dx)), np.asarray(dx_ref),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(dk), np.asarray(dk_ref),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("reference_compat", [False, True])
@pytest.mark.parametrize("channels,group_size", [(8, 4), (5, 2), (6, 8)])
def test_group_norm_nhwc_matches_nchw(rng, reference_compat, channels,
                                      group_size):
    x = jnp.asarray(rng.standard_normal((2, channels, 5, 7)))

    out_ref = group_norm(x, group_size, reference_compat=reference_compat)
    out = group_norm_nhwc(to_nhwc(x), group_size,
                          reference_compat=reference_compat)
    np.testing.assert_allclose(np.asarray(to_nchw(out)), np.asarray(out_ref),
                               rtol=1e-12, atol=1e-12)

    g = jnp.asarray(rng.standard_normal(x.shape))
    _, vjp_ref = jax.vjp(
        lambda a: group_norm(a, group_size,
                             reference_compat=reference_compat), x)
    (dx_ref,) = vjp_ref(g)
    _, vjp = jax.vjp(
        lambda a: group_norm_nhwc(a, group_size,
                                  reference_compat=reference_compat),
        to_nhwc(x))
    (dx,) = vjp(to_nhwc(g))
    np.testing.assert_allclose(np.asarray(to_nchw(dx)), np.asarray(dx_ref),
                               rtol=1e-12, atol=1e-12)


def test_self_attention_block_nhwc_matches_nchw(rng):
    b, c, h, w, kd = 2, 12, 4, 4, 4
    x = jnp.asarray(rng.standard_normal((b, c, h, w)))
    params = {
        "q": jnp.asarray(rng.standard_normal((c, kd))),
        "k": jnp.asarray(rng.standard_normal((c, kd))),
        "v": jnp.asarray(rng.standard_normal((c, kd))),
        "w": jnp.asarray(rng.standard_normal((kd, c))),
        "b": jnp.asarray(rng.standard_normal((c,))),
    }
    out_ref = self_attention_block(x, params)
    out = self_attention_block_nhwc(to_nhwc(x), params)
    np.testing.assert_allclose(np.asarray(to_nchw(out)), np.asarray(out_ref),
                               rtol=1e-10, atol=1e-10)

    g = jnp.asarray(rng.standard_normal(out_ref.shape))
    _, vjp_ref = jax.vjp(self_attention_block, x, params)
    dx_ref, dp_ref = vjp_ref(g)
    _, vjp = jax.vjp(self_attention_block_nhwc, to_nhwc(x), params)
    dx, dp = vjp(to_nhwc(g))
    np.testing.assert_allclose(np.asarray(to_nchw(dx)), np.asarray(dx_ref),
                               rtol=1e-10, atol=1e-10)
    for name in params:
        np.testing.assert_allclose(np.asarray(dp[name]),
                                   np.asarray(dp_ref[name]),
                                   rtol=1e-10, atol=1e-10)


def test_unet_forward_layout_parity(rng):
    """Full TINY U-Net: layout="NHWC" must match "NCHW" on the same params
    and NCHW external input (the transpose is internal)."""
    cfg_nchw = cu.TINY
    cfg_nhwc = dataclasses.replace(cu.TINY, layout="NHWC")
    params = cu.init_params(jax.random.key(0), cfg_nchw)
    x = jnp.asarray(rng.standard_normal((2, 3, 32, 32)), jnp.float32)
    t = jnp.asarray([1, cfg_nchw.timesteps - 1])
    out_ref = np.asarray(cu.forward(params, x, t, cfg_nchw))
    out = np.asarray(cu.forward(params, x, t, cfg_nhwc))
    assert out.shape == out_ref.shape == (2, 3, 32, 32)
    np.testing.assert_allclose(out, out_ref, rtol=2e-4,
                               atol=2e-4 * np.abs(out_ref).max())


def test_unet_grad_layout_parity(rng):
    """Parameter gradients through the full loss agree across layouts.

    Run in float64: in f32 the two layouts' different reduction orders
    amplify through the 18-block GN/attention chain to ~1e-2 relative — the
    f64 run pins mathematical equivalence at 1e-6 instead (measured worst
    leaf: 7e-9). dropout_rate=0 because the dropout mask is drawn in the
    activation's own layout — with dropout on, the two layouts see
    different (equally valid) masks."""
    cfg_nchw = dataclasses.replace(cu.TINY, dropout_rate=0.0,
                                   compute_dtype="float64")
    cfg_nhwc = dataclasses.replace(cfg_nchw, layout="NHWC")
    params = cu.init_params(jax.random.key(0), cfg_nchw)
    params = jax.tree.map(lambda a: a.astype(jnp.float64), params)
    x0 = jnp.asarray(rng.standard_normal((2, 3, 32, 32)) * 0.5, jnp.float64)
    key = jax.random.key(3)
    g_ref = jax.grad(cu.loss_fn)(params, x0, key, cfg_nchw)
    g = jax.grad(cu.loss_fn)(params, x0, key, cfg_nhwc)
    flat_ref = jax.tree_util.tree_leaves_with_path(g_ref)
    flat = dict(jax.tree_util.tree_leaves_with_path(g))
    for path, leaf_ref in flat_ref:
        a_ref = np.asarray(leaf_ref)
        a = np.asarray(flat[path])
        scale = max(np.abs(a_ref).max(), 1e-12)
        np.testing.assert_allclose(
            a / scale, a_ref / scale, rtol=0, atol=1e-6,
            err_msg=f"grad mismatch at {jax.tree_util.keystr(path)}")


def test_cfg_flags_batch_and_layout():
    cfg = cu._cfg_from_flags({"tiny": True, "batch": "8", "layout": "nhwc"})
    assert cfg.batch_size == 8 and cfg.layout == "NHWC"
    assert cu._cfg_from_flags({"tiny": True}).layout == "NCHW"
    with pytest.raises(ValueError):
        cu._cfg_from_flags({"layout": "NCWH"})
    # bare / empty / non-positive values are hard errors, not silent defaults
    with pytest.raises(ValueError):
        cu._cfg_from_flags({"batch": ""})
    with pytest.raises(ValueError):
        cu._cfg_from_flags({"batch": "0"})
    with pytest.raises(ValueError):
        cu._cfg_from_flags({"layout": ""})


def test_unet_remat_grad_parity(rng):
    """jax.checkpoint on the resnet blocks is semantics-preserving: loss and
    parameter gradients match the non-remat graph (same ops recomputed in
    the same order — f64 pins it tightly)."""
    cfg = dataclasses.replace(cu.TINY, compute_dtype="float64")
    cfg_r = dataclasses.replace(cfg, remat=True)
    params = jax.tree.map(lambda a: a.astype(jnp.float64),
                          cu.init_params(jax.random.key(0), cu.TINY))
    x0 = jnp.asarray(rng.standard_normal((2, 3, 32, 32)) * 0.5)
    key = jax.random.key(3)
    l_ref, g_ref = jax.value_and_grad(cu.loss_fn)(params, x0, key, cfg)
    l_r, g_r = jax.value_and_grad(cu.loss_fn)(params, x0, key, cfg_r)
    assert abs(float(l_ref) - float(l_r)) < 1e-12
    flat_ref = jax.tree_util.tree_leaves_with_path(g_ref)
    flat_r = dict(jax.tree_util.tree_leaves_with_path(g_r))
    for path, leaf in flat_ref:
        a, b = np.asarray(leaf), np.asarray(flat_r[path])
        scale = max(np.abs(a).max(), 1e-12)
        np.testing.assert_allclose(
            b / scale, a / scale, rtol=0, atol=1e-9,
            err_msg=f"remat grad mismatch at {jax.tree_util.keystr(path)}")


def test_cfg_flag_remat():
    # parse_flags represents a bare --remat as "" — a value is a hard error
    # (silently enabling remat on --remat=false would invert the intent)
    assert cu._cfg_from_flags({"tiny": "", "remat": ""}).remat
    assert not cu._cfg_from_flags({"tiny": ""}).remat
    with pytest.raises(ValueError, match="--remat takes no value"):
        cu._cfg_from_flags({"tiny": "", "remat": "false"})


def test_unet_train_step_nhwc_learns(rng):
    cfg = dataclasses.replace(cu.TINY, layout="NHWC")
    params = cu.init_params(jax.random.key(0), cfg)
    opt = cu.adam_init(params)
    x0 = jnp.asarray(rng.standard_normal((2, 3, 32, 32)) * 0.5, jnp.float32)
    key = jax.random.key(2)
    losses = []
    for _ in range(30):
        key, k = jax.random.split(key)
        params, opt, loss = cu.train_step(params, opt, x0, k, cfg)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-10:]) < np.mean(losses[:10]), losses
