"""Matmul tests: C-oracle parity (float64), transposed variants against
float64 numpy in f32 and bf16, and hand-written VJPs vs autodiff."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from big_linear_algebra.ops import matmul, matmul_nt, matmul_tn
from tests import oracle

SHAPES = [(3, 4, 5), (64, 32, 10), (1, 7, 1), (100, 100, 100)]


@pytest.mark.skipif(not oracle.reference_available(), reason="no reference")
@pytest.mark.parametrize("mnk", SHAPES)
def test_matmul_matches_c_reference(rng, mnk):
    m, k, n = mnk
    a = rng.standard_normal((m, k))
    b = rng.standard_normal((k, n))
    np.testing.assert_allclose(
        np.asarray(matmul(a, b)), oracle.c_matmul(a, b), rtol=1e-10, atol=1e-10
    )


@pytest.mark.parametrize("mnk", SHAPES)
def test_variants_match_numpy(rng, mnk):
    m, k, n = mnk
    a = rng.standard_normal((m, k))
    b = rng.standard_normal((k, n))
    np.testing.assert_allclose(np.asarray(matmul(a, b)), a @ b, rtol=1e-10)
    np.testing.assert_allclose(
        np.asarray(matmul_nt(a, b.T.copy())), a @ b, rtol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(matmul_tn(a.T.copy(), b)), a @ b, rtol=1e-10
    )


def _variant_operands(a, b, variant):
    """Lay out (a: m×k, b: k×n) as the operands of ``variant``."""
    if variant == "nn":
        return a, b
    if variant == "nt":
        return a, b.T.copy()
    return a.T.copy(), b


@pytest.mark.parametrize("variant", ["nn", "nt", "tn"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_variants_bias_relu_grads_vs_float64(rng, variant, dtype):
    """matmul/matmul_nt/matmul_tn on unaligned shapes, followed by bias and
    ReLU: forward and the gradients of a, b and the bias against float64
    numpy. f32 runs at HIGHEST (1e-4); bf16 keeps 8 mantissa bits, so its
    operands are rounded first and the tolerance is 2e-2 of the scale."""
    fn = {"nn": matmul, "nt": matmul_nt, "tn": matmul_tn}[variant]
    dt = jnp.dtype(dtype)
    m, k, n = 130, 257, 200
    a64, b64 = rng.standard_normal((m, k)), rng.standard_normal((k, n))
    bias64, g64 = rng.standard_normal(n), rng.standard_normal((m, n))
    # the float64 reference sees exactly the values the kernel sees
    a64, b64, bias64 = (np.asarray(jnp.asarray(x, dt), np.float64)
                        for x in (a64, b64, bias64))
    pa, pb = _variant_operands(a64, b64, variant)

    def loss(pa, pb, bias):
        pre = fn(pa, pb).astype(jnp.float32) + bias.astype(jnp.float32)
        return jnp.sum(jnp.maximum(pre, 0.0) * g64.astype(np.float32)), pre

    (_, pre), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(
        jnp.asarray(pa, dt), jnp.asarray(pb, dt), jnp.asarray(bias64, dt))

    z = a64 @ b64 + bias64
    # the ReLU mask is a discrete decision: take it from the kernel's own
    # pre-activation, so a bf16-rounded z near 0 cannot flip an element
    # (an exact tie, common in bf16, takes jnp.maximum's half gradient)
    pre = np.asarray(pre, np.float64)
    dz = g64 * ((pre > 0) + 0.5 * (pre == 0))
    want = {"out": np.maximum(z, 0.0), "bias": dz.sum(0)}
    da, db = dz @ b64.T, a64.T @ dz
    want["pa"], want["pb"] = _variant_operands(da, db, variant)
    if variant == "tn":
        want["pa"] = da.T
    if variant == "nt":
        want["pb"] = db.T
    got = {"out": np.maximum(pre, 0.0), "pa": grads[0], "pb": grads[1], "bias": grads[2]}
    rtol = 1e-4 if dtype == "float32" else 2e-2
    for name, w in want.items():
        g = np.asarray(jnp.asarray(got[name], jnp.float32), np.float64)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=rtol * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("fn,shapes", [
    (matmul, ((17, 23), (23, 9))),
    (matmul_nt, ((17, 23), (9, 23))),
    (matmul_tn, ((23, 17), (23, 9))),
])
def test_hand_vjp_matches_autodiff(rng, fn, shapes):
    a = jnp.asarray(rng.standard_normal(shapes[0]))
    b = jnp.asarray(rng.standard_normal(shapes[1]))
    g = jnp.asarray(rng.standard_normal(jax.eval_shape(fn, a, b).shape))

    def ref_fn(a, b):
        if fn is matmul:
            return a @ b
        if fn is matmul_nt:
            return a @ b.T
        return a.T @ b

    _, vjp = jax.vjp(fn, a, b)
    _, ref_vjp = jax.vjp(ref_fn, a, b)
    for got, want in zip(vjp(g), ref_vjp(g)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-10)


def test_shape_mismatch_raises(rng):
    with pytest.raises(ValueError):
        matmul(jnp.zeros((3, 4)), jnp.zeros((5, 6)))


def test_fused_bias_relu_epilogue(rng):
    """The bias+ReLU epilogue must match the composed ops, including on
    non-power-of-two shapes, f32 and bf16."""
    import jax.numpy as jnp

    from big_linear_algebra.ops.matmul import _dispatch

    for m, k, n, dtype in [(200, 300, 170, jnp.float32),
                           (256, 512, 384, jnp.bfloat16)]:
        x = jnp.asarray(rng.standard_normal((m, k)), dtype)
        w = jnp.asarray(rng.standard_normal((k, n)), dtype)
        b = jnp.asarray(rng.standard_normal((n,)), dtype)
        fused = _dispatch(x, w, "nn", jnp.float32,
                          bias=b, activation="relu")
        want = jnp.maximum(
            _dispatch(x, w, "nn", jnp.float32)
            + b[None, :].astype(jnp.float32), 0.0)
        np.testing.assert_allclose(np.asarray(fused), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


def test_dense_fused_relu_gradients(rng):
    """dense(..., 'relu') hand VJP == autodiff of relu(x@w+b)."""
    import jax
    import jax.numpy as jnp

    from big_linear_algebra.nn.dense import dense

    x = jnp.asarray(rng.standard_normal((64, 96)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((96, 80)), jnp.float32)
    b = jnp.asarray(rng.standard_normal((80,)), jnp.float32)
    g = jnp.asarray(rng.standard_normal((64, 80)), jnp.float32)

    out, vjp = jax.vjp(lambda x, w, b: dense(x, w, b, "relu"), x, w, b)
    ref_out, ref_vjp = jax.vjp(
        lambda x, w, b: jnp.maximum(x @ w + b[None, :], 0.0), x, w, b)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref_out),
                               rtol=1e-5, atol=1e-6)
    for got, want in zip(vjp(g), ref_vjp(g)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
