"""nn layer/loss tests: hand-written VJPs vs autodiff + finite differences."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from big_linear_algebra.nn import (
    dense,
    hinge_loss,
    mse_loss,
    softmax_cross_entropy,
)


def test_dense_forward(rng):
    x = jnp.asarray(rng.standard_normal((5, 7)))
    w = jnp.asarray(rng.standard_normal((7, 3)))
    b = jnp.asarray(rng.standard_normal((3,)))
    np.testing.assert_allclose(
        np.asarray(dense(x, w, b)), np.asarray(x) @ np.asarray(w) + np.asarray(b),
        rtol=1e-12,
    )


def test_dense_vjp_matches_autodiff(rng):
    x = jnp.asarray(rng.standard_normal((5, 7)))
    w = jnp.asarray(rng.standard_normal((7, 3)))
    b = jnp.asarray(rng.standard_normal((3,)))
    g = jnp.asarray(rng.standard_normal((5, 3)))
    _, vjp = jax.vjp(dense, x, w, b)
    _, ref_vjp = jax.vjp(lambda x, w, b: x @ w + b[None, :], x, w, b)
    for got, want in zip(vjp(g), ref_vjp(g)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-10)


def test_softmax_cross_entropy_value_and_grad(rng):
    logits = jnp.asarray(rng.standard_normal((6, 10)))
    y = np.zeros((6, 10))
    y[np.arange(6), rng.integers(0, 10, 6)] = 1
    y = jnp.asarray(y)

    # value: -sum y log(softmax + eps)
    p = jax.nn.softmax(logits, axis=-1)
    want = float(-jnp.sum(y * jnp.log(p + 1e-15)))
    got = float(softmax_cross_entropy(logits, y))
    np.testing.assert_allclose(got, want, rtol=1e-12)

    # gradient: the fused seed p - y (model/mnist_nn.c:263-268)
    grad = jax.grad(lambda z: softmax_cross_entropy(z, y))(logits)
    np.testing.assert_allclose(np.asarray(grad), np.asarray(p - y), rtol=1e-9,
                               atol=1e-12)


def test_softmax_cross_entropy_mask(rng):
    logits = jnp.asarray(rng.standard_normal((4, 3)))
    y = jnp.asarray(np.eye(3)[[0, 1, 2, 0]])
    mask = jnp.asarray([1.0, 1.0, 0.0, 0.0])
    # masked value == value over the first two rows only
    want = float(softmax_cross_entropy(logits[:2], y[:2]))
    got = float(softmax_cross_entropy(logits, y, mask))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    grad = jax.grad(lambda z: softmax_cross_entropy(z, y, mask))(logits)
    assert np.all(np.asarray(grad)[2:] == 0)


def test_mse_loss_grad_is_reference_seed(rng):
    pred = jnp.asarray(rng.standard_normal((3, 4)))
    target = jnp.asarray(rng.standard_normal((3, 4)))
    val = float(mse_loss(pred, target))
    np.testing.assert_allclose(val, float(jnp.sum((pred - target) ** 2)),
                               rtol=1e-12)
    # seed 2(pred - target): model/cifar_unet.c:1353-1364
    g = jax.grad(mse_loss)(pred, target)
    np.testing.assert_allclose(np.asarray(g), 2 * np.asarray(pred - target),
                               rtol=1e-12)


def test_hinge_loss_value_and_subgradient(rng):
    w = jnp.asarray(rng.standard_normal((7,)))
    x = jnp.asarray(rng.standard_normal((9, 7)))
    y = jnp.asarray(np.sign(rng.standard_normal(9)))
    margins = np.asarray(y) * (np.asarray(x) @ np.asarray(w))
    want = np.maximum(0, 1 - margins).sum()
    np.testing.assert_allclose(float(hinge_loss(w, x, y)), want, rtol=1e-10)

    dw = jax.grad(hinge_loss)(w, x, y)
    viol = (margins < 1).astype(np.float64)
    want_dw = -(viol * np.asarray(y)) @ np.asarray(x)
    np.testing.assert_allclose(np.asarray(dw), want_dw, rtol=1e-10)


@pytest.mark.parametrize("loss", ["sce", "mse"])
def test_loss_finite_difference(rng, loss):
    if loss == "sce":
        y = jnp.asarray(np.eye(5)[[1, 3]])
        fn = lambda z: softmax_cross_entropy(z, y)
        z0 = jnp.asarray(rng.standard_normal((2, 5)))
    else:
        t = jnp.asarray(rng.standard_normal((2, 5)))
        fn = lambda z: mse_loss(z, t)
        z0 = jnp.asarray(rng.standard_normal((2, 5)))
    g = jax.grad(fn)(z0)
    eps = 1e-6
    for idx in [(0, 0), (1, 4)]:
        e = jnp.zeros_like(z0).at[idx].set(eps)
        fd = (fn(z0 + e) - fn(z0 - e)) / (2 * eps)
        np.testing.assert_allclose(float(g[idx]), float(fd), rtol=1e-5,
                                   atol=1e-9)


def test_mse_and_hinge_loss_mask(rng):
    """Ragged-batch masks: masked examples contribute nothing to value or
    gradient (the module contract all losses share)."""
    from big_linear_algebra.nn.losses import hinge_loss, mse_loss

    pred = jnp.asarray(rng.standard_normal((4, 3, 2, 2)))
    target = jnp.asarray(rng.standard_normal((4, 3, 2, 2)))
    mask = jnp.asarray([1.0, 1.0, 0.0, 1.0])
    want = float(mse_loss(pred[jnp.array([0, 1, 3])], target[jnp.array([0, 1, 3])]))
    np.testing.assert_allclose(float(mse_loss(pred, target, mask)), want,
                               rtol=1e-12)
    g = jax.grad(lambda p: mse_loss(p, target, mask))(pred)
    assert np.all(np.asarray(g)[2] == 0)
    assert np.abs(np.asarray(g)[[0, 1, 3]]).max() > 0

    w = jnp.asarray(rng.standard_normal((5,)))
    x = jnp.asarray(rng.standard_normal((4, 5)))
    y = jnp.asarray(np.sign(rng.standard_normal(4)))
    want_h = float(hinge_loss(w, x[jnp.array([0, 1, 3])], y[jnp.array([0, 1, 3])]))
    np.testing.assert_allclose(float(hinge_loss(w, x, y, mask)), want_h,
                               rtol=1e-12)
    gw = jax.grad(lambda ww: hinge_loss(ww, x, y, mask))(w)
    gw_want = jax.grad(lambda ww: hinge_loss(ww, x[jnp.array([0, 1, 3])],
                                             y[jnp.array([0, 1, 3])]))(w)
    np.testing.assert_allclose(np.asarray(gw), np.asarray(gw_want),
                               rtol=1e-12)


def test_mse_fractional_mask_primal_vjp_agree(rng):
    """The primal and the custom-vjp forward must agree for fractional
    masks: sum(m*d^2) with seed 2*m*d (premasking d computed sum(m^2*d^2)
    only under differentiation — the same call silently changed value)."""
    from big_linear_algebra.nn.losses import mse_loss

    pred = jnp.asarray(rng.standard_normal((3, 4)))
    target = jnp.asarray(rng.standard_normal((3, 4)))
    mask = jnp.asarray([0.5, 1.0, 0.25])
    primal = mse_loss(pred, target, mask)
    val, grad = jax.value_and_grad(mse_loss)(pred, target, mask)
    np.testing.assert_allclose(np.asarray(val), np.asarray(primal),
                               rtol=1e-6)
    m = mask[:, None]
    np.testing.assert_allclose(np.asarray(grad),
                               np.asarray(2.0 * m * (pred - target)),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# Adam with bf16-resident params (f32 masters confined to the optimizer)
# ---------------------------------------------------------------------------


def test_adam_moments_promote_to_f32_for_bf16_params():
    """bf16 params get f32 moments (the 'master precision' of the
    optimizer); f32/f64 params keep their own dtype — the classic paths
    are bit-identical to the pre-mixed-precision optimizer."""
    from big_linear_algebra.nn.optim import adam_init

    params = {"a": jnp.ones((3,), jnp.bfloat16),
              "b": jnp.ones((3,), jnp.float32),
              "c": jnp.ones((3,), jnp.float64)}
    st = adam_init(params)
    assert st.m["a"].dtype == jnp.float32
    assert st.v["a"].dtype == jnp.float32
    assert st.m["b"].dtype == jnp.float32
    assert st.m["c"].dtype == jnp.float64


def test_adam_bf16_update_is_f32_math_rounded(rng):
    """One bf16-param Adam step == the same step on f32 copies of the
    params/grads, rounded to bf16 at the very end (update arithmetic never
    happens in bf16), and the returned moments stay exactly the f32 ones."""
    from big_linear_algebra.nn.optim import adam_init, adam_update

    p32 = jnp.asarray(rng.standard_normal((64,)) * 0.05, jnp.float32)
    g32 = jnp.asarray(rng.standard_normal((64,)) * 0.1, jnp.float32)
    # start from values exactly representable in bf16 so the only rounding
    # under test is the one on the updated value
    p32 = p32.astype(jnp.bfloat16).astype(jnp.float32)
    g32 = g32.astype(jnp.bfloat16).astype(jnp.float32)

    pb, gb = p32.astype(jnp.bfloat16), g32.astype(jnp.bfloat16)
    new_b, st_b = adam_update(pb, gb, adam_init(pb), 1e-3)
    new_f, st_f = adam_update(p32, g32, adam_init(p32), 1e-3)

    assert new_b.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(new_b), np.asarray(new_f.astype(jnp.bfloat16)))
    np.testing.assert_array_equal(np.asarray(st_b.m), np.asarray(st_f.m))
    np.testing.assert_array_equal(np.asarray(st_b.v), np.asarray(st_f.v))


def test_adam_f32_path_matches_textbook(rng):
    """The f32 path is the plain Kingma-Ba update (regression guard for the
    mixed-precision refactor: promote/cast must be identities here)."""
    from big_linear_algebra.nn.optim import adam_init, adam_update

    p = jnp.asarray(rng.standard_normal((16,)), jnp.float32)
    g = jnp.asarray(rng.standard_normal((16,)), jnp.float32)
    new_p, st = adam_update(p, g, adam_init(p), 1e-3)
    m = 0.1 * np.asarray(g)
    v = 0.001 * np.asarray(g) ** 2
    want = np.asarray(p) - 1e-3 * (m / 0.1) / (np.sqrt(v / 0.001) + 1e-8)
    np.testing.assert_allclose(np.asarray(new_p), want, rtol=1e-6)
    assert st.m.dtype == jnp.float32 and new_p.dtype == jnp.float32


def test_stochastic_round_bf16_exact_and_unbiased(rng):
    """Exactly-representable values pass through unchanged for every key;
    a midpoint value rounds each way with ~equal probability and the mean
    of the rounded values approaches the true value (unbiasedness)."""
    from big_linear_algebra.nn.optim import stochastic_round_bf16

    exact = jnp.asarray(rng.standard_normal((256,)), jnp.float32)
    exact = exact.astype(jnp.bfloat16).astype(jnp.float32)
    for s in (0, 1, 2):
        out = stochastic_round_bf16(exact, jnp.uint32(s))
        np.testing.assert_array_equal(np.asarray(out, np.float32),
                                      np.asarray(exact))

    # x = 1 + 0.25 ulp: round-to-nearest ALWAYS gives 1.0; SR must give
    # the next bf16 (1 + ulp = 1.0078125) with p = 0.25
    x = jnp.full((4096,), 1.0 + 0.25 * 2.0 ** -7, jnp.float32)
    out = np.asarray(stochastic_round_bf16(x, jnp.uint32(7)), np.float32)
    p_up = (out > 1.0).mean()
    assert 0.2 < p_up < 0.3, p_up
    np.testing.assert_allclose(out.mean(), 1.0 + 0.25 * 2.0 ** -7, rtol=3e-4)


def test_adam_sr_key_only_touches_bf16(rng):
    """sr_key must leave f32 params bit-identical to the keyless path."""
    from big_linear_algebra.nn.optim import adam_init, adam_update

    p = jnp.asarray(rng.standard_normal((32,)), jnp.float32)
    g = jnp.asarray(rng.standard_normal((32,)), jnp.float32)
    a, _ = adam_update(p, g, adam_init(p), 1e-3)
    b, _ = adam_update(p, g, adam_init(p), 1e-3, sr_key=jax.random.key(3))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
