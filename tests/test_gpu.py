"""Tests that need the card. Marked ``gpu``: they skip on the CPU (the
``gpu`` fixture decides at run time) and run on the card through
``python chip_smoke.py``, phase 6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from big_linear_algebra.nn.attention import attention_dense, flash_attention
from big_linear_algebra.ops import matmul
from big_linear_algebra.ops.pallas_utils import interpret_mode

pytestmark = pytest.mark.gpu


def test_flash_compiles_through_triton(gpu):
    """On the card the flash kernel is compiled by Triton, not interpreted:
    the lowered module carries the Triton custom call."""
    assert interpret_mode() is False
    spec = jax.ShapeDtypeStruct((2, 1024, 16), jnp.bfloat16)
    text = jax.jit(flash_attention).lower(spec, spec, spec).as_text()
    assert "triton" in text.lower()
    grad = jax.jit(jax.grad(lambda q: jnp.sum(
        flash_attention(q, q, q).astype(jnp.float32))))
    assert "triton" in grad.lower(spec).as_text().lower()


def test_f32_matmul_is_not_tf32(gpu):
    """f32 operands run at HIGHEST: TF32 would miss float64 by ~1e-3."""
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((1024, 512)), rng.standard_normal((512, 768))
    got = np.asarray(matmul(jnp.asarray(a, jnp.float32),
                            jnp.asarray(b, jnp.float32)), np.float64)
    want = (np.asarray(a, np.float32).astype(np.float64)
            @ np.asarray(b, np.float32).astype(np.float64))
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


def test_flash_f32_matches_dense_on_card(gpu):
    """IEEE f32 dots inside the kernel: forward and grads within 1e-4 of
    the dense float32 HIGHEST path."""
    keys = jax.random.split(jax.random.key(0), 4)
    q, k, v, g = (jax.random.normal(kk, (2, 2048, 16), jnp.float32)
                  for kk in keys)

    def fwd_bwd(att):
        o, vjp = jax.vjp(att, q, k, v)
        return (o,) + vjp(g)

    for got, want in zip(fwd_bwd(flash_attention), fwd_bwd(attention_dense)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


def test_dense_attention_f32_is_not_tf32(gpu):
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((2, 256, 64)).astype(np.float32)
               for _ in range(3))
    got = np.asarray(attention_dense(*map(jnp.asarray, (q, k, v))))
    s = np.einsum("bnd,bmd->bnm", q.astype(np.float64), k) / 8.0
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    want = np.einsum("bnm,bmd->bnd", p, v.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
