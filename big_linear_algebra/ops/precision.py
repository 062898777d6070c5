"""The library-wide matmul input-precision policy, in one place.

bfloat16 operands take the tensor cores' native path (peak throughput);
float32 operands use ``Precision.HIGHEST`` so XLA never silently runs them
in TF32, which keeps about three decimal digits (the GPU's default for f32
matmuls and convs). Everything that multiplies matrices — the matmul
wrappers (ops/matmul.py), convolutions (nn/conv.py), attention einsums and
the flash kernel's own dots (nn/attention.py), and model-level matmuls —
routes through this helper so the policy can only change in one place.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def matmul_precision(dtype) -> jax.lax.Precision:
    if jnp.dtype(dtype) == jnp.bfloat16:
        return jax.lax.Precision.DEFAULT
    return jax.lax.Precision.HIGHEST
