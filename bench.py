#!/usr/bin/env python
"""Benchmark harness for one NVIDIA card: ``python bench.py``.

Prints one JSON line per measurement. Every line names the device it ran on
(platform, ``device_kind``, device count) and the card's power limit, and
the script fails on a machine without a GPU instead of timing the CPU.

Timing is host-clock around work that ends in ``block_until_ready``, after a
warm-up that compiles every shape. Rates are divided by the published peaks
of the device kind (``PEAKS``); a device that is not in the table is an
error, not a default.

The cells of a real benchmark (configurations, per-layer metrics from a
device trace) are future work; these are the measurements the kernel
decisions in PERF.md rest on.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

# Published dense peaks (no sparsity), keyed by jax's ``device_kind``.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "tf32_flops": 495e12,
        "hbm_bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 SXM5 data sheet, dense rates at 700 W",
    },
}


def peaks(device_kind: str) -> dict:
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {device_kind!r}; "
                       f"add them to bench.PEAKS with their source")
    return PEAKS[device_kind]


def card_name_and_power() -> str:
    """``name, power.limit`` of the first card, read by nvidia-smi in a
    child process that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def device_identity() -> dict:
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def require_gpu() -> None:
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX found {platform!r}")


def time_host(fn, *args, iters: int = 20, warmup: int = 2) -> float:
    """Seconds per call of ``fn(*args)``: host clock over ``iters`` calls
    that end in ``block_until_ready``, after ``warmup`` calls."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def bench_xla_matmul(m: int = 4096) -> dict:
    """XLA's (cuBLAS) bf16 GEMM at m³ with f32 accumulation."""
    k1, k2 = jax.random.split(jax.random.key(0))
    a = jax.random.normal(k1, (m, m), jnp.bfloat16)
    b = jax.random.normal(k2, (m, m), jnp.bfloat16)
    f = jax.jit(lambda a, b: jnp.dot(a, b, preferred_element_type=jnp.float32)
                .astype(jnp.bfloat16))
    dt = time_host(f, a, b, iters=50)
    rate = 2 * m ** 3 / dt
    return {"metric": "xla_matmul_bf16_tflops", "m": m, "ms": dt * 1e3,
            "value": rate / 1e12,
            "bf16_peak_share": rate / peaks(jax.devices()[0].device_kind)[
                "bf16_flops"]}


def cudnn_attention(q, k, v):
    """cuDNN's fused attention, a library kernel (bf16/fp16 only), through
    jax.nn.dot_product_attention on (B, N, 1 head, d)."""
    o = jax.nn.dot_product_attention(q[:, :, None], k[:, :, None],
                                     v[:, :, None], implementation="cudnn")
    return o[:, :, 0]


def bench_attention(b: int = 16, n: int = 4096, d: int = 16,
                    iters: int = 50) -> dict:
    """Forward+backward ms, bf16: the flash kernel, the dense XLA path and
    cuDNN."""
    from big_linear_algebra.nn.attention import attention_dense, flash_attention

    keys = jax.random.split(jax.random.key(n), 4)
    q, k, v, g = (jax.random.normal(kk, (b, n, d), jnp.bfloat16)
                  for kk in keys)
    out = {"metric": "attention_fwd_bwd_ms", "b": b, "n": n, "d": d}
    for name, att in (("flash", flash_attention), ("dense", attention_dense),
                      ("cudnn", cudnn_attention)):
        f = jax.jit(lambda q, k, v, g, att=att: jax.vjp(att, q, k, v)[1](g))
        out[name] = time_host(f, q, k, v, g, iters=iters) * 1e3
    return out


def bench_mnist_nn(iters: int = 200) -> dict:
    """mnist_nn train step (784→256→128→10, batch 64) images/s."""
    from big_linear_algebra.models import mnist_nn

    cfg = mnist_nn.CONFIG
    params = mnist_nn.init_params(jax.random.key(0), cfg)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.random((cfg.batch_size, 784)), jnp.float32)
    onehot = jnp.asarray(np.eye(10, dtype=np.float32)[
        rng.integers(0, 10, cfg.batch_size)])
    mask = jnp.ones((cfg.batch_size,), jnp.float32)
    state = {"p": params}

    def step():
        state["p"], _, ce = mnist_nn.train_step(state["p"], x, onehot, mask,
                                                cfg)
        return ce

    dt = time_host(step, iters=iters, warmup=5)
    return {"metric": "mnist_nn_train_images_per_s",
            "value": cfg.batch_size / dt, "step_us": dt * 1e6}


def bench_unet_step(iters: int = 20, image_size: int = 32) -> dict:
    """cifar_unet train step (reference widths, batch 16, bf16 compute)."""
    import dataclasses

    from big_linear_algebra.models import cifar_unet as cu
    from big_linear_algebra.nn.optim import adam_init

    cfg = dataclasses.replace(cu.CONFIG, image_size=image_size)
    params = cu.init_params(jax.random.key(0), cfg)
    state = {"p": params, "o": adam_init(params), "k": cu.root_key(1, cfg)}
    x0 = jax.random.normal(jax.random.key(2),
                           (cfg.batch_size, 3, image_size, image_size))

    def step():
        state["k"], k = jax.random.split(state["k"])
        state["p"], state["o"], loss = cu.train_step(
            state["p"], state["o"], x0, k, cfg)
        return loss

    dt = time_host(step, iters=iters, warmup=3)
    return {"metric": "unet_train_ms_per_step", "image_size": image_size,
            "value": dt * 1e3, "images_per_s": cfg.batch_size / dt}


def main() -> int:
    require_gpu()
    from big_linear_algebra.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    context = {"device": device_identity(), "card": card_name_and_power()}
    for fn in (bench_xla_matmul, bench_attention, bench_mnist_nn,
               bench_unet_step):
        print(json.dumps({**fn(), **context}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
