#!/usr/bin/env python
"""End-to-end proof that the system runs on one NVIDIA card.

    python chip_smoke.py                # one card: every phase below
    python chip_smoke.py --four-cards   # four cards: the DP comparison only

One process drives the card; a phase that fails raises, and the script
exits nonzero without printing a result. The last line of standard output
is the JSON result ``{"ok": true, "device": {...}}``; everything else comes
before it. On a machine without a GPU it exits nonzero before any phase.

Phases on one card:
 1. cifar_unet through its CLI at reference width on synthesized data:
    ``init``, ``train 1 --max-steps=20`` (per-step path), ``train 1`` twice
    (device-resident epoch, cold then warm), ``run 2`` (1000-step DDPM
    sampling); losses and the train step's ``memory_analysis()``.
 2. mnist_nn through its CLI: ``init``, ``train 1`` twice, ``run 100``.
 3. cifar_unet ``train 1 --max-steps=5 --image-size=128``: the flash
    attention kernel compiled at its real width inside the model.
 4. Parity of each kernel against its plain reference at real widths.
 5. Kernel-vs-XLA timings behind the decisions in PERF.md.
 6. The ``gpu``-marked tests, run in this process.

``--four-cards``: the ``cifar_unet --dp`` train step on four cards at a
global batch of 64, against the same steps, keys and shard draws on one
card, in float32, each step from the same state; compares losses and the
largest parameter difference.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import io
import json
import math
import os
import shutil
import sys
import time
from pathlib import Path

import numpy as np

CHECKOUT = Path(__file__).resolve().parent


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    log(f"[{name}] start")
    t0 = time.perf_counter()
    yield
    log(f"[{name}] ok in {time.perf_counter() - t0:.1f} s")


def _cli(main, argv, capture=False):
    """Run a model CLI verb; returns its stdout when ``capture``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf) if capture else contextlib.nullcontext():
        rc = main(argv)
    out = buf.getvalue()
    if capture:
        print(out, end="", flush=True)
    if rc != 0:
        raise RuntimeError(f"{argv} exited {rc}")
    return out


def _read_jsonl(path: Path) -> list[dict]:
    return [json.loads(line) for line in path.read_text().splitlines()]


def _memory(compiled) -> str:
    m = compiled.memory_analysis()
    gib = 1 << 30
    return (f"args {m.argument_size_in_bytes / gib:.3f} GiB, "
            f"outputs {m.output_size_in_bytes / gib:.3f} GiB, "
            f"temp {m.temp_size_in_bytes / gib:.3f} GiB, "
            f"generated code {m.generated_code_size_in_bytes / 1e6:.1f} MB")


def _unet_step_memory(cfg) -> str:
    import jax

    from big_linear_algebra.models import cifar_unet as cu
    from big_linear_algebra.nn.optim import adam_init

    params = jax.eval_shape(lambda: cu.init_params(jax.random.key(0), cfg))
    opt = jax.eval_shape(adam_init, params)
    x0 = jax.ShapeDtypeStruct(
        (cfg.batch_size, 3, cfg.image_size, cfg.image_size), np.float32)
    key = jax.eval_shape(lambda: cu.root_key(0, cfg))
    return _memory(cu.train_step.lower(params, opt, x0, key, cfg).compile())


# ---------------------------------------------------------------------------
# Phases 1-3: the model programs through their CLIs
# ---------------------------------------------------------------------------


def phase_unet(data_dir: Path, tiny: bool = False) -> dict:
    """cifar_unet init / train (per-step, then device epoch) / run 2."""
    from big_linear_algebra.data import synth
    from big_linear_algebra.models import cifar_unet as cu

    size = ["--tiny"] if tiny else []
    if tiny:
        # all five batch files, small: the CLI synthesizes any missing one
        # at full size
        synth.ensure_cifar(str(data_dir), per_batch=16)
    jsonl = data_dir / "unet.jsonl"
    _cli(cu.main, ["init", *size])
    _cli(cu.main, ["train", "1", "--max-steps=20", "--keep=1",
                   f"--jsonl={jsonl}", *size])
    # two device epochs in this process: the first compiles the epoch scan,
    # the second reuses it, so their difference is the set-up time
    for _ in range(2):
        _cli(cu.main, ["train", "1", "--keep=1", f"--jsonl={jsonl}", *size])
    _cli(cu.main, ["run", "2", *size])
    records = _read_jsonl(jsonl)
    losses = [r["avg_loss"] for r in records]
    log(f"cifar_unet losses (20 per-step steps, then two device epochs): "
        f"{losses}")
    log(f"cifar_unet device epoch: {records[2]['epoch_seconds']:.3f} s, "
        f"{records[2]['images_per_sec']:.1f} images/s warm; set-up "
        f"(compiling the epoch scan) "
        f"{records[1]['epoch_seconds'] - records[2]['epoch_seconds']:.1f} s")
    if len(losses) != 3 or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"cifar_unet losses not finite: {records}")
    if not tiny and not losses[2] < losses[0]:
        raise RuntimeError(f"cifar_unet loss did not fall: {losses}")
    samples = sorted((data_dir / "cifar_unet" / "samples").glob("*.bmp"))
    if len(samples) != 2:
        raise RuntimeError(f"cifar_unet run 2 wrote {samples}")
    cfg = cu.TINY if tiny else cu.CONFIG
    log(f"cifar_unet train_step memory: {_unet_step_memory(cfg)}")
    return {"losses": losses,
            "epoch_images_per_s": records[2]["images_per_sec"]}


def phase_mnist(data_dir: Path, tiny: bool = False) -> dict:
    """mnist_nn init / train 1 (twice: losses must fall) / run 100."""
    from big_linear_algebra.data import synth
    from big_linear_algebra.models import mnist_nn

    if tiny:
        synth.ensure_mnist(str(data_dir), train_n=512, test_n=128)
    jsonl = data_dir / "mnist.jsonl"
    _cli(mnist_nn.main, ["init"])
    for _ in range(2):
        _cli(mnist_nn.main, ["train", "1", f"--jsonl={jsonl}"])
    out = _cli(mnist_nn.main, ["run", "100"], capture=True)
    records = _read_jsonl(jsonl)
    losses = [r["avg_loss"] for r in records]
    log(f"mnist_nn epochs: {records}")
    if not all(math.isfinite(x) for x in losses) or (
            not tiny and not losses[1] < losses[0]):
        raise RuntimeError(f"mnist_nn losses {losses} not finite and falling")
    if "correct" not in out:
        raise RuntimeError(f"mnist_nn run printed no accuracy: {out!r}")
    return {"losses": losses, "run": out.strip().splitlines()[-1]}


def phase_unet_highres(data_dir: Path, image_size: int = 128) -> dict:
    """cifar_unet train at --image-size, where attention takes the flash
    kernel (N = (image_size/2)² tokens at down_2/up_3)."""
    import dataclasses as dc

    from big_linear_algebra.models import cifar_unet as cu

    jsonl = data_dir / "unet_highres.jsonl"
    _cli(cu.main, ["train", "1", "--max-steps=5", f"--image-size={image_size}",
                   "--keep=1", f"--jsonl={jsonl}"])
    rec = _read_jsonl(jsonl)[-1]
    log(f"cifar_unet --image-size={image_size}: {rec}")
    if not math.isfinite(rec["avg_loss"]):
        raise RuntimeError(f"non-finite loss at image size {image_size}")
    cfg = dc.replace(cu.CONFIG, image_size=image_size)
    log(f"cifar_unet --image-size={image_size} train_step memory: "
        f"{_unet_step_memory(cfg)}")
    return rec


# ---------------------------------------------------------------------------
# Phase 4: kernel parity at real widths
# ---------------------------------------------------------------------------


def _close(name, got, want, tol):
    """|got - want| ≤ tol + tol·|want| elementwise; raises with the worst
    element otherwise. Returns the largest error relative to that bound."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    ratio = float(np.max(np.abs(got - want) / (tol + tol * np.abs(want))))
    if not ratio <= 1.0:
        raise RuntimeError(f"{name}: error {ratio:.3g}× the tolerance {tol}")
    return ratio


def parity_attention(shapes=((16, 1024, 16), (16, 4096, 16), (4, 4096, 128))):
    """Flash kernel forward and all three gradients against attention_dense
    in float32 at HIGHEST. bf16 keeps 8 mantissa bits and the online softmax
    sums in another order: 2e-2. float32 (IEEE dots in the kernel): 1e-4."""
    import jax
    import jax.numpy as jnp

    from big_linear_algebra.nn.attention import attention_dense, flash_attention

    def fwd_bwd(att):
        def f(q, k, v, g):
            o, vjp = jax.vjp(att, q, k, v)
            return (o,) + vjp(g)
        return jax.jit(f)

    flash, dense = fwd_bwd(flash_attention), fwd_bwd(attention_dense)
    for b, n, d in shapes:
        keys = jax.random.split(jax.random.key(n + d), 4)
        x32 = [jax.random.normal(k, (b, n, d), jnp.float32) for k in keys]
        for dtype, tol in ((jnp.bfloat16, 2e-2), (jnp.float32, 1e-4)):
            xs = [x.astype(dtype) for x in x32]
            want = dense(*[x.astype(jnp.float32) for x in xs])
            got = flash(*xs)
            worst = max(_close(f"flash {nm} {b}x{n}x{d} {jnp.dtype(dtype)}",
                               g.astype(jnp.float32), w, tol)
                        for nm, g, w in zip(("o", "dq", "dk", "dv"), got,
                                            want))
            log(f"parity flash_attention ({b}, {n}, {d}) "
                f"{jnp.dtype(dtype).name}: o, dq, dk, dv within {tol} "
                f"(worst {worst:.3f} of the bound)")


def parity_matmul(m: int = 4096):
    """ops/matmul nn/nt/tn against float64 numpy at m³, normwise:
    max|err| / max|ref| ≤ 1e-4 in f32 (HIGHEST), 2e-2 in bf16."""
    import jax
    import jax.numpy as jnp

    from big_linear_algebra.ops import matmul, matmul_nt, matmul_tn

    rng = np.random.default_rng(0)
    a64 = rng.standard_normal((m, m))
    b64 = rng.standard_normal((m, m))
    for dtype, tol in ((jnp.float32, 1e-4), (jnp.bfloat16, 2e-2)):
        a = jnp.asarray(a64, dtype)
        b = jnp.asarray(b64, dtype)
        ar = np.asarray(a.astype(jnp.float32), np.float64)
        br = np.asarray(b.astype(jnp.float32), np.float64)
        want = ar @ br
        scale = np.abs(want).max()
        for name, fn, args, ref in (
                ("nn", matmul, (a, b), want),
                ("nt", matmul_nt, (a, b.T), want),
                ("tn", matmul_tn, (a.T, b), want)):
            got = np.asarray(jax.jit(fn)(*args).astype(jnp.float32),
                             np.float64)
            err = float(np.abs(got - ref).max() / scale)
            if not err <= tol:
                raise RuntimeError(f"matmul_{name} {jnp.dtype(dtype).name}: "
                                   f"normwise error {err:.3g} > {tol}")
            log(f"parity matmul_{name} {m}^3 {jnp.dtype(dtype).name}: "
                f"normwise error {err:.2e} (limit {tol})")


# ---------------------------------------------------------------------------
# Phase 5: kernel-vs-XLA timings
# ---------------------------------------------------------------------------


def timing_gemm(m: int = 4096) -> dict:
    """XLA's bf16 GEMM against the Hopper matmul kernel shipped with JAX
    (jax.experimental.pallas.ops.gpu.hopper_matmul_mgpu, a library kernel
    through Mosaic GPU), and the mnist_nn train step."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas.ops.gpu import hopper_matmul_mgpu as hm

    import bench

    k1, k2 = jax.random.split(jax.random.key(0))
    a = jax.random.normal(k1, (m, m), jnp.bfloat16)
    b = jax.random.normal(k2, (m, m), jnp.bfloat16)
    xla = jax.jit(lambda a, b: jnp.dot(a, b, preferred_element_type=jnp.float32)
                  .astype(jnp.bfloat16))
    cfg = hm.TuningConfig(tile_m=128, tile_n=128, tile_k=64,
                          max_concurrent_steps=4,
                          grid_minor_dim=hm.MatmulDimension.N,
                          grid_tile_width=4,
                          wg_dimension=hm.MatmulDimension.N)
    lib = jax.jit(lambda a, b: hm.matmul(a, b, cfg))
    err = float(jnp.max(jnp.abs(lib(a, b).astype(jnp.float32)
                                - xla(a, b).astype(jnp.float32))))
    out = {}
    for turn in ("xla", "library", "library", "xla"):
        fn = xla if turn == "xla" else lib
        out.setdefault(turn, []).append(bench.time_host(fn, a, b, iters=100)
                                        * 1e3)
    peak = bench.peaks(jax.devices()[0].device_kind)["bf16_flops"]
    res = {name: min(ts) for name, ts in out.items()}
    for name, ms in res.items():
        log(f"timing gemm {m}^3 bf16 {name}: {ms:.4f} ms "
            f"({2 * m ** 3 / (ms * 1e-3) / 1e12:.1f} TF/s, "
            f"{2 * m ** 3 / (ms * 1e-3) / peak:.3f} of the bf16 peak); "
            f"all turns {out[name]}")
    log(f"timing gemm library vs xla max |diff| {err:.3g}")
    mnist = bench.bench_mnist_nn()
    log(f"timing mnist_nn train step: {mnist['step_us']:.1f} us "
        f"({mnist['value']:.0f} images/s)")
    return {"gemm_ms": res, "mnist_step_us": mnist["step_us"]}


def timing_attention(b: int = 16, d: int = 16,
                     ns=(256, 512, 1024, 4096)) -> dict:
    """Forward+backward, bf16: the flash kernel, the dense XLA path and
    cuDNN, at the U-Net's attention shapes."""
    import bench

    res = {}
    for n in ns:
        row = bench.bench_attention(b, n, d)
        res[n] = {k: row[k] for k in ("flash", "dense", "cudnn")}
        log(f"timing attention fwd+bwd ({b}, {n}, {d}) bf16 ms: "
            + ", ".join(f"{k} {v:.4f}" for k, v in res[n].items()))
    return res


def timing_unet_attention(image_size: int = 128, iters: int = 20) -> dict:
    """One cifar_unet train step at --image-size with the long attention
    sites (N ≥ 1024) on each implementation; shorter sites stay dense."""
    import jax

    import bench
    from big_linear_algebra.models import cifar_unet as cu
    from big_linear_algebra.nn.optim import adam_init

    # the module itself: the package re-exports a function of the same name
    att_mod = importlib.import_module("big_linear_algebra.nn.attention")

    cfg = dataclasses.replace(cu.CONFIG, image_size=image_size)
    long_impls = {"flash": att_mod.flash_attention,
                  "dense": att_mod.attention_dense,
                  "cudnn": bench.cudnn_attention}
    x0 = jax.random.normal(jax.random.key(2),
                           (cfg.batch_size, 3, image_size, image_size))
    dispatch = att_mod.attention
    res = {}
    try:
        for name, impl in long_impls.items():
            att_mod.attention = (
                lambda q, k, v, impl=impl: impl(q, k, v)
                if q.shape[1] >= 1024 else att_mod.attention_dense(q, k, v))
            # a fresh function per implementation: the patched dispatch is
            # read when the step is traced, and jit caches traces by function
            step = jax.jit(
                lambda p, o, x, k: cu.train_step.__wrapped__(p, o, x, k, cfg),
                donate_argnums=(0, 1))
            params = cu.init_params(jax.random.key(0), cfg)
            state = {"p": params, "o": adam_init(params),
                     "k": cu.root_key(1, cfg)}

            def run():
                state["k"], k = jax.random.split(state["k"])
                state["p"], state["o"], loss = step(state["p"], state["o"],
                                                    x0, k)
                return loss

            t0 = time.perf_counter()
            jax.block_until_ready(run())
            compile_s = time.perf_counter() - t0
            ms = bench.time_host(run, iters=iters, warmup=2) * 1e3
            res[name] = ms
            log(f"timing cifar_unet train step --image-size={image_size} "
                f"attention={name}: {ms:.3f} ms/step "
                f"(first call incl. compile {compile_s:.1f} s)")
    finally:
        att_mod.attention = dispatch
    return res


# ---------------------------------------------------------------------------
# Phase 6: the gpu-marked tests
# ---------------------------------------------------------------------------


def run_gpu_tests() -> None:
    import pytest

    os.environ["BLA_TESTS_ON_GPU"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      str(CHECKOUT / "tests")])
    if rc != 0:
        raise RuntimeError(f"gpu-marked tests exited {rc}")


# ---------------------------------------------------------------------------
# --four-cards: DP across cards against the same math on one card
# ---------------------------------------------------------------------------


def dp_reference_step(cfg, n_shards: int):
    """One card computing what ``make_train_step_dp`` computes on
    ``n_shards`` devices: each shard's slice of the batch with the step key
    folded by the shard's index, grads averaged, one Adam update."""
    import jax
    import jax.numpy as jnp

    from big_linear_algebra.models import cifar_unet as cu
    from big_linear_algebra.nn.optim import adam_update

    def step(params, opt, x0, key):
        xs = x0.reshape(n_shards, -1, *x0.shape[1:])

        def loss(p):
            return jnp.mean(jnp.stack([
                cu.loss_fn(p, xs[r], jax.random.fold_in(key, r), cfg)
                for r in range(n_shards)]))

        value, grads = jax.value_and_grad(loss)(params)
        params, opt = adam_update(params, grads, opt, cfg.learn_rate,
                                  sr_key=cu._sr_key(key, cfg))
        return params, opt, value

    return jax.jit(step)


def compare_dp(devices, cfg, steps: int, seed: int = 0) -> dict:
    """``steps`` DP train steps over ``devices`` against
    ``dp_reference_step`` on the first device, same data and keys. Each DP
    step starts from the reference's state: Adam's first steps move every
    weight by about ±lr whatever the gradient's size, so a weight whose
    gradient is reduction-order noise takes a random sign, and free-running
    trajectories drift apart by chaos, not by a fault. Synchronized steps
    test the DP math itself."""
    import jax
    import jax.numpy as jnp

    from big_linear_algebra.data import synth
    from big_linear_algebra.data.cifar10 import pixels_to_chw
    from big_linear_algebra.models import cifar_unet as cu
    from big_linear_algebra.nn.optim import adam_init
    from big_linear_algebra.parallel import make_mesh

    n = len(devices)
    _, pixels = synth.synth_cifar_examples(np.random.default_rng(seed),
                                           steps * cfg.batch_size)
    data = jnp.asarray(pixels_to_chw(pixels.astype(np.float32)))
    data = data.reshape(steps, cfg.batch_size, *data.shape[1:])
    dp_step = cu.make_train_step_dp(make_mesh({"data": n}, devices), cfg)
    ref_step = dp_reference_step(cfg, n)
    params = cu.init_params(jax.random.key(seed), cfg)
    opt = adam_init(params)
    key = cu.root_key(seed + 1, cfg)
    l_dp, l_ref, diffs = [], [], []
    for s in range(steps):
        key, ks = jax.random.split(key)
        # copies: the DP step donates its params and optimizer state
        p_dp, _, loss_dp = dp_step(jax.tree.map(jnp.copy, params),
                                   jax.tree.map(jnp.copy, opt), data[s], ks)
        params, opt, loss_ref = ref_step(params, opt, data[s], ks)
        l_dp.append(float(loss_dp))
        l_ref.append(float(loss_ref))
        diffs.append(max(float(jnp.max(jnp.abs(a - b))) for a, b in zip(
            jax.tree.leaves(p_dp), jax.tree.leaves(params))))
    rel = max(abs(a - b) / abs(b) for a, b in zip(l_dp, l_ref))
    return {"dp_losses": l_dp, "ref_losses": l_ref, "loss_rel_diff": rel,
            "max_param_diff": max(diffs), "param_diff_per_step": diffs}


def four_cards(steps: int = 5) -> None:
    import jax

    from big_linear_algebra.models import cifar_unet as cu

    devices = jax.devices()
    if len(devices) != 4:
        raise RuntimeError(f"--four-cards needs 4 devices, found {len(devices)}")
    cfg = dataclasses.replace(cu.CONFIG, batch_size=64,
                              compute_dtype="float32")
    with phase("four-cards DP vs one card"):
        r = compare_dp(devices, cfg, steps)
        log(f"DP on 4 cards vs one card, batch 64, float32, {steps} steps: "
            f"{json.dumps(r)}")
        if not r["loss_rel_diff"] <= 1e-3:
            raise RuntimeError(f"DP losses differ by {r['loss_rel_diff']:.3g}"
                               f" (limit 1e-3)")


# ---------------------------------------------------------------------------


def one_card() -> None:
    data_dir = CHECKOUT / ".smoke_data"
    shutil.rmtree(data_dir, ignore_errors=True)
    data_dir.mkdir()
    os.environ["BLA_DATA_DIR"] = str(data_dir)
    try:
        with phase("1 cifar_unet init/train/run"):
            phase_unet(data_dir)
        with phase("2 mnist_nn init/train/run"):
            phase_mnist(data_dir)
        with phase("3 cifar_unet --image-size=128"):
            phase_unet_highres(data_dir)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    with phase("4 kernel parity"):
        parity_attention()
        parity_matmul()
    with phase("5 kernel-vs-XLA timings"):
        timing_gemm()
        timing_attention()
        timing_unet_attention()
    with phase("6 gpu-marked tests"):
        run_gpu_tests()


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv not in ([], ["--four-cards"]):
        print(f"usage: chip_smoke.py [--four-cards] (got {argv})",
              file=sys.stderr)
        return 2
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {platform!r}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(CHECKOUT))
    import bench
    from big_linear_algebra.utils.compile_cache import enable_compile_cache

    log(f"card: {bench.card_name_and_power()}")
    log(f"compile cache: {enable_compile_cache()}")
    t0 = time.perf_counter()
    if argv == ["--four-cards"]:
        four_cards()
    else:
        one_card()
    log(f"chip_smoke finished in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": bench.device_identity()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
