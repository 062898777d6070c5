"""mnist_nn: the flagship 784→256→128→10 MLP (≈ model/mnist_nn.c).

Reference semantics rebuilt in JAX:
- architecture, batch 64, SGD lr 0.02, He-uniform init with zero biases
  (model/mnist_nn.c:11-12,97-142)
- loss: softmax + cross-entropy (ε=1e-15), gradient seed scaled by
  1/input_size — the reference's deliberate ``scale = 1/784``
  (model/mnist_nn.c:260, SURVEY.md §7.10) — so training dynamics match
- per-gradient frobenius clip (threshold ∞ by default = inert, exactly as
  compiled into the reference, model/mnist_nn.c:13,76-81)
- epoch metrics: avg accuracy + avg CE loss over examples
  (model/mnist_nn.c:339-341); plus step-time/images-per-sec (new)
- CSV checkpoints bit-compatible with the reference layout
  (weights_N.csv (out,in) row-major, biases_N.csv one line), so the
  shipped trained weights load directly; ``train`` resumes from them
  (model/mnist_nn.c:165-170,344-376)

Differences from the reference:
- batch-major activations (B, 784) with (in, out) weights; dense fwd/bwd are
  explicit-VJP GEMMs (nn/dense.py)
- one jit-compiled train step with donated params; the ragged last batch
  (model/mnist_nn.c:194-195) is zero-padded + masked so one compiled shape
  serves the whole epoch
- optional data-parallel execution (``--dp``): batch dim sharded over all
  local devices, gradient psum inserted by XLA
- RNG: jax.random with a fixed seed (the reference's srand(42) global rand();
  trajectories are statistically, not bitwise, comparable — SURVEY.md §8.2)
"""

from __future__ import annotations

import dataclasses
import functools
import time
from pathlib import Path
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from big_linear_algebra.ckpt import csv_layouts
from big_linear_algebra.ckpt.csv_layouts import layout_exists
from big_linear_algebra.data.mnist import MnistDataset
from big_linear_algebra.data import synth
from big_linear_algebra.models import common
from big_linear_algebra.nn import dense, he_uniform, softmax_cross_entropy
from big_linear_algebra.ops import frobenius_norm
from big_linear_algebra.parallel import default_mesh
from big_linear_algebra.parallel.spmd import psum_tree, shard_map_fn


@dataclasses.dataclass(frozen=True)
class Config:
    input_size: int = 784          # LAYER_INPUT_SIZE, model/mnist_nn.c:26
    layer_1: int = 256             # LAYER_1_SIZE
    layer_2: int = 128             # LAYER_2_SIZE
    layer_3: int = 10              # LAYER_3_SIZE
    batch_size: int = 64           # SGD_BATCH_SIZE, :11
    learn_rate: float = 0.02       # SGD_LEARN_RATE_MULTIPLIER, :12
    grad_clip: float = float("inf")  # SGD_GRADIENT_CLIP, :13
    seed: int = 42                 # srand(42), :513
    # lax.scan unroll for the fused-epoch paths. The train step is tiny, so
    # the scan's fixed per-iteration slice cost is proportionally large;
    # unrolling amortizes it without changing the per-step op order (same
    # lever as cifar_unet.Config.scan_unroll; to be re-measured on the card,
    # ROADMAP queue 1 item 5).
    scan_unroll: int = 4

    @property
    def sizes(self):
        return (self.input_size, self.layer_1, self.layer_2, self.layer_3)


CONFIG = Config()

_LAYOUT = {  # reference on-disk layout: (rows, cols) per file
    "weights_1.csv": (256, 784),
    "weights_2.csv": (128, 256),
    "weights_3.csv": (10, 128),
    "biases_1.csv": (1, 256),
    "biases_2.csv": (1, 128),
    "biases_3.csv": (1, 10),
}


def ckpt_dir() -> Path:
    return common.data_dir() / "mnist_nn"


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_params(key, cfg: Config = CONFIG) -> Dict[str, jax.Array]:
    """He-uniform weights U(±√(6/fan_in)), zero biases
    (model/mnist_nn.c:97-142)."""
    ks = jax.random.split(key, 3)
    s = cfg.sizes
    params = {}
    for i in range(3):
        params[f"w{i+1}"] = he_uniform(ks[i], (s[i], s[i + 1]), fan_in=s[i])
        params[f"b{i+1}"] = jnp.zeros((s[i + 1],), jnp.float32)
    return params


def save_params_csv(params, base: Path | None = None) -> None:
    """Write the reference CSV layout via the shared ckpt.csv_layouts
    helpers (_LAYOUT is the single source of the file list). Our (in, out)
    weights transpose to the reference's (out, in) row-major files; biases
    are one CSV line."""
    arrays = {}
    for i in (1, 2, 3):
        arrays[f"weights_{i}.csv"] = np.asarray(params[f"w{i}"]).T
        arrays[f"biases_{i}.csv"] = np.asarray(params[f"b{i}"]).reshape(1, -1)
    csv_layouts.save_matrices(str(base or ckpt_dir()), arrays)


def load_params_csv(base: Path | None = None,
                    cfg: Config = CONFIG) -> Dict[str, jax.Array]:
    mats = csv_layouts.load_matrices(str(base or ckpt_dir()), _LAYOUT)
    params = {}
    for i in (1, 2, 3):
        params[f"w{i}"] = jnp.asarray(mats[f"weights_{i}.csv"].T)
        params[f"b{i}"] = jnp.asarray(mats[f"biases_{i}.csv"][0])
    return params


# ---------------------------------------------------------------------------
# Forward / loss / step
# ---------------------------------------------------------------------------


def forward(params, x):
    """relu(dense) ×2 → logits (model/mnist_nn.c:221-234). x: (B, 784) scaled
    to [0,1] by the caller (matrix_scale 1/255, :218). The hidden layers'
    bias+ReLU are fused into the matmul kernel epilogue (nn/dense.py)."""
    a1 = dense(x, params["w1"], params["b1"], "relu")
    a2 = dense(a1, params["w2"], params["b2"], "relu")
    return dense(a2, params["w3"], params["b3"])


def loss_and_metrics(params, x, onehot, mask, cfg: Config = CONFIG):
    logits = forward(params, x)
    # reference gradient scale: 1/LAYER_INPUT_SIZE (model/mnist_nn.c:260)
    loss = softmax_cross_entropy(logits, onehot, mask) / cfg.input_size
    pred = jnp.argmax(logits, axis=-1)
    label = jnp.argmax(onehot, axis=-1)
    correct = jnp.sum((pred == label) * mask)
    # unscaled CE sum for the reference's epoch-avg-loss metric
    ce_sum = loss * cfg.input_size
    return loss, (correct, ce_sum)


def _clip(g, threshold):
    """Per-gradient frobenius clip (≈ clip_gradient, model/mnist_nn.c:76-81).
    Inert at the default ∞ threshold, exactly like the reference build."""
    if threshold == float("inf"):
        return g
    norm = frobenius_norm(g)
    return jnp.where(norm > threshold, g * (threshold / norm), g)


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(0,))
def train_step(params, x, onehot, mask, cfg: Config = CONFIG):
    (_, (correct, ce_sum)), grads = jax.value_and_grad(
        loss_and_metrics, has_aux=True
    )(params, x, onehot, mask, cfg)
    grads = jax.tree.map(lambda g: _clip(g, cfg.grad_clip), grads)
    params = jax.tree.map(
        lambda p, g: p - cfg.learn_rate * g, params, grads
    )
    return params, correct, ce_sum


@functools.partial(jax.jit, static_argnames=("cfg",))
def eval_batch(params, x, onehot, mask, cfg: Config = CONFIG):
    _, (correct, ce_sum) = loss_and_metrics(params, x, onehot, mask, cfg)
    return correct, ce_sum


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(0,))
def epoch_step_resident(params, x_dev, y_dev, perm, cfg: Config = CONFIG):
    """A whole epoch against a device-resident dataset: the host sends only
    the epoch permutation. ``x_dev``: (N, 784) raw 0-255 pixels on device;
    ``y_dev``: (N,) labels; ``perm``: (n_batches·B,) int32, −1 = padding
    (ragged last batch mask)."""
    b = cfg.batch_size
    n_batches = perm.shape[0] // b
    idx = perm.reshape(n_batches, b)

    def body(p, batch_idx):
        safe = jnp.clip(batch_idx, 0, x_dev.shape[0] - 1)
        x = x_dev[safe] / 255.0
        onehot = jax.nn.one_hot(y_dev[safe].astype(jnp.int32), cfg.layer_3,
                                dtype=jnp.float32)
        mask = (batch_idx >= 0).astype(jnp.float32)
        (_, (correct, ce_sum)), grads = jax.value_and_grad(
            loss_and_metrics, has_aux=True)(p, x, onehot, mask, cfg)
        grads = jax.tree.map(lambda g: _clip(g, cfg.grad_clip), grads)
        p = jax.tree.map(lambda w, g: w - cfg.learn_rate * g, p, grads)
        return p, (correct, ce_sum)

    params, (corrects, ces) = jax.lax.scan(body, params, idx,
                                           unroll=cfg.scan_unroll)
    return params, jnp.sum(corrects), jnp.sum(ces)


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(0,))
def epoch_step(params, xs, onehots, masks, cfg: Config = CONFIG):
    """A whole epoch as one jitted lax.scan over pre-stacked batches.

    Device-side counterpart of the reference's per-batch host loop
    (model/mnist_nn.c:193-337): one dispatch per *epoch* instead of per
    batch, so step time is pure device compute. xs: (n_batches, B, 784).
    """

    def body(p, batch):
        x, onehot, mask = batch
        (_, (correct, ce_sum)), grads = jax.value_and_grad(
            loss_and_metrics, has_aux=True)(p, x, onehot, mask, cfg)
        grads = jax.tree.map(lambda g: _clip(g, cfg.grad_clip), grads)
        p = jax.tree.map(lambda w, g: w - cfg.learn_rate * g, p, grads)
        return p, (correct, ce_sum)

    params, (corrects, ces) = jax.lax.scan(body, params,
                                           (xs, onehots, masks),
                                           unroll=cfg.scan_unroll)
    return params, jnp.sum(corrects), jnp.sum(ces)


# ---------------------------------------------------------------------------
# SPMD (shard_map) training: DP and DP×TP. The step functions are written
# per-shard so the GEMMs (ops/matmul.py) execute on each device's
# local block, with explicit psum/all_gather collectives over the mesh —
# the SURVEY.md §2.4 scaling story for the reference's minibatch loop
# (model/mnist_nn.c:193-337).
# ---------------------------------------------------------------------------


def make_train_step_dp(mesh, cfg: Config = CONFIG, axis: str = "data"):
    """DP train step: batch sharded over ``axis``, params replicated,
    gradients psum'd. Numerically identical to ``train_step`` — the loss is
    example-summed, so the psum of per-shard grads IS the full-batch
    gradient (up to reduction order)."""

    def local_step(params, x, onehot, mask):
        (_, (correct, ce_sum)), grads = jax.value_and_grad(
            loss_and_metrics, has_aux=True)(params, x, onehot, mask, cfg)
        grads = psum_tree(grads, axis)
        grads = jax.tree.map(lambda g: _clip(g, cfg.grad_clip), grads)
        params = jax.tree.map(lambda p, g: p - cfg.learn_rate * g,
                              params, grads)
        return (params, jax.lax.psum(correct, axis),
                jax.lax.psum(ce_sum, axis))

    fn = shard_map_fn(local_step, mesh,
                      in_specs=(P(), P(axis), P(axis), P(axis)),
                      out_specs=(P(), P(), P()))
    return jax.jit(fn, donate_argnums=(0,))


def tp_param_specs(model_axis: str = "model"):
    """Output-dim sharding for every dense layer (Megatron column-parallel):
    weights (in, out) shard the out dim, biases shard their only dim."""
    specs = {}
    for i in (1, 2, 3):
        specs[f"w{i}"] = P(None, model_axis)
        specs[f"b{i}"] = P(model_axis)
    return specs


def place_params_tp(mesh, params, model_axis: str = "model"):
    specs = tp_param_specs(model_axis)
    return {k: jax.device_put(v, NamedSharding(mesh, specs[k]))
            for k, v in params.items()}


def tp_forward(params, x, model_axis: str = "model"):
    """TP forward on output-dim-sharded weights: each dense GEMM (one dot
    per shard) computes a feature shard; an all_gather over
    ``model_axis`` rebuilds the full activation before the next layer."""
    a = x
    for i in (1, 2, 3):
        # ReLU commutes with the feature-dim gather, so it stays fused in
        # the per-shard GEMM epilogue
        z = dense(a, params[f"w{i}"], params[f"b{i}"],
                  "relu" if i < 3 else None)
        a = jax.lax.all_gather(z, model_axis, axis=1, tiled=True)
    return a


def make_train_step_dp_tp(mesh, cfg: Config = CONFIG,
                          data_axis: str = "data",
                          model_axis: str = "model"):
    """DP×TP train step: batch over ``data_axis``, dense output dims over
    ``model_axis``. Gradients for the weight shards arrive via the
    all_gather transpose (reduce_scatter over ``model_axis``, inserted by
    autodiff) plus an explicit psum over ``data_axis``."""

    def local_step(params, x, onehot, mask):
        def tp_loss(p):
            logits = tp_forward(p, x, model_axis)
            loss = softmax_cross_entropy(logits, onehot, mask) / cfg.input_size
            pred = jnp.argmax(logits, axis=-1)
            label = jnp.argmax(onehot, axis=-1)
            correct = jnp.sum((pred == label) * mask)
            # every model shard computes an identical copy of this loss from
            # the gathered logits, and the all_gather transpose (psum_scatter
            # over model_axis) SUMS the cotangents from all copies — scale the
            # differentiated value by 1/tp so the gradient is exact
            tp = jax.lax.axis_size(model_axis)
            return loss / tp, (correct, loss * cfg.input_size)

        (_, (correct, ce_sum)), grads = jax.value_and_grad(
            tp_loss, has_aux=True)(params)
        grads = psum_tree(grads, data_axis)
        if cfg.grad_clip != float("inf"):
            # frobenius norm of the *full* gradient spans the model shards
            grads = {
                k: g * jnp.minimum(
                    1.0,
                    cfg.grad_clip
                    / jnp.sqrt(jax.lax.psum(jnp.sum(g * g), model_axis)))
                for k, g in grads.items()
            }
        params = jax.tree.map(lambda p, g: p - cfg.learn_rate * g,
                              params, grads)
        return (params, jax.lax.psum(correct, data_axis),
                jax.lax.psum(ce_sum, data_axis))

    pspecs = tp_param_specs(model_axis)
    fn = shard_map_fn(
        local_step, mesh,
        in_specs=(pspecs, P(data_axis), P(data_axis), P(data_axis)),
        out_specs=(pspecs, P(), P()))
    return jax.jit(fn, donate_argnums=(0,))


def make_epoch_resident_dp(mesh, cfg: Config = CONFIG, axis: str = "data"):
    """DP variant of ``epoch_step_resident``: the dataset is replicated on
    every device (25 MB — cheap), each device gathers its slice of every
    batch by mesh position, and gradients psum per step inside one
    lax.scan dispatch per epoch."""
    ndev = mesh.shape[axis]
    if cfg.batch_size % ndev:
        raise ValueError(
            f"batch_size {cfg.batch_size} not divisible by {ndev} devices")
    b_local = cfg.batch_size // ndev

    def local_epoch(params, x_dev, y_dev, perm):
        r = jax.lax.axis_index(axis)
        n_batches = perm.shape[0] // cfg.batch_size
        idx = perm.reshape(n_batches, ndev, b_local)

        def body(p, batch_idx_all):
            batch_idx = batch_idx_all[r]
            safe = jnp.clip(batch_idx, 0, x_dev.shape[0] - 1)
            x = x_dev[safe] / 255.0
            onehot = jax.nn.one_hot(y_dev[safe].astype(jnp.int32),
                                    cfg.layer_3, dtype=jnp.float32)
            mask = (batch_idx >= 0).astype(jnp.float32)
            (_, (correct, ce_sum)), grads = jax.value_and_grad(
                loss_and_metrics, has_aux=True)(p, x, onehot, mask, cfg)
            grads = psum_tree(grads, axis)
            grads = jax.tree.map(lambda g: _clip(g, cfg.grad_clip), grads)
            p = jax.tree.map(lambda w, g: w - cfg.learn_rate * g, p, grads)
            return p, (jax.lax.psum(correct, axis),
                       jax.lax.psum(ce_sum, axis))

        params, (corrects, ces) = jax.lax.scan(body, params, idx,
                                               unroll=cfg.scan_unroll)
        return params, jnp.sum(corrects), jnp.sum(ces)

    fn = shard_map_fn(local_epoch, mesh,
                      in_specs=(P(), P(), P(), P()),
                      out_specs=(P(), P(), P()))
    return jax.jit(fn, donate_argnums=(0,))


def _make_batch(xb, yb, batch_size, num_classes):
    """Zero-pad a ragged batch to ``batch_size`` and build onehot + mask."""
    n = xb.shape[0]
    x = np.zeros((batch_size, xb.shape[1]), np.float32)
    x[:n] = xb / 255.0  # matrix_scale(1/255), model/mnist_nn.c:218
    onehot = np.zeros((batch_size, num_classes), np.float32)
    onehot[np.arange(n), yb.astype(np.int64)] = 1.0
    mask = np.zeros((batch_size,), np.float32)
    mask[:n] = 1.0
    return x, onehot, mask


# ---------------------------------------------------------------------------
# CLI verbs
# ---------------------------------------------------------------------------


def init(flags=None, cfg: Config = CONFIG) -> None:
    params = init_params(jax.random.key(cfg.seed), cfg)
    save_params_csv(params)
    print(f"initialized parameters in {ckpt_dir()}")


def _dp_mesh(flags, cfg: Config):
    """The DP mesh when ``--dp`` applies (>1 device, divisible batch)."""
    flags = flags or {}
    if "dp" not in flags:
        return None
    mesh = default_mesh()
    n = mesh.devices.size
    if n <= 1:
        print("--dp: single device, running unsharded")
        return None
    if cfg.batch_size % n:
        raise SystemExit(
            f"--dp: batch size {cfg.batch_size} is not divisible by "
            f"{n} devices")
    return mesh


def train(num_epochs: int, *args, flags=None, cfg: Config = CONFIG) -> None:
    if "batch" in (flags or {}):
        # --batch=N: scale past the reference's 64 (model/mnist_nn.c:11) —
        # the per-step GEMMs are far too small to fill the card at batch 64
        cfg = dataclasses.replace(
            cfg, batch_size=common.positive_int_flag(flags, "batch"))
    if "scan-unroll" in (flags or {}):
        cfg = dataclasses.replace(
            cfg, scan_unroll=common.positive_int_flag(flags, "scan-unroll"))
    train_csv, _ = synth.ensure_mnist(str(common.data_dir()))
    if layout_exists(str(ckpt_dir()), _LAYOUT):
        params = load_params_csv()   # training IS resume (mnist_nn.c:165-170)
    else:
        print("no checkpoint found; initializing")
        params = init_params(jax.random.key(cfg.seed), cfg)
    data = MnistDataset.from_csv(train_csv)
    rng = np.random.default_rng(cfg.seed)
    logger = common.MetricsLogger((flags or {}).get("jsonl") or None)
    mesh = _dp_mesh(flags, cfg)

    fused = "per-batch" not in (flags or {})  # --per-batch: reference-style
    x_dev = y_dev = None
    epoch_dp = step_dp = None
    if fused:
        # dataset to HBM once (replicated across the DP mesh — each device
        # gathers its batch slice locally); each epoch ships a permutation
        x_dev = jnp.asarray(data.x, jnp.float32)
        y_dev = jnp.asarray(data.y, jnp.float32)
        if mesh is not None:
            epoch_dp = make_epoch_resident_dp(mesh, cfg)
    elif mesh is not None:
        step_dp = make_train_step_dp(mesh, cfg)
    for epoch in range(num_epochs):
        t0 = time.perf_counter()
        if fused:
            n = data.num_examples
            b = cfg.batch_size
            padded = -(-n // b) * b
            perm = np.full(padded, -1, np.int32)
            perm[:n] = rng.permutation(n).astype(np.int32)
            if epoch_dp is not None:
                params, correct, ce_sum = epoch_dp(
                    params, x_dev, y_dev, jnp.asarray(perm))
            else:
                params, correct, ce_sum = epoch_step_resident(
                    params, x_dev, y_dev, jnp.asarray(perm), cfg)
            correct_sum, loss_sum = float(correct), float(ce_sum)
        else:
            correct_sum, loss_sum = 0.0, 0.0
            for xb, yb in data.epoch_batches(rng, cfg.batch_size):
                x, onehot, mask = _make_batch(xb, yb, cfg.batch_size,
                                              cfg.layer_3)
                if step_dp is not None:
                    params, correct, ce_sum = step_dp(params, x, onehot, mask)
                else:
                    params, correct, ce_sum = train_step(params, x, onehot,
                                                         mask, cfg)
                correct_sum += float(correct)
                loss_sum += float(ce_sum)
        dt = time.perf_counter() - t0
        n = data.num_examples
        logger.log(
            epoch=epoch,
            avg_accuracy=correct_sum / n,
            avg_loss=loss_sum / n,
            epoch_seconds=dt,
            images_per_sec=n / dt,
        )
    save_params_csv(params)
    logger.close()


def run(num_predictions: int = -1, flags=None, cfg: Config = CONFIG) -> None:
    """Eval on the test set as one batch (model/mnist_nn.c:401-490);
    ``-1`` = whole set."""
    _, test_csv = synth.ensure_mnist(str(common.data_dir()))
    params = load_params_csv()
    data = MnistDataset.from_csv(test_csv)
    # reference: -1 (or over-ask) = whole set (model/mnist_nn.c:419-421);
    # 0/negative would divide by zero / build a negative-size batch
    n = data.num_examples if (num_predictions < 1
                              or num_predictions > data.num_examples) \
        else num_predictions
    print(f"Running predictions for {n} digits...", end="", flush=True)
    x, onehot, mask = _make_batch(data.x[:n], data.y[:n], n, cfg.layer_3)
    correct, _ = eval_batch(params, x, onehot, mask, cfg)
    acc = float(correct) / n
    print(f"done! Got {int(correct)} correct ({acc:.3f}).")


def main(argv=None) -> int:
    return common.run_cli("mnist_nn", init, train, run, argv=argv,
                          extra_flags=("dp", "per-batch", "batch",
                                       "scan-unroll"))


if __name__ == "__main__":
    raise SystemExit(main())
