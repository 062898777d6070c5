"""mnist_hinge: 10-model one-vs-rest linear hinge ensemble (≈ model/mnist_hinge.c).

Ten 784-weight linear classifiers, one per digit, trained with **full-batch**
hinge gradients per iteration and a convergence stop when the summed
per-model gradient norm (each normalized by the example count) drops below
0.05 (model/mnist_hinge.c:101-176). ``init`` uses scaled-uniform weights
U(−0.05, +0.05) with srand(42) (:14-25). CSV layout: weights_0..9.csv, one
line of 784 values each (:16-24).

Design: the ensemble is a single (784, 10) weight matrix; one
jit-compiled step computes all ten full-batch hinge gradients as one GEMM
pair (margins = X @ W, then maskᵀ-weighted Xᵀ @ (viol·y)) instead of the
reference's 10 × N × 784 scalar loops.

Intended-semantics deviations (SURVEY.md §7.9, policy §7): the reference
pairs gradient *ascent* (+lr·(−y·x) accumulated where ``y·wᵀx > 0``) with an
inverted score ``1 − wᵀx`` at prediction time — two mutually-consistent sign
inversions, plus a memset that only clears 196 of 784 floats. We implement
the textbook pair: descent on max(0, 1 − y·wᵀx) with argmax-of-``wᵀx``
scoring, and full gradient resets. Reference-trained weights can still be
evaluated by passing ``--reference-scoring`` to ``run``.
"""

from __future__ import annotations

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from big_linear_algebra.data.csv import read_csv_matrix, write_csv_matrix
from big_linear_algebra.data.mnist import MnistDataset, visualize_digit
from big_linear_algebra.data import synth
from big_linear_algebra.models import common
from big_linear_algebra.ops.precision import matmul_precision as _matmul_precision

EPSILON = 0.05  # convergence threshold, model/mnist_hinge.c:168


def ckpt_dir() -> Path:
    return common.data_dir() / "mnist_hinge"


def load_weights() -> jax.Array:
    """→ (784, 10): column d is model d's weight vector."""
    cols = [
        read_csv_matrix(str(ckpt_dir() / f"weights_{i}.csv"), 1, 784)[0]
        for i in range(10)
    ]
    return jnp.asarray(np.stack(cols, axis=1))


def save_weights(w: jax.Array) -> None:
    arr = np.asarray(w)
    for i in range(10):
        write_csv_matrix(str(ckpt_dir() / f"weights_{i}.csv"),
                         arr[:, i].reshape(1, -1))


def init(flags=None, seed: int = 42):
    """U(−0.05, 0.05) per weight (model/mnist_hinge.c:14-25's
    rand()/(10·RAND_MAX) − 0.05)."""
    key = jax.random.key(seed)
    w = jax.random.uniform(key, (784, 10), jnp.float32, -0.05, 0.05)
    save_weights(w)
    print(f"initialized parameters in {ckpt_dir()}")


def _chunk_body(y, x, lr, n_total, axis=None):
    """Shared per-iteration body with the reference's exact convergence
    semantics (model/mnist_hinge.c:158-171): the update is applied *before*
    the ε check, so the converging iteration's update lands; every later
    iteration leaves w frozen — chunked execution is then bit-equivalent to
    the reference's per-iteration break."""

    def body(carry, _):
        w, done = carry
        # explicit precision: a bare @ may run f32 in TF32; margins
        # within bf16 error of the 1.0 threshold would flip the violation
        # set and the EPSILON convergence stop (see nn/losses.py)
        prec = _matmul_precision(x.dtype)
        margins = y * jnp.matmul(x, w, precision=prec)
        viol = (margins < 1.0).astype(x.dtype)
        grads = -jnp.matmul(x.T, viol * y, precision=prec)
        if axis is not None:
            grads = jax.lax.psum(grads, axis)
        norms = jnp.sqrt(jnp.sum(grads * grads, axis=0)) / n_total
        w = jnp.where(done, w, w - lr * grads)
        done = jnp.logical_or(done, jnp.sum(norms) < EPSILON)
        return (w, done), norms

    return body


@functools.partial(jax.jit, static_argnames=("n_iters",),
                   donate_argnums=(0,))
def _train_chunk(w, x, labels, lr, n_iters: int = 10):
    """n_iters full-batch iterations in one dispatch (the reference logs and
    checks convergence every 10 iterations, :152 — the host only needs to
    see norms at that cadence). Returns (w, norms history (n_iters, 10))."""
    n = x.shape[0]
    y = jnp.where(jax.nn.one_hot(labels, 10, dtype=x.dtype) > 0, 1.0, -1.0)
    (w, _), norms = jax.lax.scan(
        _chunk_body(y, x, lr, n), (w, jnp.asarray(False)), None,
        length=n_iters)
    return w, norms


def make_train_chunk_dp(mesh, n_total: int, n_iters: int = 10,
                        axis: str = "data"):
    """DP chunk via shard_map: examples sharded over ``axis``, full-batch
    gradient assembled with one psum per iteration — the identical trajectory
    to ``_train_chunk`` (the hinge gradient is an example sum). ``n_total``
    is the true (unpadded) example count for the reference's norm/N metric;
    zero-padded example rows contribute exactly 0 to the gradient."""
    from jax.sharding import PartitionSpec as P

    from big_linear_algebra.parallel.spmd import shard_map_fn

    def local_chunk(w, x, labels, lr):
        y = jnp.where(jax.nn.one_hot(labels, 10, dtype=x.dtype) > 0,
                      1.0, -1.0)
        (w, _), norms = jax.lax.scan(
            _chunk_body(y, x, lr, n_total, axis), (w, jnp.asarray(False)),
            None, length=n_iters)
        return w, norms

    fn = shard_map_fn(local_chunk, mesh,
                      in_specs=(P(), P(axis), P(axis), P()),
                      out_specs=(P(), P()))
    return jax.jit(fn, donate_argnums=(0,))


def train(iterations: int, learn_rate: str = None, *args, flags=None):
    if learn_rate is None:
        print("Please supply a number of iterations and a learn rate, "
              "usage:\n\ttrain <iterations> <learn_rate>\n")
        return
    lr = float(learn_rate)
    train_csv, _ = synth.ensure_mnist(str(common.data_dir()))
    if not (ckpt_dir() / "weights_0.csv").is_file():
        print("no checkpoint found; initializing")
        init()
    w = load_weights()
    data = MnistDataset.from_csv(train_csv)
    x_np = data.x / 255.0                       # matrix_scale 1/255 (:125)
    labels_np = data.y.astype(np.int32)
    n_total = data.num_examples
    chunk_dp = None
    if "dp" in (flags or {}):
        from big_linear_algebra.parallel import default_mesh

        mesh = default_mesh()
        ndev = mesh.devices.size
        if ndev > 1:
            pad = (-n_total) % ndev  # zero rows: exactly 0 grad contribution
            if pad:
                x_np = np.concatenate(
                    [x_np, np.zeros((pad, x_np.shape[1]), x_np.dtype)])
                labels_np = np.concatenate(
                    [labels_np, np.zeros(pad, labels_np.dtype)])
            chunk_dp = functools.partial(make_train_chunk_dp, mesh, n_total)
        else:
            print("--dp: single device, running unsharded")
    x = jnp.asarray(x_np)
    labels = jnp.asarray(labels_np)
    dp_steps = {}
    i = 0
    while i < iterations:
        chunk = min(10, iterations - i)         # convergence cadence (:152)
        if chunk_dp is not None:
            if chunk not in dp_steps:
                dp_steps[chunk] = chunk_dp(chunk)
            w, norms_hist = dp_steps[chunk](w, x, labels, lr)
        else:
            w, norms_hist = _train_chunk(w, x, labels, lr, chunk)
        norms_hist = np.asarray(norms_hist)
        i += chunk
        if (i % 10 == 0) or i == iterations:    # logUpdate (:152)
            print(f"Gradient norms after iteration {i - 1}:")
            for j, nv in enumerate(norms_hist[-1]):
                print(f"\tModel {j}: {nv:.5f}")
        sums = norms_hist.sum(axis=1)
        if (sums < EPSILON).any():              # (:168-171)
            conv = i - chunk + int(np.argmax(sums < EPSILON))
            print(f"Gradient converged < epsilon after iteration {conv}")
            break
    save_weights(w)
    print("Finished training")


def run(num: int = -1, log_update_every: int = 1, flags=None):
    flags = flags or {}
    _, test_csv = synth.ensure_mnist(str(common.data_dir()))
    w = load_weights()
    data = MnistDataset.from_csv(test_csv)
    if num != -1 and num < 1:
        # 0 would divide by zero below; negatives would slice a wrong
        # prefix and print a negative "accuracy" (mnist_nn.run's guard)
        raise SystemExit(f"run: num predictions must be -1 or >= 1, "
                         f"got {num}")
    n = data.num_examples if (num == -1 or num > data.num_examples) else num
    x = data.x[:n] / 255.0
    # explicit precision: a bare @ may run f32 in TF32 on the GPU and
    # can flip close argmaxes vs the f64 oracle (repo policy)
    scores = np.asarray(jnp.matmul(jnp.asarray(x), w,
                                   precision=_matmul_precision(w.dtype)))
    if "reference-scoring" in flags:
        scores = 1.0 - scores                    # the reference's 1 − wᵀx (:70)
    preds = scores.argmax(axis=1)
    labels = data.y[:n].astype(np.int64)
    num_correct = int((preds == labels).sum())
    for i in range(n):
        if log_update_every > 0 and i % log_update_every == log_update_every - 1:
            print(f"Digit {i}:")
            print(visualize_digit(x[i], labels[i]))
            if preds[i] == labels[i]:
                print("\x1b[1;32mCORRECT\x1b[m")
            else:
                print(f"\x1b[1;31mINCORRECT\x1b[m predicted {preds[i]} "
                      f"instead of {labels[i]}")
            for p in range(10):
                print(f"\tModel {p}: {scores[i, p]:.2f}")
            print()
    print(f"Finished running with accuracy {num_correct / n:.5f}")


def main(argv=None) -> int:
    return common.run_cli(
        "mnist_hinge", init, train, run, argv=argv,
        train_usage="train <iterations> <learn_rate>",
        run_usage="run <num> [<output_every_n = 1>]",
        extra_flags=("dp", "reference-scoring"),
    )


if __name__ == "__main__":
    raise SystemExit(main())
