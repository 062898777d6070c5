"""mnist_nn end-to-end tests.

Parity strategy (SURVEY.md §4, §8.1):
- forward parity against the *actual C compute path* — the oracle's
  matrix_multiply / matrix_add_tile_columns / relu / softmax composed exactly
  as model/mnist_nn.c:221-234 — using the reference's shipped trained weights;
- gradient parity against the reference's hand-derived backward chain
  (model/mnist_nn.c:259-293) re-derived in float64 numpy with the intended
  col-sum semantics;
- training smoke: loss decreases, accuracy rises, CSV checkpoints round-trip;
- CLI verbs init|train|run run end-to-end on synthetic data.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from big_linear_algebra.models import mnist_nn
from tests import oracle

needs_ref = pytest.mark.skipif(
    not oracle.reference_available(), reason="no reference"
)

REF_CKPT = "/root/reference/data/mnist_nn"


def _ref_forward_c(params64, x64):
    """The reference forward pass executed by the compiled C library."""
    a = x64.T  # (784, B) column-major batch as in the reference
    for i in (1, 2, 3):
        w = params64[f"w{i}"].T  # (out, in)
        b = params64[f"b{i}"].reshape(-1, 1)
        z = oracle.c_matmul(w, a)
        z = oracle.c_add_tile_columns(z, b)
        a = oracle.c_relu(z) if i < 3 else oracle.c_softmax(z)
    return a.T  # (B, 10)


def _params64(params):
    return {k: np.asarray(v, np.float64) for k, v in params.items()}


@needs_ref
def test_forward_parity_with_reference_trained_weights(rng):
    params = mnist_nn.load_params_csv(base=__import__("pathlib").Path(REF_CKPT))
    x = rng.random((16, 784)).astype(np.float32)  # like scaled pixels
    logits = mnist_nn.forward(params, jnp.asarray(x))
    ours = np.asarray(jax.nn.softmax(logits, axis=-1))
    theirs = _ref_forward_c(_params64(params), x.astype(np.float64))
    np.testing.assert_allclose(ours, theirs, atol=1e-5)
    # prediction agreement
    assert (ours.argmax(-1) == theirs.argmax(-1)).all()


def _ref_backward_numpy(params64, x64, onehot64):
    """model/mnist_nn.c:259-293 re-derived in float64 (intended semantics)."""
    w1, w2, w3 = params64["w1"].T, params64["w2"].T, params64["w3"].T
    b1 = params64["b1"].reshape(-1, 1)
    b2 = params64["b2"].reshape(-1, 1)
    b3 = params64["b3"].reshape(-1, 1)
    x = x64.T            # (784, B)
    y = onehot64.T       # (10, B)
    z1 = w1 @ x + b1
    a1 = np.maximum(z1, 0)
    z2 = w2 @ a1 + b2
    a2 = np.maximum(z2, 0)
    z3 = w3 @ a2 + b3
    e = np.exp(z3 - z3.max(axis=0, keepdims=True))
    p = e / e.sum(axis=0, keepdims=True)

    scale = 1.0 / 784.0                       # :260
    dz3 = (p - y) * scale                     # :263-268
    dw3 = dz3 @ a2.T                          # :269
    db3 = dz3.sum(axis=1, keepdims=True)      # :271 (intended col_sum)
    dz2 = (w3.T @ dz3) * (z2 > 0)             # :273-278
    dw2 = dz2 @ a1.T
    db2 = dz2.sum(axis=1, keepdims=True)
    dz1 = (w2.T @ dz2) * (z1 > 0)
    dw1 = dz1 @ x.T
    db1 = dz1.sum(axis=1, keepdims=True)
    return {"w1": dw1.T, "b1": db1[:, 0], "w2": dw2.T, "b2": db2[:, 0],
            "w3": dw3.T, "b3": db3[:, 0]}


def test_gradient_parity_with_reference_derivation(rng):
    params = mnist_nn.init_params(jax.random.key(0))
    x = rng.random((8, 784)).astype(np.float32)
    y_idx = rng.integers(0, 10, 8)
    onehot = np.eye(10, dtype=np.float32)[y_idx]
    mask = np.ones((8,), np.float32)

    grads = jax.grad(
        lambda p: mnist_nn.loss_and_metrics(
            p, jnp.asarray(x), jnp.asarray(onehot), jnp.asarray(mask)
        )[0]
    )(params)

    want = _ref_backward_numpy(
        _params64(params), x.astype(np.float64), onehot.astype(np.float64)
    )
    for k in want:
        np.testing.assert_allclose(
            np.asarray(grads[k]), want[k], atol=1e-5,
            err_msg=f"gradient mismatch for {k}",
        )


def test_train_step_learns(rng, tmp_path):
    os.environ["BLA_DATA_DIR"] = str(tmp_path)
    try:
        from big_linear_algebra.data import synth, MnistDataset

        train_csv, _ = synth.ensure_mnist(str(tmp_path), train_n=512, test_n=64)
        data = MnistDataset.from_csv(train_csv)
        # hotter lr than the reference default so a short smoke test converges
        # (the reference's 1/784 gradient scale makes 0.02 an extremely small
        # effective step; it relies on many epochs over 60k examples)
        cfg = mnist_nn.Config(learn_rate=1.0)
        params = mnist_nn.init_params(jax.random.key(0), cfg)
        nprng = np.random.default_rng(0)
        first_loss, last_loss = None, None
        for _ in range(8):
            for xb, yb in data.epoch_batches(nprng, 64):
                x, onehot, mask = mnist_nn._make_batch(xb, yb, 64, 10)
                params, correct, ce = mnist_nn.train_step(
                    params, jnp.asarray(x), jnp.asarray(onehot),
                    jnp.asarray(mask), cfg)
                if first_loss is None:
                    first_loss = float(ce)
                last_loss = float(ce)
        assert last_loss < 0.5 * first_loss, (first_loss, last_loss)
    finally:
        del os.environ["BLA_DATA_DIR"]


def test_epoch_step_matches_per_batch(rng):
    """The fused lax.scan epoch must equal the sequential per-batch loop."""
    cfg = mnist_nn.Config(learn_rate=0.5)
    params = mnist_nn.init_params(jax.random.key(7), cfg)
    n_batches = 3
    batches = []
    for _ in range(n_batches):
        xb = rng.random((64, 784)).astype(np.float32) * 255
        yb = rng.integers(0, 10, 64).astype(np.float32)
        batches.append(mnist_nn._make_batch(xb, yb, 64, 10))

    p_seq = jax.tree.map(jnp.copy, params)
    tot_c, tot_l = 0.0, 0.0
    for x, onehot, mask in batches:
        p_seq, c, l = mnist_nn.train_step(
            p_seq, jnp.asarray(x), jnp.asarray(onehot), jnp.asarray(mask),
            cfg)
        tot_c += float(c)
        tot_l += float(l)

    xs = jnp.asarray(np.stack([b[0] for b in batches]))
    onehots = jnp.asarray(np.stack([b[1] for b in batches]))
    masks = jnp.asarray(np.stack([b[2] for b in batches]))
    p_fused, c_fused, l_fused = mnist_nn.epoch_step(
        jax.tree.map(jnp.copy, params), xs, onehots, masks, cfg)
    assert float(c_fused) == tot_c
    np.testing.assert_allclose(float(l_fused), tot_l, rtol=1e-5)
    for k in p_seq:
        np.testing.assert_allclose(np.asarray(p_fused[k]),
                                   np.asarray(p_seq[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_epoch_step_resident_matches_per_batch(rng):
    """Device-resident epoch (perm gather on device) == sequential steps,
    including the ragged-tail mask."""
    cfg = mnist_nn.Config(learn_rate=0.5)
    params = mnist_nn.init_params(jax.random.key(3), cfg)
    n = 150  # not a multiple of 64 -> ragged tail
    x = (rng.random((n, 784)) * 255).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.float32)
    perm_np = rng.permutation(n).astype(np.int32)
    padded = -(-n // 64) * 64
    perm = np.full(padded, -1, np.int32)
    perm[:n] = perm_np

    p_seq = jax.tree.map(jnp.copy, params)
    tot_c = tot_l = 0.0
    for start in range(0, padded, 64):
        idx = perm[start:start + 64]
        xb = x[np.clip(idx, 0, n - 1)]
        yb = y[np.clip(idx, 0, n - 1)]
        xq, onehot, mask = mnist_nn._make_batch(xb, yb, 64, 10)
        mask = (idx >= 0).astype(np.float32)
        onehot = onehot * mask[:, None]
        p_seq, c, l = mnist_nn.train_step(
            p_seq, jnp.asarray(xq), jnp.asarray(onehot), jnp.asarray(mask),
            cfg)
        tot_c += float(c)
        tot_l += float(l)

    p_res, c_res, l_res = mnist_nn.epoch_step_resident(
        jax.tree.map(jnp.copy, params), jnp.asarray(x), jnp.asarray(y),
        jnp.asarray(perm), cfg)
    assert float(c_res) == tot_c
    np.testing.assert_allclose(float(l_res), tot_l, rtol=1e-5)
    for k in p_seq:
        np.testing.assert_allclose(np.asarray(p_res[k]),
                                   np.asarray(p_seq[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_csv_checkpoint_roundtrip(tmp_path, rng):
    params = mnist_nn.init_params(jax.random.key(1))
    mnist_nn.save_params_csv(params, base=tmp_path)
    back = mnist_nn.load_params_csv(base=tmp_path)
    for k in params:
        np.testing.assert_allclose(
            np.asarray(back[k]), np.asarray(params[k]), atol=5e-7
        )


def test_cli_end_to_end(tmp_path, capsys):
    os.environ["BLA_DATA_DIR"] = str(tmp_path)
    try:
        from big_linear_algebra.data import synth

        synth.ensure_mnist(str(tmp_path), train_n=256, test_n=64)
        assert mnist_nn.main(["init"]) == 0
        assert mnist_nn.main(["train", "2"]) == 0
        out = capsys.readouterr().out
        assert "avg_accuracy" in out
        assert mnist_nn.main(["run", "32"]) == 0
        out = capsys.readouterr().out
        assert "correct" in out
        # whole-set eval
        assert mnist_nn.main(["run"]) == 0
        assert "64 digits" in capsys.readouterr().out
        # --scan-unroll reaches Config (epoch codegen knob, round 5);
        # non-positive values are loud
        assert mnist_nn.main(["train", "1", "--scan-unroll=2"]) == 0
        assert "avg_accuracy" in capsys.readouterr().out
        with pytest.raises(ValueError, match="must be positive"):
            mnist_nn.main(["train", "1", "--scan-unroll=0"])
    finally:
        del os.environ["BLA_DATA_DIR"]
