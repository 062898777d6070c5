"""Tests for the Layer-graph module and the three legacy model programs."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from big_linear_algebra.nn import layer_graph


@pytest.fixture
def env_data_dir(tmp_path):
    os.environ["BLA_DATA_DIR"] = str(tmp_path)
    yield tmp_path
    del os.environ["BLA_DATA_DIR"]


# ---------------------------------------------------------------------------
# layer_graph core
# ---------------------------------------------------------------------------


def _random_params(rng, sizes):
    return [
        (jnp.asarray(rng.standard_normal((o, i)) * 0.5),
         jnp.asarray(rng.standard_normal(o) * 0.1))
        for i, o in zip(sizes[:-1], sizes[1:])
    ]


def test_sgd_step_equals_gradient_descent_for_relu(rng):
    """For exact-derivative activations, the reference recursion (lib/layer.c)
    must equal plain gradient descent on the squared-error cost."""
    sizes = (4, 6, 3)
    acts = ("relu", "relu")
    params = _random_params(rng, sizes)
    x = jnp.asarray(rng.standard_normal(4))
    y = jnp.asarray(rng.standard_normal(3))
    lr = 0.05

    stepped = layer_graph.sgd_step(params, acts, x, y, lr)
    grads = jax.grad(lambda p: layer_graph.cost(p, acts, x, y))(params)
    for (w_new, b_new), (w, b), (gw, gb) in zip(stepped, params, grads):
        np.testing.assert_allclose(np.asarray(w_new), np.asarray(w - lr * gw),
                                   rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(np.asarray(b_new), np.asarray(b - lr * gb),
                                   rtol=1e-6, atol=1e-8)


def test_softmax_legacy_diagonal_jacobian(rng):
    """softmax_legacy backward uses p(1−p) per element (the reference's
    deliberate independence approximation, model/mnist.c:37-46)."""
    params = _random_params(rng, (5, 4))
    acts = ("softmax_legacy",)
    x = jnp.asarray(rng.standard_normal(5))
    y = jnp.asarray(np.eye(4)[1])
    lr = 0.1
    (w, b) = params[0]
    raw = np.asarray(w) @ np.asarray(x) + np.asarray(b)
    e = np.exp(raw - raw.max())
    p = e / e.sum()
    delta = (p * (1 - p)) * (2 * (p - np.asarray(y)))
    want_w = np.asarray(w) - lr * np.outer(delta, np.asarray(x))
    (w_new, b_new), = layer_graph.sgd_step(params, acts, x, y, lr)
    np.testing.assert_allclose(np.asarray(w_new), want_w, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(b_new),
                               np.asarray(b) - lr * delta, rtol=1e-5,
                               atol=1e-7)


def test_predict_batch_matches_single(rng):
    params = _random_params(rng, (3, 5, 2))
    acts = ("relu", "linear")
    xb = jnp.asarray(rng.standard_normal((7, 3)))
    batched = layer_graph.predict_batch(params, acts, xb)
    for i in range(7):
        single = layer_graph.predict(params, acts, xb[i])
        np.testing.assert_allclose(np.asarray(batched[i]), np.asarray(single),
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# my_first_model
# ---------------------------------------------------------------------------


def test_my_first_model_end_to_end(env_data_dir, capsys):
    from big_linear_algebra.data.csv import write_csv_matrix
    from big_linear_algebra.models import my_first_model as mfm

    assert mfm.main(["init"]) == 0
    assert mfm.main(["train", "800", "0.1"]) == 0
    out = capsys.readouterr().out
    assert "Finished training" in out
    # the last rolling-cost window should be far below the first
    costs = [float(l.split("Avg:")[1]) for l in out.splitlines() if "Avg:" in l]
    assert costs[-1] < costs[0]

    # same-sign input → "Same sign!"
    write_csv_matrix(str(env_data_dir / "my_first_model/input_nodes.csv"),
                     np.array([[0.7, 0.8]], np.float32))
    assert mfm.main(["run"]) == 0
    assert "Same sign!" in capsys.readouterr().out

    write_csv_matrix(str(env_data_dir / "my_first_model/input_nodes.csv"),
                     np.array([[-0.7, 0.8]], np.float32))
    assert mfm.main(["run"]) == 0
    assert "Different signs!" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# mnist (legacy)
# ---------------------------------------------------------------------------


def test_mnist_legacy_cli_smoke(env_data_dir, capsys):
    from big_linear_algebra.data import synth
    from big_linear_algebra.models import mnist as mnist_legacy

    synth.ensure_mnist(str(env_data_dir), train_n=64, test_n=32)
    assert mnist_legacy.main(["init"]) == 0
    assert mnist_legacy.main(["train", "40", "0.05", "0"]) == 0
    out = capsys.readouterr().out
    assert "Finished training" in out
    assert mnist_legacy.main(["run", "10", "5"]) == 0
    out = capsys.readouterr().out
    assert "correct out of" in out
    assert "Predictions:" in out


# ---------------------------------------------------------------------------
# mnist_hinge
# ---------------------------------------------------------------------------


def test_mnist_hinge_trains_and_evaluates(env_data_dir, capsys):
    from big_linear_algebra.data import synth
    from big_linear_algebra.models import mnist_hinge

    synth.ensure_mnist(str(env_data_dir), train_n=512, test_n=128)
    assert mnist_hinge.main(["init"]) == 0
    assert mnist_hinge.main(["train", "100", "0.0005"]) == 0
    out = capsys.readouterr().out
    assert "Finished training" in out
    assert "Gradient norms" in out
    # eval without per-digit logging
    assert mnist_hinge.main(["run", "-1", "0"]) == 0
    out = capsys.readouterr().out
    acc = float(out.split("accuracy")[1])
    # linear one-vs-rest on the 7-segment synthetic data should beat chance
    # by a wide margin
    assert acc > 0.5, out


def test_hinge_convergence_freezes_updates(rng):
    """Reference semantics (model/mnist_hinge.c:158-176): the converging
    iteration's update is applied, then the loop breaks — later iterations in
    a fused chunk must leave the weights untouched."""
    import jax
    import jax.numpy as jnp

    from big_linear_algebra.models import mnist_hinge

    # one tiny example: per-model grad norm = |x|₂, summed over 10 models
    # → 10·|x|₂ ≈ 0.0032 < ε = 0.05, so iteration 0 converges (grads ≠ 0)
    x = jnp.asarray(rng.normal(0, 0.0001, (1, 784)), jnp.float32)
    labels = jnp.asarray([3], jnp.int32)
    w0 = jnp.asarray(rng.normal(0, 0.01, (784, 10)), jnp.float32)
    lr = 0.5

    y = jnp.where(jax.nn.one_hot(labels, 10, dtype=x.dtype) > 0, 1.0, -1.0)
    viol = ((y * (x @ w0)) < 1.0).astype(x.dtype)
    g0 = -(x.T @ (viol * y))
    w_expect = w0 - lr * g0                      # exactly ONE update

    w_out, norms = mnist_hinge._train_chunk(jnp.copy(w0), x, labels, lr, 10)
    assert float(jnp.sum(norms[0])) < mnist_hinge.EPSILON
    assert float(jnp.max(jnp.abs(g0))) > 0.0
    np.testing.assert_allclose(np.asarray(w_out), np.asarray(w_expect),
                               rtol=1e-6, atol=1e-8)
    # and NOT ten updates (the old chunked behavior)
    assert float(jnp.max(jnp.abs(w_out - (w0 - 10 * lr * g0)))) > 0


def test_mnist_legacy_he_init_learns(env_data_dir, capsys):
    """--he-init escape hatch: the Layer path CAN learn when initialized
    sanely (the default uniform(−.5,.5) init saturates by design — reference
    parity; see models/mnist.py docstring)."""
    from big_linear_algebra.data import synth
    from big_linear_algebra.models import mnist as mnist_legacy

    synth.ensure_mnist(str(env_data_dir), train_n=256, test_n=64)
    assert mnist_legacy.main(["init", "--he-init"]) == 0
    assert mnist_legacy.main(["train", "600", "0.05", "0"]) == 0
    out = capsys.readouterr().out
    final = float(out.split("Final batch avg:")[1].split()[0])
    assert final < 0.5, f"he-init Layer path failed to learn: {out[-400:]}"


def test_cli_rejects_unknown_and_unsupported_flags(capsys):
    from big_linear_algebra.models import mnist_nn, my_first_model
    from big_linear_algebra.models import mnist as mnist_legacy

    assert mnist_nn.main(["train", "1", "--bogus"]) == 1
    assert "Unrecognized flag --bogus" in capsys.readouterr().out
    # --dp on the online-SGD models: explicit rejection with the reason
    assert my_first_model.main(["train", "1", "0.1", "--dp"]) == 1
    assert "not supported" in capsys.readouterr().out
    assert mnist_legacy.main(["train", "1", "0.1", "--dp"]) == 1
    assert "sequential" in capsys.readouterr().out


def test_mnist_hinge_run_guards_bad_counts(env_data_dir):
    """run 0 previously died with ZeroDivisionError after all the work;
    negatives printed a negative 'accuracy' over a wrong slice."""
    from big_linear_algebra.models import mnist_hinge

    assert mnist_hinge.main(["init"]) == 0
    with pytest.raises(SystemExit):
        mnist_hinge.main(["run", "0"])
    with pytest.raises(SystemExit):
        mnist_hinge.main(["run", "-2"])


def test_mnist_train_autoinit_forwards_he_flag(env_data_dir, monkeypatch):
    """train --he-init on a fresh dir must apply the flag in the automatic
    init (it was previously dropped: init() was called with flags=None)."""
    from big_linear_algebra.models import mnist

    seen = {}
    real_init = mnist.init

    def spy(flags=None):
        seen["flags"] = flags
        return real_init(flags=flags)

    monkeypatch.setattr(mnist, "init", spy)
    assert mnist.main(["train", "2", "0.01", "--he-init"]) == 0
    assert seen["flags"] is not None and "he-init" in seen["flags"]


def test_mnist_stream_eof_terminated_last_value(tmp_path):
    """An MNIST CSV whose last line ends at EOF (no trailing comma or
    newline) must still yield its final example — the csv format contract
    accepts EOF-terminated values."""
    from big_linear_algebra.data.mnist import MnistCSVStream

    vals1 = ",".join(str(v) for v in range(785))
    vals2 = ",".join(str(v + 1) for v in range(785))
    p = tmp_path / "t.csv"
    p.write_text(vals1 + ",\n" + vals2)  # second line EOF-terminated
    stream = MnistCSVStream(str(p))
    assert stream.get_next_data()
    assert stream.buffer[0] == 0 and stream.buffer[784] == 784
    assert stream.get_next_data(), "EOF-terminated final example dropped"
    assert stream.buffer[0] == 1 and stream.buffer[784] == 785
    assert not stream.get_next_data()
    stream.close()
