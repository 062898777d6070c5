"""mnist (legacy): 784→200→200→10 Layer-graph MLP (≈ model/mnist.c).

Per-example online SGD through the ``Layer`` abstraction with squared-error
cost on softmax outputs, streaming examples from the MNIST CSV
(model/mnist.c:132-216). Rolling 20-step cost window during training
(:175-192), per-example prediction printouts + final accuracy in ``run``
(:48-131).

Intended-semantics deviations (SURVEY.md §7.7-7.8, policy §7):
- the output softmax forward is a true softmax (the reference divides raw
  logits by the sum of exponents, model/mnist.c:33); the backward keeps the
  reference's deliberate diagonal-only Jacobian (``softmax_legacy`` in
  nn/layer_graph.py)
- accuracy compares ``prediction == label`` (the reference has an off-by-one:
  ``prediction_index + 1 == label``, model/mnist.c:110)
- ``run``'s digit visualizer receives 1/255-scaled pixels (the reference
  visualizes unscaled values against 0-1 thresholds, §7.14)

Fidelity note: this model's learning dynamics are faithfully *weak* — the
reference's uniform(−0.5, 0.5) init saturates the 784-input first layer
(pre-activation std ≈ 8) and the deliberate diagonal softmax Jacobian
vanishes on saturated outputs, so accuracy stays near chance. That matches
the reference's own status: the legacy Layer-path models are commented out
of its build (build.sh:4-7, SURVEY.md §0) and superseded by mnist_nn, and no
trained data/mnist/ weights ship upstream. The capability (per-example
streaming SGD through the Layer graph) is what is ported and tested.

CSV layout (reference data/mnist/): hidden_weights.csv (200, 784),
hidden_weights_2.csv (200, 200), output_weights.csv (10, 200), and one-line
bias files. (The reference's *save* path writes hidden_weights_2 with a
784-value line width, overreading its 200×200 buffer — model/mnist.c:202; we
write the correct shapes, which its loader accepts since parsing is
comma-driven.)
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from big_linear_algebra.data.csv import read_csv_matrix, write_csv_matrix
from big_linear_algebra.data.mnist import MnistCSVStream, visualize_digit
from big_linear_algebra.data import synth
from big_linear_algebra.models import common
from big_linear_algebra.nn import layer_graph
from big_linear_algebra.nn.init import he_uniform, uniform_init

HIDDEN = 200  # HIDDEN_LAYER_SIZE, model/mnist.c:10
WINDOW = 20   # TRAINING_REPORT_COSTS_EVERY_N, :11
ACTS = ("relu", "relu", "softmax_legacy")
SHAPES = [((HIDDEN, 784), (HIDDEN,)),
          ((HIDDEN, HIDDEN), (HIDDEN,)),
          ((10, HIDDEN), (10,))]
_FILES = [("hidden_weights.csv", "hidden_biases.csv"),
          ("hidden_weights_2.csv", "hidden_biases_2.csv"),
          ("output_weights.csv", "output_biases.csv")]


def ckpt_dir() -> Path:
    return common.data_dir() / "mnist"


def load_params():
    base = ckpt_dir()
    params = []
    for (wf, bf), ((r, c), _) in zip(_FILES, SHAPES):
        w = read_csv_matrix(str(base / wf), r, c)
        b = read_csv_matrix(str(base / bf), 1, r)[0]
        params.append((jnp.asarray(w), jnp.asarray(b)))
    return params


def save_params(params):
    base = ckpt_dir()
    for (wf, bf), (w, b) in zip(_FILES, params):
        write_csv_matrix(str(base / wf), np.asarray(w))
        write_csv_matrix(str(base / bf), np.asarray(b).reshape(1, -1))


def init(flags=None, seed: int = 42):
    """Uniform(−0.5, 0.5) for weights AND biases (model/mnist.c:218-249).

    ``--he-init``: He-uniform weights + zero biases instead — the escape
    hatch from the reference's saturating init (see the fidelity note in the
    module docstring), demonstrating the Layer path *can* learn."""
    key = jax.random.key(seed)
    params = []
    he = "he-init" in (flags or {})
    for (shape_w, shape_b) in SHAPES:
        key, kw, kb = jax.random.split(key, 3)
        if he:
            params.append((he_uniform(kw, shape_w, fan_in=shape_w[1]),
                           jnp.zeros(shape_b, jnp.float32)))
        else:
            params.append((uniform_init(kw, shape_w),
                           uniform_init(kb, shape_b)))
    save_params(params)
    print(f"initialized parameters in {ckpt_dir()}")


def train(iterations: int, learn_rate: str = None, should_output: str = "1",
          *args, flags=None):
    if learn_rate is None:
        print("Please supply a number of iterations and a learn rate, "
              "usage:\n\ttrain <iterations> <learn_rate> [<output=1>]\n")
        return
    lr = float(learn_rate)
    should_output = bool(int(should_output))
    train_csv, _ = synth.ensure_mnist(str(common.data_dir()))
    if not (ckpt_dir() / "hidden_weights.csv").is_file():
        print("no checkpoint found; initializing")
        init(flags=flags)  # forward --he-init: silently dropping the
        # user's explicit escape hatch here would run the saturating
        # reference init they asked to avoid
    params = load_params()
    # Stage the streamed examples (file order, wrapping at EOF — the
    # reference's fgetc stream, lib/mnist_csv.c:6) and run all per-example
    # SGD steps in one device dispatch.
    stream = MnistCSVStream(train_csv)
    xs = np.zeros((iterations, 784), np.float32)
    ys = np.zeros((iterations, 10), np.float32)
    for i in range(iterations):
        if not stream.get_next_data():           # wrap at EOF
            stream.close()
            stream = MnistCSVStream(train_csv)
            stream.get_next_data()
        xs[i] = stream.buffer[1:] / 255.0
        ys[i, int(stream.buffer[0])] = 1.0
    stream.close()
    run_scan = layer_graph.make_sgd_scan(ACTS)
    params, costs = run_scan(params, jnp.asarray(xs), jnp.asarray(ys), lr)
    costs = np.asarray(costs)
    prev_costs = costs[max(0, iterations - WINDOW):]
    if should_output:
        for i in range(WINDOW - 1, iterations, WINDOW):
            win = costs[i - WINDOW + 1:i + 1]
            print(f"Last {WINDOW} costs:")
            for j, c in enumerate(win):
                print(f"\tCost[{j}]: {c:.3f}")
            print(f"\tAvg: {win.mean():.3f}")
    else:
        print(f"Final batch avg: {prev_costs.mean():.3f}")
    save_params(params)
    print("Finished training")


def run(num: int = -1, report_every_n: int = 1, flags=None):
    _, test_csv = synth.ensure_mnist(str(common.data_dir()))
    params = load_params()
    stream = MnistCSVStream(test_csv)
    num_correct = 0
    total = 0
    predict = jax.jit(
        lambda p, x: layer_graph.predict(p, ACTS, x))
    i = 0
    while (num == -1 or i < num) and stream.get_next_data():
        report = report_every_n > 0 and i % report_every_n == report_every_n - 1
        label = int(stream.buffer[0])
        pixels = stream.buffer[1:] / 255.0
        out = np.asarray(predict(params, jnp.asarray(pixels)))
        prediction = int(out.argmax())
        if report:
            print(visualize_digit(pixels, label))
            print("Predictions:")
            for d, v in enumerate(out):
                print(f"\t{d}: {v:.2f}")
        onehot = np.zeros(10)
        onehot[label] = 1
        cost = float(((onehot - out) ** 2).sum())
        if prediction == label:
            num_correct += 1
            if report:
                print(f"Correct with cost: {cost:.2f}")
        elif report:
            print(f"Incorrect with cost: {cost:.2f}")
        i += 1
        total = i
    stream.close()
    if total:
        pct = num_correct / total
        print(f"\nGot {num_correct} correct out of {total}, ({pct:.2f}%)")


def main(argv=None) -> int:
    return common.run_cli(
        "mnist", init, train, run, argv=argv,
        train_usage="train <iterations> <learn_rate> [<output=1>]",
        run_usage="run <num> [<output_every_n = 1>]",
        extra_flags=("he-init",),
        unsupported_flags={
            "dp": "per-example online SGD is inherently sequential "
                  "(each step's weights depend on the previous example, "
                  "model/mnist.c:158-173); use mnist_nn for data-parallel "
                  "minibatch training"},
    )


if __name__ == "__main__":
    raise SystemExit(main())
