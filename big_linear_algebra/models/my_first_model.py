"""my_first_model: 2→3→2 ReLU MLP sign classifier (≈ model/my_first_model.c).

Learns whether two numbers share a sign: output close to [1, 0] for same
sign, [0, 1] for different (model/my_first_model.c:139-143). Online SGD
against synthetic uniform data cycling the four sign quadrants (:71-97),
squared-error cost with a rolling 20-step cost window (:102-116).

CSV layout (shipped trained weights in reference data/my_first_model/):
hidden_weights.csv (3, 2), hidden_biases.csv (1 line of 3),
output_weights.csv (2, 3), output_biases.csv (1 line of 2),
input_nodes.csv (the run input, 1 line of 2).

Deviations (intended semantics, SURVEY.md §7.14): train does not clobber
input_nodes.csv with zeros on save (the reference writes dummy 0s,
model/my_first_model.c:119-120); RNG is jax.random, not global rand().
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from big_linear_algebra.data.csv import read_csv_matrix, write_csv_matrix
from big_linear_algebra.models import common
from big_linear_algebra.nn import layer_graph
from big_linear_algebra.nn.init import uniform_init

ACTS = ("relu", "relu")
SHAPES = [((3, 2), (3,)), ((2, 3), (2,))]
_FILES = [("hidden_weights.csv", "hidden_biases.csv"),
          ("output_weights.csv", "output_biases.csv")]


def ckpt_dir() -> Path:
    return common.data_dir() / "my_first_model"


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
    """U(−0.5, 0.5) weights, small positive biases. (The reference ships
    trained weights and has no init verb for this model; zero biases leave
    this tiny all-ReLU net prone to dead units, so biases start at 0.1.)"""
    key = jax.random.key(seed)
    params = []
    for (shape_w, shape_b) in SHAPES:
        key, kw = jax.random.split(key)
        params.append((uniform_init(kw, shape_w),
                       jnp.full(shape_b, 0.1, jnp.float32)))
    save_params(params)
    # default run input (the reference ships one in data/my_first_model/)
    input_path = ckpt_dir() / "input_nodes.csv"
    if not input_path.is_file():
        write_csv_matrix(str(input_path), np.array([[0.5, 0.5]], np.float32))
    print(f"initialized parameters in {ckpt_dir()}")


def _synth_example(rng: np.random.Generator, i: int):
    """The reference's quadrant-cycling data synthesis
    (model/my_first_model.c:71-97): i%4 picks the sign pattern; expectation
    alternates [1,0] (same sign) / [0,1] (different) with i%2."""
    a, b = rng.random(), rng.random()
    signs = [(1, 1), (-1, 1), (-1, -1), (1, -1)][i % 4]
    x = np.array([signs[0] * a, signs[1] * b], np.float32)
    y = np.array([1.0, 0.0] if i % 2 == 0 else [0.0, 1.0], np.float32)
    return x, y


def train(iterations: int, learn_rate: str = None, *args, flags=None):
    if learn_rate is None:
        print("Please supply a number of iterations and a learn rate, "
              "usage:\n\ttrain <iterations> <learn_rate>\n")
        return
    lr = float(learn_rate)
    if not (ckpt_dir() / "hidden_weights.csv").is_file():
        print("no checkpoint found; initializing")
        init()
    params = load_params()
    rng = np.random.default_rng(42)
    window = 20  # report_costs_every_n, model/my_first_model.c:69
    # pre-generate the synthetic stream, run all online-SGD steps in one
    # dispatch (identical example order/semantics to the per-step loop)
    xs = np.zeros((iterations, 2), np.float32)
    ys = np.zeros((iterations, 2), np.float32)
    for i in range(iterations):
        xs[i], ys[i] = _synth_example(rng, i)
    run_scan = layer_graph.make_sgd_scan(ACTS)
    params, costs = run_scan(params, jnp.asarray(xs), jnp.asarray(ys), lr)
    costs = np.asarray(costs)
    for i in range(window - 1, iterations, window):
        prev_costs = costs[i - window + 1:i + 1]
        print(f"Last {window} costs:")
        for j, c in enumerate(prev_costs):
            print(f"\tCost[{j}]: {c:.3f}")
        print(f"\tAvg: {prev_costs.mean():.3f}")
    save_params(params)
    print("Finished training")


def run(num: int = -1, flags=None):
    """Classify the pair in input_nodes.csv (model/my_first_model.c:22-54)."""
    params = load_params()
    x = read_csv_matrix(str(ckpt_dir() / "input_nodes.csv"), 1, 2)[0]
    out = layer_graph.predict(params, ACTS, jnp.asarray(x))
    out = np.asarray(out)
    for v in out:
        print(f"{v: .6f}")
    if out[0] > out[1]:
        print("Same sign!")
    else:
        print("Different signs!")


def main(argv=None) -> int:
    return common.run_cli(
        "my_first_model", init, train, run, argv=argv,
        train_usage="train <iterations> <learn_rate>",
        run_usage="run",
        unsupported_flags={
            "dp": "per-example online SGD on synthesized single examples is "
                  "inherently sequential (model/my_first_model.c:99-105); "
                  "use mnist_nn for data-parallel minibatch training"},
    )


if __name__ == "__main__":
    raise SystemExit(main())
