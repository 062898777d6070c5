"""Smoke driver (≈ reference ``main.c``): exercises matmul, CSV IO, and a
2-layer Layer-graph net with the toy 0.1× linear activation, printing
before/after one backprop step (main.c:19-88).

Reads the reference's tiny fixtures when present (data/a.csv, b.csv,
inputs.csv, weights.csv, biases.csv — 3×3 / 3×1 / 3×2, main.c:43-70),
otherwise generates equivalents.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from big_linear_algebra.data.csv import read_csv_matrix, write_csv_matrix
from big_linear_algebra.models import common
from big_linear_algebra.nn import layer_graph
from big_linear_algebra.ops import matmul, print_matrix


def main(argv=None) -> int:
    base = common.data_dir()
    if not (base / "a.csv").is_file():
        rng = np.random.default_rng(42)
        write_csv_matrix(str(base / "a.csv"), rng.standard_normal((3, 3)))
        write_csv_matrix(str(base / "b.csv"), rng.standard_normal((3, 3)))
        write_csv_matrix(str(base / "inputs.csv"), rng.standard_normal((3, 1)))
        write_csv_matrix(str(base / "weights.csv"),
                         rng.standard_normal((2, 3)))
        write_csv_matrix(str(base / "biases.csv"), rng.standard_normal((2, 1)))

    # 1) matmul smoke (main.c:39-41)
    a = jnp.asarray(read_csv_matrix(str(base / "a.csv"), 3, 3))
    b = jnp.asarray(read_csv_matrix(str(base / "b.csv"), 3, 3))
    print_matrix(matmul(a, b), "a @ b")

    # 2) Layer-graph net with the toy 0.1x activation (main.c:7-17,52-83)
    x = jnp.asarray(read_csv_matrix(str(base / "inputs.csv"), 3, 1)[:, 0])
    w = jnp.asarray(read_csv_matrix(str(base / "weights.csv"), 2, 3))
    bias = jnp.asarray(read_csv_matrix(str(base / "biases.csv"), 2, 1)[:, 0])
    params = [(w, bias)]
    acts = ("scale_0.1",)
    out = layer_graph.predict(params, acts, x)
    print_matrix(np.asarray(out).reshape(-1, 1), "output before")
    target = jnp.asarray([1.0, 0.0])
    params = layer_graph.sgd_step(params, acts, x, target, 0.5)
    out = layer_graph.predict(params, acts, x)
    print_matrix(np.asarray(out).reshape(-1, 1), "output after one step")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
