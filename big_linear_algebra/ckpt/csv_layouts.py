"""Reference-compatible CSV weight layouts.

Generic helpers for the per-model CSV checkpoint layouts the reference uses
(flat files for mnist_nn, model/mnist_nn.c:30-35,344-376; one file per
ensemble member for mnist_hinge, model/mnist_hinge.c:16-24; a directory tree
for cifar_unet, model/cifar_unet.c:1545-1660). Each model module declares its
own layout as a ``{name: (relative_path, shape)}`` spec and calls these.

Orientation note: the reference stores dense weights as (out, in) acting on
column-vector activations; our models are batch-major (batch, features) with
(in, out) weights. The per-model import/export code does the transpose so the
on-disk bytes stay reference-compatible.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping, Tuple

import numpy as np

from big_linear_algebra.data.csv import read_csv_matrix, write_csv_matrix


def save_matrices(base_dir: str,
                  arrays: Mapping[str, np.ndarray]) -> None:
    """Write each array to ``base_dir/<name>`` in reference CSV format.
    Names may contain subdirectories (the cifar_unet tree layout)."""
    base = Path(base_dir)
    for name, arr in arrays.items():
        write_csv_matrix(str(base / name), np.asarray(arr))


def load_matrices(base_dir: str,
                  spec: Mapping[str, Tuple[int, int]],
                  dtype=np.float32) -> Dict[str, np.ndarray]:
    """Load ``{name: (rows, cols)}`` CSVs from ``base_dir``."""
    base = Path(base_dir)
    return {
        name: read_csv_matrix(str(base / name), rows, cols, dtype=dtype)
        for name, (rows, cols) in spec.items()
    }


def layout_exists(base_dir: str, spec: Mapping[str, Tuple[int, int]]) -> bool:
    base = Path(base_dir)
    return all((base / name).is_file() for name in spec)
