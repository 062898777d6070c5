"""MNIST-CSV loaders (≈ lib/mnist_csv.c streaming + lib/mnist_csv2.c in-RAM).

File format: one example per line, ``label,p0,...,p783,`` with pixel values
0-255 (785 values/line, lib/mnist_csv2.c:8).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from big_linear_algebra.data.csv import read_csv_values

MNIST_LINE_LENGTH = 785
MNIST_PIXELS = 784
MNIST_DIM = 28


class MnistCSVStream:
    """Streaming one-example-at-a-time reader (≈ ``MnistCSV`` +
    ``get_next_data``, lib/mnist_csv.c:6): used by the legacy per-example
    models. Parses lazily so huge files need no RAM."""

    def __init__(self, path: str):
        self.path = path
        self._file = open(path, "r")
        self.buffer = np.zeros(MNIST_LINE_LENGTH, dtype=np.float32)

    def get_next_data(self) -> bool:
        """Fill ``self.buffer`` with the next label+784 pixels. Returns False
        at EOF (reference returns 1, lib/mnist_csv.c:7-10)."""
        index = 0
        token = []
        while index < MNIST_LINE_LENGTH:
            c = self._file.read(1)
            if not c:
                # EOF-terminated last value (no trailing comma/newline):
                # data/csv.py's format contract accepts it, so a fully-read
                # final example must not be discarded here either
                if token and index == MNIST_LINE_LENGTH - 1:
                    self.buffer[index] = float("".join(token))
                    token.clear()
                    return True
                return False
            if c == "," or (c == "\n" and token):
                self.buffer[index] = float("".join(token)) if token else 0.0
                token.clear()
                index += 1
            elif c not in "\n\r":
                token.append(c)
        return True

    def __iter__(self) -> Iterator[np.ndarray]:
        while self.get_next_data():
            yield self.buffer.copy()

    def close(self):
        self._file.close()


def visualize_digit(pixels: np.ndarray, label=None) -> str:
    """ASCII-art digit rendering (≈ ``visualize_digit_data``,
    lib/mnist_csv.c:31-47). ``pixels`` must be scaled to [0, 1]; thresholds
    are the reference's 0.32/0.6 (the reference's legacy ``mnist run`` passes
    unscaled 0-255 values here — SURVEY.md §7.14 — callers should scale)."""
    pixels = np.asarray(pixels).reshape(MNIST_DIM, MNIST_DIM)
    lines = ["=" * MNIST_DIM]
    if label is not None:
        lines.append(f"Data for digit {label:.0f}:")
    for row in pixels:
        lines.append(
            "".join(" " if v < 0.32 else (":" if v < 0.6 else "#") for v in row)
        )
    lines.append("=" * MNIST_DIM)
    return "\n".join(lines)


@dataclasses.dataclass
class MnistDataset:
    """Whole-file in-RAM dataset with sampling (≈ ``mnist_csv_init`` +
    ``get_random_data_{replace,take}``, lib/mnist_csv2.c:13-62).

    ``x``: (N, 784) float32, raw 0-255 pixel values (scaling, e.g. 1/255 as in
    model/mnist_nn.c:218, is the model's job). ``y``: (N,) float32 labels.
    Batch-major layout — the accelerator-idiomatic equivalent of the reference's
    example-major-interleaved storage (lib/mnist_csv2.c:29).
    """

    x: np.ndarray
    y: np.ndarray

    @property
    def num_examples(self) -> int:
        return self.x.shape[0]

    @classmethod
    def from_csv(cls, path: str) -> "MnistDataset":
        values = read_csv_values(path)
        n = values.size // MNIST_LINE_LENGTH
        values = values[: n * MNIST_LINE_LENGTH].reshape(n, MNIST_LINE_LENGTH)
        return cls(x=np.ascontiguousarray(values[:, 1:]),
                   y=np.ascontiguousarray(values[:, 0]))

    def sample_with_replacement(self, rng: np.random.Generator, batch: int):
        """Uniform with replacement (≈ get_random_data_replace,
        lib/mnist_csv2.c:36)."""
        idx = rng.integers(0, self.num_examples, size=batch)
        return self.x[idx], self.y[idx]

    def epoch_batches(self, rng: np.random.Generator, batch: int,
                      drop_remainder: bool = False):
        """Without-replacement epoch sweep via permutation — the intended
        semantics of ``get_random_data_take`` (lib/mnist_csv2.c:41; the
        reference's bitmap scan has a boundary off-by-one that can re-pick a
        sampled index, SURVEY.md §7.14)."""
        perm = rng.permutation(self.num_examples)
        stop = (self.num_examples // batch) * batch if drop_remainder \
            else self.num_examples
        for start in range(0, stop, batch):
            idx = perm[start:start + batch]
            yield self.x[idx], self.y[idx]
