"""Shared helpers for the library's Pallas kernels.

One rule decides how a kernel runs, keyed on JAX's default backend:

- ``cpu``: the Pallas interpreter (tests and CPU rehearsals);
- ``gpu``: compiled for the route the kernel names (``backend="triton"``);
- anything else: an error. A kernel never falls back to the interpreter on
  an accelerator, where it would run correctly but orders of magnitude
  slower without saying so.
"""

from __future__ import annotations

import jax


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def next_pow2(x: int) -> int:
    return 1 << max(0, (int(x) - 1).bit_length())


def interpret_mode(backend: str | None = None) -> bool:
    """True on the CPU backend, False on the GPU, and an error elsewhere."""
    backend = backend or jax.default_backend()
    if backend == "cpu":
        return True
    if backend == "gpu":
        return False
    raise RuntimeError(
        f"no Pallas route for the {backend!r} backend: the library's kernels "
        f"compile for the GPU (Triton) and interpret on the CPU")
