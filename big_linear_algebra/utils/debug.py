"""Runtime-validation helpers (≈ the reference's safety net, SURVEY.md §5).

The reference leans on AddressSanitizer + -Wall -Wextra -Werror (build.sh:1)
and printf-and-exit dimension checks (lib/matrix.c:36-39). The JAX
equivalents:

- trace-time shape/dtype errors are free (every op in ``ops``/``nn`` raises
  typed ``ValueError``s before compilation);
- ``checked``: wraps a function with ``jax.experimental.checkify`` so
  division-by-zero / NaN / OOB-index errors inside jitted code surface as
  Python errors instead of silent garbage;
- ``debug_nans`` / ``no_jit``: context managers over the corresponding JAX
  escape hatches (also exposed as --debug-nans / --disable-jit CLI flags in
  models/common.py);
- ``validate_finite``: host-side pytree assertion for tests and checkpoints.
"""

from __future__ import annotations

import contextlib
from typing import Any

import jax
import numpy as np


def checked(fn, errors=None):
    """Return a jittable, checkify-instrumented version of ``fn`` that raises
    on NaN / div-by-zero / OOB indexing. Usage::

        safe_step = checked(train_step)
        out = safe_step(params, batch)   # raises JaxRuntimeError on NaN
    """
    from jax.experimental import checkify

    if errors is None:
        errors = checkify.float_checks | checkify.index_checks \
            | checkify.div_checks

    cfn = checkify.checkify(fn, errors=errors)

    def wrapper(*args, **kwargs):
        err, out = cfn(*args, **kwargs)
        checkify.check_error(err)
        return out

    return wrapper


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", enable)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


@contextlib.contextmanager
def no_jit():
    """Escape hatch: run everything op-by-op for debugging."""
    with jax.disable_jit():
        yield


def validate_finite(tree: Any, name: str = "pytree") -> None:
    """Host-side: raise if any leaf contains non-finite values."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        arr = np.asarray(leaf)
        if not np.isfinite(arr).all():
            raise FloatingPointError(
                f"{name}{jax.tree_util.keystr(path)} contains non-finite "
                f"values")
