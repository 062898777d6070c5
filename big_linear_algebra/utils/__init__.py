"""Debugging / validation utilities (SURVEY.md §5 "Race detection /
sanitizers" row): the JAX equivalents of the reference's ASan +
-Wall -Werror safety net."""

from big_linear_algebra.utils.debug import (  # noqa: F401
    checked,
    debug_nans,
    no_jit,
    validate_finite,
)
