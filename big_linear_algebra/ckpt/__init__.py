"""Checkpointing: pytree checkpoints + reference-compatible CSV layouts.

The reference's checkpoint format *is* CSV (lib/csv.c writers; per-model
layouts in SURVEY.md §5 "Checkpoint / resume"). We keep that as a
bit-compatible interchange layer (so the shipped trained weights load for
parity tests and our checkpoints load in the reference), and add a pytree
checkpoint (numpy ``.npz`` plus a JSON manifest, ckpt/pytree.py) as the
train-state format: atomic, asynchronous through a writer thread, restored
onto the target tree's shardings and dtypes.
"""

from big_linear_algebra.ckpt.csv_layouts import (  # noqa: F401
    load_matrices,
    save_matrices,
)
from big_linear_algebra.ckpt.pytree import (  # noqa: F401
    latest_step,
    restore_pytree,
    save_pytree,
)
