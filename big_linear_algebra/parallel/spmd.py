"""shard_map-based SPMD execution: kernels run per-shard.

Why shard_map (and not sharding-annotated jit alone): under GSPMD auto
partitioning a ``pallas_call`` (the flash attention kernel) has no
partitioning rule, so a sharded train step could not reach it. Under
``shard_map`` the program is written *per shard*: every device runs its
kernels on its local block and the collectives (``psum`` / ``all_gather``)
are explicit in the step function — the scaling recipe SURVEY.md §2.4
commits to.

The model-specific SPMD train steps live next to their models
(models/mnist_nn.py, models/cifar_unet.py, models/mnist_hinge.py); this
module holds the shared plumbing.
"""

from __future__ import annotations

from typing import Any

import jax


def shard_map_fn(fn, mesh, in_specs, out_specs):
    """``jax.shard_map`` with the settings every SPMD step here needs:
    replication checking off because Pallas calls (and interpret-mode
    kernels on CPU test meshes) don't carry varying-mesh-axis metadata.
    The flag is ``check_vma`` on current jax; pre-promotion versions (where
    shard_map lives under experimental) call it ``check_rep``."""
    try:
        from jax import shard_map
        kw = {"check_vma": False}
    except ImportError:  # pragma: no cover - older jax
        from jax.experimental.shard_map import shard_map
        kw = {"check_rep": False}
    return shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                     **kw)


def psum_tree(tree: Any, axis_name: str) -> Any:
    """psum every leaf of a pytree over a mesh axis (gradient all-reduce)."""
    return jax.tree.map(lambda x: jax.lax.psum(x, axis_name), tree)


def pmean_tree(tree: Any, axis_name: str) -> Any:
    return jax.tree.map(lambda x: jax.lax.pmean(x, axis_name), tree)
