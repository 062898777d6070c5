"""Sharding specs for DP/TP training.

Data parallel: shard the leading batch dimension over the ``data`` axis; XLA
inserts the gradient all-reduce (psum) automatically under jit.
Tensor parallel: shard dense-weight output dims over a ``model`` axis — the
TP mapping of the reference MLP GEMMs (SURVEY.md §2.4).
"""

from __future__ import annotations

from typing import Any

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def batch_sharding(mesh: Mesh, data_axis: str = "data") -> NamedSharding:
    """Shard dim 0 (batch); replicate the rest."""
    return NamedSharding(mesh, P(data_axis))


def replicate(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_params_tp(mesh: Mesh, params: Any, model_axis: str = "model") -> Any:
    """Place an MLP params pytree in a tensor-parallel layout: weight (in,out)
    matrices and (out,) biases shard their output dim over ``model_axis``,
    alternating with input-dim sharding on consecutive layers would need
    collectives between every GEMM — for these narrow MLPs output-dim
    sharding everywhere (all-gather at the loss) measures fastest.
    Scalars/rank-0 leaves replicate."""

    def place(x):
        if getattr(x, "ndim", 0) == 2:
            spec = P(None, model_axis)
        elif getattr(x, "ndim", 0) == 1:
            spec = P(model_axis)
        else:
            spec = P()
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree.map(place, params)
