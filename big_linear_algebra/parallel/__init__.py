"""Distribution: mesh construction, DP/TP shardings, collective helpers.

The reference has zero parallelism (SURVEY.md §2.4); this package is the
distribution layer all models share: a ``Mesh`` over the host's cards,
batch-dim data parallelism, optional tensor parallelism for the dense GEMMs,
and sequence-sharded ring attention (nn/attention.py builds on these).
No custom transport — XLA collectives only, which XLA hands to NCCL on the
GPU.
"""

from big_linear_algebra.parallel.mesh import (  # noqa: F401
    default_mesh,
    distributed_init,
    local_device_count,
    make_hybrid_mesh,
    make_mesh,
)
from big_linear_algebra.parallel.sharding import (  # noqa: F401
    batch_sharding,
    replicate,
    shard_params_tp,
)
from big_linear_algebra.parallel.pipeline import gpipe  # noqa: F401
from big_linear_algebra.parallel.ring_attention import (  # noqa: F401
    ring_attention,
)
