"""Host→device prefetching batch iterator.

The reference's data path is synchronous fgetc/lseek in the training thread
(lib/mnist_csv.c:6, lib/cifar10.c:13). The device equivalent overlaps
host batch assembly and HBM transfer with device compute: ``device_put`` is
async in JAX, so keeping a small queue of already-transferred batches ahead
of the consumer hides the host→HBM copy behind the previous step's compute.
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator, Optional

import jax


def prefetch_to_device(iterator: Iterable, size: int = 2,
                       sharding: Optional[jax.sharding.Sharding] = None
                       ) -> Iterator:
    """Yield items from ``iterator`` with ``size`` batches pre-transferred.

    ``sharding`` places each batch directly in its distributed layout (e.g.
    batch-dim sharded over a data-parallel mesh axis), so per-device shards
    are transferred without a gather/scatter hop.
    """
    queue = collections.deque()
    it = iter(iterator)

    def put(item):
        if sharding is not None:
            return jax.tree.map(lambda x: jax.device_put(x, sharding), item)
        return jax.tree.map(jax.device_put, item)

    try:
        for _ in range(size):
            queue.append(put(next(it)))
    except StopIteration:
        pass
    while queue:
        out = queue.popleft()
        try:
            queue.append(put(next(it)))
        except StopIteration:
            pass
        yield out
