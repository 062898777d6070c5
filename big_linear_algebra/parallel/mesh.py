"""Device-mesh construction.

≈ nothing in the reference (single thread, SURVEY.md §2.4); this is the
framework's substrate for every distributed feature. Meshes are standard
``jax.sharding.Mesh`` objects so all sharded code works identically on one
card, the four NVLink-connected cards of one host, or a CPU host with
``--xla_force_host_platform_device_count`` virtual devices (how tests
validate multi-device behavior without hardware). Every card of a host
reaches every other at the same NVLink rate, so a mesh is a plain reshape of
the device list and its shape follows the algorithm alone.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def local_device_count() -> int:
    """Devices attached to THIS process (== jax.devices() on a single host;
    a strict subset across several hosts)."""
    return len(jax.local_devices())


def make_mesh(axes: Mapping[str, int],
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Build a named mesh, e.g. ``make_mesh({"data": 4, "model": 2})``.

    Axis sizes must multiply to the device count; devices fill the mesh in
    their listed order."""
    names = tuple(axes.keys())
    shape = tuple(axes.values())
    if devices is None:
        devices = jax.devices()
    n = int(np.prod(shape))
    if n != len(devices):
        raise ValueError(
            f"mesh shape {dict(axes)} needs {n} devices, have {len(devices)}"
        )
    return Mesh(np.asarray(devices).reshape(shape), names)


def default_mesh(data_axis: str = "data") -> Mesh:
    """All local devices on one data-parallel axis."""
    return make_mesh({data_axis: local_device_count()},
                     devices=jax.local_devices())


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> int:
    """Multi-process bring-up: ``jax.distributed.initialize`` when a
    coordinator is given, a no-op otherwise (SURVEY.md §5 distributed-comm
    row). Nothing is discovered from the environment: pass
    ``coordinator_address`` (e.g. ``"localhost:12345"``), ``num_processes``
    and ``process_id``. Safe to call twice. Returns the process index (0 on
    a single process)."""
    if jax.distributed.is_initialized():
        return jax.process_index()
    if coordinator_address is None:
        return 0
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return jax.process_index()


def make_hybrid_mesh(host_axes: Mapping[str, int],
                     local_axes: Mapping[str, int]) -> Mesh:
    """Two-level mesh for several hosts: ``host_axes`` partition across
    processes (the slow inter-host network — put only the data-parallel axis
    here), ``local_axes`` within a process's cards (NVLink — for TP/SP/PP).
    Axis order is host axes first, then local axes.

    With one process every device is local, so host axes must be size 1 and
    the result is the flat mesh."""
    names = tuple(host_axes.keys()) + tuple(local_axes.keys())
    if len(set(names)) != len(names):
        dup = sorted(n for n in set(names) if names.count(n) > 1)
        raise ValueError(f"axis names appear in both host_axes and "
                         f"local_axes: {dup}")
    shape = tuple(host_axes.values()) + tuple(local_axes.values())
    devices = jax.devices()
    if jax.process_count() > 1:
        from jax.experimental import mesh_utils

        # create_hybrid_device_mesh takes same-rank shapes and returns their
        # elementwise product; pad with 1s so the result's axes are exactly
        # (host..., local...) concatenated
        nh, nl = len(host_axes), len(local_axes)
        dev_array = mesh_utils.create_hybrid_device_mesh(
            (1,) * nh + tuple(local_axes.values()),
            tuple(host_axes.values()) + (1,) * nl,
            devices=devices, process_is_granule=True)
        return Mesh(dev_array, names)
    if int(np.prod(tuple(host_axes.values()))) != 1:
        raise ValueError(
            f"host_axes {dict(host_axes)} need "
            f"{np.prod(tuple(host_axes.values()))} processes but all "
            f"{len(devices)} devices are in one")
    return make_mesh(dict(zip(names, shape)))
