"""Multi-host initialization helpers.

On a multi-host cluster each host runs the same program;
``initialize_multihost`` wraps ``jax.distributed.initialize`` and returns
the global mesh spanning every host's devices.  The partitioners in this
package shard over *global* device meshes, so the same ``dist_*`` code
runs unchanged on 1 device, 1 host, or N hosts — only the mesh
construction differs.  (The tests exercise the simulated multi-device
path; a multi-host run needs a cluster.)
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
from jax.sharding import Mesh

__all__ = ["initialize_multihost", "global_mesh"]


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> None:
    """Initialize jax.distributed.  Pass ``coordinator_address``,
    ``num_processes`` and ``process_id`` explicitly where the cluster
    environment does not provide them."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    jax.distributed.initialize(**kwargs)


def global_mesh(axis_names: Sequence[str] = ("shard",),
                shape: Optional[Sequence[int]] = None) -> Mesh:
    """Mesh over all global devices (across hosts).  With no ``shape`` the
    mesh is 1-D over every device; otherwise devices are reshaped to it."""
    devs = jax.devices()
    import numpy as np

    arr = np.array(devs)
    if shape is not None:
        arr = arr.reshape(tuple(shape))
    elif len(axis_names) == 1:
        pass
    else:
        raise ValueError("shape required for multi-axis meshes")
    return Mesh(arr, tuple(axis_names))
