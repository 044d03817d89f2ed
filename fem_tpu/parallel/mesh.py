"""Device-mesh helpers.

The reference's parallelism is one-axis domain decomposition over mesh
elements via METIS + MPI (SURVEY.md §2c). The equivalent here is one
logical mesh axis over the local devices: elements are sharded along it,
DOF vectors are either replicated (small n) or sharded (large n), and the
shared-node reduction that PETSc's MatAssembly/VecScatter performed becomes a
psum / reduce_scatter over the device interconnect.
"""

from __future__ import annotations

from typing import Optional

import jax
from jax.sharding import Mesh

AXIS = "dev"


def make_mesh(n_devices: Optional[int] = None, axis: str = AXIS) -> Mesh:
    """1D device mesh over the first n local devices (default: all)."""
    devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devices)} available"
            )
        devices = devices[:n_devices]
    import numpy as np

    return Mesh(np.array(devices), (axis,))
