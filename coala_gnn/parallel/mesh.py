"""Device mesh helpers.

Replaces the reference's four-layer comm stack (MPI bootstrap + NVSHMEM +
NCCL + gloo, SURVEY.md §2.4) with one JAX mesh: a 1-D ``data`` axis spanning
all devices. Hosts are contiguous groups of ``local_size`` devices along the
axis (``jax.devices()`` enumerates devices host-major, so neighbouring
devices share a host).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def make_mesh(devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    return Mesh(np.asarray(devices), (DATA_AXIS,))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def data_sharded(mesh: Mesh, rank: int = 1) -> NamedSharding:
    """Shard the leading axis over devices; remaining axes replicated."""
    return NamedSharding(mesh, P(DATA_AXIS, *([None] * (rank - 1))))
