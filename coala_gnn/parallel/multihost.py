"""Multi-host bootstrap and cross-host control-plane collectives.

Replaces the reference's process topology layer
(reference: COALA-GNN-Setup/COALA_GNN/Shared_Tensor.py:24-113 —
MPI bootstrap + node-split comms, per-node gloo groups, master gather group):

  MPI.COMM_WORLD / SLURM env        -> jax.distributed.initialize
  local (per-node) comm split       -> process_index / local_device_count
  gloo all_reduce + master gather   -> multihost_utils.process_allgather
  (cache-meta exchange, :96-100)

In JAX every host runs one process and the mesh spans all devices; "part" in
the seed distributor == host == process_index.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """jax.distributed bootstrap. No-op when single-process. Arguments fall
    back to COALA_COORDINATOR / COALA_NUM_PROCS / COALA_PROC_ID env vars
    (the SLURM-free analogue of the reference's MASTER_ADDR/PORT +
    SLURM_NODEID wiring, 4GB_script.sh:19-20, sbatch:249-250).

    On the CPU backend, cross-process collectives need the gloo
    implementation (COALA_CPU_COLLECTIVES overrides)."""
    import jax

    coordinator = coordinator or os.environ.get("COALA_COORDINATOR")
    if not coordinator:
        return
    num_processes = num_processes or int(os.environ.get("COALA_NUM_PROCS", 1))
    process_id = process_id if process_id is not None else \
        int(os.environ.get("COALA_PROC_ID", 0))
    jax.config.update("jax_cpu_collectives_implementation",
                      os.environ.get("COALA_CPU_COLLECTIVES", "gloo"))
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def put_local(mesh, spec, local_np):
    """Place per-process-local host data onto a (possibly multi-process)
    mesh sharding.

    Single-process: plain device_put. Multi-process: the array is this
    process's slice of the global array (e.g. [n_local_dev, ...] of a
    [n_global_dev, ...] P('data', ...) array) — assembled with
    jax.make_array_from_process_local_data. This is the correct multi-host
    placement: device_put of host-local data with a
    global-mesh NamedSharding is wrong when hosts hold different values."""
    import jax
    from jax.sharding import NamedSharding

    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(local_np, sharding)
    return jax.make_array_from_process_local_data(sharding, local_np)


def read_replicated(arr) -> np.ndarray:
    """Host value of a fully-replicated global array (every process reads
    its own addressable copy; no cross-process transfer)."""
    shard = arr.addressable_shards[0]
    return np.asarray(shard.data)


def read_local_shards(arr) -> "tuple[list, np.ndarray]":
    """(global row indices, stacked rows) of this process's shards of a
    P('data', ...)-sharded array whose leading axis is the device axis."""
    idxs, datas = [], []
    for shard in arr.addressable_shards:
        sl = shard.index[0]
        start = sl.start or 0
        data = np.asarray(shard.data)
        for i in range(data.shape[0]):
            idxs.append(start + i)
            datas.append(data[i])
    return idxs, np.stack(datas) if datas else np.empty((0,))


def topology():
    """(num_hosts, this_host, local_device_count) — the num_nodes/node_id/
    local_size triple of the reference comm manager (Shared_Tensor.py:31-56)."""
    import jax

    return jax.process_count(), jax.process_index(), jax.local_device_count()


def make_meta_exchange_fn(num_colors: int) -> Callable[[np.ndarray], np.ndarray]:
    """Cross-host cache-meta exchange: every host contributes its local
    color-occupancy counters and receives all hosts' counters
    [num_hosts, num_colors+1] — the distributor's scoring input. Equivalent
    of gather_cache_meta (Shared_Tensor.py:96-100: local gloo all_reduce then
    master all_gather), as one process_allgather."""
    import jax

    if jax.process_count() == 1:
        return lambda local: np.asarray(local, np.int32)[None, :]

    from jax.experimental import multihost_utils

    def fn(local: np.ndarray) -> np.ndarray:
        out = multihost_utils.process_allgather(
            np.ascontiguousarray(local, dtype=np.int32))
        return np.asarray(out, dtype=np.int32).reshape(-1, num_colors + 1)

    return fn
