"""Mesh-sharded graph topology with frontier-routed on-device sampling.

The single-replica device-resident layout (device_sampler.DeviceGraph)
copies ``indptr``/``indices`` into every device's HBM — fine up to a few
hundred million edges, impossible for papers100M-class graphs (~3.2B
symmetrized edges, the reference's headline scale,
reference: examples/ssd_gnn_dataloader.py:819) next to the feature
cache. This module shards the CSC topology over the mesh instead: device
``d`` holds only the adjacency lists of the nodes it owns
(``id % n_dev == d`` — the same ownership rule as the sharded feature
cache, cache_kernel.cu:11), so per-device HBM is ~E/n_dev edges.

Sampling a frontier then needs cross-device neighbor reads. The reference
solves this with one-sided NVSHMEM gets into remote adjacency windows;
here the formulation is collective and bandwidth-optimal:

  1. ``all_gather`` the frontier id vector (tiny: 4·n bytes/device) so
     every device sees every device's frontier.
  2. Each device samples fanout slots for the rows IT OWNS from its local
     edge shard; unowned rows contribute exact zeros.
  3. One ``psum_scatter`` (reduce-scatter) over the [n_dev·n, fanout]
     contribution grid returns each device exactly its own frontier's
     neighbor blocks — each device ships (n_dev-1)/n_dev of its grid once
     around the device ring, with no request buckets, no overflow, and no
     scatter-back bookkeeping.

Because every row has exactly one owner and non-owners contribute zeros,
the reduce IS the route: sum == the owner's value. Degrees (and hetero
edge types) ride the same reduce-scatter, and the slot semantics
(deg<=f sequential, deg>f uniform-with-replacement, masked slots -> dst)
match device_sampler._sample_layer exactly, so the block contract is
unchanged and models/caches are oblivious to where the topology lives.

Only the contiguous ``dedup=False`` layout is provided — it is the
production resident-pipeline path (sorts beat gather redundancy only on
host links; see sample_blocks_device's dedup note).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from coala_gnn.models.layers import DeviceBlock
from coala_gnn.parallel.mesh import DATA_AXIS
from coala_gnn.sampling.neighbor import block_capacities


class ShardedTopology(NamedTuple):
    """Per-device CSC shards, leading axis = device (sharded over the mesh
    data axis; inside shard_map the local view is [1, ...]).

    ``indptr[d]`` indexes device d's local edge array: owned node
    ``id`` (with ``id % n_dev == d``) lives at local row ``id // n_dev``.
    Rows past the device's owned count (ceil-division padding) have
    degree 0. ``indices`` holds GLOBAL neighbor ids, -padded with 0 past
    each device's edge count (never addressed: offsets stay inside the
    real range)."""
    indptr: jax.Array    # int32/uint32 [n_dev, rows_per_dev + 1]
    indices: jax.Array   # int32 [n_dev, max_local_edges]
    edge_types: Optional[jax.Array] = None  # int32 [n_dev, max_local_edges]

    @property
    def n_dev(self) -> int:
        return self.indptr.shape[0]


def _local_edge_counts(indptr: np.ndarray, N: int, n_dev: int,
                       chunk_rows: int) -> np.ndarray:
    """Per-device owned-edge totals, O(chunk) transient memory."""
    totals = np.zeros(n_dev, np.int64)
    for d in range(n_dev):
        for lo in range(d, N, chunk_rows * n_dev):
            own = np.arange(lo, min(lo + chunk_rows * n_dev, N), n_dev,
                            dtype=np.int64)
            totals[d] += int((indptr[own + 1] - indptr[own]).sum())
    return totals


def shard_topology_arrays(graph, n_dev: int,
                          device_ids: Optional[Sequence[int]] = None,
                          chunk_rows: int = 1 << 20
                          ) -> Tuple[np.ndarray, np.ndarray,
                                     Optional[np.ndarray]]:
    """Host-side build: CSCGraph -> stacked per-device shard arrays
    (indptr [len(device_ids), rows+1], indices [.., max_e], edge_types or
    None). Callers place them on the mesh (put_local).

    papers100M-scale safe: the build streams owned
    rows in ``chunk_rows`` chunks, so transient memory is O(chunk·avg_deg)
    regardless of E (the r2 version materialized per-device ``np.repeat``
    temporaries of E/n_dev entries — tens of GB at the reference's 3.2B
    symmetrized edges, ssd_gnn_dataloader.py:819). ``device_ids`` builds
    only the requested devices' shards (a multi-host process needs its
    local devices only); ``max_e`` is still computed globally so shard
    shapes agree across processes. ``graph.indices``/``graph.edge_types``
    may be any array-like supporting fancy indexing (e.g. np.memmap) —
    they are never materialized whole."""
    from coala_gnn.cache.feature_cache import assert_ids_fit_int32

    N = graph.num_nodes
    assert_ids_fit_int32(N)
    indptr = np.asarray(graph.indptr, dtype=np.int64)
    indices = graph.indices
    if isinstance(indices, (list, tuple)):
        indices = np.asarray(indices)
    et = getattr(graph, "edge_types", None)
    rows = -(-N // n_dev)                      # ceil: rows per device
    if device_ids is None:
        device_ids = range(n_dev)
    device_ids = list(device_ids)

    totals = _local_edge_counts(indptr, N, n_dev, chunk_rows)
    max_e = max(int(totals.max()), 1)
    n_out = len(device_ids)
    local_ptrs = np.zeros((n_out, rows + 1), np.int64)
    idx_out = np.zeros((n_out, max_e), np.int32)
    et_out = np.zeros((n_out, max_e), np.int32) if et is not None else None

    for i, d in enumerate(device_ids):
        own_total = -(-max(N - d, 0) // n_dev)  # owned rows of device d
        csum = local_ptrs[i]
        filled = 0                              # rows written so far
        for lo in range(d, N, chunk_rows * n_dev):
            own = np.arange(lo, min(lo + chunk_rows * n_dev, N), n_dev,
                            dtype=np.int64)
            starts = indptr[own]
            deg = indptr[own + 1] - starts
            base = csum[filled]
            np.cumsum(deg, out=csum[filled + 1: filled + 1 + own.size])
            csum[filled + 1: filled + 1 + own.size] += base
            # per-edge source positions in the global indices array
            n_e = int(deg.sum())
            pos = (np.arange(n_e, dtype=np.int64)
                   - np.repeat(csum[filled: filled + own.size] - base, deg)
                   + np.repeat(starts, deg))
            idx_out[i, base: base + n_e] = np.asarray(indices[pos],
                                                      dtype=np.int32)
            if et is not None:
                et_out[i, base: base + n_e] = np.asarray(et[pos],
                                                         dtype=np.int32)
            filled += own.size
        csum[own_total + 1:] = csum[own_total]  # padded rows: degree 0

    ptr_dtype = (np.int32 if local_ptrs.max() <= np.iinfo(np.int32).max
                 else np.uint32)
    if local_ptrs.max() > np.iinfo(np.uint32).max:
        raise ValueError("per-device edge shard exceeds uint32 offsets; "
                         "increase the mesh size")
    return local_ptrs.astype(ptr_dtype), idx_out, et_out


def put_sharded_topology(graph, mesh) -> ShardedTopology:
    """Build + place the sharded topology on the mesh data axis. Each
    process builds + materializes ONLY its local devices' shards
    (multi-host safe via put_local / make_array_from_process_local_data;
    shard shapes agree because max_e is computed globally)."""
    from jax.sharding import PartitionSpec as P

    from coala_gnn.parallel.multihost import put_local

    n_dev = mesh.devices.size
    me = jax.process_index()
    local_rows = [i for i, d in enumerate(mesh.devices.flat)
                  if d.process_index == me]
    ptrs, idx, et = shard_topology_arrays(graph, n_dev,
                                          device_ids=local_rows)
    spec = P(DATA_AXIS, None)
    return ShardedTopology(
        indptr=put_local(mesh, spec, ptrs),
        indices=put_local(mesh, spec, idx),
        edge_types=None if et is None else put_local(mesh, spec, et))


def _sample_layer_sharded(indptr: jax.Array, indices: jax.Array,
                          edge_types: Optional[jax.Array], dst: jax.Array,
                          fanout: int, key: jax.Array, n_dev: int,
                          num_nodes: int
                          ) -> Tuple[jax.Array, jax.Array,
                                     Optional[jax.Array]]:
    """One frontier layer against the sharded topology (call inside
    shard_map over the data axis). Returns (nbr [n, fanout], mask f32,
    rel or None) with device_sampler._sample_layer slot semantics.

    all_gather -> owner-side masked sample -> psum_scatter; the owner's
    contribution is exact and everyone else's is zero, so the reduce is
    the route (see module docstring)."""
    n = dst.shape[0]
    me = jax.lax.axis_index(DATA_AXIS)
    flat = jax.lax.all_gather(dst, DATA_AXIS).reshape(-1)   # [n_dev * n]
    owned = (flat < num_nodes) & (flat % n_dev == me)
    row = jnp.where(owned, flat // n_dev, 0)
    starts = indptr[row]
    deg = jnp.where(owned, (indptr[row + 1] - starts).astype(jnp.int32), 0)

    k = jnp.arange(fanout, dtype=jnp.int32)[None, :]
    rand = jax.random.uniform(key, (flat.shape[0], fanout))
    rand_off = (rand * jnp.maximum(deg, 1)[:, None]).astype(jnp.int32)
    seq_off = jnp.minimum(k, jnp.maximum(deg[:, None] - 1, 0))
    offsets = jnp.where(deg[:, None] <= fanout, seq_off, rand_off)
    edge_pos = starts[:, None] + offsets.astype(starts.dtype)
    slot = (k < jnp.minimum(deg, fanout)[:, None])          # owner-side mask

    contrib_nbr = jnp.where(slot, indices[edge_pos], 0)
    contrib_deg = deg                                        # 0 if unowned
    nbr = jax.lax.psum_scatter(contrib_nbr, DATA_AXIS,
                               scatter_dimension=0, tiled=True)  # [n, f]
    deg_out = jax.lax.psum_scatter(contrib_deg, DATA_AXIS,
                                   scatter_dimension=0, tiled=True)  # [n]
    mask = k < jnp.minimum(deg_out, fanout)[:, None]
    nbr = jnp.where(mask, nbr, dst[:, None])
    rel = None
    if edge_types is not None:
        contrib_rel = jnp.where(slot, edge_types[edge_pos], 0)
        rel = jax.lax.psum_scatter(contrib_rel, DATA_AXIS,
                                   scatter_dimension=0, tiled=True)
        rel = jnp.where(mask, rel, 0)
    return nbr, mask.astype(jnp.float32), rel


def sample_blocks_sharded(st_local: ShardedTopology, num_nodes: int,
                          seeds: jax.Array, fanouts: Sequence[int],
                          batch_size: int, key: jax.Array, n_dev: int
                          ) -> Tuple[List[DeviceBlock], jax.Array,
                                     jax.Array]:
    """Multi-layer sampling against the sharded topology, inside shard_map.

    ``st_local`` is the per-device view (leading device axis of size 1).
    Contract == sample_blocks_device(dedup=False): contiguous layout
    (adj=None), sentinel-padded ``input_ids``, per-layer masks; the
    sentinel is ``num_nodes``."""
    indptr = st_local.indptr[0]
    indices = st_local.indices[0]
    et = None if st_local.edge_types is None else st_local.edge_types[0]
    caps = block_capacities(batch_size, fanouts)
    sentinel = num_nodes
    blocks: List[DeviceBlock] = []
    dst = seeds.astype(jnp.int32)
    valid_dst = None
    ids = num = None
    for layer in range(len(fanouts) - 1, -1, -1):
        fanout = fanouts[layer]
        cap_dst, _ = caps[layer]
        pad = cap_dst - dst.shape[0]
        if pad:
            dst = jnp.concatenate([dst, jnp.full(pad, sentinel, jnp.int32)])
            if valid_dst is not None:
                valid_dst = jnp.concatenate([valid_dst,
                                             jnp.zeros(pad, bool)])
        if valid_dst is not None:
            dst = jnp.where(valid_dst, dst, sentinel)

        key, sub = jax.random.split(key)
        nbr, mask, rel = _sample_layer_sharded(indptr, indices, et, dst,
                                               fanout, sub, n_dev,
                                               num_nodes)
        # slot-major contiguous layout (see device_sampler.py): slot
        # (i, k) at row cap + k*cap + i — the fanout reduce streams
        # per-slot [cap, D] planes at HBM bandwidth
        cat = jnp.concatenate([dst, nbr.T.reshape(-1)])
        ids = cat
        valid_dst = cat != sentinel
        num = valid_dst.sum(dtype=jnp.int32)
        dst = cat
        if rel is None:
            blocks.insert(0, DeviceBlock(adj=None, mask=mask))
        else:
            from coala_gnn.models.hetero import DeviceHeteroBlock
            blocks.insert(0, DeviceHeteroBlock(adj=None, mask=mask,
                                               rel=rel))
    return blocks, ids, num
