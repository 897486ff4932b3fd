"""Distributed sharded feature cache over a device mesh.

Re-design of the reference's distributed GPU cache data plane:

  reference mechanism                          -> this build
  ------------------------------------------------------------------------
  NVSHMEM request queues + one-sided puts      -> two-phase
  (send_requests/read_feature,                    jax.lax.all_to_all under
   cache_kernel.cu:4-57, ssd_gnn_cache.cuh:111-174)  shard_map: ids out,
                                                  features back
  NCCL backend (split/all_to_all/send-recv/remap, -> the SAME all_to_all path
   COALA_GNN_Manager.py:143-211)                   (the natural collective
                                                   formulation; one impl
                                                   covers both backends)
  isolated backend (local-only cache,           -> mode="isolated": no
   isolated_cache.h get_set_id path)              collectives, private sets
  owner = id % num_gpus (cache_kernel.cu:11)    -> owner = id % n_devices
  set = (id / n_gpus) % num_sets                -> same (feature_cache.set_index)
  BaM NVMe / host-UVA miss fill                 -> host-RAM tier gather +
  (nvshmem_cache.h:278-332)                       compact device_put, merged
                                                  by a jitted scatter; owner
                                                  caches refilled by a third
                                                  all_to_all "push" phase

Fixed-size request buckets with -1 sentinels mirror the reference's
max_sample_size request buffers (ssd_gnn_cache.cuh:119): all_to_all needs
equal splits, so each (src, dst) pair gets ``bucket_cap`` slots; requests
beyond capacity simply fall back to the host tier on the requester (always
correct, never drops data — only a lost caching opportunity).

Everything here is pure and shard_map-compatible: cache state lives as global
arrays with a leading device axis sharded over the mesh ``data`` axis.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import ml_dtypes  # numpy bfloat16 buffers for half-width host->device rows
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from coala_gnn.cache import feature_cache as fc
from coala_gnn.parallel import sizing
from coala_gnn.parallel.mesh import DATA_AXIS


class ShardedCacheState(NamedTuple):
    """Per-device cache shards, leading axis = device (sharded over mesh)."""
    tags: jax.Array          # int32 [n_dev, num_sets, ways]
    data: jax.Array          # dtype|int8 [n_dev, num_sets, ways, cache_dim]
    rr: jax.Array            # int32 [n_dev, num_sets]
    line_colors: jax.Array   # int32 [n_dev, num_sets, ways]
    color_counts: jax.Array  # int32 [n_dev, num_colors + 1]
    hits: jax.Array          # int32 [n_dev]
    misses: jax.Array        # int32 [n_dev]
    scales: Optional[jax.Array] = None  # f32 [n_dev, num_sets, ways]


def _to_local(state: ShardedCacheState) -> fc.ColoredCacheState:
    """Per-device view (leading axis squeezed) -> single-device cache state."""
    base = fc.CacheState(tags=state.tags[0], data=state.data[0], rr=state.rr[0],
                         color_counts=state.color_counts[0],
                         hits=state.hits[0], misses=state.misses[0],
                         scales=(None if state.scales is None
                                 else state.scales[0]))
    return fc.ColoredCacheState(base=base, line_colors=state.line_colors[0])


def _from_local(c: fc.ColoredCacheState) -> ShardedCacheState:
    b = c.base
    return ShardedCacheState(
        tags=b.tags[None], data=b.data[None], rr=b.rr[None],
        line_colors=c.line_colors[None], color_counts=b.color_counts[None],
        hits=b.hits[None], misses=b.misses[None],
        scales=None if b.scales is None else b.scales[None])


def init_sharded_state(cfg: fc.CacheConfig, mesh: Mesh) -> ShardedCacheState:
    """Build the global state sharded over the mesh data axis (each process
    materializes only its local devices' shards)."""
    from coala_gnn.parallel.multihost import put_local

    n_local = len([d for d in mesh.devices.flat
                   if d.process_index == jax.process_index()])

    def mk(shape, np_dtype, fill=0):
        arr = np.full((n_local,) + shape, fill, dtype=np_dtype)
        return put_local(mesh, P(DATA_AXIS, *[None] * len(shape)), arr)

    np_data = (ml_dtypes.bfloat16 if cfg.dtype == jnp.bfloat16
               else np.dtype(cfg.dtype))
    if cfg.quantize:
        np_data = np.int8
    return ShardedCacheState(
        tags=mk((cfg.num_sets, cfg.ways), np.int32, -1),
        data=mk((cfg.num_sets, cfg.ways, cfg.cache_dim), np_data),
        rr=mk((cfg.num_sets,), np.int32),
        line_colors=mk((cfg.num_sets, cfg.ways), np.int32),
        color_counts=mk((cfg.num_colors + 1,), np.int32),
        hits=mk((), np.int32),
        misses=mk((), np.int32),
        scales=(mk((cfg.num_sets, cfg.ways), np.float32, 1.0)
                if cfg.quantize else None),
    )


def _owner_rank(ids: jax.Array, valid: jax.Array, n_dev: int
                ) -> Tuple[jax.Array, jax.Array]:
    """(owner, within-owner occurrence rank) per request slot.

    The shard_map analogue of nccl_split_node_list_kernel
    (cache_kernel.cu:79-91): bucket ids by owner and remember each id's
    position so responses scatter back. Sort-free: rank comes from a
    one-hot prefix sum (a device argsort of the request ids costs far more
    than the [n, n_dev+1] cumsum, a cheap streaming pass)."""
    n = ids.shape[0]
    owner = jnp.where(valid, ids % n_dev, n_dev)   # invalid -> OOB bucket
    onehot = (owner[:, None]
              == jnp.arange(n_dev + 1, dtype=owner.dtype)[None, :])
    csum = jnp.cumsum(onehot.astype(jnp.int32), axis=0)
    rank = csum[jnp.arange(n), owner] - 1
    return owner, rank


def exchange_lookup(cfg: fc.CacheConfig, bucket_cap: int, n_dev: int,
                    local: fc.ColoredCacheState, ids: jax.Array,
                    valid: jax.Array, int8_response: bool = True,
                    groups=None):
    """Core per-device probe (call from inside a shard_map body over the
    data axis): route ids to owners, probe, route features back.

    Quantized caches ship the RESPONSE compressed: raw int8 lines + one
    f32 scale per row ride the all_to_all (dim + 4 bytes/row vs 4*dim —
    ~3.9x less interconnect traffic) and the requester dequantizes, replacing the
    reference's raw-page response put (nvshmem_cache.h:381-385).
    Dequantize is elementwise, so which side of the wire it runs on is
    bitwise-irrelevant; int8_response=False forces the f32-response path
    (the parity test's oracle).

    ``groups`` (axis_index_groups of contiguous same-host blocks, each of
    size n_dev) scopes every all_to_all to the local (intra-host) device group —
    the node_local hierarchical mode: features NEVER cross hosts, exactly
    the reference's one-NVSHMEM-world-per-node cache scoping
    (nvshmem_manager.cuh:15-28); only seeds and cache-meta move cross-host.
    With groups, n_dev is the GROUP size and owner = id % group_size is a
    within-group position.

    Returns (local_state', feats [n_req, dim], hit [n_req], overflow
    [n_req]). n_dev == 1 degenerates to a local probe."""
    n_req = ids.shape[0]
    ids = jnp.where(valid, ids, 0)
    if n_dev == 1:
        base, feats, hit = fc.lookup(cfg, local.base, ids, valid)
        local = local._replace(base=base)
        return local, feats, hit, jnp.zeros((n_req,), jnp.bool_)
    c = bucket_cap
    owner, rank = _owner_rank(ids, valid, n_dev)
    routed = rank < c               # made it into a bucket
    a2a = functools.partial(jax.lax.all_to_all, axis_name=DATA_AXIS,
                            split_axis=0, concat_axis=0, tiled=True,
                            axis_index_groups=groups)

    # Phase 1: route request ids to owners (send_requests parity).
    buckets = jnp.full((n_dev, c), -1, jnp.int32)
    buckets = buckets.at[owner, rank].set(ids, mode="drop")
    req = a2a(buckets)                                      # [n_dev, c]

    # Owner-side probe (read_feature parity).
    req_flat = req.reshape(-1)
    req_valid = req_flat >= 0
    quant = local.base.scales is not None and int8_response
    if quant:
        base, q, sc, hit = fc.lookup_quantized(
            cfg, local.base, jnp.where(req_valid, req_flat, 0), req_valid)
    else:
        base, feats, hit = fc.lookup(cfg, local.base,
                                     jnp.where(req_valid, req_flat, 0),
                                     req_valid)
    local = local._replace(base=base)

    # Phase 2: features (and hit bits) back to requesters — int8 lines +
    # scales when quantized, f32 rows otherwise.
    if quant:
        resp_q = a2a(q.reshape(n_dev, c, cfg.dim))
        resp_sc = a2a(sc.reshape(n_dev, c))
    else:
        resp = a2a(feats.reshape(n_dev, c, cfg.dim))
    hit_back = a2a(hit.reshape(n_dev, c))

    # Scatter back into request order (map_feat_data parity,
    # cache_kernel.cu:129-137).
    g_owner = jnp.where(routed, owner, 0)
    g_rank = jnp.where(routed, rank, 0)
    if quant:
        rows = fc.dequantize_rows(resp_q[g_owner, g_rank],
                                  resp_sc[g_owner, g_rank],
                                  dtype=cfg.dtype)
        out = jnp.where((routed & valid)[:, None], rows, 0)
    else:
        out = jnp.where((routed & valid)[:, None], resp[g_owner, g_rank], 0)
    out_hit = hit_back[g_owner, g_rank] & routed & valid
    overflow = ~routed & valid
    return local, out, out_hit, overflow


def exchange_probe(cfg: fc.CacheConfig, bucket_cap: int, n_dev: int,
                   local: fc.ColoredCacheState, ids: jax.Array,
                   valid: jax.Array, groups=None
                   ) -> Tuple[jax.Array, jax.Array]:
    """Residency check across the mesh: route ids to owners, compare tags,
    route hit bits back. No feature movement, no state change — the cheap
    prefetch-planning half of exchange_lookup. ``groups`` scopes the
    exchange to host-local device blocks (node_local mode).

    Returns (hit, overflow) bool [n_req]. Overflow slots (requests beyond
    their (src, owner) bucket's capacity) are reported SEPARATELY from
    residency misses: insertion at the owner cannot repair them — they need
    a host-side row merged into the consuming step instead (the same
    fallback the per-step path uses)."""
    n_req = ids.shape[0]
    ids = jnp.where(valid, ids, 0)
    if n_dev == 1:
        return (fc.probe(cfg, local.base, ids, valid),
                jnp.zeros((n_req,), jnp.bool_))
    c = bucket_cap
    owner, rank = _owner_rank(ids, valid, n_dev)
    routed = rank < c
    a2a = functools.partial(jax.lax.all_to_all, axis_name=DATA_AXIS,
                            split_axis=0, concat_axis=0, tiled=True,
                            axis_index_groups=groups)
    buckets = jnp.full((n_dev, c), -1, jnp.int32)
    buckets = buckets.at[owner, rank].set(ids, mode="drop")
    req = a2a(buckets)
    req_flat = req.reshape(-1)
    hit = fc.probe(cfg, local.base, jnp.where(req_flat >= 0, req_flat, 0),
                   req_flat >= 0)
    hit_back = a2a(hit.reshape(n_dev, c))
    g_owner = jnp.where(routed, owner, 0)
    g_rank = jnp.where(routed, rank, 0)
    return (hit_back[g_owner, g_rank] & routed & valid,
            ~routed & valid)


def _lookup_exchange_local(cfg: fc.CacheConfig, bucket_cap: int, n_dev: int,
                           packed_n_req: int, groups,
                           state: ShardedCacheState, ids: jax.Array,
                           num_valid: jax.Array, sentinel: int = 0):
    """shard_map body wrapping exchange_lookup for the standalone fetch path.

    With packed_n_req > 0, ``ids`` is a full request buffer
    [1 + n_req + ...] whose prefix holds [num_input | input_ids] (see
    data/packing.pack_request) and ``num_valid`` is ignored.

    sentinel > 0 switches the validity convention from valid-prefix to
    sentinel-marking: entries equal to ``sentinel`` (== num_nodes, the
    contiguous-layout convention of sampling/device_sampler) are invalid
    wherever they appear — the id vector of the contiguous host pipeline
    (data/packing.pack_request_contig) scatters padding instead of
    prefixing it.

    Returns, besides the per-device outputs, two REPLICATED scalars
    (global total miss count, global per-device max miss count) so every
    process takes the same miss-path decision and compiles the same
    fill-kernel shapes — the multi-host coherence contract."""
    if packed_n_req > 0:
        buf = ids[0]
        num_valid = buf[0]
        ids = jax.lax.dynamic_slice_in_dim(buf, 1, packed_n_req)
    else:
        ids = ids[0]                # [n_req] this device's request list
        num_valid = num_valid[0]
    n_req = ids.shape[0]
    if sentinel > 0:
        valid = ids != sentinel
        ids = jnp.where(valid, ids, 0)
    else:
        valid = jnp.arange(n_req) < num_valid
    local = _to_local(state)
    local, out, out_hit, overflow = exchange_lookup(
        cfg, bucket_cap, n_dev, local, ids, valid, groups=groups)
    n_miss = (valid & (~out_hit | overflow)).sum(dtype=jnp.int32)
    total_miss = jax.lax.psum(n_miss, DATA_AXIS)
    max_miss = jax.lax.pmax(n_miss, DATA_AXIS)
    return (_from_local(local), out[None], out_hit[None], overflow[None],
            total_miss, max_miss)


def _fill_local(cfg: fc.CacheConfig, fill_cap: int, n_dev: int, groups,
                state: ShardedCacheState, ids: jax.Array,
                positions: jax.Array, rows: jax.Array,
                miss_colors: jax.Array):
    """Push miss rows to their owner shards and insert (the BaM-fill +
    color-counter update of the reference miss path, nvshmem_cache.h:417-468,
    expressed as one all_to_all + batch insert).

    The miss rows were already shipped once for the output merge; here the
    miss *ids* are re-derived on device from (ids, positions) so nothing is
    transferred twice. positions are -1 padded."""
    ids = ids[0]                    # [n_req]
    positions = positions[0]        # [m]
    rows = rows[0]                  # [m, dim]
    miss_colors = miss_colors[0]    # [m]
    local = _to_local(state)
    valid = positions >= 0
    miss_ids = jnp.where(valid, ids[jnp.clip(positions, 0)], -1)
    miss_feats = rows

    if n_dev == 1:
        local = fc.insert_with_colors(cfg, local, jnp.where(valid, miss_ids, 0),
                                      miss_feats, valid, miss_colors)
        return _from_local(local)

    c = fill_cap
    owner, rank = _owner_rank(miss_ids, valid, n_dev)
    id_b = jnp.full((n_dev, c), -1, jnp.int32).at[owner, rank].set(
        miss_ids, mode="drop")
    ft_b = jnp.zeros((n_dev, c, cfg.dim), cfg.dtype).at[owner, rank].set(
        miss_feats.astype(cfg.dtype), mode="drop")
    cl_b = jnp.zeros((n_dev, c), jnp.int32).at[owner, rank].set(
        miss_colors, mode="drop")

    a2a = functools.partial(jax.lax.all_to_all, axis_name=DATA_AXIS,
                            split_axis=0, concat_axis=0, tiled=True,
                            axis_index_groups=groups)
    rid = a2a(id_b).reshape(-1)
    rft = a2a(ft_b).reshape(-1, cfg.dim)
    rcl = a2a(cl_b).reshape(-1)

    local = fc.insert_with_colors(cfg, local, jnp.where(rid >= 0, rid, 0),
                                  rft, rid >= 0, rcl)
    return _from_local(local)


@dataclasses.dataclass
class ShardedFeatureCache:
    """Orchestrates the jitted exchange kernels + the host feature tier.

    mode "sharded"    — ids hash-partitioned across ALL mesh devices,
                        two-phase all_to_all exchange (reference
                        nvshmem/nccl backends). On a multi-host mesh every
                        lookup's exchange rides DCN.
    mode "node_local" — hierarchical: ids hash-partitioned across each
                        HOST's devices only; every all_to_all is scoped to
                        the local (intra-host) device group via axis_index_groups.
                        Each host's group caches its own working set
                        independently; cross-host traffic is control-plane
                        only (seed lists + cache-meta allgather). This is
                        the reference's exact cache topology — one NVSHMEM
                        world per node (nvshmem_manager.cuh:15-28), seeds
                        steered cross-node by affinity
                        (node_distributor_pybind.cuh:150-222).
    mode "isolated"   — each device caches what it requests, no collectives
                        (reference isolated backend).
    """

    cfg: fc.CacheConfig
    mesh: Mesh
    mode: str = "sharded"
    bucket_slack: float = 2.0
    group_size: int = 0   # node_local: devices per (host) group; 0 = this
                          # process's local device count (the host boundary)

    def __post_init__(self):
        n_dev = self.mesh.devices.size
        if self.mode not in ("sharded", "isolated", "node_local"):
            raise ValueError(f"unknown cache mode {self.mode!r}")
        self.groups = None
        if self.mode == "isolated" or n_dev == 1:
            self.n_route = 1
        elif self.mode == "node_local":
            L = self.group_size or max(n_dev // jax.process_count(), 1)
            if n_dev % L:
                raise ValueError(
                    f"node_local group_size {L} must divide mesh size {n_dev}")
            self.n_route = L
            if L < n_dev:
                self.groups = [[g * L + i for i in range(L)]
                               for g in range(n_dev // L)]
                # the mode's whole point is that each group's all_to_all
                # stays on one host's links (nvshmem_manager.cuh:15-28
                # parity) — positionally contiguous blocks only deliver
                # that if the mesh lays devices out process-contiguous
                devs = list(self.mesh.devices.flat)
                for g in self.groups:
                    procs = {devs[p].process_index for p in g}
                    if len(procs) > 1:
                        raise ValueError(
                            "node_local cache groups must not span hosts: "
                            f"mesh positions {g} mix processes "
                            f"{sorted(procs)}. Build the mesh with process-"
                            "contiguous device order (parallel.mesh."
                            "make_mesh does) or pass a group_size that "
                            "divides each host's contiguous block.")
            # L == n_dev degenerates to the flat sharded exchange
        else:
            self.n_route = n_dev
        self.state = init_sharded_state(self.cfg, self.mesh)
        self._jit_cache = {}
        self._np_dtype = (ml_dtypes.bfloat16
                          if self.cfg.dtype == jnp.bfloat16 else np.float32)
        # positions along the mesh data axis served by THIS process; the
        # public API takes/returns per-local-device host arrays (== global
        # arrays when single-process)
        self.local_positions = [p for p, d in
                                enumerate(self.mesh.devices.flat)
                                if d.process_index == jax.process_index()]
        self.n_local = len(self.local_positions)

    def _put(self, local_np, extra_dims: int):
        from coala_gnn.parallel.multihost import put_local
        if np.ndim(local_np) and np.shape(local_np)[0] != self.n_local:
            raise ValueError(
                f"expected per-LOCAL-device leading dim {self.n_local}, got "
                f"{np.shape(local_np)} — the public API takes this "
                "process's device slices, not the global array")
        return put_local(self.mesh, P(DATA_AXIS, *[None] * extra_dims),
                         local_np)

    @staticmethod
    def _read_local(arr) -> np.ndarray:
        """Host copy of this process's shards, stacked along the device
        axis (== the whole array when single-process)."""
        shards = sorted(arr.addressable_shards,
                        key=lambda s: s.index[0].start or 0)
        return np.concatenate([np.asarray(s.data) for s in shards], axis=0)

    # ---- jitted kernels (built per request-shape) -------------------------

    def _lookup_kernel(self, n_req: int, packed: bool = False,
                       sentinel: int = 0):
        key = ("lookup", n_req, packed, sentinel)
        if key in self._jit_cache:
            return self._jit_cache[key]
        mesh, cfg, n_dev = self.mesh, self.cfg, self.n_route
        bucket_cap = sizing.lookup_bucket_cap(n_req, n_dev, self.bucket_slack)
        state_specs = jax.tree.map(lambda _: P(DATA_AXIS), self.state)
        lookup = shard_map(
            functools.partial(_lookup_exchange_local, cfg, bucket_cap, n_dev,
                              n_req if packed else 0, self.groups,
                              sentinel=sentinel),
            mesh=mesh,
            in_specs=(state_specs, P(DATA_AXIS), P(DATA_AXIS)),
            out_specs=(state_specs, P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS),
                       P(), P()),
            check_vma=False)
        k = jax.jit(lookup)
        self._jit_cache[key] = k
        return k

    def _miss_kernels(self, n_req: int, m_cap: int):
        key = ("miss", n_req, m_cap)
        if key in self._jit_cache:
            return self._jit_cache[key]
        mesh, cfg, n_dev = self.mesh, self.cfg, self.n_route
        # per-owner fill bucket: misses spread ~uniformly over owners
        fill_cap = sizing.fill_bucket_cap(m_cap, n_dev, self.bucket_slack)
        state_specs = jax.tree.map(lambda _: P(DATA_AXIS), self.state)
        fill = shard_map(
            functools.partial(_fill_local, cfg, fill_cap, n_dev, self.groups),
            mesh=mesh,
            in_specs=(state_specs, P(DATA_AXIS), P(DATA_AXIS),
                      P(DATA_AXIS), P(DATA_AXIS)),
            out_specs=state_specs,
            check_vma=False)

        def merge(feats, positions, rows):
            # feats [D, n_req, dim]; rows [D, m, dim]; positions [D, m]
            # (-1 padded -> dropped)
            def body(f, p, r):
                pos = jnp.where(p >= 0, p, f.shape[0])
                return f.at[pos].set(r, mode="drop")
            return jax.vmap(body)(feats, positions, rows)

        kernels = (jax.jit(fill), jax.jit(merge))
        self._jit_cache[key] = kernels
        return kernels

    # ---- public API -------------------------------------------------------

    def fetch_begin(self, ids: np.ndarray, num_valid: np.ndarray):
        """Dispatch the (possibly cross-device) cache probe for a request
        list and start streaming the hit mask back to the host — without
        blocking. Pair with fetch_complete(). Pipelining one batch ahead
        hides the device->host round trip behind the current step's work —
        the analogue of the reference scheduler running distribution one
        iteration ahead (COALA_GNN_DataLoader.py:31-68)."""
        ids = np.ascontiguousarray(ids, dtype=np.int32)
        n_req = ids.shape[1]
        k_lookup = self._lookup_kernel(n_req)
        dids = self._put(ids, 1)
        dnum = self._put(np.asarray(num_valid, np.int32), 0)
        self.state, feats, hit, overflow, n_miss, m_max = k_lookup(
            self.state, dids, dnum)
        try:
            n_miss.copy_to_host_async()
        except Exception:
            pass
        return (ids, np.asarray(num_valid, np.int32), dids, feats, hit,
                overflow, n_miss, m_max, 0)

    def fetch_begin_packed(self, ids_np: np.ndarray, num_valid: np.ndarray,
                           dbuf: jax.Array, n_req: int, sentinel: int = 0):
        """fetch_begin reading the request from an already-on-device packed
        buffer (data/packing.pack_request): the same transfer that carries
        the batch's blocks carries the probe's ids; only the per-device miss
        COUNT (4 bytes) streams back in the common all-hit case.

        sentinel > 0: the buffer uses the contiguous-layout convention
        (pack_request_contig) — entries equal to ``sentinel`` are invalid
        wherever they appear, instead of validity being a prefix."""
        k_lookup = self._lookup_kernel(n_req, packed=True, sentinel=sentinel)
        self.state, feats, hit, overflow, n_miss, m_max = k_lookup(
            self.state, dbuf, self._put(np.zeros(self.n_local, np.int32), 0))
        try:
            n_miss.copy_to_host_async()
        except Exception:
            pass
        return (np.ascontiguousarray(ids_np, np.int32),
                np.asarray(num_valid, np.int32), None, feats, hit, overflow,
                n_miss, m_max, sentinel)

    def fetch_complete(self, handle, host_fetch,
                       colors: Optional[np.ndarray] = None,
                       fill: bool = True) -> jax.Array:
        """Resolve a fetch_begin handle: gather misses from the host tier,
        merge them into the output, and push them into their owner shards.
        Multi-process coherent: the miss decision and the fill-kernel shape
        come from REPLICATED counters, so every process dispatches the same
        collectives; each process fetches rows for its own devices only."""
        (ids, num_valid, dids, feats, hit, overflow, n_miss, m_max,
         sentinel) = handle
        n_req = ids.shape[1]

        # Fast path: only the replicated miss COUNT crosses device->host.
        # All-hit steady state never reads the full masks.
        if int(np.asarray(n_miss)) == 0:
            return feats

        # Host tier: gather rows the cache couldn't serve (local devices).
        hit_np = self._read_local(hit)
        over_np = self._read_local(overflow)
        if sentinel > 0:
            valid_np = ids != sentinel
        else:
            valid_np = np.arange(n_req)[None, :] < num_valid[:, None]
        need = valid_np & (~hit_np | over_np)
        if dids is None:  # packed-begin path: ship ids only on the miss path
            dids = self._put(ids, 1)

        # Compact transfer buffers sized to the GLOBAL max per-device miss
        # count (replicated -> identical compiled shapes on every process);
        # rows are shipped exactly once and reused on device by both the
        # merge and the owner fill.
        m_cap = _ceil_pow2(int(np.asarray(m_max)))
        k_fill, k_merge = self._miss_kernels(n_req, m_cap)
        positions = np.full((self.n_local, m_cap), -1, dtype=np.int32)
        rows = np.zeros((self.n_local, m_cap, self.cfg.dim),
                        dtype=self._np_dtype)
        miss_colors = np.zeros((self.n_local, m_cap), dtype=np.int32)

        for d in range(self.n_local):
            pos = np.flatnonzero(need[d])
            if pos.size == 0:
                continue
            miss_ids = ids[d, pos].astype(np.int64)
            positions[d, : pos.size] = pos
            rows[d, : pos.size] = host_fetch(miss_ids)
            if colors is not None:
                miss_colors[d, : pos.size] = colors[miss_ids]

        dpos = self._put(positions, 1)
        drows = self._put(rows, 2)
        feats = k_merge(feats, dpos, drows)
        if fill:
            self.state = k_fill(self.state, dids, dpos, drows,
                                self._put(miss_colors, 1))
        return feats

    def fetch(self, ids: np.ndarray, num_valid: np.ndarray,
              host_fetch, colors: Optional[np.ndarray] = None,
              fill: bool = True) -> jax.Array:
        """Synchronous fetch (fetch_begin + fetch_complete back to back).

        ids       : int32 [n_dev, n_req] global node ids (may repeat padding)
        num_valid : int32 [n_dev] valid prefix per device
        host_fetch: fn(int64 [m]) -> float32 [m, dim] — the host tier
        colors    : int64/int32 [num_nodes] node->color map (optional)
        Returns feats [n_dev, n_req, dim] sharded over the mesh data axis.
        """
        return self.fetch_complete(self.fetch_begin(ids, num_valid),
                                   host_fetch, colors=colors, fill=fill)

    def _insert_kernel(self, chunk: int):
        key = ("insert", chunk)
        if key in self._jit_cache:
            return self._jit_cache[key]
        cfg = self.cfg
        state_specs = jax.tree.map(lambda _: P(DATA_AXIS), self.state)

        def body(state, ids, rows, colors):
            local = _to_local(state)
            ids, rows, colors = ids[0], rows[0], colors[0]
            local = fc.insert_with_colors(cfg, local,
                                          jnp.where(ids >= 0, ids, 0), rows,
                                          ids >= 0, colors)
            return _from_local(local)

        k = jax.jit(shard_map(
            body, mesh=self.mesh,
            in_specs=(state_specs, P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS)),
            out_specs=state_specs, check_vma=False))
        self._jit_cache[key] = k
        return k

    def _insert_evict_kernel(self, chunk: int):
        """insert kernel that also reports the ids the insert evicted,
        all_gathered so the result is REPLICATED (every process reads the
        same array — the multi-host stage-coherence contract). Feeds the
        overlapped staged schedule (sharded_resident.train_windows)."""
        key = ("insert_evict", chunk)
        if key in self._jit_cache:
            return self._jit_cache[key]
        cfg = self.cfg
        state_specs = jax.tree.map(lambda _: P(DATA_AXIS), self.state)

        def body(state, ids, rows, colors):
            local = _to_local(state)
            ids, rows, colors = ids[0], rows[0], colors[0]
            local, evicted = fc.insert_with_colors(
                cfg, local, jnp.where(ids >= 0, ids, 0), rows, ids >= 0,
                colors, return_evicted=True)
            ev_all = jax.lax.all_gather(evicted, DATA_AXIS, tiled=True)
            return _from_local(local), ev_all

        k = jax.jit(shard_map(
            body, mesh=self.mesh,
            in_specs=(state_specs, P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS)),
            out_specs=(state_specs, P()), check_vma=False))
        self._jit_cache[key] = k
        return k

    def prewarm(self, ids: np.ndarray, host_fetch,
                colors: Optional[np.ndarray] = None,
                chunk: int = 16384) -> None:
        """Bulk-populate the cache with ``ids`` via a direct insert kernel
        (no probe round trips, single cheap compile). In sharded mode each id
        lands on its owner shard; in isolated mode every device gets the full
        list. One-time cost before training; the reference reaches the same
        warm state after its first epoch (hit ratios are printed and compared
        per epoch, COALA_GNN_DataLoader.py:170-174)."""
        ids = np.unique(np.asarray(ids, dtype=np.int32).reshape(-1))
        # ids must be the same global list on every process (deterministic
        # distributor/miss-union contract); each process loads only its own
        # devices' partitions, so chunk counts agree everywhere.
        if self.n_route > 1:     # sharded: host-side ownership partition
            # node_local: owner position is within-GROUP (id % group_size ==
            # device position % group_size) — every group caches the full
            # list, like every reference node warming its own NVSHMEM world
            mod = self.n_route
            per_dev = [ids[ids % mod == p % mod] for p in self.local_positions]
            # global max partition size -> same chunk count on every process
            counts = np.bincount(ids % mod, minlength=mod) \
                if ids.size else np.zeros(mod, np.int64)
            n_chunks = max(1, int(-(-counts.max() // chunk)))
        else:                    # isolated/private: every device caches all
            per_dev = [ids for _ in self.local_positions]
            n_chunks = max(1, (len(ids) + chunk - 1) // chunk)

        k_insert = self._insert_kernel(chunk)
        for c in range(n_chunks):
            grid = np.full((self.n_local, chunk), -1, dtype=np.int32)
            rows = np.zeros((self.n_local, chunk, self.cfg.dim),
                            dtype=self._np_dtype)
            cols = np.zeros((self.n_local, chunk), dtype=np.int32)
            for d in range(self.n_local):
                part = per_dev[d][c * chunk:(c + 1) * chunk]
                if part.size == 0:
                    continue
                grid[d, : part.size] = part
                rows[d, : part.size] = host_fetch(part.astype(np.int64))
                if colors is not None:
                    cols[d, : part.size] = colors[part]
            self.state = k_insert(self.state, self._put(grid, 1),
                                  self._put(rows, 2), self._put(cols, 1))

    def insert_rows(self, ids: np.ndarray, rows: np.ndarray,
                    colors: Optional[np.ndarray] = None,
                    chunk: int = 16384, return_evicted: bool = False):
        """prewarm() with the rows already in hand: ``ids`` int32 [n] (the
        same global list on every process), ``rows`` float [n, dim] aligned
        with ids, ``colors`` int32 [n] aligned with ids (NOT per-node-id
        like prewarm's). Owner-partitions in sharded mode and batch-inserts
        without touching the host store — the staged resident path uses
        this to offer a window's already-gathered rows to the cache.

        ``return_evicted=True`` returns a list of replicated device
        handles of the evicted-id arrays (one per chunk; -1 padded) for
        the overlapped staged schedule. No host sync happens here — the
        caller reads them when it patches the next stage."""
        ids = np.asarray(ids, dtype=np.int32).reshape(-1)
        rows = np.asarray(rows)
        if self.n_route > 1:
            mod = self.n_route   # == group size in node_local mode
            idx_dev = [np.flatnonzero(ids % mod == p % mod)
                       for p in self.local_positions]
            counts = np.bincount(ids % mod, minlength=mod) \
                if ids.size else np.zeros(mod, np.int64)
            n_chunks = max(1, int(-(-counts.max() // chunk)))
        else:
            idx_dev = [np.arange(ids.size) for _ in self.local_positions]
            n_chunks = max(1, (ids.size + chunk - 1) // chunk)

        k_insert = (self._insert_evict_kernel(chunk) if return_evicted
                    else self._insert_kernel(chunk))
        evicted = []
        for c in range(n_chunks):
            grid = np.full((self.n_local, chunk), -1, dtype=np.int32)
            rbuf = np.zeros((self.n_local, chunk, self.cfg.dim),
                            dtype=self._np_dtype)
            cbuf = np.zeros((self.n_local, chunk), dtype=np.int32)
            for d in range(self.n_local):
                part = idx_dev[d][c * chunk:(c + 1) * chunk]
                if part.size == 0:
                    continue
                grid[d, : part.size] = ids[part]
                rbuf[d, : part.size] = rows[part]
                if colors is not None:
                    cbuf[d, : part.size] = colors[part]
            if return_evicted:
                self.state, ev = k_insert(self.state, self._put(grid, 1),
                                          self._put(rbuf, 2),
                                          self._put(cbuf, 1))
                try:
                    ev.copy_to_host_async()
                except Exception:
                    pass
                evicted.append(ev)
            else:
                self.state = k_insert(self.state, self._put(grid, 1),
                                      self._put(rbuf, 2), self._put(cbuf, 1))
        if return_evicted:
            return evicted

    def color_meta(self) -> np.ndarray:
        """Aggregated color-occupancy counters (the get_cache_data +
        gather_cache_meta path, ssd_gnn_cache.cuh:176-186,
        Shared_Tensor.py:96-100). Returns int32 [num_colors + 1] summed over
        THIS PROCESS's devices (the whole mesh when single-process); feed
        multihost.make_meta_exchange_fn for the cross-host half."""
        return self._read_local(self.state.color_counts).sum(axis=0) \
            .astype(np.int32)

    def prewarm_by_degree(self, graph, host_fetch,
                          colors: Optional[np.ndarray] = None,
                          chunk: int = 16384) -> int:
        """Prewarm with the highest-in-degree nodes first, up to capacity.

        When the cache cannot hold the whole graph, static degree-ordered
        admission is the strongest cold-start policy for power-law graphs
        (hub features are touched by most sampled neighborhoods — the
        PaGraph-style observation; PAPERS.md cache literature). Returns the
        number of nodes admitted."""
        deg = np.diff(np.asarray(graph.indptr))
        budget = self.cfg.capacity * max(self.n_route, 1)
        n_warm = min(graph.num_nodes, budget)
        top = np.argpartition(deg, -n_warm)[-n_warm:].astype(np.int32)
        self.prewarm(top, host_fetch, colors=colors, chunk=chunk)
        return int(n_warm)

    def local_color_meta(self) -> np.ndarray:
        """This host's color-occupancy counters (sum over the devices whose
        cache shards live on this process) — the per-node half of the
        reference's gather_cache_meta (Shared_Tensor.py:96-100). Feed the
        result to multihost.make_meta_exchange_fn for the cross-host half."""
        total = np.zeros(self.cfg.num_colors + 1, dtype=np.int64)
        for shard in self.state.color_counts.addressable_shards:
            total += np.asarray(shard.data).reshape(-1, self.cfg.num_colors + 1).sum(0)
        return total.astype(np.int32)

    def stats(self) -> dict:
        """Hit/miss counters summed over THIS PROCESS's devices, reset on
        read (reference prints per-GPU stats the same way,
        COALA_GNN_DataLoader.py:170-174)."""
        h = int(self._read_local(self.state.hits).sum())
        m = int(self._read_local(self.state.misses).sum())
        zero = self._put(np.zeros(self.n_local, np.int32), 0)
        self.state = self.state._replace(hits=zero, misses=zero)
        return {"hits": h, "misses": m,
                "hit_ratio": h / (h + m) if h + m else 0.0}


def _ceil_pow2(x: int) -> int:
    return sizing.ceil_pow2(int(x))
