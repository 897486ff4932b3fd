"""Functional set-associative device-memory feature cache.

JAX re-design of the reference's GPU feature cache
(reference: COALA_GNN_Modules/nvshmem_cache.h + isolated_cache.h): the
reference needs seqlocks, warp-cooperative probes and atomics because many
CUDA warps mutate the cache concurrently (nvshmem_cache.h:339-480). Under XLA
the cache is a pytree of arrays updated batch-synchronously inside jit with
scatter ops — races are impossible by construction, no locks exist
(SURVEY.md §5 "race detection").

Geometry parity (so cache-size configs mean the same thing):
  - ways = 32                                  (ssd_gnn_cache.cuh:61)
  - cache_dim rounds the feature dim up to {128, 256, 512, 1024}
                                               (ssd_gnn_cache.cuh:34-47)
  - num_pages = cache_MB * 2^20 / (cache_dim * 4), num_sets = num_pages / 32
                                               (ssd_gnn_cache.cuh:96-97)
  - private set index:      id % num_sets      (isolated_cache.h:184-188)
  - distributed set index: (id / n_dev) % num_sets, owner = id % n_dev
                                               (nvshmem_cache.h:192-196,
                                                cache_kernel.cu:11)
  - round-robin eviction per set               (nvshmem_cache.h:200-212)
  - per-color occupancy counters feeding the seed distributor
                                               (nvshmem_cache.h:430-446)
  - hit/miss counters reset on stats read      (nvshmem_cache.h:133-142)

All ops are pure: ``state2 = insert(cfg, state, ...)``. ids are int32 on
device (node ids < 2^31 for every supported dataset; asserted at init).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

WAYS = 32  # reference: ssd_gnn_cache.cuh:61


def assert_ids_fit_int32(num_nodes: int) -> None:
    """Node ids live on device as int32 (module docstring contract); a
    graph past 2^31-1 nodes would silently truncate ids — refuse loudly.
    Edge counts are NOT bound by this (DeviceGraph promotes offsets to
    int64)."""
    if num_nodes > np.iinfo(np.int32).max:
        raise ValueError(
            f"{num_nodes} nodes exceeds the int32 node-id domain "
            "(2^31-1); shard the node space before building device state")


def round_cache_dim(dim: int) -> int:
    """Feature dim -> cache line dim {128, 256, 512, 1024}
    (reference: ssd_gnn_cache.cuh:34-47). Dims above 1024 round up to the
    next multiple of 128 (the reference errors out there; we generalize)."""
    for d in (128, 256, 512, 1024):
        if dim <= d:
            return d
    return ((dim + 127) // 128) * 128


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    num_sets: int
    ways: int
    dim: int            # true feature dim
    cache_dim: int      # padded line dim
    num_colors: int     # 0 disables color tracking
    num_shards: int = 1  # devices the distributed cache spans (1 = private)
    dtype: jnp.dtype = jnp.float32
    quantize: bool = False  # int8 lines + per-line f32 absmax scale, in
                            # BOTH tiers (flat + set-associative): ~4x (vs
                            # f32) the capacity per MB and 1/4 the
                            # lookup-gather HBM traffic; dequant fuses into
                            # the consumer. The reference has no quantized
                            # tier (GPU cache stores raw f32 pages,
                            # ssd_gnn_cache.cuh:96); with a memory-bound
                            # gather it is a first-class lever.

    @property
    def capacity(self) -> int:
        return self.num_sets * self.ways

    @property
    def line_bytes(self) -> int:
        if self.quantize:
            return self.cache_dim + 4        # int8 row + f32 scale
        return self.cache_dim * jnp.dtype(self.dtype).itemsize

    @property
    def size_mb(self) -> float:
        return self.capacity * self.line_bytes / 2**20


class CacheState(NamedTuple):
    tags: jax.Array          # int32 [num_sets, ways], -1 = empty
    data: jax.Array          # dtype|int8 [num_sets, ways, cache_dim]
    rr: jax.Array            # int32 [num_sets] round-robin cursor
    color_counts: jax.Array  # int32 [num_colors + 1] occupancy by color
    hits: jax.Array          # int32 [] since last stats reset
    misses: jax.Array        # int32 []
    scales: Optional[jax.Array] = None  # f32 [num_sets, ways] per-line
                                        # absmax scale (quantize mode)


def make_config(cache_mb: int, dim: int, num_colors: int = 0,
                num_shards: int = 1, dtype=jnp.float32,
                min_sets: int = 1, quantize: bool = False) -> CacheConfig:
    cache_dim = round_cache_dim(dim)
    page = (cache_dim + 4) if quantize \
        else cache_dim * jnp.dtype(dtype).itemsize
    num_pages = max(int(cache_mb) * 2**20 // page, WAYS)
    num_sets = max(num_pages // WAYS, min_sets)
    return CacheConfig(num_sets=num_sets, ways=WAYS, dim=dim,
                       cache_dim=cache_dim, num_colors=num_colors,
                       num_shards=num_shards, dtype=dtype,
                       quantize=quantize)


def init_state(cfg: CacheConfig) -> CacheState:
    data_dtype = jnp.int8 if cfg.quantize else cfg.dtype
    return CacheState(
        tags=jnp.full((cfg.num_sets, cfg.ways), -1, dtype=jnp.int32),
        data=jnp.zeros((cfg.num_sets, cfg.ways, cfg.cache_dim),
                       dtype=data_dtype),
        rr=jnp.zeros(cfg.num_sets, dtype=jnp.int32),
        color_counts=jnp.zeros(cfg.num_colors + 1, dtype=jnp.int32),
        hits=jnp.zeros((), dtype=jnp.int32),
        misses=jnp.zeros((), dtype=jnp.int32),
        scales=(jnp.ones((cfg.num_sets, cfg.ways), jnp.float32)
                if cfg.quantize else None),
    )


def set_index(cfg: CacheConfig, ids: jax.Array) -> jax.Array:
    """Private: id % num_sets. Distributed: (id // num_shards) % num_sets."""
    if cfg.num_shards > 1:
        return (ids // cfg.num_shards) % cfg.num_sets
    return ids % cfg.num_sets


def _dedup_valid(ids: jax.Array, valid: jax.Array) -> jax.Array:
    """valid with within-batch duplicate ids reduced to their first
    occurrence. The distributed exchange can deliver the same id from
    several requesters in one fill batch (the reference counts these as
    ``double_read`` and lets the seqlock serialize them,
    nvshmem_cache.h:260); batch-synchronous insertion must drop them or a
    line would be admitted into two ways."""
    n = ids.shape[0]
    key = jnp.where(valid, ids, jnp.iinfo(jnp.int32).max)
    order = jnp.argsort(key, stable=True)
    sorted_key = key[order]
    first_sorted = jnp.concatenate(
        [jnp.ones(1, bool), sorted_key[1:] != sorted_key[:-1]])
    is_first = jnp.zeros(n, bool).at[order].set(first_sorted)
    return valid & is_first


def quantize_rows(rows: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """rows [..., dim] float -> (int8 rows, f32 per-row scales).
    Symmetric absmax: q = round(x / (absmax/127)); dequant = q * scale."""
    absmax = jnp.max(jnp.abs(rows.astype(jnp.float32)), axis=-1)
    scale = jnp.where(absmax > 0, absmax / 127.0, 1.0).astype(jnp.float32)
    q = jnp.clip(jnp.round(rows.astype(jnp.float32) / scale[..., None]),
                 -127, 127).astype(jnp.int8)
    return q, scale


def dequantize_rows(q: jax.Array, scale: jax.Array,
                    dtype=jnp.float32) -> jax.Array:
    return (q.astype(jnp.float32) * scale[..., None]).astype(dtype)


def _to_lines(cfg: CacheConfig, feats: jax.Array, n: int
              ) -> Tuple[jax.Array, Optional[jax.Array]]:
    """Feature rows [n, dim] -> cache lines [n, cache_dim] in the storage
    dtype (+ per-row scales in quantize mode; None otherwise)."""
    if cfg.quantize:
        q, row_scales = quantize_rows(feats)
        pad = jnp.zeros((n, cfg.cache_dim - cfg.dim), dtype=jnp.int8)
        return jnp.concatenate([q, pad], axis=1), row_scales
    pad = jnp.zeros((n, cfg.cache_dim - cfg.dim), dtype=cfg.dtype)
    return jnp.concatenate([feats.astype(cfg.dtype), pad], axis=1), None


def lookup(cfg: CacheConfig, state: CacheState, ids: jax.Array,
           valid: jax.Array, count_stats: bool = True
           ) -> Tuple[CacheState, jax.Array, jax.Array]:
    """Probe the cache for ``ids`` (int32 [n]); ``valid`` bool [n] masks
    padding slots. Returns (state', feats [n, dim], hit bool [n]); feats rows
    for misses/invalid are zero.

    The warp-strided tag compare + ballot of the reference
    (nvshmem_cache.h:148-175) becomes a vectorized compare over the set's
    ways + argmax — one gather per request row."""
    sets = set_index(cfg, ids)                       # [n]
    way_tags = state.tags[sets]                      # [n, ways]
    match = way_tags == ids[:, None]                 # [n, ways]
    hit = match.any(axis=1) & valid
    way = jnp.argmax(match, axis=1)                  # first matching way
    feats = state.data[sets, way, : cfg.dim]         # [n, dim]
    if state.scales is not None:                     # int8 lines: dequant
        feats = dequantize_rows(feats, state.scales[sets, way])
    feats = jnp.where(hit[:, None], feats, 0).astype(cfg.dtype)
    if count_stats:
        n_hit = hit.sum(dtype=jnp.int32)
        n_valid = valid.sum(dtype=jnp.int32)
        state = state._replace(hits=state.hits + n_hit,
                               misses=state.misses + (n_valid - n_hit))
    return state, feats, hit


def lookup_quantized(cfg: CacheConfig, state: CacheState, ids: jax.Array,
                     valid: jax.Array, count_stats: bool = True
                     ) -> Tuple[CacheState, jax.Array, jax.Array, jax.Array]:
    """lookup() WITHOUT the dequantize: returns the raw int8 lines and
    their per-row scales so the caller can ship the response compressed —
    the int8 exchange sends dim bytes + one f32 scale per row instead of
    4*dim bytes (~3.9x less interconnect traffic), and the requester dequantizes
    after the all_to_all (replaces the reference's raw-page response put,
    nvshmem_cache.h:381-385). Only valid for quantized caches
    (state.scales is not None). Returns (state', q int8 [n, dim],
    scales f32 [n], hit bool [n]); missed rows are zero with scale 1."""
    sets = set_index(cfg, ids)
    way_tags = state.tags[sets]
    match = way_tags == ids[:, None]
    hit = match.any(axis=1) & valid
    way = jnp.argmax(match, axis=1)
    q = state.data[sets, way, : cfg.dim]
    sc = state.scales[sets, way]
    q = jnp.where(hit[:, None], q, 0)
    sc = jnp.where(hit, sc, 1.0)
    if count_stats:
        n_hit = hit.sum(dtype=jnp.int32)
        n_valid = valid.sum(dtype=jnp.int32)
        state = state._replace(hits=state.hits + n_hit,
                               misses=state.misses + (n_valid - n_hit))
    return state, q, sc, hit


def probe(cfg: CacheConfig, state: CacheState, ids: jax.Array,
          valid: jax.Array) -> jax.Array:
    """Residency check only: tags compare, no data gather, no stats.
    Returns hit bool [n]. The cheap half of lookup() for prefetch planning."""
    sets = set_index(cfg, ids)
    return (state.tags[sets] == ids[:, None]).any(axis=1) & valid


def insert(cfg: CacheConfig, state: CacheState, ids: jax.Array,
           feats: jax.Array, valid: jax.Array) -> CacheState:
    """Admit rows into the cache. ids int32 [n] (must be unique among valid
    entries — the sampler's dedup guarantees this), feats [n, dim],
    valid bool [n], colors int32 [n] (1-based; 0 = uncolored).

    Placement: if the id is already resident, refresh its way in place;
    otherwise claim ways round-robin from the set cursor. Multiple new
    arrivals to one set claim consecutive ways via their within-set
    occurrence rank (the batch-synchronous equivalent of the reference's
    lock + rr_evict sequence, nvshmem_cache.h:417-446).

    Duplicate-scatter discipline: every (set, way) slot is written by AT
    MOST ONE row, so the three scatters (tags/data/colors) can never
    diverge on XLA's unspecified duplicate-index ordering. Two cases are
    masked: (a) >ways new arrivals to one set would wrap the cursor — only
    the first `ways` ranks insert (the rest are dropped; a set can only
    hold `ways` lines anyway); (b) a same-batch refresh whose way is
    claimed by a new arrival is dropped — the new line evicts it, which is
    exactly what the reference's serialized lock sequence would do."""
    n = ids.shape[0]
    valid = _dedup_valid(ids, valid)
    sets = set_index(cfg, ids)

    # Existing-way refresh?
    way_tags = state.tags[sets]
    match = way_tags == ids[:, None]
    already = match.any(axis=1)
    match_way = jnp.argmax(match, axis=1)

    # Within-set occurrence rank among NEW valid insertions.
    is_new = valid & ~already
    sort_key = jnp.where(is_new, sets, cfg.num_sets)  # invalid sorts last
    order = jnp.argsort(sort_key, stable=True)
    sorted_key = sort_key[order]
    # rank within equal-key run
    first_of_run = jnp.searchsorted(sorted_key, sorted_key, side="left")
    rank_sorted = jnp.arange(n, dtype=jnp.int32) - first_of_run.astype(jnp.int32)
    rank = jnp.zeros(n, dtype=jnp.int32).at[order].set(rank_sorted)

    is_new = is_new & (rank < cfg.ways)               # no cursor wrap (a)
    new_way = (state.rr[sets] + rank) % cfg.ways
    way = jnp.where(already, match_way, new_way)

    # Drop refreshes whose way a same-batch new arrival claims (b).
    claimed = jnp.zeros((cfg.num_sets, cfg.ways), jnp.bool_).at[
        jnp.where(is_new, sets, cfg.num_sets), way].set(True, mode="drop")
    clobbered = valid & already & claimed[sets, way]
    valid = valid & ~clobbered & (is_new | already)

    # Victim bookkeeping for color counters.
    victim_tag = state.tags[sets, way]
    victim_valid = (victim_tag >= 0) & is_new

    # Scatter updates (drop invalid rows).
    drop_sets = jnp.where(valid, sets, cfg.num_sets)  # OOB -> dropped
    lines, row_scales = _to_lines(cfg, feats, n)
    tags = state.tags.at[drop_sets, way].set(ids, mode="drop")
    data = state.data.at[drop_sets, way].set(lines, mode="drop")
    scales = state.scales
    if scales is not None:
        scales = scales.at[drop_sets, way].set(row_scales, mode="drop")

    # Advance each set's cursor by how many new lines it admitted.
    per_set_new = jnp.zeros(cfg.num_sets, dtype=jnp.int32).at[
        jnp.where(is_new, sets, cfg.num_sets)].add(1, mode="drop")
    rr = (state.rr + per_set_new) % cfg.ways

    return CacheState(tags=tags, data=data, rr=rr,
                      color_counts=state.color_counts,
                      hits=state.hits, misses=state.misses, scales=scales)


class ColoredCacheState(NamedTuple):
    """CacheState + per-line color side table (the reference stores colors
    per cacheline to decrement the right counter on eviction,
    nvshmem_cache.h:430-446). ``line_prio`` (optional) is the per-line
    admission priority used by priority-aware eviction; None preserves the
    reference's round-robin policy (nvshmem_cache.h:200-212)."""
    base: CacheState
    line_colors: jax.Array   # int32 [num_sets, ways], 0 = uncolored/empty
    line_prio: Optional[jax.Array] = None  # f32 [num_sets, ways]


#: priority value for empty ways — any real priority admits over them
EMPTY_PRIO = jnp.float32(-3.0e38)


def init_colored_state(cfg: CacheConfig,
                       track_prio: bool = False) -> ColoredCacheState:
    return ColoredCacheState(
        base=init_state(cfg),
        line_colors=jnp.zeros((cfg.num_sets, WAYS), dtype=jnp.int32),
        line_prio=(jnp.full((cfg.num_sets, WAYS), EMPTY_PRIO, jnp.float32)
                   if track_prio else None))


def insert_with_colors(cfg: CacheConfig, cstate: ColoredCacheState,
                       ids: jax.Array, feats: jax.Array, valid: jax.Array,
                       colors: jax.Array,
                       prios: Optional[jax.Array] = None,
                       return_evicted: bool = False):
    """insert() + color occupancy accounting (same duplicate-scatter
    discipline as insert(): one writer per (set, way) slot).

    ``return_evicted=True`` additionally returns the int32 [n] array of
    ids this insert evicted (-1 where row i evicted nothing: refreshes,
    rejected admissions, empty ways). The overlapped staged schedule
    (parallel/resident.py train_windows) needs it: a presample probe that
    ran BEFORE this insert underestimates the next window's misses by
    exactly the lines the insert evicts, so the host patches these ids
    into the next stage. A clobbered same-batch refresh (case (b)) is
    captured too — the victim tag read at the new arrival's way IS the
    clobbered id.

    With ``prios`` (f32 [n], requires a state built with track_prio=True)
    eviction becomes priority-aware: a new row's victim is its set's
    LOWEST-priority way, and the row is admitted only if it outranks that
    victim. One-touch cold rows can then never evict hub lines — the
    scan-resistance the reference's round-robin policy lacks and the fix
    for the capacity-pressure thrashing regime. The
    reference's color counters feed its distributor the same way
    (node_distributor_pybind.cuh:191-195); here the counters stay exact
    because rejected rows never touch occupancy."""
    state = cstate.base
    if prios is not None and cstate.line_prio is None:
        raise ValueError(
            "insert_with_colors got prios but the state was built without "
            "track_prio=True — priority-aware eviction would be silently "
            "lost; pass track_prio=True to init_colored_state")
    use_prio = prios is not None and cstate.line_prio is not None
    n = ids.shape[0]
    valid = _dedup_valid(ids, valid)
    sets = set_index(cfg, ids)
    way_tags = state.tags[sets]
    match = way_tags == ids[:, None]
    already = match.any(axis=1)
    match_way = jnp.argmax(match, axis=1)
    is_new = valid & ~already

    # Within-set occurrence rank among new arrivals. With priorities the
    # rank orders arrivals by DESCENDING priority (lexsort: stable sort by
    # -prio first, then by set) so the strongest arrival meets the weakest
    # victim.
    sort_key = jnp.where(is_new, sets, cfg.num_sets)
    if use_prio:
        o1 = jnp.argsort(jnp.where(is_new, -prios, jnp.inf), stable=True)
        o2 = jnp.argsort(sort_key[o1], stable=True)
        order = o1[o2]
    else:
        order = jnp.argsort(sort_key, stable=True)
    sorted_key = sort_key[order]
    first_of_run = jnp.searchsorted(sorted_key, sorted_key, side="left")
    rank_sorted = jnp.arange(n, dtype=jnp.int32) - first_of_run.astype(jnp.int32)
    rank = jnp.zeros(n, dtype=jnp.int32).at[order].set(rank_sorted)

    is_new = is_new & (rank < cfg.ways)
    if use_prio:
        # victim for the rank-th arrival = the set's rank-th lowest-prio way
        way_prio = cstate.line_prio[sets]                    # [n, ways]
        way_order = jnp.argsort(way_prio, axis=1)            # ascending
        rank_c = jnp.clip(rank, 0, cfg.ways - 1)[:, None]
        new_way = jnp.take_along_axis(way_order, rank_c, axis=1)[:, 0]
        victim_prio = jnp.take_along_axis(
            jnp.take_along_axis(way_prio, way_order, axis=1), rank_c,
            axis=1)[:, 0]
        is_new = is_new & (prios > victim_prio)              # admission
    else:
        new_way = (state.rr[sets] + rank) % cfg.ways
    way = jnp.where(already, match_way, new_way)
    claimed = jnp.zeros((cfg.num_sets, cfg.ways), jnp.bool_).at[
        jnp.where(is_new, sets, cfg.num_sets), way].set(True, mode="drop")
    clobbered = valid & already & claimed[sets, way]
    valid = valid & ~clobbered & (is_new | already)
    victim_color = cstate.line_colors[sets, way]
    evicted = None
    if return_evicted:
        victim_tag = state.tags[sets, way]
        evicted = jnp.where(is_new & valid & (victim_tag >= 0),
                            victim_tag, -1)

    drop_sets = jnp.where(valid, sets, cfg.num_sets)
    lines, row_scales = _to_lines(cfg, feats, n)
    tags = state.tags.at[drop_sets, way].set(ids, mode="drop")
    data = state.data.at[drop_sets, way].set(lines, mode="drop")
    scales = state.scales
    if scales is not None:
        scales = scales.at[drop_sets, way].set(row_scales, mode="drop")
    line_colors = cstate.line_colors.at[
        jnp.where(is_new, sets, cfg.num_sets), way].set(colors, mode="drop")
    line_prio = cstate.line_prio
    if use_prio:
        line_prio = line_prio.at[drop_sets, way].set(
            prios.astype(jnp.float32), mode="drop")

    per_set_new = jnp.zeros(cfg.num_sets, dtype=jnp.int32).at[
        jnp.where(is_new, sets, cfg.num_sets)].add(1, mode="drop")
    rr = (state.rr + per_set_new) % cfg.ways

    # Occupancy: -victim color (only when a new line actually replaced it),
    # +incoming color, both dropped at slot 0 (color 0 = untracked).
    cc = state.color_counts
    dec_idx = jnp.where(is_new & (victim_color > 0), victim_color, 0)
    inc_idx = jnp.where(is_new & (colors > 0), colors, 0)
    cc = cc.at[dec_idx].add(-1).at[inc_idx].add(1)
    cc = cc.at[0].set(0)  # slot 0 is scratch, keep it clean

    base = CacheState(tags=tags, data=data, rr=rr, color_counts=cc,
                      hits=state.hits, misses=state.misses, scales=scales)
    out = ColoredCacheState(base=base, line_colors=line_colors,
                            line_prio=line_prio)
    return (out, evicted) if return_evicted else out


# ---- flat (direct-mapped) resident tier ----------------------------------
#
# When device HBM can hold EVERY feature row (capacity >= num_nodes), the
# set-associative machinery is pure overhead: the probe costs two dependent
# random gathers (tags row + data row) per request, but a flat [N, dim]
# table needs exactly one and can never evict. The reference has no such
# tier because its GPUs could never fit its datasets' features; where the
# table fits it is the natural top of the storage hierarchy (flat HBM > associative HBM
# cache > host RAM > disk). ResidentTrainer auto-selects it.

class FlatState(NamedTuple):
    data: jax.Array          # dtype|int8 [num_nodes + 1, dim] (+1 scratch)
    admitted: jax.Array      # uint8 [num_nodes + 1]
    color_counts: jax.Array  # int32 [num_colors + 1]
    hits: jax.Array          # int32 []
    misses: jax.Array        # int32 []
    scale: Optional[jax.Array] = None  # f32 [num_nodes + 1] (quantize mode)


def flat_init(cfg: CacheConfig, num_nodes: int) -> FlatState:
    data_dtype = jnp.int8 if cfg.quantize else cfg.dtype
    return FlatState(
        data=jnp.zeros((num_nodes + 1, cfg.dim), dtype=data_dtype),
        admitted=jnp.zeros(num_nodes + 1, dtype=jnp.uint8),
        color_counts=jnp.zeros(cfg.num_colors + 1, dtype=jnp.int32),
        hits=jnp.zeros((), dtype=jnp.int32),
        misses=jnp.zeros((), dtype=jnp.int32),
        scale=(jnp.ones(num_nodes + 1, jnp.float32) if cfg.quantize
               else None))


def flat_lookup(state: FlatState, ids: jax.Array, valid: jax.Array,
                count_stats: bool = True, assume_hit: bool = False,
                dtype=jnp.float32
                ) -> Tuple[FlatState, jax.Array, jax.Array]:
    """One gather (plus the tiny scale gather in quantize mode; dequant
    fuses into the consumer). assume_hit=True skips the residency-byte
    gather entirely (valid only when the caller guarantees admission, e.g.
    a presampled fused window or full prewarm). ``dtype`` is the output
    feature dtype in quantize mode (pass cfg.dtype for parity with
    lookup(), which casts its output)."""
    feats = state.data[ids]
    if state.scale is not None:
        feats = dequantize_rows(feats, state.scale[ids], dtype=dtype)
    if assume_hit:
        hit = valid
    else:
        hit = (state.admitted[ids] > 0) & valid
        feats = jnp.where(hit[:, None], feats, 0)
    if count_stats:
        n_hit = hit.sum(dtype=jnp.int32)
        n_valid = valid.sum(dtype=jnp.int32)
        state = state._replace(hits=state.hits + n_hit,
                               misses=state.misses + (n_valid - n_hit))
    return state, feats, hit


def flat_probe(state: FlatState, ids: jax.Array, valid: jax.Array
               ) -> jax.Array:
    return (state.admitted[ids] > 0) & valid


def flat_insert(cfg: CacheConfig, state: FlatState, ids: jax.Array,
                feats: jax.Array, valid: jax.Array,
                colors: jax.Array) -> FlatState:
    """Admit rows (no eviction possible; re-admission refreshes in place).
    Color occupancy counts first admissions only."""
    n_nodes = state.data.shape[0] - 1
    slot = jnp.where(valid, ids, n_nodes)         # scratch row for invalid
    scale = state.scale
    if scale is not None:
        q, s = quantize_rows(feats)
        data = state.data.at[slot].set(q)
        scale = scale.at[slot].set(s)
    else:
        data = state.data.at[slot].set(feats.astype(state.data.dtype))
    if cfg.num_colors > 0:
        # dedup within-batch repeats so a node's color is counted once
        first = _dedup_valid(ids, valid)
        newly = first & (state.admitted[slot] == 0)
    else:
        newly = valid
    admitted = state.admitted.at[slot].set(1)
    admitted = admitted.at[n_nodes].set(0)
    inc_idx = jnp.where(newly & (colors > 0), colors, 0)
    cc = state.color_counts.at[inc_idx].add(1).at[0].set(0)
    return FlatState(data=data, admitted=admitted, color_counts=cc,
                     hits=state.hits, misses=state.misses, scale=scale)


def stats(state: CacheState) -> Tuple[CacheState, dict]:
    """Read + reset hit/miss counters (reference resets on every
    print_stats, nvshmem_cache.h:133-142)."""
    h, m = int(state.hits), int(state.misses)
    state = state._replace(hits=jnp.zeros((), jnp.int32),
                           misses=jnp.zeros((), jnp.int32))
    ratio = h / (h + m) if (h + m) else 0.0
    return state, {"hits": h, "misses": m, "hit_ratio": ratio}
