"""On-device fanout neighbor sampling (graph topology resident in HBM).

The host sampler (sampling/neighbor.py) mirrors the reference's host-driven
pipeline; this module goes where CUDA/DGL could not: with CSC ``indptr`` /
``indices`` resident in device HBM (papers100M's topology is ~7 GB int32 —
it fits), sampling, frontier dedup and block construction all run inside
jit. The only host->device transfer per training step is the seed list
(~4 KB), replacing the reference's entire UVA-sampling + request machinery
(COALA_GNN_DataLoader.py:162, cache_kernel.cu:4-17).

All shapes are static (the same batch x prod(fanout+1) capacities as the
host sampler); padded destination rows use the sentinel id ``num_nodes``
whose degree is defined as 0, so they sample nothing and dedup into a
single run that is forced to sort after every real node.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from coala_gnn.models.layers import DeviceBlock
from coala_gnn.sampling.neighbor import block_capacities


class DeviceGraph(NamedTuple):
    """CSC topology in device memory. indptr is padded with one extra
    trailing entry so the sentinel id (num_nodes) reads degree 0.

    Edge offsets (indptr) auto-promote from int32 to uint32 above 2^31-1
    edges — a symmetrized papers100M has ~3.2B edges
    (ssd_gnn_dataloader.py:819 scale), which uint32 covers without the
    global jax_enable_x64 switch. Node ids and indices stay int32
    (num_nodes < 2^31 asserted at build). Past 2^32-1 edges the
    single-replica layout is refused (use the host-sampler pipeline or a
    sharded topology)."""
    indptr: jax.Array    # int32/uint32 [num_nodes + 2]
    indices: jax.Array   # int32 [num_edges]
    edge_types: Optional[jax.Array] = None  # int32 [num_edges] (hetero)
    # Optional padded-neighbor-table layout (to_device_graph nbr_cap=P):
    # row i holds node i's first min(deg, P) neighbors (a seeded random
    # P-subset when deg > P), plus a trailing sentinel row. Sampling then
    # reads one aligned [P]-row per dst instead of 2 indptr entries + F
    # scattered element reads of `indices` — the layout the sampling
    # micro-profile (examples/profile_sampling.py) measures against CSR.
    nbr_table: Optional[jax.Array] = None   # int32 [num_nodes + 1, P]
    nbr_deg: Optional[jax.Array] = None     # int32 [num_nodes + 1], min(deg, P)
    rel_table: Optional[jax.Array] = None   # int32 [num_nodes + 1, P] (hetero)

    @property
    def num_nodes(self) -> int:
        return self.indptr.shape[0] - 2


def fits_device_graph(num_nodes: int, num_edges: int) -> bool:
    """Whether the single-replica device-resident topology layout can
    represent this graph (trainers use this to auto-fall back to the host
    sampling pipeline)."""
    return (num_nodes <= np.iinfo(np.int32).max
            and num_edges <= np.iinfo(np.uint32).max)


def to_device_graph(graph, force_wide_offsets: bool = False,
                    nbr_cap: Optional[int] = None,
                    nbr_seed: int = 0) -> DeviceGraph:
    """Host CSCGraph -> device-resident DeviceGraph. Edge offsets (indptr)
    use int32 when they fit and promote to uint32 past 2^31-1 edges;
    force_wide_offsets exercises the large-graph layout on small inputs
    (tests).

    ``nbr_cap=P`` additionally builds the padded-neighbor-table layout
    ([N+1, P] dense rows + effective degrees): sampling reads one aligned
    row per dst instead of the 2-level indptr/indices gather. Sampling is
    BIT-IDENTICAL to the CSR path for nodes with deg <= P (the table row
    stores neighbors in CSR order and the same offset draw applies); nodes
    with deg > P sample uniformly from a seeded random P-subset (chosen
    once here, without replacement) — a bounded-degree truncation akin to
    DGL's neighbor cap. Costs (N+1) * P * 4 bytes of HBM per replica (x2
    for hetero rel tables)."""
    from coala_gnn.cache.feature_cache import assert_ids_fit_int32

    assert_ids_fit_int32(graph.num_nodes)
    indptr = np.asarray(graph.indptr, dtype=np.int64)
    pad = np.concatenate([indptr, indptr[-1:]]).astype(np.int64)
    if pad[-1] > np.iinfo(np.uint32).max:
        raise ValueError(
            f"graph has {int(pad[-1])} edges (> uint32 offsets); the "
            "single-replica resident layout tops out at 2^32-1 edges — "
            "use the host pipeline (fits_device_graph gates this)")
    off_dtype = (jnp.uint32 if force_wide_offsets
                 or pad[-1] > np.iinfo(np.int32).max else jnp.int32)
    et = getattr(graph, "edge_types", None)
    nbr_table = nbr_deg = rel_table = None
    if nbr_cap is not None:
        if nbr_cap < 1:
            raise ValueError("nbr_cap must be >= 1")
        N, P_ = graph.num_nodes, int(nbr_cap)
        indices_np = np.asarray(graph.indices, dtype=np.int64)
        deg = np.diff(indptr)                              # true degree [N]
        tbl = np.empty((N + 1, P_), np.int32)
        deg_eff = np.minimum(deg, P_).astype(np.int32)
        if indices_np.size:
            col = np.arange(P_, dtype=np.int64)
            # slot j of row i = neighbor (j mod deg_i) — CSR order, so
            # offset draws < deg_eff hit exactly the CSR neighbor
            pos = indptr[:-1, None] + col[None, :] % np.maximum(deg, 1)[:, None]
            pos = np.where(deg[:, None] > 0, pos, 0)
            # deg > P rows: one seeded random P-subset (no replacement)
            rng = np.random.default_rng(nbr_seed)
            for i in np.flatnonzero(deg > P_):
                pos[i] = indptr[i] + rng.choice(deg[i], P_, replace=False)
            tbl[:-1] = np.where(deg[:, None] > 0, indices_np[pos],
                                np.arange(N, dtype=np.int64)[:, None])
            if et is not None:
                rel = np.empty((N + 1, P_), np.int32)
                rel[:-1] = np.where(deg[:, None] > 0,
                                    np.asarray(et, np.int64)[pos], 0)
                rel[-1] = 0
                rel_table = jnp.asarray(rel)
        else:
            tbl[:-1] = np.arange(N, dtype=np.int32)[:, None]
        tbl[-1] = N                                        # sentinel row
        nbr_table = jnp.asarray(tbl)
        nbr_deg = jnp.asarray(np.concatenate(
            [deg_eff, np.zeros(1, np.int32)]))
    return DeviceGraph(
        indptr=jnp.asarray(pad, off_dtype),
        indices=jnp.asarray(np.asarray(graph.indices), jnp.int32),
        edge_types=None if et is None else jnp.asarray(np.asarray(et),
                                                       jnp.int32),
        nbr_table=nbr_table, nbr_deg=nbr_deg, rel_table=rel_table)


def _sample_layer(g: DeviceGraph, dst: jax.Array, fanout: int,
                  key: jax.Array
                  ) -> Tuple[jax.Array, jax.Array, Optional[jax.Array]]:
    """One layer: (nbr int32 [n, fanout], mask f32 [n, fanout], rel or None).
    Same slot semantics as the host sampler: deg<=f takes all in order,
    deg>f draws uniformly with replacement; masked slots point at dst.
    Hetero graphs (g.edge_types set) also gather the chosen edges' types.

    With the padded-table layout (g.nbr_table set) the same offset draw
    indexes dense [P]-rows: one contiguous row gather + a row-local
    take_along_axis replaces the indptr reads + scattered element gather —
    bit-identical results for deg <= P (table rows are in CSR order)."""
    n = dst.shape[0]
    k = jnp.arange(fanout, dtype=jnp.int32)[None, :]
    if g.nbr_table is not None:
        deg = g.nbr_deg[dst]             # effective degree min(deg, P)
        mask = k < jnp.minimum(deg, fanout)[:, None]
        rand = jax.random.uniform(key, (n, fanout))
        rand_off = (rand * jnp.maximum(deg, 1)[:, None]).astype(jnp.int32)
        seq_off = jnp.minimum(k, jnp.maximum(deg[:, None] - 1, 0))
        offsets = jnp.where(deg[:, None] <= fanout, seq_off, rand_off)
        rows = g.nbr_table[dst]                        # [n, P] row gather
        nbr = jnp.take_along_axis(rows, offsets, axis=1)
        nbr = jnp.where(mask, nbr, dst[:, None])
        rel = None
        if g.rel_table is not None:
            rel = jnp.where(
                mask, jnp.take_along_axis(g.rel_table[dst], offsets, axis=1),
                0)
        return nbr, mask.astype(jnp.float32), rel
    starts = g.indptr[dst]               # int32 or uint32 (wide offsets)
    deg = (g.indptr[dst + 1] - starts).astype(jnp.int32)
    mask = k < jnp.minimum(deg, fanout)[:, None]

    rand = jax.random.uniform(key, (n, fanout))
    rand_off = (rand * jnp.maximum(deg, 1)[:, None]).astype(jnp.int32)
    seq_off = jnp.minimum(k, jnp.maximum(deg[:, None] - 1, 0))
    offsets = jnp.where(deg[:, None] <= fanout, seq_off, rand_off)
    edge_pos = starts[:, None] + offsets.astype(starts.dtype)
    nbr = g.indices[edge_pos]
    nbr = jnp.where(mask, nbr, dst[:, None])
    rel = None
    if g.edge_types is not None:
        rel = jnp.where(mask, g.edge_types[edge_pos], 0)
    return nbr, mask.astype(jnp.float32), rel


def _dedup_first_occurrence(cat: jax.Array, sentinel: int
                            ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Static-shape first-occurrence dedup.

    cat [L] int32 (may contain `sentinel`). Returns
      uniq  [L] int32 — unique values in order of first occurrence, sentinel
                        (if present) forced last, tail zero-filled
      local [L] int32 — uniq-index of each cat element
      num   scalar    — count of unique non-sentinel values
    """
    L = cat.shape[0]
    pos = jnp.arange(L, dtype=jnp.int32)
    order = jnp.argsort(cat, stable=True)
    s = cat[order]
    p = pos[order]
    new_run = jnp.concatenate([jnp.ones(1, bool), s[1:] != s[:-1]])
    run_id = jnp.cumsum(new_run) - 1                     # [L]
    n_runs = run_id[-1] + 1

    first_pos = jax.ops.segment_min(p, run_id, num_segments=L)   # per run
    run_val = jax.ops.segment_min(s, run_id, num_segments=L)
    # rank runs by first occurrence; sentinel run (and empty run slots,
    # which segment_min filled with INT_MAX) forced last.
    big = jnp.int32(2 * L + 2)
    rank_key = jnp.where(run_val == sentinel, big,
                         jnp.minimum(first_pos, big))
    run_order = jnp.argsort(rank_key, stable=True)       # run ids by rank
    run_rank = jnp.zeros(L, jnp.int32).at[run_order].set(
        jnp.arange(L, dtype=jnp.int32))

    local_sorted = run_rank[run_id]
    local = jnp.zeros(L, jnp.int32).at[order].set(local_sorted)
    uniq = jnp.zeros(L, jnp.int32).at[local_sorted].set(s)
    has_sent = (cat == sentinel).any()
    num = n_runs - has_sent.astype(n_runs.dtype)
    return uniq, local, num


def sample_blocks_device(g: DeviceGraph, seeds: jax.Array,
                         fanouts: Sequence[int], batch_size: int,
                         key: jax.Array, dedup: bool = True
                         ) -> Tuple[List[DeviceBlock], jax.Array, jax.Array]:
    """Full multi-layer sampling in jit.

    seeds int32 [batch]. Returns (blocks input-most first, input_ids
    [cap_src0] int32, num_input scalar int32). Matches the host sampler's
    block contract (dst prefix, local adj, masks).

    dedup=False skips the sort-based frontier dedup: the source array keeps
    duplicates ([dst | sampled slots] with *static* adj indices) and
    sentinel padding is scattered rather than a prefix. The three big sorts
    per step cost more than the ~1.7x extra gather redundancy they save —
    dedup was a host-link optimization; on device, redundant gathers are
    cheap. Callers must treat `input_ids` entries
    equal to `g.num_nodes` (the sentinel) as invalid rather than relying on
    a valid prefix; `num_input` returns the count of non-sentinel entries."""
    caps = block_capacities(batch_size, fanouts)
    sentinel = g.num_nodes
    blocks: List[DeviceBlock] = []
    dst = seeds.astype(jnp.int32)
    num_dst = jnp.int32(batch_size)
    valid_dst = None  # dedup=False: bool mask over dst rows
    ids = num = None
    for layer in range(len(fanouts) - 1, -1, -1):
        fanout = fanouts[layer]
        cap_dst, cap_src = caps[layer]
        # pad dst to this layer's capacity with the sentinel
        pad = cap_dst - dst.shape[0]
        if pad:
            dst = jnp.concatenate(
                [dst, jnp.full(pad, sentinel, jnp.int32)])
        if dedup:
            dst = jnp.where(jnp.arange(cap_dst) < num_dst, dst, sentinel)
        elif valid_dst is not None:
            pad_v = jnp.zeros(pad, bool) if pad else None
            if pad:
                valid_dst = jnp.concatenate([valid_dst, pad_v])
            dst = jnp.where(valid_dst, dst, sentinel)

        key, sub = jax.random.split(key)
        nbr, mask, rel = _sample_layer(g, dst, fanout, sub)
        if dedup:
            cat = jnp.concatenate([dst, nbr.reshape(-1)])
            uniq, local, num = _dedup_first_occurrence(cat, sentinel)
            adj = local[cap_dst:].reshape(cap_dst, fanout)
            ids, dst, num_dst = uniq, uniq, num
        else:
            cat = jnp.concatenate([dst, nbr.T.reshape(-1)])
            # static local indexing, SLOT-MAJOR: slot (i, k) lives at row
            # cap_dst + k*cap_dst + i. adj=None marks this contiguous
            # layout — consumers reshape instead of gathering
            # (ops/aggregate.neighbor_view). Slot-major (not dst-major,
            # r3): the weighted fanout reduce becomes F streaming
            # plane-FMAs over contiguous [cap, D] slices instead of a
            # strided reduce over a non-pow2 fanout axis.
            adj = None
            ids = cat
            valid_dst = cat != sentinel
            num = valid_dst.sum(dtype=jnp.int32)
            dst = cat
        if rel is None:
            blocks.insert(0, DeviceBlock(adj=adj, mask=mask))
        else:
            from coala_gnn.models.hetero import DeviceHeteroBlock
            blocks.insert(0, DeviceHeteroBlock(adj=adj, mask=mask, rel=rel))
    return blocks, ids, num
