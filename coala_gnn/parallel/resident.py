"""Device-resident training pipeline (single device).

The device-resident formulation of COALA's data path: graph topology lives
in device memory, sampling + frontier dedup + cache probe + label gather run in ONE jit,
and the train step in a second — per step the host uploads only the seed
list (~4 KB) and reads back a 4-byte miss count. Replaces, on-device, the
reference's entire host pipeline: UVA sampling (COALA_GNN_DataLoader.py:162),
request build/send (cache_kernel.cu:4-17) and feature read
(ssd_gnn_cache.cuh:132-174).

Capacity pressure (the regime COALA exists for) runs through STAGED fused
windows: a presample probe reports the window's cache misses as a node
bitmap, the host gathers exactly those unique rows once and uploads them
into a sideband *stage* buffer, and the fused window overlays stage rows
onto cache misses via a per-window position map. Correctness never
depends on cache inserts: the cache can reject one-touch rows (priority
admission, feature_cache.insert_with_colors) and hub lines stay resident
instead of thrashing — the reference's cache must admit every miss
(nvshmem_cache.h:417-446) because its output path only reads cache lines.
Transfer per window is the *unique* miss set, optionally compressed
(bf16/int8 + per-row scale) across the host link, which is the provable
lower bound for any backing-store design serving the same misses.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import optax

from coala_gnn.cache import feature_cache as fc
from coala_gnn.sampling.device_sampler import (
    DeviceGraph,
    sample_blocks_device,
    to_device_graph,
)
from coala_gnn.sampling.neighbor import block_capacities
from coala_gnn.utils.timers import PhaseTimers
from coala_gnn.utils.rng import wrap_key_any

INT32_MAX = np.iinfo(np.int32).max


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def stage_cap(n: int) -> int:
    """Stage-buffer capacity for n miss rows: pow2 up to 8192 (few compiled
    shapes for the small/test regimes), then multiples of 8192 — pow2
    padding wasted up to 2x the stage upload (67 MB shipped for 36 MB of
    rows at the r5 48 MB pressure point) and the upload is the staged
    window's dominant wire cost. Miss counts are stable within a run, so
    the coarse granule still compiles O(1) shapes."""
    n = max(int(n), 1)
    if n <= 8192:
        return _pow2(n)
    return -(-n // 8192) * 8192


def encode_stage_rows(rows: np.ndarray, transport: str):
    """Host-side transport encoding of staged miss rows.

    f32 rows [n, dim] -> (encoded rows, scales or None). int8 is symmetric
    per-row absmax (identical to the quantized cache-line format,
    feature_cache.quantize_rows) so a staged row dequantizes to exactly
    what an int8 cache hit would have served."""
    if transport == "float32":
        return rows.astype(np.float32, copy=False), None
    if transport == "bfloat16":
        from coala_gnn.native.lib import encode_bf16
        enc = encode_bf16(rows)   # multithreaded RNE cast (the ml_dtypes
        if enc is not None:       # astype is single-threaded and was SLOWER
            return enc, None      # than shipping f32)
        import ml_dtypes
        return rows.astype(ml_dtypes.bfloat16), None
    if transport == "int8":
        from coala_gnn.native.lib import quantize_rows_native
        q, scale = quantize_rows_native(rows)
        if q is not None:
            return q, scale
        # numpy fallback: in-place, f32-scalar ops (np.clip/rint with
        # python scalars cost 5x the traffic via f64 promotion — measured
        # 3.3s/window at [82k, 1024] before this, ~0.3s after)
        absmax = np.abs(rows).max(axis=1)
        scale = np.where(absmax > 0, absmax / np.float32(127.0),
                         np.float32(1.0)).astype(np.float32)
        d = rows / scale[:, None]
        np.rint(d, out=d)
        np.minimum(d, np.float32(127.0), out=d)
        np.maximum(d, np.float32(-127.0), out=d)
        return d.astype(np.int8), scale
    raise ValueError(f"unknown stage transport {transport!r}")


class HostScratch:
    """Rotating (2-deep) host scratch pool. Fresh 100s-of-MB numpy
    allocations per window page-fault on first touch inside the gather's
    parallel loop, which made host_gather vary many-fold run to run. Two
    buffers per key alternate; a buffer is only rewritten two windows
    after it was uploaded, by which point the staged schedules'
    per-window probe readback has synced past every computation that
    could still read it (incl. CPU-backend aliasing and asynchronous
    host-to-device copies)."""

    def __init__(self):
        self._bufs: dict = {}
        self._flip: dict = {}

    def get(self, name: str, shape: tuple, dtype) -> np.ndarray:
        key = (name, shape, np.dtype(dtype).str)
        pair = self._bufs.get(key)
        if pair is None:
            pair = [np.zeros(shape, dtype), np.zeros(shape, dtype)]
            self._bufs[key] = pair
            self._flip[key] = 0
        i = self._flip[key] = 1 - self._flip[key]
        return pair[i]


def merge_evicted_patch(mids: np.ndarray, gathered: np.ndarray,
                        evicted_ids: np.ndarray, host_fetch):
    """Merge a previous insert's evicted ids into a probe-miss stage as
    PATCH rows (overlapped schedule, single-device + mesh): patch rows are
    included in the window overlay (exactness: the probe ran before the
    insert and could not see these evictions) but marked non-offerable —
    re-admitting rows no window requested evicts useful lines and
    ping-pongs with the next insert (measured: hit-ratio regression vs the
    serial schedule). Returns (mids, gathered, offer bool[n]) with the
    merge kept id-sorted for the position map."""
    offer = np.ones(mids.size, bool)
    ev = np.unique(evicted_ids[evicted_ids >= 0]).astype(np.int32)
    ev = ev[np.isin(ev, mids, assume_unique=True, invert=True)]
    if ev.size:
        ev_rows = host_fetch(ev.astype(np.int64)).astype(np.float32,
                                                         copy=False)
        order = np.argsort(np.concatenate([mids, ev]), kind="stable")
        mids = np.concatenate([mids, ev])[order]
        gathered = np.concatenate([gathered, ev_rows])[order]
        offer = np.concatenate([offer, np.zeros(ev.size, bool)])[order]
    return mids, gathered, offer


@dataclasses.dataclass
class ResidentTrainer:
    graph: object                 # host CSCGraph
    host_fetch: Callable          # host tier fn(ids)->rows
    labels: np.ndarray            # [num_nodes]
    cache_cfg: fc.CacheConfig
    model: object                 # models.Stack (init/apply)
    tx: optax.GradientTransformation
    fanouts: Sequence[int]
    batch_size: int
    colors: Optional[np.ndarray] = None
    dedup: bool = False   # sort-based frontier dedup costs more than the
                          # gather redundancy it saves (see device_sampler)
    direct: Optional[bool] = None  # None = auto: flat tier iff the cache
                                   # capacity covers every node (see
                                   # feature_cache "flat tier" notes)
    priorities: Optional[np.ndarray] = None  # f32 [num_nodes] admission
                                   # priority (e.g. degree); enables
                                   # priority-aware eviction in the
                                   # associative tier. "degree" computes
                                   # in-degree from the graph.
    stage_transport: str = "auto"  # miss-row encoding across the host
                                   # link: float32 | bfloat16 | int8;
                                   # auto = int8 when the cache lines are
                                   # int8 (same precision as a hit),
                                   # float32 otherwise
    stage_admit: bool = True       # offer staged rows to the cache after
                                   # each window (admission-filtered);
                                   # False freezes cache contents during
                                   # fused windows
    stage_overlap: bool = False    # overlapped staged schedule: probe w+1
                                   # runs BEFORE window w on the stream
                                   # (pre-insert state) so the host gather
                                   # of stage w+1 can overlap window w's
                                   # compute; the insert reports which
                                   # lines it evicted and the host patches
                                   # those rows into the stage, restoring
                                   # exactness. Default OFF: it only wins
                                   # where a device->host readback does
                                   # not drain the device queue; where it
                                   # does, the extra evicted-read per
                                   # window makes overlap a net loss. The
                                   # serial schedule keeps exactly ONE
                                   # sync per window.
    scan_unroll: int = 1           # lax.scan unroll for the fused window:
                                   # a rolled scan is a while loop, so XLA
                                   # cannot start step i+1's sampling +
                                   # cache gather (params-independent)
                                   # under step i's fwd/bwd — unrolling
                                   # exposes that cross-step overlap and
                                   # leaves only the params chain serial.
                                   # Identical math, K/unroll x bigger HLO.
    nbr_cap: Optional[int] = None  # padded-neighbor-table topology layout
                                   # (to_device_graph nbr_cap): one aligned
                                   # [P]-row read per dst; exact for
                                   # deg <= P, seeded random P-subset
                                   # truncation above. P >= max(fanouts).

    def __post_init__(self):
        if self.nbr_cap is not None and self.nbr_cap < max(self.fanouts):
            raise ValueError(
                f"nbr_cap={self.nbr_cap} < max fanout {max(self.fanouts)}")
        self.g = to_device_graph(self.graph, nbr_cap=self.nbr_cap)
        self.labels_dev = jnp.asarray(self.labels.astype(np.int32))
        self.colors_dev = (jnp.asarray(self.colors.astype(np.int32))
                           if self.colors is not None else None)
        cfg, B, fanouts = self.cache_cfg, self.batch_size, list(self.fanouts)
        if self.direct is None:
            self.direct = cfg.capacity >= self.graph.num_nodes
        direct = self.direct
        if isinstance(self.priorities, str):
            if self.priorities != "degree":
                raise ValueError(f"unknown priorities {self.priorities!r}")
            self.priorities = np.diff(
                np.asarray(self.graph.indptr)).astype(np.float32)
        if self.stage_transport == "auto":
            self.stage_transport = "int8" if cfg.quantize else "float32"
        use_prio = self.priorities is not None and not direct
        if direct:
            self.cache = fc.flat_init(cfg, self.graph.num_nodes)
        else:
            self.cache = fc.init_colored_state(cfg, track_prio=use_prio)
        self._use_prio = use_prio
        g, labels_dev, colors_dev = self.g, self.labels_dev, self.colors_dev
        model, tx = self.model, self.tx
        self.timers = PhaseTimers()

        sentinel = self.g.num_nodes
        self._cap0 = block_capacities(B, fanouts)[0][1]  # input frontier cap

        # engine dispatch: flat (one gather, no eviction) vs associative
        def eng_lookup(cache, ids, valid, count_stats=True, assume_hit=False):
            if direct:
                return fc.flat_lookup(cache, ids, valid,
                                      count_stats=count_stats,
                                      assume_hit=assume_hit,
                                      dtype=cfg.dtype)
            base, feats, hit = fc.lookup(cfg, cache.base, ids, valid,
                                         count_stats=count_stats)
            return (cache._replace(base=base), feats, hit)

        def eng_probe(cache, ids, valid):
            if direct:
                return fc.flat_probe(cache, ids, valid)
            return fc.probe(cfg, cache.base, ids, valid)

        def eng_insert(cache, ids, rows, valid, colors, prios=None):
            if direct:
                return fc.flat_insert(cfg, cache, ids, rows, valid, colors)
            return fc.insert_with_colors(cfg, cache, ids, rows, valid,
                                         colors,
                                         prios=prios if use_prio else None)

        self._eng_insert = eng_insert

        @jax.jit
        def stage_a(g, labels_dev, cache, seeds, key):
            blocks, ids, num = sample_blocks_device(g, seeds, fanouts, B, key,
                                                    dedup=self.dedup)
            if self.dedup:
                valid = jnp.arange(ids.shape[0]) < num
            else:
                valid = ids != sentinel
            safe = jnp.where(valid, ids, 0)
            cache, feats, hit = eng_lookup(cache, safe, valid)
            n_miss = (valid & ~hit).sum(dtype=jnp.int32)
            n_edges = sum(b.mask.sum() for b in blocks)
            y = labels_dev[seeds]
            return cache, blocks, ids, valid, feats, hit, n_miss, n_edges, y

        def loss_fn(params, key, blocks, x, y):
            logits = model.apply(params, blocks, x, train=True,
                                 rngs={"dropout": key})[:B]
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, y).mean(), logits

        @jax.jit
        def stage_b(params, opt_state, key, blocks, feats, y):
            (loss, logits), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params, key, blocks, feats, y)
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            acc = (logits.argmax(-1) == y).mean()
            return params, opt_state, loss, acc

        @jax.jit
        def eval_b(params, blocks, feats, y):
            logits = model.apply(params, blocks, feats, train=False)[:B]
            return (logits.argmax(-1) == y).sum()

        def repair(cache, feats, ids, positions, rows, colors_m, prios_m):
            # merge host-fetched rows + admit them (per-step miss path only)
            pos = jnp.where(positions >= 0, positions, feats.shape[0])
            feats = feats.at[pos].set(rows.astype(feats.dtype), mode="drop")
            miss_ids = jnp.where(positions >= 0, ids[jnp.clip(positions, 0)], 0)
            cache = eng_insert(cache, miss_ids, rows, positions >= 0,
                               colors_m, prios_m)
            return cache, feats

        # ---- fused multi-step window: K steps per dispatch ---------------
        # Seeds [K, B] upload once; lax.scan runs sample+lookup+train K
        # times on device. The window never mutates cache contents (lookups
        # don't evict), so the cache stays OUT of the scan carry and the
        # jit outputs: no multi-hundred-MB pass-through copy per window.
        # Hit/miss stats come back as per-step counts and accumulate
        # host-side (stats()).
        #
        # Two variants:
        #   window        — plain; correct only at full coverage (flat tier
        #                   fully prewarmed) where misses are impossible.
        #   window_staged — overlays a sideband stage buffer (the window's
        #                   presampled unique miss rows) onto cache misses;
        #                   EXACT at any hit ratio. `unres` counts rows
        #                   served by neither cache nor stage — guaranteed
        #                   zero when the probe ran against this cache
        #                   state; nonzero triggers the replay safety net.
        def window(g, labels_dev, cache, params, opt_state, seeds_grid, key):
            def body(carry, inp):
                params, opt_state = carry
                seeds, k = inp
                k1, k2 = jax.random.split(wrap_key_any(k))
                blocks, ids, num = sample_blocks_device(g, seeds, fanouts, B,
                                                        k1, dedup=False)
                valid = ids != sentinel
                # direct tier: presample-prefetch + no-eviction make window
                # misses impossible -> skip the residency gather entirely
                _, feats, hit = eng_lookup(cache, jnp.where(valid, ids, 0),
                                           valid, count_stats=False,
                                           assume_hit=direct)
                n_hit = hit.sum(dtype=jnp.int32)
                n_miss = valid.sum(dtype=jnp.int32) - n_hit
                y = labels_dev[seeds]
                (loss, logits), grads = jax.value_and_grad(
                    loss_fn, has_aux=True)(params, k2, blocks, feats, y)
                updates, opt_state = tx.update(grads, opt_state, params)
                params = optax.apply_updates(params, updates)
                n_edges = sum(b.mask.sum() for b in blocks)
                return (params, opt_state), (loss, n_miss, n_hit, n_miss,
                                             n_edges)

            keys = jax.random.split(key, seeds_grid.shape[0])
            (params, opt_state), (losses, miss, hits, unres, edges) = \
                jax.lax.scan(body, (params, opt_state),
                             (seeds_grid, jax.random.key_data(keys)),
                             unroll=self.scan_unroll)
            return params, opt_state, losses, miss, hits, unres, edges

        self._window = jax.jit(window)

        def window_staged(g, labels_dev, cache, stage_ids, stage_rows,
                          stage_scale, params, opt_state, seeds_grid, key):
            U = stage_ids.shape[0]
            # per-window stage position map: one [num_nodes] scatter here
            # replaces a per-step searchsorted (log2(U) dependent
            # gather-compare rounds on every frontier id, K times per
            # window) with a single gather per step
            pos_map = jnp.zeros(sentinel + 1, jnp.int32).at[
                jnp.minimum(stage_ids, sentinel)].set(
                jnp.arange(U, dtype=jnp.int32), mode="drop")

            def body(carry, inp):
                params, opt_state = carry
                seeds, k = inp
                k1, k2 = jax.random.split(wrap_key_any(k))
                blocks, ids, num = sample_blocks_device(g, seeds, fanouts, B,
                                                        k1, dedup=False)
                valid = ids != sentinel
                safe = jnp.where(valid, ids, 0)
                _, feats, hit = eng_lookup(cache, safe, valid,
                                           count_stats=False)
                pos = pos_map[safe]
                found = (stage_ids[pos] == safe) & valid & ~hit
                srows = stage_rows[pos]
                if stage_scale is not None:
                    srows = fc.dequantize_rows(srows, stage_scale[pos],
                                               dtype=feats.dtype)
                feats = jnp.where(found[:, None], srows.astype(feats.dtype),
                                  feats)
                n_hit = hit.sum(dtype=jnp.int32)
                n_valid = valid.sum(dtype=jnp.int32)
                n_unres = n_valid - n_hit - found.sum(dtype=jnp.int32)
                y = labels_dev[seeds]
                (loss, logits), grads = jax.value_and_grad(
                    loss_fn, has_aux=True)(params, k2, blocks, feats, y)
                updates, opt_state = tx.update(grads, opt_state, params)
                params = optax.apply_updates(params, updates)
                n_edges = sum(b.mask.sum() for b in blocks)
                return (params, opt_state), (loss, n_valid - n_hit, n_hit,
                                             n_unres, n_edges)

            keys = jax.random.split(key, seeds_grid.shape[0])
            (params, opt_state), (losses, miss, hits, unres, edges) = \
                jax.lax.scan(body, (params, opt_state),
                             (seeds_grid, jax.random.key_data(keys)),
                             unroll=self.scan_unroll)
            return params, opt_state, losses, miss, hits, unres, edges

        self._window_staged = jax.jit(window_staged)

        # Presample probes: seeds and keys are known before the window, so
        # the (cheap) sampling + residency probe can run first and report
        # exactly which rows the window will miss. Two output formats:
        #   flat   — [K*cap] miss-id array (-1 = hit/pad); d2h scales with
        #            the frontier size
        #   bitmap — uint8 [num_nodes+1] miss flags; d2h scales with the
        #            node count and is one bit of entropy per node — the
        #            natural format whenever nodes < 4*K*cap (the r2 probe
        #            readback was the pressure regime's first bottleneck)
        def presample(g, cache, seeds_grid, keys):
            def body(_, inp):
                seeds, k = inp
                k1, _ = jax.random.split(wrap_key_any(k))
                _, ids, _ = sample_blocks_device(g, seeds, fanouts, B, k1,
                                                 dedup=False)
                valid = ids != sentinel
                hit = eng_probe(cache, jnp.where(valid, ids, 0), valid)
                miss_ids = jnp.where(valid & ~hit, ids, -1)
                return 0, miss_ids

            _, miss = jax.lax.scan(body, 0, (seeds_grid, keys))
            miss = miss.reshape(-1)          # [K * cap] (-1 = no miss)
            return (miss >= 0).sum(dtype=jnp.int32), miss

        self._presample = jax.jit(presample)

        def presample_bitmap(g, cache, seeds_grid, keys):
            def body(bm, inp):
                seeds, k = inp
                k1, _ = jax.random.split(wrap_key_any(k))
                _, ids, _ = sample_blocks_device(g, seeds, fanouts, B, k1,
                                                 dedup=False)
                valid = ids != sentinel
                hit = eng_probe(cache, jnp.where(valid, ids, 0), valid)
                miss_ids = jnp.where(valid & ~hit, ids, sentinel)
                return bm.at[miss_ids].max(jnp.uint8(1)), None

            bm0 = jnp.zeros(sentinel + 1, jnp.uint8)   # last slot = trash
            bm, _ = jax.lax.scan(body, bm0, (seeds_grid, keys))
            return bm

        self._presample_bitmap = jax.jit(presample_bitmap)

        def insert_rows(cache, ids_d, rows, colors_d, prios_d):
            return eng_insert(cache, jnp.where(ids_d >= 0, ids_d, 0),
                              rows, ids_d >= 0, colors_d, prios_d)

        self._insert_rows = {}
        self._insert_rows_fn = insert_rows

        # admission-filtered cache offer of a window's staged rows (same
        # decode as the window's overlay; stage pad id INT32_MAX -> invalid)
        def insert_stage(cache, stage_ids, stage_rows, stage_scale,
                         colors_d, prios_d, offer):
            rows = stage_rows
            if stage_scale is not None:
                rows = fc.dequantize_rows(rows, stage_scale)
            valid = (stage_ids != INT32_MAX) & offer
            return eng_insert(cache, jnp.where(valid, stage_ids, 0),
                              rows.astype(jnp.float32), valid, colors_d,
                              prios_d)

        self._insert_stage = jax.jit(insert_stage)

        # overlap variant: also report which resident lines the insert
        # evicted (associative tier only — the flat tier never evicts, so
        # the overlapped schedule needs no patch there). `offer` excludes
        # evicted-patch rows: re-admitting rows no window requested evicts
        # useful lines and ping-pongs with the next insert.
        def insert_stage_evict(cache, stage_ids, stage_rows, stage_scale,
                               colors_d, prios_d, offer):
            rows = stage_rows
            if stage_scale is not None:
                rows = fc.dequantize_rows(rows, stage_scale)
            valid = (stage_ids != INT32_MAX) & offer
            return fc.insert_with_colors(
                cfg, cache, jnp.where(valid, stage_ids, 0),
                rows.astype(jnp.float32), valid, colors_d,
                prios=prios_d if use_prio else None, return_evicted=True)

        self._insert_stage_evict = jax.jit(insert_stage_evict)

        self._stage_a = stage_a
        self._stage_b = stage_b
        self._eval_b = eval_b
        self._repair = {}
        self._repair_fn = repair
        self.hits = self.misses = 0
        self.full_coverage = False
        # fused host gather+encode (native, serial schedule): detect a
        # HostFeatureStore behind the host_fetch callable
        self._store = getattr(self.host_fetch, "__self__", None)
        if not getattr(self._store, "_native_ok", False):
            self._store = None
        self._scratch_pool = HostScratch()

    def _scratch(self, name: str, shape: tuple, dtype) -> np.ndarray:
        return self._scratch_pool.get(name, shape, dtype)

    # ------------------------------------------------------------------
    def begin(self, seeds: np.ndarray, key) -> tuple:
        seeds_dev = jnp.asarray(np.asarray(seeds, np.int32))
        self.cache, blocks, ids, valid, feats, hit, n_miss, n_edges, y = \
            self._stage_a(self.g, self.labels_dev, self.cache, seeds_dev, key)
        try:
            n_miss.copy_to_host_async()
        except Exception:
            pass
        return (blocks, ids, valid, feats, hit, n_miss, n_edges, y)

    def resolve(self, handle) -> tuple:
        """Returns (blocks, feats, labels) with misses repaired."""
        blocks, ids, valid, feats, hit, n_miss, n_edges, y = handle
        m = int(n_miss)
        if m == 0:
            return blocks, feats, y
        # miss path: identify rows, gather on host, merge + insert
        hit_np = np.asarray(hit)
        ids_np = np.asarray(ids)
        need = (~hit_np) & np.asarray(valid)
        pos = np.flatnonzero(need)
        m_cap = _pow2(pos.size)
        positions = np.full(m_cap, -1, np.int32)
        positions[: pos.size] = pos
        rows = np.zeros((m_cap, self.cache_cfg.dim), np.float32)
        with self.timers.time("host_gather"):
            rows[: pos.size] = self.host_fetch(ids_np[pos].astype(np.int64))
        colors_m = np.zeros(m_cap, np.int32)
        if self.colors is not None:
            colors_m[: pos.size] = self.colors[ids_np[pos]]
        prios_m = np.zeros(m_cap, np.float32)
        if self._use_prio:
            prios_m[: pos.size] = self.priorities[ids_np[pos]]
        key = m_cap
        if key not in self._repair:
            self._repair[key] = jax.jit(self._repair_fn)
        self.cache, feats = self._repair[key](
            self.cache, feats, ids, jnp.asarray(positions),
            jnp.asarray(rows), jnp.asarray(colors_m), jnp.asarray(prios_m))
        return blocks, feats, y

    def train_step(self, params, opt_state, key, resolved):
        blocks, feats, y = resolved
        return self._stage_b(params, opt_state, key, blocks, feats, y)

    # ---- probe / stage plumbing --------------------------------------
    def _probe_window(self, seeds_dev, keys_data):
        """Dispatch the presample residency probe (no host sync). Returns
        ("bitmap"|"flat", device handle). Format picked by readback size:
        node bitmap when smaller than the flat [K*cap] int32 array."""
        K = seeds_dev.shape[0]
        if self.graph.num_nodes + 1 <= 4 * K * self._cap0:
            out = self._presample_bitmap(self.g, self.cache, seeds_dev,
                                         keys_data)
            fmt = "bitmap"
        else:
            _, out = self._presample(self.g, self.cache, seeds_dev, keys_data)
            fmt = "flat"
        try:
            out.copy_to_host_async()
        except Exception:
            pass
        return fmt, out

    def _probe_miss_ids(self, probe) -> np.ndarray:
        """Read a probe back (ONE d2h transfer) -> sorted unique miss ids."""
        fmt, out = probe
        with self.timers.time("probe_wait"):
            arr = np.asarray(out)
        if fmt == "bitmap":
            return np.flatnonzero(arr[: self.graph.num_nodes]).astype(np.int32)
        return np.unique(arr[arr >= 0]).astype(np.int32)

    def _build_stage(self, probe, evicted=None):
        """Probe readback -> host gather of the unique miss rows ->
        transport-encoded stage pytree on device (upload is async).
        Returns (stage_ids, stage_rows, stage_scale, colors_d, prios_d).

        ``evicted`` (overlapped schedule): device handle of the previous
        insert's evicted-id array. The probe ran before that insert, so
        rows it saw as hits may have been evicted since — patching the
        evicted ids into the stage restores the superset guarantee. Read
        AFTER the main gather: the big host transfer overlaps the window
        still running on device; the evicted array is tiny and ready the
        moment the insert (right after the window) retires."""
        mids = self._probe_miss_ids(probe)
        return self._stage_from_mids(mids, evicted)

    def _stage_from_mids(self, mids, evicted=None):
        """Host gather + transport encode + upload for a known miss-id
        set (the overlapped schedule reads the probe EAGERLY — before the
        window dispatch, while the stream is empty — and calls this after
        dispatching the window so the gather overlaps its compute).

        Fast path (native HostFeatureStore, no evicted patch): the fused
        gather+encode reads each feature row ONCE and writes only the
        transport-width encoding into a reused scratch buffer — no fresh
        f32 staging alloc, no second encode pass."""
        u_cap = stage_cap(mids.size)
        dim = self.cache_cfg.dim
        if self._store is not None and evicted is None:
            gid = self._scratch("gid", (u_cap,), np.int64)
            gid[:] = -1
            gid[: mids.size] = mids
            tr = self.stage_transport
            scale = None
            if tr == "int8":
                enc_buf = self._scratch("enc8", (u_cap, dim), np.int8)
                scale = self._scratch("scale", (u_cap,), np.float32)
            elif tr == "bfloat16":
                enc_buf = self._scratch("enc16", (u_cap, dim), np.uint16)
            else:
                enc_buf = self._scratch("enc32", (u_cap, dim), np.float32)
            with self.timers.time("host_gather"):
                enc, scale = self._store.fetch_encoded(
                    gid, tr, enc_out=enc_buf, scale_out=scale)
            offer_p = np.ones(u_cap, bool)
            offer_p[mids.size:] = False
        else:
            gathered = np.zeros((mids.size, dim), np.float32)
            with self.timers.time("host_gather"):
                if mids.size:
                    # the big transfer — overlaps the window on device
                    gathered = self.host_fetch(mids.astype(np.int64)) \
                        .astype(np.float32, copy=False)
            offer = np.ones(mids.size, bool)
            if evicted is not None:
                with self.timers.time("evict_patch"):
                    # readback is ready right after the window+insert retire
                    mids, gathered, offer = merge_evicted_patch(
                        mids, gathered, np.asarray(evicted), self.host_fetch)
            u_cap = stage_cap(mids.size)
            offer_p = np.zeros(u_cap, bool)
            offer_p[: mids.size] = offer
            with self.timers.time("stage_encode"):
                # encode the REAL rows only, then pad the encoded (padding
                # the f32 rows first and encoding u_cap rows cost up to 1.6x
                # the traffic for nothing — pad rows encode to zero anyway)
                enc_r, scale_r = encode_stage_rows(gathered,
                                                   self.stage_transport)
                enc = np.zeros((u_cap, dim), enc_r.dtype)
                enc[: mids.size] = enc_r
                scale = None
                if scale_r is not None:
                    scale = np.ones(u_cap, np.float32)
                    scale[: mids.size] = scale_r
        ids_p = self._scratch("ids", (u_cap,), np.int32)
        ids_p[:] = INT32_MAX
        ids_p[: mids.size] = mids
        colors_d = self._scratch("colors", (u_cap,), np.int32)
        colors_d[:] = 0
        if self.colors is not None and mids.size:
            colors_d[: mids.size] = self.colors[mids]
        prios_d = self._scratch("prios", (u_cap,), np.float32)
        prios_d[:] = 0
        if self._use_prio and mids.size:
            prios_d[: mids.size] = self.priorities[mids]
        with self.timers.time("stage_upload"):
            stage = (jnp.asarray(ids_p), jnp.asarray(enc),
                     None if scale is None else jnp.asarray(scale),
                     jnp.asarray(colors_d), jnp.asarray(prios_d),
                     jnp.asarray(offer_p))
        self.timers.tally("stage_rows", float(mids.size))
        return stage

    def _offer_stage(self, stage) -> None:
        """Offer a window's staged rows to the cache (priority admission
        filters them; without priorities this refreshes like the reference's
        mandatory miss insert). Evicted-patch rows are excluded (stage[5])."""
        ids_p = stage[0]
        self.cache = self._insert_stage(self.cache, ids_p, stage[1],
                                        stage[2], stage[3], stage[4],
                                        stage[5])

    def _repair_from_probe(self, probe) -> None:
        """Per-step compat path: read a probe's miss ids and insert them
        (train_window's pre-staged guarantee for the flat tier)."""
        mids = self._probe_miss_ids(probe)
        if mids.size == 0:
            return
        m_cap = _pow2(mids.size)
        if m_cap not in self._insert_rows:
            self._insert_rows[m_cap] = jax.jit(self._insert_rows_fn)
        ids_p = np.full(m_cap, -1, np.int32)
        ids_p[: mids.size] = mids
        rows = np.zeros((m_cap, self.cache_cfg.dim), np.float32)
        with self.timers.time("host_gather"):
            rows[: mids.size] = self.host_fetch(mids.astype(np.int64))
        colors_d = np.zeros(m_cap, np.int32)
        if self.colors is not None:
            colors_d[: mids.size] = self.colors[mids]
        prios_d = np.zeros(m_cap, np.float32)
        if self._use_prio:
            prios_d[: mids.size] = self.priorities[mids]
        self.cache = self._insert_rows[m_cap](
            self.cache, jnp.asarray(ids_p), jnp.asarray(rows),
            jnp.asarray(colors_d), jnp.asarray(prios_d))

    def _window_keys(self, seeds_grid, key):
        return jax.random.key_data(
            jax.random.split(key, seeds_grid.shape[0]))

    def _replay_window(self, params, opt_state, seeds_grid, key):
        """Precise per-step replay with miss repair (the safety net)."""
        out_losses, out_edges = [], []
        for i in range(seeds_grid.shape[0]):
            key, k1, k2 = jax.random.split(key, 3)
            resolved = self.resolve(self.begin(seeds_grid[i], k1))
            params, opt_state, loss, acc = self.train_step(
                params, opt_state, k2, resolved)
            out_losses.append(loss)
            out_edges.append(sum(b.mask.sum() for b in resolved[0]))
        return params, opt_state, jnp.stack(out_losses), jnp.stack(out_edges)

    def train_window(self, params, opt_state, seeds_grid: np.ndarray, key):
        """K fused steps in one dispatch. seeds_grid int32 [K, B].
        Returns (params', opt_state', losses [K], edges [K])."""
        return self.train_windows(params, opt_state, seeds_grid[None], key,
                                  _keys=[key])

    def train_windows(self, params, opt_state, seeds_grids: np.ndarray, key,
                      _keys=None):
        """M fused windows. seeds_grids int32 [M, K, B].
        Returns (params', opt_state', losses [M*K], edges [M*K]).

        Full coverage (flat tier, fully prewarmed): every window dispatches
        back-to-back with ZERO per-window device->host synchronization; the
        counters of all M windows fold into one [M, 3] device array read
        back in a SINGLE transfer (a per-window readback would put one
        device->host round trip between every two windows).

        Flat tier under partial coverage: inserts cannot evict, so the
        probe's miss rows are inserted BEFORE the window (pipelined: probe
        w+1 dispatches right after window w's repair insert and its
        readback overlaps window w's compute) and the plain window is
        guaranteed to hit — `misses` stays 0, matching r2 semantics.

        Associative tier under capacity pressure: the software-pipelined
        STAGED schedule. With ``stage_overlap`` (optional; default is the
        serial schedule below) device stream order per window w is
            probe(w+1) -> window(w) -> insert(stage_w, evict-reporting)
        — the probe sees the same pre-insert state the window reads, so
        its readback retires almost immediately and the host gathers
        stage w+1's rows WHILE window w computes; misses the probe could
        not foresee (lines insert(stage_w) evicts) are read back from the
        insert (tiny array) and patched into the stage, preserving
        exactness: miss(w+1, post-insert) ⊆ probe misses ∪ evicted.
        With ``stage_overlap=False`` (the default: one sync per
        window) the serial order
            window(w) -> insert(stage_w) -> probe(w+1)
        keeps the probe exact by construction but puts the host gather on
        the critical path. Stage-served rows count as MISSES (they came
        from the backing store — the reference's hit/miss semantics,
        nvshmem_cache.h:404,477). The only host syncs are the probe
        readbacks and the final counter fold."""
        M = seeds_grids.shape[0]
        keys = list(jax.random.split(key, M)) if _keys is None else _keys
        losses_out: list = [None] * M
        edges_out: list = [None] * M
        snaps: list = [None] * M
        counters: list = [None] * M
        seeds_dev = [jnp.asarray(np.ascontiguousarray(s, np.int32))
                     for s in seeds_grids]
        staged = not self.full_coverage and not self.direct
        prefill = not self.full_coverage and self.direct

        stage = probe = None
        if staged:
            stage = self._build_stage(self._probe_window(
                seeds_dev[0], self._window_keys(seeds_grids[0], keys[0])))
        elif prefill:
            probe = self._probe_window(
                seeds_dev[0], self._window_keys(seeds_grids[0], keys[0]))
        for w in range(M):
            snaps[w] = (params, opt_state)
            if staged:
                mids_next = None
                if self.stage_overlap and w + 1 < M:
                    # OVERLAPPED schedule: probe w+1 dispatches BEFORE
                    # window w (so it sees exactly the pre-insert state
                    # window w reads) and its bitmap is read back
                    # IMMEDIATELY — the stream is empty here, so this sync
                    # is cheap. The big stage gather then runs while
                    # window w computes.
                    # The insert below reports what it evicted;
                    # _stage_from_mids patches those rows in, restoring
                    # the superset guarantee
                    # (miss(w+1, post-insert) ⊆ probe misses ∪ evicted).
                    mids_next = self._probe_miss_ids(self._probe_window(
                        seeds_dev[w + 1],
                        self._window_keys(seeds_grids[w + 1], keys[w + 1])))
                with self.timers.time("window_dispatch"):
                    (params, opt_state, losses, miss, hits, unres,
                     edges) = self._window_staged(
                        self.g, self.labels_dev, self.cache, stage[0],
                        stage[1], stage[2], params, opt_state,
                        seeds_dev[w], keys[w])
                evicted = None
                if self.stage_admit:
                    with self.timers.time("insert_dispatch"):
                        if mids_next is not None:
                            self.cache, evicted = self._insert_stage_evict(
                                self.cache, stage[0], stage[1], stage[2],
                                stage[3], stage[4], stage[5])
                            try:
                                evicted.copy_to_host_async()
                            except Exception:
                                pass
                        else:
                            self._offer_stage(stage)
                if w + 1 < M:
                    if mids_next is not None:
                        stage = self._stage_from_mids(mids_next,
                                                      evicted=evicted)
                    else:
                        stage = self._build_stage(self._probe_window(
                            seeds_dev[w + 1],
                            self._window_keys(seeds_grids[w + 1],
                                              keys[w + 1])))
            else:
                if prefill:
                    self._repair_from_probe(probe)
                    if w + 1 < M:
                        probe = self._probe_window(
                            seeds_dev[w + 1],
                            self._window_keys(seeds_grids[w + 1],
                                              keys[w + 1]))
                with self.timers.time("window_dispatch"):
                    (params, opt_state, losses, miss, hits, unres,
                     edges) = self._window(
                        self.g, self.labels_dev, self.cache, params,
                        opt_state, seeds_dev[w], keys[w])
            losses_out[w], edges_out[w] = losses, edges
            counters[w] = jnp.stack([miss.sum(), hits.sum(), unres.sum()])
        folded = np.asarray(jnp.stack(counters))        # ONE d2h transfer
        self.misses += int(folded[:, 0].sum())
        self.hits += int(folded[:, 1].sum())
        bad = np.flatnonzero(folded[:, 2])
        if bad.size:
            # Safety net (unreachable when probes ran in stream order, kept
            # for defense in depth): replay the first window with
            # unresolved rows and everything after it (the tail consumed
            # post-miss state). The replayed steps re-count through the
            # device counters, so subtract their already-folded window
            # counts first (else stats() double-counts replays).
            w0 = int(bad[0])
            self.misses -= int(folded[w0:, 0].sum())
            self.hits -= int(folded[w0:, 1].sum())
            params, opt_state = snaps[w0]
            with self.timers.time("replay"):
                for w in range(w0, M):
                    params, opt_state, plosses, pedges = self._replay_window(
                        params, opt_state, seeds_grids[w], keys[w])
                    losses_out[w], edges_out[w] = plosses, pedges
        return (params, opt_state, jnp.concatenate(losses_out),
                jnp.concatenate(edges_out))

    def eval_step(self, params, resolved) -> int:
        blocks, feats, y = resolved
        return int(self._eval_b(params, blocks, feats, y))

    def prewarm(self, ids: np.ndarray, chunk: int = 65536) -> None:
        cfg = self.cache_cfg
        ids = np.unique(np.asarray(ids, np.int32))
        self.full_coverage = (cfg.capacity >= self.graph.num_nodes
                              and ids.size >= self.graph.num_nodes)

        insert = jax.jit(self._insert_rows_fn)
        for lo in range(0, len(ids), chunk):
            part = ids[lo:lo + chunk]
            grid = np.full(chunk, -1, np.int32)
            grid[: part.size] = part
            rows = np.zeros((chunk, cfg.dim), np.float32)
            rows[: part.size] = self.host_fetch(part.astype(np.int64))
            colors_d = np.zeros(chunk, np.int32)
            if self.colors is not None:
                colors_d[: part.size] = self.colors[part]
            prios_d = np.zeros(chunk, np.float32)
            if self._use_prio:
                prios_d[: part.size] = self.priorities[part]
            self.cache = insert(self.cache, jnp.asarray(grid),
                                jnp.asarray(rows), jnp.asarray(colors_d),
                                jnp.asarray(prios_d))
        # reset stats counters accumulated during prewarm
        self.cache = self._reset_counters(self.cache)
        self.hits = self.misses = 0

    @staticmethod
    def _reset_counters(cache):
        zero = jnp.zeros((), jnp.int32)
        if isinstance(cache, fc.FlatState):
            return cache._replace(hits=zero, misses=zero)
        return cache._replace(base=cache.base._replace(hits=zero,
                                                       misses=zero))

    def stats(self) -> dict:
        """Device counters (per-step path) + host accumulators (fused
        windows), reset on read (reference parity: nvshmem_cache.h:133-142)."""
        if isinstance(self.cache, fc.FlatState):
            h, m = int(self.cache.hits), int(self.cache.misses)
        else:
            h, m = int(self.cache.base.hits), int(self.cache.base.misses)
        self.cache = self._reset_counters(self.cache)
        h += self.hits
        m += self.misses
        self.hits = self.misses = 0
        return {"hits": h, "misses": m,
                "hit_ratio": h / (h + m) if (h + m) else 0.0}
