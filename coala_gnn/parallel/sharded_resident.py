"""Multi-device device-resident training pipeline.

The full COALA architecture, entirely on the mesh: every device samples its
own seed slice from HBM-resident topology, probes the mesh-sharded feature
cache through the two-phase all_to_all exchange, and trains data-parallel
with pmean'd gradients — all inside two jits. Per step the host uploads one
[n_dev, batch] seed grid (a few KB) and reads one scalar miss count.

This composes the whole reference data path on device:
  seed distribution  -> host (affinity distributor chooses the seed grid)
  sampling           -> stage A (device, replaces DGL UVA sampling)
  request routing    -> stage A (all_to_all, replaces NVSHMEM send_requests)
  cache probe        -> stage A (replaces NVShmem_read_feature)
  miss fill          -> host tier + owner push (rare at steady state)
  fwd/bwd/optimize   -> stage B (replaces DDP)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from coala_gnn.cache import feature_cache as fc
from coala_gnn.parallel.mesh import DATA_AXIS
from coala_gnn.parallel.sharded_cache import (
    ShardedFeatureCache,
    _ceil_pow2,
    _to_local,
    _from_local,
    exchange_lookup,
    exchange_probe,
)
from coala_gnn.parallel.resident import (
    INT32_MAX,
    _pow2,
    encode_stage_rows,
    stage_cap,
)
from coala_gnn.sampling.device_sampler import (
    sample_blocks_device,
    to_device_graph,
)
from coala_gnn.utils.timers import PhaseTimers
from coala_gnn.utils.rng import wrap_key_any


@dataclasses.dataclass
class ShardedResidentTrainer:
    graph: object
    host_fetch: object
    labels: np.ndarray
    cache: ShardedFeatureCache          # provides state + miss kernels
    model: object
    tx: optax.GradientTransformation
    fanouts: Sequence[int]
    batch_size: int
    colors: Optional[np.ndarray] = None
    shard_topology: bool = False   # shard indptr/indices over the mesh
                                   # (papers100M-class graphs; E/n_dev
                                   # edges per device) instead of
                                   # replicating them into every HBM
    nbr_cap: Optional[int] = None  # padded-neighbor-table topology layout
                                   # (to_device_graph nbr_cap): sampling
                                   # reads one aligned [P]-row per dst —
                                   # exact for deg <= P, seeded random
                                   # P-subset truncation above. Requires
                                   # P >= max(fanouts); excludes
                                   # shard_topology
    stage_transport: str = "auto"  # miss-row encoding across the host
                                   # link for staged fused windows:
                                   # float32 | bfloat16 | int8; auto =
                                   # int8 when cache lines are int8
    stage_admit: bool = True       # offer staged rows to their owner
                                   # shards after each window
    stage_overlap: bool = False    # overlapped staged schedule (mesh
                                   # mirror of ResidentTrainer): probe w+1
                                   # dispatches BEFORE window w so its
                                   # bitmap readback + host gather can
                                   # overlap the window's compute; the
                                   # insert reports evicted ids
                                   # (replicated) and the host patches
                                   # them into the next stage, preserving
                                   # exactness. Default OFF — wins only on
                                   # value-async-d2h hosts (see
                                   # resident.py stage_overlap)

    def __post_init__(self):
        from coala_gnn.parallel.resident import HostScratch
        self._store = getattr(self.host_fetch, "__self__", None)
        if not getattr(self._store, "_native_ok", False):
            self._store = None
        self._scratch = HostScratch()
        mesh = self.cache.mesh
        self.mesh = mesh
        n_route = self.cache.n_route
        groups = self.cache.groups   # node_local: per-host exchange blocks
        cfg, B, fanouts = self.cache.cfg, self.batch_size, list(self.fanouts)
        n_dev_mesh = mesh.devices.size
        num_nodes = self.graph.num_nodes
        hetero = getattr(self.graph, "edge_types", None) is not None
        if self.shard_topology and n_dev_mesh > 1:
            if self.nbr_cap is not None:
                raise ValueError("nbr_cap (padded neighbor table) does not "
                                 "combine with shard_topology — the table "
                                 "layout is single-replica")
            from coala_gnn.sampling.sharded_topology import (
                put_sharded_topology, sample_blocks_sharded)
            g = put_sharded_topology(self.graph, mesh)
            g_specs = jax.tree.map(lambda _: P(DATA_AXIS, None), g)

            def sample_fn(g, seeds, key):
                return sample_blocks_sharded(g, num_nodes, seeds, fanouts,
                                             B, key, n_dev_mesh)
        else:
            if self.nbr_cap is not None and self.nbr_cap < max(fanouts):
                raise ValueError(
                    f"nbr_cap={self.nbr_cap} < max fanout {max(fanouts)}: "
                    "the padded row could not honor the take-all-in-order "
                    "slot semantics for deg <= fanout")
            g = to_device_graph(self.graph, nbr_cap=self.nbr_cap)
            g_specs = jax.tree.map(lambda _: P(), g)

            def sample_fn(g, seeds, key):
                return sample_blocks_device(g, seeds, fanouts, B, key,
                                            dedup=False)
        labels_dev = jnp.asarray(self.labels.astype(np.int32))
        sentinel = num_nodes
        model, tx = self.model, self.tx
        state_specs = jax.tree.map(lambda _: P(DATA_AXIS), self.cache.state)

        from coala_gnn.sampling.neighbor import block_capacities
        self.caps = block_capacities(B, fanouts)
        n_req = self.caps[0][1]
        self.n_req = n_req
        from coala_gnn.parallel.sizing import lookup_bucket_cap
        bucket_cap = lookup_bucket_cap(n_req, n_route, self.cache.bucket_slack)

        def body_a(g, labels_dev, state, seeds, key):
            seeds = seeds[0]                       # [B] this device's slice
            key = jax.random.fold_in(key, jax.lax.axis_index(DATA_AXIS))
            blocks, ids, num = sample_fn(g, seeds, key)
            valid = ids != sentinel
            local = _to_local(state)
            local, feats, hit, overflow = exchange_lookup(
                cfg, bucket_cap, n_route, local, ids, valid, groups=groups)
            n_miss = (valid & (~hit | overflow)).sum(dtype=jnp.int32)
            n_edges = sum(b.mask.sum() for b in blocks)
            y = labels_dev[seeds]
            blocks_out = [jax.tree.map(lambda leaf: leaf[None], b)
                          for b in blocks]
            return (_from_local(local), blocks_out, ids[None], valid[None],
                    feats[None], hit[None], n_miss[None], n_edges[None],
                    y[None])

        blocks_spec = [jax.tree.map(lambda _: P(DATA_AXIS), b)
                       for b in _block_struct(len(fanouts), hetero)]
        self._stage_a = jax.jit(shard_map(
            body_a, mesh=mesh,
            in_specs=(g_specs, P(), state_specs, P(DATA_AXIS), P()),
            out_specs=(state_specs, blocks_spec, P(DATA_AXIS), P(DATA_AXIS),
                       P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS),
                       P(DATA_AXIS)),
            check_vma=False))

        def local_grads(params, key, blocks, x, labels):
            blocks = jax.tree.map(lambda a: a[0], blocks)
            x, labels = x[0], labels[0]
            key = jax.random.fold_in(key, jax.lax.axis_index(DATA_AXIS))

            def loss_fn(p):
                logits = model.apply(p, blocks, x, train=True,
                                     rngs={"dropout": key})[:B]
                ce = optax.softmax_cross_entropy_with_integer_labels(
                    logits, labels)
                return ce.mean(), logits

            (loss, logits), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            grads = jax.lax.pmean(grads, DATA_AXIS)
            loss = jax.lax.pmean(loss, DATA_AXIS)
            acc = jax.lax.pmean((logits.argmax(-1) == labels).mean(),
                                DATA_AXIS)
            return grads, loss, acc

        def stage_b(params, opt_state, key, blocks, x, labels):
            params_spec = jax.tree.map(lambda _: P(), params)
            bspec = jax.tree.map(lambda _: P(DATA_AXIS), blocks)
            grads, loss, acc = shard_map(
                local_grads, mesh=mesh,
                in_specs=(params_spec, P(), bspec, P(DATA_AXIS), P(DATA_AXIS)),
                out_specs=(params_spec, P(), P()),
                check_vma=False)(params, key, blocks, x, labels)
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss, acc

        self._stage_b = jax.jit(stage_b)

        # masked variant (exact-tail training): optimizes the GLOBAL masked
        # mean — wrapped drop_tail=False duplicates (valid=False slots, from
        # SeedDistributor.distribute(return_valid=True)) contribute exactly
        # zero loss/gradient. Traced only if a caller passes a mask.
        def local_grads_masked(params, key, blocks, x, labels, valid):
            blocks = jax.tree.map(lambda a: a[0], blocks)
            x, labels = x[0], labels[0]
            w = valid[0].astype(jnp.float32)
            key = jax.random.fold_in(key, jax.lax.axis_index(DATA_AXIS))
            n_glob = jnp.maximum(jax.lax.psum(w.sum(), DATA_AXIS), 1.0)

            def loss_fn(p):
                logits = model.apply(p, blocks, x, train=True,
                                     rngs={"dropout": key})[:B]
                ce = optax.softmax_cross_entropy_with_integer_labels(
                    logits, labels)
                return (ce * w).sum() / n_glob, logits

            (loss, logits), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            grads = jax.lax.psum(grads, DATA_AXIS)
            loss = jax.lax.psum(loss, DATA_AXIS)
            acc = jax.lax.psum(((logits.argmax(-1) == labels) * w).sum(),
                               DATA_AXIS) / n_glob
            return grads, loss, acc

        def stage_b_masked(params, opt_state, key, blocks, x, labels, valid):
            params_spec = jax.tree.map(lambda _: P(), params)
            bspec = jax.tree.map(lambda _: P(DATA_AXIS), blocks)
            grads, loss, acc = shard_map(
                local_grads_masked, mesh=mesh,
                in_specs=(params_spec, P(), bspec, P(DATA_AXIS),
                          P(DATA_AXIS), P(DATA_AXIS)),
                out_specs=(params_spec, P(), P()),
                check_vma=False)(params, key, blocks, x, labels, valid)
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss, acc

        self._stage_b_masked = jax.jit(stage_b_masked)

        def local_eval(params, blocks, x, labels):
            blocks = jax.tree.map(lambda a: a[0], blocks)
            logits = model.apply(params, blocks, x[0], train=False)[:B]
            return (logits.argmax(-1) == labels[0])[None]   # [1, B] bool

        def eval_b(params, blocks, x, labels):
            params_spec = jax.tree.map(lambda _: P(), params)
            bspec = jax.tree.map(lambda _: P(DATA_AXIS), blocks)
            return shard_map(
                local_eval, mesh=mesh,
                in_specs=(params_spec, bspec, P(DATA_AXIS), P(DATA_AXIS)),
                out_specs=P(DATA_AXIS, None),
                check_vma=False)(params, blocks, x, labels)

        self._eval_b = jax.jit(eval_b)

        # ---- fused multi-step window (multi-device) ----------------------
        # The window never mutates cache contents (exchange lookups don't
        # evict), so the cache stays OUT of the scan carry and the jit
        # outputs (no pass-through copies; rollback snapshots stay valid).
        # Bucket-overflow slots — requests beyond a (src, owner) bucket's
        # capacity, which owner-insertion can never repair — are satisfied
        # by host rows fetched during presample and merged INSIDE the window
        # (ovf_pos/ovf_rows), so overflow does not trigger rollback-replay.
        def window_local(g, labels_dev, state, params, opt_state, seeds_grid,
                         keys, ovf_pos, ovf_rows):
            """Per-device: scan K fused sample+exchange+train steps.
            seeds_grid [1, K, B]; keys [K, 2] uint32 key data (replicated);
            ovf_pos [1, K, ovf_cap] slot indices (-1 padded); ovf_rows
            [1, K, ovf_cap, dim] host rows for those slots."""
            seeds_grid = seeds_grid[0]
            ovf_pos, ovf_rows = ovf_pos[0], ovf_rows[0]
            local = _to_local(state)

            def body(carry, inp):
                params, opt_state = carry
                seeds, kdata, opos, orows = inp
                k = wrap_key_any(kdata)
                k = jax.random.fold_in(k, jax.lax.axis_index(DATA_AXIS))
                k1, k2 = jax.random.split(k)
                blocks, ids, num = sample_fn(g, seeds, k1)
                valid = ids != sentinel
                _, feats, hit, overflow = exchange_lookup(
                    cfg, bucket_cap, n_route, local, ids, valid,
                    groups=groups)
                safe_pos = jnp.where(opos >= 0, opos, feats.shape[0])
                feats = feats.at[safe_pos].set(orows.astype(feats.dtype),
                                               mode="drop")
                covered = jnp.zeros(ids.shape[0], jnp.bool_).at[
                    safe_pos].set(True, mode="drop")
                n_hit = hit.sum(dtype=jnp.int32)
                n_miss = (valid & ~hit & ~covered).sum(dtype=jnp.int32)
                n_miss = jax.lax.psum(n_miss, DATA_AXIS)
                n_hit = jax.lax.psum(n_hit, DATA_AXIS)
                y = labels_dev[seeds]

                def lfn(p):
                    logits = model.apply(p, blocks, feats, train=True,
                                         rngs={"dropout": k2})[:B]
                    return optax.softmax_cross_entropy_with_integer_labels(
                        logits, y).mean()

                loss, grads = jax.value_and_grad(lfn)(params)
                grads = jax.lax.pmean(grads, DATA_AXIS)
                loss = jax.lax.pmean(loss, DATA_AXIS)
                updates, opt_state = tx.update(grads, opt_state, params)
                params = optax.apply_updates(params, updates)
                n_edges = jax.lax.psum(
                    sum(b.mask.sum() for b in blocks), DATA_AXIS)
                return (params, opt_state), (loss, n_miss, n_hit, n_edges)

            (params, opt_state), (losses, miss, hits, edges) = jax.lax.scan(
                body, (params, opt_state),
                (seeds_grid, keys, ovf_pos, ovf_rows))
            return params, opt_state, losses, miss, hits, edges

        # Presample-prefetch (multi-device): replicate the window's exact
        # key derivation, probe residency only (exchange_probe), and return
        # the global counts + per-device miss/overflow ids. Repairable
        # misses get one batched owner-partitioned insert; overflow slots
        # get host rows threaded into the window (see window_local).
        def presample_local(g, state, seeds_grid, keys):
            seeds_grid = seeds_grid[0]
            local = _to_local(state)

            def body(_, inp):
                seeds, kdata = inp
                k = wrap_key_any(kdata)
                k = jax.random.fold_in(k, jax.lax.axis_index(DATA_AXIS))
                k1, _ = jax.random.split(k)
                _, ids, _ = sample_fn(g, seeds, k1)
                valid = ids != sentinel
                hit, overflow = exchange_probe(cfg, bucket_cap, n_route,
                                               local, ids, valid,
                                               groups=groups)
                return 0, (jnp.where(valid & ~hit & ~overflow, ids, -1),
                           jnp.where(overflow, ids, -1))

            _, (miss, ovf) = jax.lax.scan(body, 0, (seeds_grid, keys))
            n_miss = jax.lax.psum((miss >= 0).sum(dtype=jnp.int32), DATA_AXIS)
            n_ovf = jax.lax.psum((ovf >= 0).sum(dtype=jnp.int32), DATA_AXIS)
            return (n_miss[None], n_ovf[None], miss.reshape(-1)[None],
                    ovf[None])

        self._presample = jax.jit(shard_map(
            presample_local, mesh=mesh,
            in_specs=(g_specs, state_specs, P(DATA_AXIS, None, None), P()),
            out_specs=(P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS),
                       P(DATA_AXIS)),
            check_vma=False))

        # ---- staged fused windows (capacity pressure, multi-device) ------
        # The mesh analogue of ResidentTrainer's staged path: a bitmap
        # probe reports every row the window's exchange lookups will NOT
        # serve (residency misses AND bucket overflow — the stage overlay
        # subsumes the ovf_pos/ovf_rows threading), the host gathers the
        # unique rows once, and the window overlays the REPLICATED stage
        # onto unserved slots. Exact at any hit ratio; the cache never has
        # to admit anything for correctness.
        def presample_bitmap_local(g, state, seeds_grid, keys):
            seeds_grid = seeds_grid[0]
            local = _to_local(state)

            def body(bm, inp):
                seeds, kdata = inp
                k = wrap_key_any(kdata)
                k = jax.random.fold_in(k, jax.lax.axis_index(DATA_AXIS))
                k1, _ = jax.random.split(k)
                _, ids, _ = sample_fn(g, seeds, k1)
                valid = ids != sentinel
                hit, _ = exchange_probe(cfg, bucket_cap, n_route, local,
                                        ids, valid, groups=groups)
                miss_ids = jnp.where(valid & ~hit, ids, sentinel)
                return bm.at[miss_ids].max(jnp.uint8(1)), None

            bm0 = jnp.zeros(sentinel + 1, jnp.uint8)   # last slot = trash
            bm, _ = jax.lax.scan(body, bm0, (seeds_grid, keys))
            return jax.lax.pmax(bm, DATA_AXIS)         # union -> replicated

        self._presample_bitmap = jax.jit(shard_map(
            presample_bitmap_local, mesh=mesh,
            in_specs=(g_specs, state_specs, P(DATA_AXIS, None, None), P()),
            out_specs=P(), check_vma=False))

        def window_staged_local(g, labels_dev, state, stage_ids, stage_rows,
                                stage_scale, params, opt_state, seeds_grid,
                                keys):
            """Per-device staged window. stage_* are replicated: ids int32
            [U] sorted (INT32_MAX pad), rows [U, dim] transport-encoded,
            scale f32 [U] or None. Counters are psum'd: miss counts every
            slot the exchange didn't serve (stage-served rows came from
            the backing store — reference hit/miss semantics), unres
            counts slots served by neither (the replay trigger)."""
            seeds_grid = seeds_grid[0]
            local = _to_local(state)
            U = stage_ids.shape[0]
            # per-window stage position map (see resident.py window_staged)
            pos_map = jnp.zeros(sentinel + 1, jnp.int32).at[
                jnp.minimum(stage_ids, sentinel)].set(
                jnp.arange(U, dtype=jnp.int32), mode="drop")

            def body(carry, inp):
                params, opt_state = carry
                seeds, kdata = inp
                k = wrap_key_any(kdata)
                k = jax.random.fold_in(k, jax.lax.axis_index(DATA_AXIS))
                k1, k2 = jax.random.split(k)
                blocks, ids, num = sample_fn(g, seeds, k1)
                valid = ids != sentinel
                _, feats, hit, _ovf = exchange_lookup(
                    cfg, bucket_cap, n_route, local, ids, valid,
                    groups=groups)
                safe = jnp.where(valid, ids, 0)
                pos = pos_map[safe]
                found = (stage_ids[pos] == safe) & valid & ~hit
                srows = stage_rows[pos]
                if stage_scale is not None:
                    srows = fc.dequantize_rows(srows, stage_scale[pos],
                                               dtype=feats.dtype)
                feats = jnp.where(found[:, None],
                                  srows.astype(feats.dtype), feats)
                n_hit = jax.lax.psum(hit.sum(dtype=jnp.int32), DATA_AXIS)
                n_miss = jax.lax.psum((valid & ~hit).sum(dtype=jnp.int32),
                                      DATA_AXIS)
                n_unres = jax.lax.psum(
                    (valid & ~hit & ~found).sum(dtype=jnp.int32), DATA_AXIS)
                y = labels_dev[seeds]

                def lfn(p):
                    logits = model.apply(p, blocks, feats, train=True,
                                         rngs={"dropout": k2})[:B]
                    return optax.softmax_cross_entropy_with_integer_labels(
                        logits, y).mean()

                loss, grads = jax.value_and_grad(lfn)(params)
                grads = jax.lax.pmean(grads, DATA_AXIS)
                loss = jax.lax.pmean(loss, DATA_AXIS)
                updates, opt_state = tx.update(grads, opt_state, params)
                params = optax.apply_updates(params, updates)
                n_edges = jax.lax.psum(
                    sum(b.mask.sum() for b in blocks), DATA_AXIS)
                return (params, opt_state), (loss, n_miss, n_hit, n_unres,
                                             n_edges)

            (params, opt_state), (losses, miss, hits, unres, edges) = \
                jax.lax.scan(body, (params, opt_state), (seeds_grid, keys))
            return params, opt_state, losses, miss, hits, unres, edges

        self._window_staged_local = window_staged_local
        self._window_cache = {}
        self._window_local = window_local
        self._mesh = mesh
        self._state_specs = state_specs
        self._g = g
        self._g_specs = g_specs
        self._labels_dev = labels_dev
        self.full_coverage = False
        self.hits = self.misses = 0
        self.timers = PhaseTimers()
        if self.stage_transport == "auto":
            self.stage_transport = "int8" if cfg.quantize else "float32"

    def _window_jit(self, params, opt_state, ovf_cap: int):
        key = ("window", ovf_cap)
        if key in self._window_cache:
            return self._window_cache[key]
        pspec = jax.tree.map(lambda _: P(), params)
        ospec = jax.tree.map(lambda _: P(), opt_state)
        k = jax.jit(shard_map(
            self._window_local, mesh=self._mesh,
            in_specs=(self._g_specs, P(), self._state_specs, pspec, ospec,
                      P(DATA_AXIS, None), P(), P(DATA_AXIS, None, None),
                      P(DATA_AXIS, None, None, None)),
            out_specs=(pspec, ospec, P(), P(), P(), P()),
            check_vma=False))
        self._window_cache[key] = k
        return k

    def _window_staged_jit(self, params, opt_state, has_scale: bool):
        key = ("window_staged", has_scale)
        if key in self._window_cache:
            return self._window_cache[key]
        pspec = jax.tree.map(lambda _: P(), params)
        ospec = jax.tree.map(lambda _: P(), opt_state)
        fn = self._window_staged_local
        if not has_scale:
            def fn(g, labels_dev, state, sids, srows, params, opt_state,
                   seeds_grid, keys, _inner=self._window_staged_local):
                return _inner(g, labels_dev, state, sids, srows, None,
                              params, opt_state, seeds_grid, keys)
        stage_specs = (P(), P(), P()) if has_scale else (P(), P())
        k = jax.jit(shard_map(
            fn, mesh=self._mesh,
            in_specs=(self._g_specs, P(), self._state_specs) + stage_specs
                     + (pspec, ospec, P(DATA_AXIS, None), P()),
            out_specs=(pspec, ospec, P(), P(), P(), P(), P()),
            check_vma=False))
        self._window_cache[key] = k
        return k

    # ---- staged stage plumbing (mesh) --------------------------------
    def _probe_window_staged(self, seeds_dev, keys):
        """Dispatch the bitmap residency probe (no host sync); returns the
        replicated [num_nodes+1] uint8 device handle."""
        bm = self._presample_bitmap(self._g, self.cache.state, seeds_dev,
                                    keys)
        try:
            bm.copy_to_host_async()
        except Exception:
            pass
        return bm

    def _build_stage(self, bm, evicted=None):
        """Bitmap readback (ONE replicated d2h) -> host gather of unique
        unserved rows -> transport-encoded replicated stage. Deterministic
        from replicated inputs, so every process builds the identical
        stage (the multi-host coherence contract — the evicted-id arrays
        are all_gathered on device for the same reason).

        ``evicted`` (overlapped schedule): replicated handles from the
        previous insert; the probe ran before that insert, so its bitmap
        misses rows the insert evicted — they are read AFTER the big
        gather (which overlaps the window on device) and patched in."""
        from coala_gnn.parallel.multihost import read_replicated
        with self.timers.time("probe_wait"):
            arr = read_replicated(bm)
        mids = np.flatnonzero(arr[: self.graph.num_nodes]).astype(np.int32)
        return self._stage_from_mids(mids, evicted)

    def _probe_mids(self, bm) -> np.ndarray:
        """Bitmap readback (ONE replicated d2h) -> sorted unique miss ids."""
        from coala_gnn.parallel.multihost import read_replicated
        with self.timers.time("probe_wait"):
            arr = read_replicated(bm)
        return np.flatnonzero(arr[: self.graph.num_nodes]).astype(np.int32)

    def _stage_from_mids(self, mids, evicted=None):
        """Host gather + transport encode + replicated upload for a known
        miss-id set (the overlapped schedule reads the probe eagerly while
        the stream is empty, then calls this after dispatching the window
        so the gather overlaps its compute).

        Fast path (native HostFeatureStore, no evicted patch): gather into
        a REUSED pow2-capacity f32 scratch (pads are -1 -> zero rows, so
        f32 transport reuses the buffer as the stage with zero copies) and
        encode bf16/int8 with the multithreaded native kernels — no fresh
        100s-of-MB allocs and no single-threaded ml_dtypes cast on the
        window critical path."""
        from coala_gnn.parallel.multihost import read_replicated
        from coala_gnn.parallel.resident import merge_evicted_patch
        u_cap = stage_cap(mids.size)
        dim = self.cache.cfg.dim
        if self._store is not None and not evicted:
            gid = self._scratch.get("gid", (u_cap,), np.int64)
            gid[:] = -1
            gid[: mids.size] = mids
            buf = self._scratch.get("gath", (u_cap, dim), np.float32)
            with self.timers.time("host_gather"):
                self._store.fetch(gid, out=buf)
            gathered = buf[: mids.size]
            offer = np.ones(mids.size, bool)
            with self.timers.time("stage_encode"):
                if self.stage_transport == "float32":
                    enc, scale = buf, None   # pads are already zero rows
                elif self.stage_transport == "bfloat16":
                    from coala_gnn.native import lib as native_lib
                    u16 = self._scratch.get("enc16", (u_cap, dim), np.uint16)
                    enc = native_lib.encode_bf16(buf, out=u16)
                    scale = None
                else:
                    from coala_gnn.native import lib as native_lib
                    q = self._scratch.get("enc8", (u_cap, dim), np.int8)
                    sc = self._scratch.get("scale", (u_cap,), np.float32)
                    native_lib.get().cg_quantize_rows(buf, u_cap, dim, q, sc)
                    enc, scale = q, sc   # zero pad rows -> q 0, scale 1
            ids_p = self._scratch.get("ids", (u_cap,), np.int32)
            ids_p[:] = INT32_MAX
            ids_p[: mids.size] = mids
        else:
            gathered = np.zeros((mids.size, dim), np.float32)
            with self.timers.time("host_gather"):
                if mids.size:
                    gathered = self.host_fetch(mids.astype(np.int64)) \
                        .astype(np.float32, copy=False)
            offer = np.ones(mids.size, bool)
            if evicted:
                with self.timers.time("evict_patch"):
                    ev = np.concatenate(
                        [np.asarray(read_replicated(h)).ravel()
                         for h in evicted])
                    mids, gathered, offer = merge_evicted_patch(
                        mids, gathered, ev, self.host_fetch)
            u_cap = stage_cap(mids.size)
            ids_p = np.full(u_cap, INT32_MAX, np.int32)
            ids_p[: mids.size] = mids
            with self.timers.time("stage_encode"):
                enc_r, scale_r = encode_stage_rows(gathered,
                                                   self.stage_transport)
                enc = np.zeros((u_cap, dim), enc_r.dtype)
                enc[: mids.size] = enc_r
                scale = None
                if scale_r is not None:
                    scale = np.ones(u_cap, np.float32)
                    scale[: mids.size] = scale_r
        colors = np.zeros(u_cap, np.int32)
        if self.colors is not None and mids.size:
            colors[: mids.size] = self.colors[mids]
        sh = NamedSharding(self.mesh, P())
        with self.timers.time("stage_upload"):
            stage = (jax.device_put(ids_p, sh), jax.device_put(enc, sh),
                     None if scale is None else jax.device_put(scale, sh),
                     mids, gathered, colors, offer)
        self.timers.tally("stage_rows", float(mids.size))
        return stage

    def _offer_stage(self, stage, return_evicted: bool = False):
        """Owner-partitioned insert of a window's staged rows (refresh, as
        the reference's mandatory miss insert; correctness never depends
        on it). Reuses the hot rows already gathered for the stage.
        ``return_evicted`` threads through to the evict-reporting insert
        kernel for the overlapped schedule. Evicted-patch rows (stage[6]
        False) are excluded — re-admitting rows no window requested
        evicts useful lines and ping-pongs with the next insert."""
        _, _, _, mids, rows, colors, offer = stage
        mids = mids[offer]
        if mids.size == 0:
            return None
        with self.timers.time("insert_dispatch"):
            return self.cache.insert_rows(
                mids, rows[: offer.size][offer],
                colors[: offer.size][offer] if self.colors is not None
                else None,
                return_evicted=return_evicted)

    def _prefetch_window(self, seeds_dev, keys, K: int):
        """Probe the window's residency across the mesh. Repairable misses
        get one owner-partitioned insert (the fused pass then hits them);
        bucket-overflow slots get host rows returned as per-step merge
        inputs for the window. Only two scalar counts cross device->host on
        the all-hit path. Returns (ovf_pos [n_dev, K, ovf_cap],
        ovf_rows [n_dev, K, ovf_cap, dim]) numpy arrays."""
        n_dev = self.mesh.devices.size
        dim = self.cache.cfg.dim
        n_miss, n_ovf, miss, ovf = self._presample(
            self._g, self.cache.state, seeds_dev, keys)
        empty = (np.zeros((n_dev, K, 0), np.int32),
                 np.zeros((n_dev, K, 0, dim), self.cache._np_dtype))
        have_miss = np.asarray(n_miss).any()
        have_ovf = np.asarray(n_ovf).any()
        if have_miss:
            miss_np = np.asarray(miss)
            mids = np.unique(miss_np[miss_np >= 0])
            if mids.size:
                self.cache.prewarm(mids, self.host_fetch, colors=self.colors)
        if not have_ovf:
            return empty
        ovf_np = np.asarray(ovf)                       # [n_dev, K, n_req]
        counts = (ovf_np >= 0).sum(axis=2)
        ovf_cap = _ceil_pow2(int(counts.max()))
        ovf_pos = np.full((n_dev, K, ovf_cap), -1, np.int32)
        ovf_rows = np.zeros((n_dev, K, ovf_cap, dim), self.cache._np_dtype)
        for d in range(n_dev):
            for k in range(K):
                pos = np.flatnonzero(ovf_np[d, k] >= 0)[:ovf_cap]
                if pos.size == 0:
                    continue
                ovf_pos[d, k, : pos.size] = pos
                ovf_rows[d, k, : pos.size] = self.host_fetch(
                    ovf_np[d, k, pos].astype(np.int64))
        return ovf_pos, ovf_rows

    def _dispatch_window(self, params, opt_state, seeds_grid, key,
                         sync_miss: bool = True):
        """Upload seeds, prefetch (unless full coverage) and dispatch one
        fused window; sync_miss starts the miss-count transfer immediately
        (single-window callers). Returns (params', opt', losses, miss,
        hits, edges)."""
        sh = NamedSharding(self.mesh, P(DATA_AXIS, None, None))
        seeds_dev = jax.device_put(
            np.ascontiguousarray(seeds_grid, np.int32), sh)
        K = seeds_grid.shape[1]
        keys = jax.random.key_data(jax.random.split(key, K))
        n_dev = self.mesh.devices.size
        dim = self.cache.cfg.dim
        if not self.full_coverage:
            ovf_pos, ovf_rows = self._prefetch_window(seeds_dev, keys, K)
        else:
            ovf_pos = np.zeros((n_dev, K, 0), np.int32)
            ovf_rows = np.zeros((n_dev, K, 0, dim), self.cache._np_dtype)
        k_window = self._window_jit(params, opt_state, ovf_pos.shape[2])
        sh3 = NamedSharding(self.mesh, P(DATA_AXIS, None, None))
        sh4 = NamedSharding(self.mesh, P(DATA_AXIS, None, None, None))
        out = k_window(self._g, self._labels_dev, self.cache.state, params,
                       opt_state, seeds_dev, keys,
                       jax.device_put(ovf_pos, sh3),
                       jax.device_put(ovf_rows, sh4))
        if sync_miss:
            try:
                out[3].copy_to_host_async()
            except Exception:
                pass
        return out

    def _replay_window(self, params, opt_state, seeds_grid, key):
        """Precise per-step replay with host miss repair (the safety net)."""
        out_losses, out_edges = [], []
        for i in range(seeds_grid.shape[1]):
            key, k1, k2 = jax.random.split(key, 3)
            handle = self.begin(seeds_grid[:, i], k1)
            resolved = self.resolve(handle)
            params, opt_state, loss, acc = self.train_step(
                params, opt_state, k2, resolved)
            out_losses.append(loss)
            out_edges.append(handle[6].sum())   # per-device edge counts
        return (params, opt_state, jnp.stack(out_losses),
                jnp.stack(out_edges).astype(jnp.float32))

    def train_window(self, params, opt_state, seeds_grid: np.ndarray, key):
        """K fused DP steps in one dispatch. seeds_grid int32 [n_dev, K, B].
        Returns (params', opt_state', losses [K], edges [K])."""
        return self.train_windows(params, opt_state, seeds_grid[None], key,
                                  _keys=[key])

    def train_windows(self, params, opt_state, seeds_grids: np.ndarray, key,
                      _keys=None):
        """M fused windows. seeds_grids int32 [M, n_dev, K, B].
        Returns (params', opt_state', losses [M*K], edges [M*K]).

        Full coverage: all M windows dispatch with ZERO per-window host
        syncs; counters fold into one [M, 3] transfer.

        Partial coverage: the software-pipelined STAGED schedule (the mesh
        version of ResidentTrainer.train_windows). With ``stage_overlap``
        (optional; the default is the serial schedule below) device
        stream order per window w is
            probe(w+1) -> window(w) -> offer(stage_w, evict-reporting)
        — the bitmap probe sees the same pre-insert state the window's
        exchange lookups read, so its readback and the host gather of
        stage w+1 overlap window w's compute; lines the insert evicts are
        all_gathered (replicated, multi-host-coherent) and patched into
        the stage, preserving the superset guarantee. With
        ``stage_overlap=False`` (the default) the serial order
            window(w) -> offer(stage_w) -> probe(w+1)
        keeps the probe exact by construction at the cost of the gather
        on the critical path. The stage overlay serves every unserved
        slot (residency misses AND bucket overflow) either way, and the
        windows are exact at any hit ratio (an earlier path
        blocked on per-window miss counts and was not pipelined).
        Stage-served rows count as misses (reference semantics: they came
        from the backing store)."""
        M = seeds_grids.shape[0]
        keys = list(jax.random.split(key, M)) if _keys is None else _keys
        losses_out: list = [None] * M
        edges_out: list = [None] * M
        snaps: list = [None] * M
        counters: list = [None] * M
        sh = NamedSharding(self.mesh, P(DATA_AXIS, None, None))
        seeds_dev = [jax.device_put(np.ascontiguousarray(s, np.int32), sh)
                     for s in seeds_grids]
        keydata = [jax.random.key_data(
            jax.random.split(keys[w], seeds_grids[w].shape[1]))
            for w in range(M)]
        staged = not self.full_coverage

        stage = None
        if staged:
            stage = self._build_stage(self._probe_window_staged(
                seeds_dev[0], keydata[0]))
        for w in range(M):
            snaps[w] = (params, opt_state)
            if staged:
                mids_next = None
                if self.stage_overlap and w + 1 < M:
                    # overlapped: probe w+1 precedes window w on the
                    # stream (sees the same pre-insert state) and its
                    # bitmap is read back IMMEDIATELY while the stream is
                    # empty (a cheap sync);
                    # the host gather then overlaps the window, and the
                    # insert's evicted ids patch the stage afterwards
                    mids_next = self._probe_mids(self._probe_window_staged(
                        seeds_dev[w + 1], keydata[w + 1]))
                k_win = self._window_staged_jit(params, opt_state,
                                                stage[2] is not None)
                with self.timers.time("window_dispatch"):
                    (params, opt_state, losses, miss, hits, unres,
                     edges) = k_win(
                        self._g, self._labels_dev, self.cache.state,
                        *(s for s in stage[:3] if s is not None),
                        params, opt_state, seeds_dev[w], keydata[w])
                ev = None
                if self.stage_admit:
                    ev = self._offer_stage(
                        stage, return_evicted=mids_next is not None)
                if w + 1 < M:
                    if mids_next is not None:
                        stage = self._stage_from_mids(mids_next, evicted=ev)
                    else:
                        stage = self._build_stage(self._probe_window_staged(
                            seeds_dev[w + 1], keydata[w + 1]))
            else:
                with self.timers.time("window_dispatch"):
                    params, opt_state, losses, miss, hits, edges = \
                        self._dispatch_window(params, opt_state,
                                              seeds_grids[w], keys[w],
                                              sync_miss=False)
                unres = miss
            losses_out[w], edges_out[w] = losses, edges
            counters[w] = jnp.stack([miss.sum(), hits.sum(), unres.sum()])
        folded = np.asarray(jnp.stack(counters))        # ONE d2h transfer
        self.misses += int(folded[:, 0].sum())
        self.hits += int(folded[:, 1].sum())
        bad = np.flatnonzero(folded[:, 2])
        if bad.size:
            # Safety net (unreachable when probes ran in stream order).
            # Replayed steps re-count through the device counters, so
            # subtract the tainted windows' folded counts first (else
            # stats() double-counts replays).
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

    def stats(self) -> dict:
        """Cache device counters (per-step path) + window accumulators,
        reset on read."""
        s = self.cache.stats()
        h = s["hits"] + self.hits
        m = s["misses"] + self.misses
        self.hits = self.misses = 0
        return {"hits": h, "misses": m,
                "hit_ratio": h / (h + m) if (h + m) else 0.0}

    # ------------------------------------------------------------------
    def begin(self, seed_grid: np.ndarray, key):
        """seed_grid int32 [n_dev, B] — each device's seed slice (from the
        affinity distributor's domain split)."""
        sh = NamedSharding(self.mesh, P(DATA_AXIS, None))
        seeds_dev = jax.device_put(
            np.ascontiguousarray(seed_grid, np.int32), sh)
        self.cache.state, blocks, ids, valid, feats, hit, n_miss, n_edges, y \
            = self._stage_a(self._g, self._labels_dev, self.cache.state,
                            seeds_dev, key)
        try:
            n_miss.copy_to_host_async()
        except Exception:
            pass
        return (blocks, ids, valid, feats, hit, n_miss, n_edges, y)

    def resolve(self, handle):
        blocks, ids, valid, feats, hit, n_miss, n_edges, y = handle
        if not np.asarray(n_miss).any():
            return blocks, feats, y
        hit_np = np.asarray(hit)
        valid_np = np.asarray(valid)
        ids_np = np.asarray(ids)
        need = valid_np & ~hit_np
        n_dev = self.mesh.devices.size
        m_cap = 1 << max(int(need.sum(axis=1).max()) - 1, 0).bit_length()
        k_fill, k_merge = self.cache._miss_kernels(self.n_req, m_cap)
        positions = np.full((n_dev, m_cap), -1, np.int32)
        rows = np.zeros((n_dev, m_cap, self.cache.cfg.dim),
                        self.cache._np_dtype)
        colors_m = np.zeros((n_dev, m_cap), np.int32)
        with self.timers.time("host_gather"):
            for d in range(n_dev):
                pos = np.flatnonzero(need[d])
                if pos.size == 0:
                    continue
                miss_ids = ids_np[d, pos].astype(np.int64)
                positions[d, : pos.size] = pos
                rows[d, : pos.size] = self.host_fetch(miss_ids)
                if self.colors is not None:
                    colors_m[d, : pos.size] = self.colors[miss_ids]
        sh2 = NamedSharding(self.mesh, P(DATA_AXIS, None))
        sh3 = NamedSharding(self.mesh, P(DATA_AXIS, None, None))
        dpos = jax.device_put(positions, sh2)
        drows = jax.device_put(rows, sh3)
        feats = k_merge(feats, dpos, drows)
        self.cache.state = k_fill(self.cache.state, ids, dpos, drows,
                                  jax.device_put(colors_m, sh2))
        return blocks, feats, y

    def train_step(self, params, opt_state, key, resolved,
                   valid: Optional[np.ndarray] = None):
        """One DP step. ``valid`` (bool [n_dev, B], optional) switches to
        the masked global-mean loss: invalid slots (wrapped tail
        duplicates) contribute exactly zero gradient — the exact-tail
        training path (--mask_tail routes the final wrapped iteration of
        an epoch here instead of into a fused window)."""
        blocks, feats, y = resolved
        if valid is None:
            return self._stage_b(params, opt_state, key, blocks, feats, y)
        v = jax.device_put(np.asarray(valid, bool),
                           NamedSharding(self.mesh, P(DATA_AXIS)))
        return self._stage_b_masked(params, opt_state, key, blocks, feats,
                                    y, v)

    def eval_step(self, params, resolved,
                  valid: Optional[np.ndarray] = None) -> int:
        """Jitted DP eval. ``valid`` (bool [n_dev, B], optional) masks out
        padded/wrapped seed slots — exact-tail accounting for splits that
        don't fill a whole global batch. Derive it from the distributor:
        ``DistributionScheduler.domain_valid`` (or
        ``SeedDistributor.distribute(..., return_valid=True)``) threads
        per-slot validity THROUGH any reordering, so it is sound for every
        distribution mode; the older positional ``valid_mask(it)`` remains
        valid for mode='baseline' only (order-preserving striping) and
        refuses otherwise. Multi-process safe: each process counts its own
        devices' slots and the counts allgather-sum."""
        blocks, feats, y = resolved
        ok = self._eval_b(params, blocks, feats, y)       # [n_dev, B] bool
        from coala_gnn.parallel.multihost import read_local_shards
        idxs, rows = read_local_shards(ok)
        local = sum(int(np.asarray(rows[i]).sum()
                        if valid is None else
                        (np.asarray(rows[i]) & valid[g]).sum())
                    for i, g in enumerate(idxs))
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils
            return int(multihost_utils.process_allgather(
                np.asarray([local], np.int64)).sum())
        return local


def _block_struct(n_layers, hetero: bool = False):
    """Placeholder block list for spec construction (contiguous layout:
    adj=None is an empty pytree; mask — and rel for hetero — carry specs)."""
    if hetero:
        from coala_gnn.models.hetero import DeviceHeteroBlock
        return [DeviceHeteroBlock(adj=None, mask=0, rel=0)
                for _ in range(n_layers)]
    from coala_gnn.models.layers import DeviceBlock
    return [DeviceBlock(adj=None, mask=0) for _ in range(n_layers)]
