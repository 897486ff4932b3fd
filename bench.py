#!/usr/bin/env python
"""Benchmark: end-to-end GraphSAGE training throughput on one chip.

Prints ONE JSON line to stdout:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": ...}

Measurement protocol follows the reference's epoch-time benchmark
(reference: examples/sbatch_ssd_gnn_train.py:126-151 at batch 1024 —
the 4GB_script.sh grid) expressed as a rate: valid sampled edges aggregated
per second of wall-clock training (sampling + feature fetch + fwd/bwd/step).
The reference publishes no numbers (BASELINE.md), so vs_baseline is null.

Everything except the JSON line goes to stderr.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _roofline_row(B, fanouts, dim, hidden, num_classes, model_type,
                  line_bytes, model_bytes, nbr_cap, ms_step):
    """Roofline report for one measured config against the published peaks
    of the device it ran on; the string "not measured" on the CPU (a CPU
    run has no device roofline). An unknown device raises."""
    import jax

    from coala_gnn.utils.roofline import published_peaks, report, step_cost
    dev = jax.devices()[0]
    if dev.platform == "cpu":
        return "not measured"
    cost = step_cost(B, fanouts, dim, hidden, num_classes, model=model_type,
                     line_bytes=line_bytes, model_bytes=model_bytes,
                     nbr_cap=nbr_cap)
    return report(cost, published_peaks(dev.device_kind, model_bytes),
                  ms_step)


def run_resident(ds, B, fanouts, dim, hidden, cache_mb, bf16, warmup, steps,
                 prewarm_frac=1.0, tag="resident", quantize=None,
                 priorities=None, stage_transport="auto", window=None,
                 model_dtype=None, model_type="sage", scan_unroll=None,
                 nbr_cap=None, rng_impl=None, stage_overlap=None):
    """Device-resident mode: topology in HBM, sampling+probe in jit; host
    uploads only seeds (~4 KB/step). prewarm_frac < 1 leaves the cache
    under capacity pressure (the regime COALA exists for): only the
    highest-degree hub nodes are admitted and the staged miss path runs
    live (probe bitmap -> host gather of the window's unique miss rows ->
    sideband stage overlay; priority admission keeps hubs resident).
    Returns the result dict."""
    import jax
    import jax.numpy as jnp
    import optax

    from coala_gnn.cache import feature_cache as fc
    from coala_gnn.cache.host_tier import HostFeatureStore
    from coala_gnn.models import make_model
    from coala_gnn.parallel.resident import ResidentTrainer

    store = HostFeatureStore(ds.features)
    quant = (bool(int(os.environ.get("BENCH_QUANT", 0)))
             if quantize is None else quantize)
    cfg = fc.make_config(cache_mb=cache_mb, dim=dim, num_colors=0,
                         dtype=jnp.bfloat16 if bf16 else jnp.float32,
                         quantize=quant)
    if model_dtype is None:
        model_dtype = os.environ.get("BENCH_MODEL_DTYPE", "")
    model_dtype = (jnp.bfloat16 if model_dtype == "bfloat16"
                   else jnp.float32)
    model = make_model(model_type, hidden=hidden,
                       num_classes=ds.num_classes,
                       num_layers=len(fanouts), dtype=model_dtype)
    if scan_unroll is None:
        # default 1 = a rolled scan; BENCH_SCAN_UNROLL overrides
        scan_unroll = int(os.environ.get("BENCH_SCAN_UNROLL", 1))
    if nbr_cap is None:
        # padded-neighbor-table topology layout (0 = CSR, the default)
        nbr_cap = int(os.environ.get("BENCH_NBR_CAP", 0)) or None
    if stage_overlap is None:
        stage_overlap = bool(int(os.environ.get("BENCH_STAGE_OVERLAP", 0)))
    rt = ResidentTrainer(graph=ds.graph, host_fetch=store.fetch,
                         labels=ds.labels, cache_cfg=cfg, model=model,
                         tx=optax.adam(1e-3), fanouts=fanouts, batch_size=B,
                         priorities=priorities,
                         stage_transport=stage_transport,
                         stage_overlap=stage_overlap,
                         scan_unroll=scan_unroll, nbr_cap=nbr_cap)
    t = time.perf_counter()
    n_warm = min(cfg.capacity, ds.graph.num_nodes)
    if prewarm_frac >= 1.0 and cfg.capacity >= ds.graph.num_nodes:
        rt.prewarm(np.arange(ds.graph.num_nodes, dtype=np.int32))
    else:
        # capacity pressure: admit the highest-degree nodes (hub caching)
        n_warm = min(int(n_warm * min(prewarm_frac, 1.0)),
                     ds.graph.num_nodes)
        deg = np.diff(np.asarray(ds.graph.indptr))
        top = np.argpartition(deg, -n_warm)[-n_warm:]
        rt.prewarm(top.astype(np.int32))
    log(f"bench[{tag}]: prewarmed {n_warm} lines "
        f"(capacity {cfg.capacity}, {ds.graph.num_nodes} nodes) in "
        f"{time.perf_counter() - t:.1f}s")

    # fused steps per dispatch; pressure regimes default to longer windows
    # because the staged transfer ships each UNIQUE miss row once per
    # window — K amortizes the per-window probe/gather toward the "ship
    # every cold row once" lower bound
    K = window if window else int(os.environ.get("BENCH_WINDOW", 8))
    rng = np.random.default_rng(0)
    if rng_impl is None:
        # sampler PRNG family ("" = threefry default; "rbg" lowers to the
        # XLA RngBitGenerator HLO — different stream, same distribution;
        # utils/rng.py)
        rng_impl = os.environ.get("BENCH_RNG_IMPL", "")
    key = (jax.random.key(0, impl=rng_impl) if rng_impl
           else jax.random.key(0))

    def seeds_one():
        return rng.choice(ds.train_idx, B, replace=False).astype(np.int32)

    def make_grids(n_win):
        """Epoch-permutation seeds (reference parity: shuffled train nids,
        sbatch_ssd_gnn_train.py:65), sliced into [n_win, K, B] windows."""
        need = n_win * K * B
        reps = -(-need // ds.train_idx.size)
        perm = np.concatenate(
            [rng.permutation(ds.train_idx) for _ in range(reps)])
        return np.ascontiguousarray(perm[:need].astype(np.int32)
                                    .reshape(n_win, K, B))

    # init params via one resolved batch
    resolved = rt.resolve(rt.begin(seeds_one(), jax.random.key(9)))
    log(f"bench[{tag}]: compiling...")
    params = model.init(jax.random.key(1), resolved[0], resolved[1])
    opt_state = rt.tx.init(params)

    meas_w = max(steps // K, 1)
    warm_w = max(warmup // K, 1)
    # warm at the SAME window count as the measurement: every op the timed
    # region dispatches (including M-dependent stack/concat tails) must be
    # compiled before t0 — an M-mismatch puts multi-second compiles inside
    # the measured region (the r2 bench-regression trap)
    warm_w = max(warm_w, meas_w)
    key, sub = jax.random.split(key)
    params, opt_state, loss_arr, _ = rt.train_windows(
        params, opt_state, make_grids(warm_w), sub)
    float(np.asarray(loss_arr)[-1])
    log(f"bench[{tag}]: compile done (fused window K={K}, "
        f"{warm_w} warm windows)")
    rt.stats()
    rt.timers.reset()   # timers below cover the measured region only
    meas_grids = make_grids(meas_w)
    key, sub = jax.random.split(key)
    t0 = time.perf_counter()
    params, opt_state, loss_arr, edges_arr = rt.train_windows(
        params, opt_state, meas_grids, sub)
    loss = float(np.asarray(loss_arr)[-1])
    dt = (time.perf_counter() - t0)
    n_done = K * meas_w
    edges = float(np.asarray(edges_arr).sum())
    eps = edges / dt
    s = rt.stats()
    log(f"bench[{tag}]: {n_done} steps in {dt:.3f}s -> {eps:,.0f} edges/s "
        f"({1000 * dt / n_done:.1f} ms/step, loss {float(loss):.4f}, "
        f"hit {s['hit_ratio']:.3f})")
    if rt.timers.totals:
        log(f"bench[{tag}]: measured-region phase timers:\n"
            + rt.timers.report())
    config = {"batch": B, "fanout": fanouts, "dim": dim,
              "hidden": hidden, "nodes": ds.graph.num_nodes,
              "cache_mb": cache_mb, "model": model_type, "mode": tag,
              "feature_dtype": "bfloat16" if bf16 else "float32",
              "cache_lines": "int8" if quant else
              ("bfloat16" if bf16 else "float32"),
              "stage_transport": rt.stage_transport,
              "window": K, "scan_unroll": rt.scan_unroll,
              "nbr_cap": nbr_cap,
              "priorities": "degree" if priorities is not None else None}
    out = {
        "metric": "train_edges_per_s_per_chip",
        "value": round(eps, 1),
        "unit": "edges/s",
        # the reference publishes no numbers (BASELINE.md)
        "vs_baseline": None,
        "cache_hit_ratio": round(s["hit_ratio"], 4),
        "ms_per_step": round(1000 * dt / n_done, 3),
        "config": config,
    }
    # roofline accounting (full-coverage configs only: under capacity
    # pressure the step is host-link-bound and the on-chip roofline is not
    # the binding resource)
    if prewarm_frac >= 1.0 and cfg.capacity >= ds.graph.num_nodes:
        out["roofline"] = _roofline_row(
            B, fanouts, dim, hidden, ds.num_classes,
            model_type, line_bytes=1 if quant else (2 if bf16 else 4),
            model_bytes=2 if model_dtype == jnp.bfloat16 else 4,
            nbr_cap=nbr_cap, ms_step=1000 * dt / n_done)
    return out


def run_host(ds, B, fanouts, dim, hidden, cache_mb, bf16, warmup, steps,
             tag="host", contiguous=False):
    """Host packed pipeline (one transfer/step, one-batch-ahead probe
    pipelining): cache_mb == 0 is the UNCACHED host-fetch configuration.

    contiguous=True switches to the slot-major sentinel wire format
    (sampling/neighbor._sample_contiguous + data/packing
    .pack_request_contig): the adjacency never crosses the link — ~2x
    fewer bytes/step on the link-bound path.
    Returns the result dict."""
    import jax
    import jax.numpy as jnp
    import optax

    from coala_gnn.cache import feature_cache as fc
    from coala_gnn.cache.host_tier import HostFeatureStore
    from coala_gnn.data.loader import CoalaDataLoader
    from coala_gnn.data.packing import pack_request, pack_request_contig
    from coala_gnn.distribution import (DistributionScheduler,
                                            SeedDistributor)
    from coala_gnn.models import DeviceBlock, make_model
    from coala_gnn.parallel.mesh import DATA_AXIS, make_mesh
    from coala_gnn.parallel.sharded_cache import ShardedFeatureCache
    from coala_gnn.parallel.train import (make_contig_train_step,
                                              make_request_train_step)
    from coala_gnn.sampling.neighbor import NeighborSampler
    from jax.sharding import NamedSharding, PartitionSpec as P

    sentinel = ds.graph.num_nodes
    sampler = NeighborSampler(ds.graph, fanouts, B, seed=0,
                              contiguous=contiguous)
    distributor = SeedDistributor(ds.train_idx, batch_size=B, local_size=1,
                                  num_parts=1, mode="baseline", shuffle_seed=0)
    scheduler = DistributionScheduler(distributor, part_id=0, local_rank=0)
    loader = CoalaDataLoader(scheduler=scheduler, sampler=sampler,
                             labels=ds.labels, local_size=1, prefetch=2)

    model = make_model("sage", hidden=hidden, num_classes=ds.num_classes,
                       num_layers=len(fanouts))
    tx = optax.adam(1e-3)
    n_req = sampler.caps[0][1]   # input-layer src capacity == id-list length
    from coala_gnn.data.packing import batch_layout
    layout = batch_layout(sampler.caps, fanouts)
    if contiguous:
        step_fn = make_contig_train_step(model, tx, B, layout, n_req,
                                         sentinel)
    else:
        step_fn = make_request_train_step(model, tx, B, layout, n_req)

    # HBM feature cache (the whole point): steady-state hits mean features
    # come from device HBM instead of crossing host->device every step.
    cache = None
    store = HostFeatureStore(ds.features)
    if cache_mb > 0:
        mesh = make_mesh(jax.devices()[:1])
        cfg = fc.make_config(cache_mb=cache_mb, dim=dim, num_colors=0,
                             dtype=jnp.bfloat16 if bf16 else jnp.float32)
        cache = ShardedFeatureCache(cfg=cfg, mesh=mesh, mode="isolated")
        log(f"bench[{tag}]: cache {cfg.num_sets} sets x {cfg.ways} ways "
            f"({cfg.size_mb:.0f} MB, capacity {cfg.capacity} lines)")
        if int(os.environ.get("BENCH_PREWARM", 1)):
            t = time.perf_counter()
            n_warm = min(ds.graph.num_nodes, cfg.capacity)
            cache.prewarm(np.arange(n_warm, dtype=np.int32), store.fetch)
            log(f"bench[{tag}]: prewarmed {n_warm} lines in "
                f"{time.perf_counter() - t:.1f}s")

    params = opt_state = None
    key = jax.random.key(0)
    edges = 0
    t0 = None
    n_done = 0
    loss = None

    # One-batch-ahead cache-probe pipeline: the hit mask for batch i+1
    # streams to the host while batch i trains, hiding the round trip.
    it = iter(loader)
    pending = []  # [(hb, fetch handle)]

    def pull():
        try:
            hb = next(it)
        except StopIteration:
            return
        if contiguous:
            vec = pack_request_contig(hb.input_ids[0].astype(np.int32),
                                      int(hb.num_input[0]), hb.labels[0])
        else:
            vec = pack_request(hb.input_ids[0].astype(np.int32),
                               int(hb.num_input[0]),
                               [a[0] for a in hb.adjs],
                               [m[0] for m in hb.masks], hb.labels[0])
        if cache is not None:
            dbuf = jax.device_put(
                vec[None, :], NamedSharding(cache.mesh, P(DATA_AXIS, None)))
            h = cache.fetch_begin_packed(hb.input_ids, hb.num_input, dbuf,
                                         n_req,
                                         sentinel=sentinel if contiguous
                                         else 0)
        else:
            dbuf = jnp.asarray(vec[None, :])
            h = None
        pending.append((hb, dbuf, h))

    # Speculative all-hit execution: in the prewarmed
    # steady state every step's miss count is zero, so reading it BEFORE
    # the step puts one d2h scalar round trip on every step's critical
    # path — the measured RTT floor of this pipeline (docs/DESIGN.md).
    # Instead, run the step against the probe's feats as-is and verify a
    # GROUP of miss counters after the fact (they streamed back via
    # copy_to_host_async while later steps dispatched). On any nonzero
    # count: roll back to the group-start params (references — functional
    # updates make snapshots free) and replay the group precisely through
    # fetch_complete's miss-repair path. Exactness matches the resident
    # windows' replay safety net.
    spec = cache is not None and bool(
        int(os.environ.get("BENCH_HOST_SPECULATE", 1)))
    group_cap = int(os.environ.get("BENCH_HOST_SPEC_GROUP", 8))
    group = []      # [(handle, packed, key)] since last verify
    snap = None     # (params, opt_state) at group start
    replays = 0

    def flush_group():
        nonlocal params, opt_state, loss, replays, snap
        if not group:
            return
        miss = [int(np.asarray(h[6])) for h, _, _ in group]
        if any(miss):
            replays += 1
            params, opt_state = snap
            for h_g, packed_g, key_g in group:
                x_g = cache.fetch_complete(h_g, store.fetch)[0]
                params, opt_state, loss, _ = step_fn(params, opt_state,
                                                     key_g, packed_g, x_g)
        group.clear()
        snap = None

    pull()
    for i in range(warmup + steps):
        if not pending:
            break
        hb, packed, handle = pending.pop(0)
        pull()  # start next batch's probe before resolving this one
        if cache is not None:
            if spec and params is not None:
                if snap is None:
                    snap = (params, opt_state)
                x = handle[3][0]        # probe feats, misses unverified
            else:
                x = cache.fetch_complete(handle, store.fetch)[0]
        else:
            # sentinel ids (contiguous layout) index a clamped row — the
            # value never contributes (mask weight 0)
            x = jnp.asarray(ds.features[np.minimum(hb.input_ids[0],
                                                   sentinel - 1)])
        if params is None:
            log(f"bench[{tag}]: first batch ready (sampled "
                f"{hb.sampled_nodes} nodes); initializing + compiling...")
            # contiguous HostBatch carries no masks (wire never ships
            # them); init only needs the shape, values are irrelevant
            blocks0 = [DeviceBlock(
                adj=None if contiguous else jnp.asarray(hb.adjs[l][0]),
                mask=(jnp.zeros((sampler.caps[l][0], fanouts[l]), jnp.float32)
                      if contiguous else jnp.asarray(hb.masks[l][0])))
                       for l in range(len(fanouts))]
            params = model.init(jax.random.key(1), blocks0, x)
            opt_state = tx.init(params)
        key, sub = jax.random.split(key)
        params, opt_state, loss, acc = step_fn(params, opt_state, sub,
                                               packed, x)
        if spec and cache is not None and snap is not None:
            group.append((handle, packed, sub))
            if len(group) >= group_cap:
                flush_group()
        if i == 0:
            flush_group()
            jax.block_until_ready(loss)
            log(f"bench[{tag}]: compile done, warming up")
        if i == warmup - 1:
            flush_group()
            jax.block_until_ready(loss)
            if cache is not None:
                cache.stats()  # reset so reported ratio covers timed steps
            t0 = time.perf_counter()
            edges = 0
        if i >= warmup:
            edges += hb.edges        # all-device valid-edge count (local_size=1 here)
            n_done += 1

    flush_group()
    if replays:
        log(f"bench[{tag}]: speculative groups replayed: {replays}")
    jax.block_until_ready(loss)
    dt = time.perf_counter() - t0
    eps = edges / dt
    hit_ratio = None
    if cache is not None:
        s = cache.stats()
        hit_ratio = round(s["hit_ratio"], 4)
        log(f"bench[{tag}]: cache hit ratio {s['hit_ratio']:.3f} "
            f"({s['hits']} hits / {s['misses']} misses)")
    log(f"bench[{tag}]: {n_done} steps in {dt:.3f}s -> {eps:,.0f} edges/s "
        f"({1000 * dt / n_done:.1f} ms/step, loss {float(loss):.4f})")
    return {
        "metric": "train_edges_per_s_per_chip",
        "value": round(eps, 1),
        "unit": "edges/s",
        "vs_baseline": None,
        "cache_hit_ratio": hit_ratio,
        "config": {"batch": B, "fanout": fanouts, "dim": dim,
                   "hidden": hidden, "nodes": ds.graph.num_nodes,
                   "cache_mb": cache_mb, "model": "sage", "mode": tag,
                   "layout": "contig" if contiguous else "dedup",
                   "feature_dtype": "bfloat16" if bf16 else "float32"},
    }


def run_dim1024(warmup, steps, nodes=None, dim=1024, B=512,
                fanouts=(10, 5), hidden=256, window=None):
    """int8-overflow-scale pressure regime: dim 1024
    (IGB-large width, ssd_gnn_dataloader.py:819 scale) with the cache
    budget at 12.5% of the f32 feature bytes — int8 lines only reach ~50%
    coverage, so NO tier escapes to full coverage and the staged miss path
    must win on its own. The uncached reference is measured INLINE at this
    exact config."""
    from coala_gnn.graph.datasets import synthetic_graph

    if nodes is None:
        nodes = int(os.environ.get("BENCH_DIM1024_NODES", 100_000))
    fanouts = list(fanouts)
    ds = synthetic_graph(num_nodes=nodes, avg_degree=15, feature_dim=dim,
                         num_classes=16, seed=0)
    unc = run_host(ds, B, fanouts, dim, hidden, cache_mb=0, bf16=False,
                   warmup=2, steps=6, tag="dim1024-uncached")
    press_mb = max(int(nodes * 0.125 * dim * 4) >> 20, 1)
    pk = window or int(os.environ.get("BENCH_WINDOW_PRESSURE", 32))
    p = run_resident(ds, B, fanouts, dim, hidden, press_mb, False,
                     warmup, steps, tag="dim1024-staged",
                     priorities="degree", stage_transport="int8", window=pk)
    q = run_resident(ds, B, fanouts, dim, hidden, press_mb, False,
                     warmup, steps, tag="dim1024-int8-lines",
                     priorities="degree", stage_transport="int8",
                     window=pk, quantize=True)
    base = unc["value"]

    def summ(r):
        return {"value": r["value"], "unit": r["unit"],
                "cache_hit_ratio": r["cache_hit_ratio"],
                "cache_mb": press_mb,
                "cache_lines": r["config"]["cache_lines"],
                "vs_uncached_same_config": round(r["value"] / base, 2)}

    return {"uncached_edges_per_s": base,
            "config": {"nodes": nodes, "dim": dim, "batch": B,
                       "fanout": fanouts, "cache_mb": press_mb},
            "staged_f32_lines": summ(p),
            "staged_int8_lines": summ(q)}


def main():
    from coala_gnn.utils.jaxconfig import setup as jax_setup
    # BENCH_PLATFORM=cpu for CPU rehearsals; anything but the GPU otherwise
    # refuses to run
    jax_setup(os.environ.get("BENCH_PLATFORM", "gpu"))
    import jax
    import jax.numpy as jnp
    import optax

    from coala_gnn.cache import feature_cache as fc
    from coala_gnn.cache.host_tier import HostFeatureStore
    from coala_gnn.data.loader import CoalaDataLoader
    from coala_gnn.distribution import DistributionScheduler, SeedDistributor
    from coala_gnn.graph.datasets import synthetic_graph
    from coala_gnn.models import DeviceBlock, make_model
    from coala_gnn.parallel.mesh import make_mesh
    from coala_gnn.parallel.sharded_cache import ShardedFeatureCache
    from coala_gnn.parallel.train import make_train_step
    from coala_gnn.sampling.neighbor import NeighborSampler

    B = int(os.environ.get("BENCH_BATCH", 1024))
    fanouts = [int(f) for f in os.environ.get("BENCH_FANOUT", "10,5").split(",")]
    dim = int(os.environ.get("BENCH_DIM", 256))
    hidden = int(os.environ.get("BENCH_HIDDEN", 256))
    num_nodes = int(os.environ.get("BENCH_NODES", 200_000))
    cache_mb = int(os.environ.get("BENCH_CACHE_MB", 1024))
    bf16 = bool(int(os.environ.get("BENCH_BF16", 0)))
    # 128 measured steps: a few-ms step makes a 64-step window too short
    # to average out host dispatch jitter
    warmup, steps = int(os.environ.get("BENCH_WARMUP", 16)), \
        int(os.environ.get("BENCH_STEPS", 128))

    resident = bool(int(os.environ.get("BENCH_RESIDENT", 1)))
    if os.environ.get("BENCH_PER_STEP") is not None:
        # the per-step pipelined A/B engine path was removed in r2; fail
        # loudly instead of silently ignoring the knob
        raise SystemExit(
            "BENCH_PER_STEP was removed (r2): the fused-window resident "
            "path replaced the per-step A/B engine. Use BENCH_WINDOW=1 "
            "for near-per-step behavior or examples/compare.py for A/Bs.")

    log(f"bench: backend={jax.default_backend()} devices={jax.devices()}")
    ds = synthetic_graph(num_nodes=num_nodes, avg_degree=15, feature_dim=dim,
                         num_classes=16, seed=0)

    if resident:
        res = run_resident(ds, B, fanouts, dim, hidden, cache_mb, bf16,
                           warmup, steps)
        res["device"] = {"platform": jax.devices()[0].platform,
                         "kind": jax.devices()[0].device_kind,
                         "count": len(jax.devices())}
        if int(os.environ.get("BENCH_BF16_BLOCK", 1)) and not bf16:
            # bf16 features + bf16 model compute: halves the cache
            # footprint and the gather traffic; the headline stays f32
            bf = run_resident(ds, B, fanouts, dim, hidden, cache_mb,
                              True, warmup, steps, tag="resident-bf16",
                              model_dtype="bfloat16")
            res["bf16"] = {"value": bf["value"], "unit": bf["unit"],
                           "cache_hit_ratio": bf["cache_hit_ratio"]}
        if int(os.environ.get("BENCH_PRESSURE", 1)):
            # Capacity-pressure regime (the regime COALA exists for):
            # cache sized to ~50% of the feature set,
            # degree-prewarmed hubs protected by priority admission, live
            # staged miss path (probe bitmap -> unique-row host gather ->
            # stage overlay). Longer fused windows amortize the staged
            # transfer toward the ship-each-cold-row-once lower bound.
            cdim = fc.round_cache_dim(dim)
            line_b = cdim * (2 if bf16 else 4)
            press_mb = max(int(num_nodes * 0.5 * line_b) >> 20, 1)
            pk = int(os.environ.get("BENCH_WINDOW_PRESSURE", 32))

            def summarize(r):
                return {"value": r["value"], "unit": r["unit"],
                        "cache_hit_ratio": r["cache_hit_ratio"],
                        "cache_mb": press_mb,
                        "stage_transport": r["config"]["stage_transport"]}

            p = run_resident(ds, B, fanouts, dim, hidden, press_mb, bf16,
                             warmup, steps, tag="resident-pressure",
                             priorities="degree",
                             stage_transport="float32", window=pk)
            res["pressure"] = summarize(p)
            # bf16 stage transport: halves the dominant per-window stage
            # upload at near-f32 fidelity
            pb = run_resident(ds, B, fanouts, dim, hidden, press_mb, bf16,
                              warmup, steps,
                              tag="resident-pressure-bf16-transport",
                              priorities="degree",
                              stage_transport="bfloat16", window=pk)
            res["pressure_bf16_transport"] = summarize(pb)
            # int8 stage TRANSPORT (f32 lines): 4x less host-link traffic
            # on the miss path — the knob for pressure regimes where the
            # link, not HBM, is the bottleneck.
            pt = run_resident(ds, B, fanouts, dim, hidden, press_mb, bf16,
                              warmup, steps,
                              tag="resident-pressure-int8-transport",
                              priorities="degree",
                              stage_transport="int8", window=pk)
            res["pressure_int8_transport"] = summarize(pt)
            # Same HBM budget, int8 LINES (+ per-line scale): ~4x the
            # lines per MB — the quantized tier turns the pressure budget
            # back into (near-)full coverage. No reference analogue (the
            # GPU cache stores raw pages, ssd_gnn_cache.cuh:96).
            q = run_resident(ds, B, fanouts, dim, hidden, press_mb, bf16,
                             warmup, steps, tag="resident-pressure-int8",
                             quantize=True)
            res["pressure_int8"] = summarize(q)
            if int(os.environ.get("BENCH_DIM1024", 1)):
                res["pressure_dim1024"] = run_dim1024(
                    warmup=min(warmup, 8), steps=min(steps, 32))
        if int(os.environ.get("BENCH_GRID", 1)):
            # Reference measurement-grid parity:
            # model {sage, gat} x fanout {2-layer, 3-layer "10,5,5"} at the
            # flagship scale (4GB_script.sh:28-37 sweeps sage/gat x
            # "5,5"/"10,5,5"). The sage/[10,5] cell is the headline above;
            # the other cells run shorter (32 steps) to bound bench time.
            grid = {f"sage_{'x'.join(map(str, fanouts))}":
                    {"value": res["value"], "unit": res["unit"],
                     "cache_hit_ratio": res["cache_hit_ratio"]}}
            for m, fo in (("gat", fanouts), ("sage", [10, 5, 5]),
                          ("gat", [10, 5, 5])):
                g = run_resident(ds, B, list(fo), dim, hidden, cache_mb,
                                 bf16, warmup=8, steps=32,
                                 tag=f"grid-{m}-{'x'.join(map(str, fo))}",
                                 model_type=m)
                grid[f"{m}_{'x'.join(map(str, fo))}"] = {
                    "value": g["value"], "unit": g["unit"],
                    "cache_hit_ratio": g["cache_hit_ratio"]}
            res["grid"] = grid
        if int(os.environ.get("BENCH_HOST", 1)):
            # fresh packed-host-pipeline number every run (an old
            # number goes stale against a changed code base) — same dataset/config as the headline
            h = run_host(ds, B, fanouts, dim, hidden, cache_mb, bf16,
                         warmup=min(warmup, 8), steps=min(steps, 32),
                         tag="host-packed")
            res["host_packed"] = {"value": h["value"], "unit": h["unit"],
                                  "cache_hit_ratio": h["cache_hit_ratio"]}
            # contiguous slot-major wire format: the adjacency stays on
            # device (implicit in the layout), ~2x fewer bytes/step on the
            # link-bound host pipeline
            hc = run_host(ds, B, fanouts, dim, hidden, cache_mb, bf16,
                          warmup=min(warmup, 8), steps=min(steps, 32),
                          tag="host-contig", contiguous=True)
            res["host_contig"] = {"value": hc["value"], "unit": hc["unit"],
                                  "cache_hit_ratio": hc["cache_hit_ratio"],
                                  "vs_host_packed":
                                      round(hc["value"] / h["value"], 2)}
        print(json.dumps(res))
        return
    res = run_host(ds, B, fanouts, dim, hidden, cache_mb, bf16,
                   warmup, steps)
    print(json.dumps(res))



if __name__ == "__main__":
    main()
