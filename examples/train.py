#!/usr/bin/env python
"""Mini-batch GNN training entry point.

User-facing equivalent of the reference trainer
(reference: examples/sbatch_ssd_gnn_train.py) with the same flag surface
(:201-248) where it applies to this build: model_type, fan_out, batch_size,
hidden_channels, learning_rate, epochs, num_layers, num_heads, cache_size,
distribution, refresh_counter. SLURM/MPI bootstrap is replaced by
single-process-per-host JAX; DDP by pjit data parallelism.

Examples:
  python examples/train.py --data synthetic --model_type sage --fan_out 5,5
  python examples/train.py --data synthetic --model_type gat --epochs 2
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="COALA-GNN trainer (JAX)")
    # Reference flag surface (sbatch_ssd_gnn_train.py:201-248), the subset
    # that applies to this build.
    p.add_argument("--path", type=str, default="")
    p.add_argument("--data", type=str, default="synthetic",
                   help="synthetic | ogbn-arxiv | igb | preprocessed dir")
    p.add_argument("--dataset_size", type=str, default="tiny")
    p.add_argument("--num_classes", type=int, default=16)
    p.add_argument("--model_type", type=str, default="sage",
                   choices=["sage", "distsage", "gcn", "gat",
                            "rsage", "rgcn", "rgat"])
    p.add_argument("--fan_out", type=str, default="5,5")
    p.add_argument("--batch_size", type=int, default=1024)
    p.add_argument("--hidden_channels", type=int, default=128)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--decay", type=float, default=0.0)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--num_layers", type=int, default=None,
                   help="defaults to len(fan_out)")
    p.add_argument("--num_heads", type=int, default=4)
    p.add_argument("--cache_size", type=int, default=0,
                   help="feature cache MB; 0 = direct host gather")
    p.add_argument("--cache_backend", type=str, default="sharded",
                   choices=["sharded", "isolated", "node_local",
                            "nvshmem", "nccl"],
                   help="nvshmem/nccl (reference names) alias sharded; "
                        "node_local scopes the exchange to each host's "
                        "devices (intra-host links only) — the reference's "
                        "NVSHMEM-world-per-node topology "
                        "(nvshmem_manager.cuh:15-28)")
    p.add_argument("--devices", type=int, default=0,
                   help="limit local devices (0 = all)")
    p.add_argument("--feat_cpu", action="store_true",
                   help="accepted for reference-CLI parity; the host-RAM "
                        "feature tier is always this build's backing store "
                        "(reference --feat_cpu simulation mode, "
                        "ssd_gnn_dataloader.py:413-439)")
    p.add_argument("--pipeline", type=str, default="host",
                   choices=["host", "resident"],
                   help="host: host sampling + cache fetch; resident: "
                        "on-device sampling + exchange probe (seeds-only "
                        "upload; needs --cache_size)")
    p.add_argument("--window", type=int, default=1,
                   help="resident pipeline: fuse K training steps per "
                        "dispatch (lax.scan); composes with node_color when "
                        "K <= refresh_counter (seed grids use one cache-meta "
                        "snapshot, which is the refresh-cadence contract "
                        "anyway)")
    p.add_argument("--quantize", action="store_true",
                   help="store cache lines as int8 + per-line absmax scale "
                        "(~4x lines per MB, 1/4 gather HBM traffic; no "
                        "reference analogue — the GPU cache stores raw "
                        "pages, ssd_gnn_cache.cuh:96)")
    p.add_argument("--keep_tail", action="store_true",
                   help="exact-epoch mode: visit every seed each epoch by "
                        "wrap-padding the final global batch (default "
                        "drops tail seeds like the reference, "
                        "COALA_GNN_DataLoader.py:141-151)")
    p.add_argument("--mask_tail", action="store_true",
                   help="implies --keep_tail and additionally zeroes the "
                        "wrapped duplicates' loss/gradient contribution "
                        "(global masked mean): the epoch's updates equal "
                        "training on the real seeds alone, under any "
                        "distribution mode (host pipeline; the resident "
                        "pipeline routes the one wrapped iteration through "
                        "its masked per-step path)")
    p.add_argument("--shard_topology", action="store_true",
                   help="resident pipeline: shard indptr/indices over the "
                        "mesh (E/n_dev edges per device; papers100M-class "
                        "graphs) instead of replicating them; frontier "
                        "neighbors route via all_gather + psum_scatter")
    p.add_argument("--nbr_cap", type=int, default=0,
                   help="resident pipeline: padded-neighbor-table topology "
                        "layout with P=nbr_cap slots per node (one aligned "
                        "row read per dst instead of indptr + scattered "
                        "indices gathers; bit-exact sampling for deg <= P, "
                        "seeded random P-subset truncation above). 0 = CSR "
                        "layout. Requires nbr_cap >= max fanout; excludes "
                        "--shard_topology")
    p.add_argument("--rng_impl", type=str, default="",
                   choices=["", "threefry2x32", "rbg"],
                   help="sampler/dropout PRNG family. '' = JAX default "
                        "(threefry2x32, the parity-pinned stream); 'rbg' "
                        "lowers to the XLA RngBitGenerator HLO — a "
                        "different stream of the same "
                        "distribution (utils/rng.py)")
    p.add_argument("--distribution", type=str, default="baseline",
                   choices=["baseline", "node_color"])
    p.add_argument("--refresh_counter", type=int, default=8)
    p.add_argument("--color_dir", type=str, default="",
                   help="dir with color.npy/topk.npy/score.npy for node_color")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval", action="store_true", help="run test eval at end")
    p.add_argument("--max_steps", type=int, default=0,
                   help="truncate each epoch (0 = full epoch)")
    # synthetic dataset knobs
    p.add_argument("--num_edge_types", type=int, default=1,
                   help=">1 turns the synthetic graph heterogeneous "
                        "(random edge types) for rsage/rgcn/rgat")
    p.add_argument("--num_nodes", type=int, default=100_000)
    p.add_argument("--avg_degree", type=int, default=15)
    p.add_argument("--feature_dim", type=int, default=128)
    p.add_argument("--platform", type=str, default="gpu",
                   choices=["gpu", "cpu"],
                   help="jax platform; refuses to run anywhere else "
                        "(cpu = explicit CPU rehearsal)")
    p.add_argument("--save_dir", type=str, default="",
                   help="checkpoint dir (.npz per step); saves params+opt "
                        "each epoch "
                        "(the reference has no checkpointing, SURVEY.md §5)")
    p.add_argument("--resume", action="store_true",
                   help="restore latest checkpoint from --save_dir")
    p.add_argument("--profile_dir", type=str, default="",
                   help="capture a jax.profiler trace of epoch 0 here "
                        "(replaces the reference's wall-clock-only timers, "
                        "SURVEY.md §5)")
    return p.parse_args(argv)


def _run_resident(args, ds, meta, cache, store, model, tx, scheduler,
                  fanouts, B, n_dev, jax):
    """Device-resident training loop: per step the host uploads only the
    [n_dev, B] seed grid chosen by the (affinity) distributor; sampling,
    exchange probe and the DP step run on the mesh.

    Returns the run record: the trainer, final params/opt_state, the first
    step's (params, resolved batch) and, per epoch, its losses, wall
    seconds (ending in a device sync), sampled edges, cache counters and
    phase-timer totals."""
    import numpy as np
    import time

    from coala_gnn.parallel.sharded_resident import ShardedResidentTrainer
    from coala_gnn.utils.rng import make_root_key

    rt = ShardedResidentTrainer(
        graph=ds.graph, host_fetch=store.fetch, labels=ds.labels,
        cache=cache, model=model, tx=tx, fanouts=fanouts, batch_size=B,
        colors=None if meta is None else meta.color,
        shard_topology=bool(getattr(args, "shard_topology", False)),
        nbr_cap=getattr(args, "nbr_cap", 0) or None)
    print("pipeline: device-resident (seeds-only upload"
          + (", sharded topology)" if rt.shard_topology else
             f", padded table P={rt.nbr_cap})" if rt.nbr_cap else ")"))

    key = make_root_key(args.seed, getattr(args, 'rng_impl', ''))
    params = opt_state = None
    steps_per_epoch = scheduler.d.num_iters
    if args.max_steps:
        steps_per_epoch = min(steps_per_epoch, args.max_steps)

    def seed_grid():
        domain = scheduler.run_domain()
        return domain.reshape(n_dev, B).astype(np.int32)

    # exact-tail training: the only iteration with wrapped duplicates is
    # the epoch's last (drop_tail=False); --mask_tail routes it through the
    # masked per-step path so the duplicates contribute zero gradient
    tail_it = -1
    if args.mask_tail and scheduler.d.num_iters and \
            len(scheduler.d.items) % scheduler.d.global_batch:
        tail_it = scheduler.d.num_iters - 1

    def masked_tail_step(params, opt_state, key):
        grid = seed_grid()
        v = scheduler.domain_valid.reshape(n_dev, B)
        key, k1, k2 = jax.random.split(key, 3)
        h = rt.begin(grid, k1)
        params, opt_state, loss, acc = rt.train_step(
            params, opt_state, k2, rt.resolve(h), valid=v)
        return params, opt_state, loss, acc, h[6], key

    def init_params(resolved):
        import jax.numpy as jnp
        blocks0 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)[0]),
                               resolved[0])
        p = model.init(jax.random.key(args.seed), blocks0,
                       jnp.asarray(np.asarray(resolved[1])[0]))
        return p, tx.init(p)

    K = max(args.window, 1)
    if K > 1 and args.refresh_counter < K:
        print(f"note: clamping window {K} to refresh_counter "
              f"{args.refresh_counter} to keep the cache-meta cadence")
        K = args.refresh_counter

    # "feature agg time" = host-side feature work (probe readback waits,
    # host gathers, stage encode/upload, cache offers) — the resident
    # analogue of the reference's aggregation_timer accumulation
    # (COALA_GNN_Manager.py:74,122-210).
    AGG_PHASES = ("probe_wait", "host_gather", "stage_encode",
                  "stage_upload", "insert_dispatch")

    def agg_total():
        return sum(rt.timers.totals.get(p, 0.0) for p in AGG_PHASES)

    start_epoch = 0
    if args.resume and args.save_dir:
        # Probe one batch to build params, restore, then restart the
        # scheduler at the resumed epoch (the consumed probe iteration
        # must not count — mirror of the host path's loader.reset).
        from coala_gnn.utils import checkpoint as ckpt
        key, k0 = jax.random.split(key)
        params, opt_state = init_params(rt.resolve(rt.begin(seed_grid(),
                                                            k0)))
        like = {"params": params, "opt_state": opt_state, "step": 0}
        restored = ckpt.restore(args.save_dir, like)
        if restored is not None:
            params, opt_state, step0 = restored
            # restored arrays land committed to one device; the DP step
            # expects them replicated over the mesh
            from jax.sharding import NamedSharding, PartitionSpec
            rep = NamedSharding(rt.mesh, PartitionSpec())
            params, opt_state = jax.tree.map(
                lambda a: jax.device_put(np.asarray(a), rep),
                (params, opt_state))
            start_epoch = min(step0 // max(steps_per_epoch, 1), args.epochs)
            print(f"resumed from step {step0} -> starting at epoch "
                  f"{start_epoch}")
        scheduler.reset(args.seed + start_epoch if start_epoch else
                        args.seed)

    run = {"trainer": rt, "first_step": None, "epochs": []}
    for epoch in range(start_epoch, args.epochs):
        t0 = time.perf_counter()
        agg0 = agg_total()
        timers0 = dict(rt.timers.totals)
        loss = acc = None
        pending = None
        edge_counts = []
        loss_log = []
        it = 0
        while it < steps_per_epoch:
            if params is None:
                key, k0 = jax.random.split(key)
                grid0 = seed_grid()
                v0 = (scheduler.domain_valid.reshape(n_dev, B)
                      if it == tail_it else None)
                resolved0 = rt.resolve(rt.begin(grid0, k0))
                params, opt_state = init_params(resolved0)
                run["first_step"] = (params, resolved0)
                key, k2 = jax.random.split(key)
                params, opt_state, loss, acc = rt.train_step(
                    params, opt_state, k2, resolved0, valid=v0)
                loss_log.append(loss[None])
                it += 1
                continue
            if it == tail_it:
                params, opt_state, loss, acc, edges, key = masked_tail_step(
                    params, opt_state, key)
                loss_log.append(loss[None])
                edge_counts.append(edges)
                it += 1
            elif K > 1:
                k_here = min(K, steps_per_epoch - it)
                if tail_it >= 0 and it < tail_it < it + k_here:
                    k_here = tail_it - it  # stop the window before the tail
                grid = np.stack([seed_grid() for _ in range(k_here)], axis=1)
                key, kw = jax.random.split(key)
                params, opt_state, losses, edges = rt.train_window(
                    params, opt_state, grid, kw)
                loss = losses[-1]
                loss_log.append(losses)
                edge_counts.append(edges)
                it += k_here
            else:
                key, k1, k2 = jax.random.split(key, 3)
                if pending is None:
                    nxt = rt.begin(seed_grid(), k1)
                else:
                    nxt = pending
                pending = None
                if it + 1 < steps_per_epoch and it + 1 != tail_it:
                    key, kp = jax.random.split(key)
                    pending = rt.begin(seed_grid(), kp)
                resolved = rt.resolve(nxt)
                params, opt_state, loss, acc = rt.train_step(
                    params, opt_state, k2, resolved)
                loss_log.append(loss[None])
                edge_counts.append(nxt[6])
                it += 1
        jax.block_until_ready(loss)
        dt = time.perf_counter() - t0
        sampled = int(sum(float(np.asarray(c).sum()) for c in edge_counts))
        acc_s = f"{float(acc):.4f}" if acc is not None else "n/a"
        print(f"Epoch {epoch} | loss {float(loss):.4f} | batch acc "
              f"{acc_s} | Epoch Time: {dt:.3f}s | feature agg time "
              f"{agg_total() - agg0:.3f}s | sampled nodes {sampled}")
        s = rt.stats()   # device counters + fused-window accumulators
        print(f"Cache hit ratio: {s['hit_ratio']:.3f} "
              f"({s['hits']} hits / {s['misses']} misses)")
        run["epochs"].append({
            "losses": np.concatenate([np.asarray(v) for v in loss_log]),
            "started": t0, "seconds": dt, "steps": it, "edges": sampled, **s,
            "timers": {k: v - timers0.get(k, 0.0)
                       for k, v in rt.timers.totals.items()}})
        scheduler.reset(args.seed + epoch + 1)
        if args.save_dir:
            from coala_gnn.utils import checkpoint as ckpt
            ckpt.save(args.save_dir, params, opt_state,
                      step=(epoch + 1) * steps_per_epoch)
            print(f"checkpoint saved to {args.save_dir}")

    if args.eval:
        from coala_gnn.distribution import (
            DistributionScheduler, SeedDistributor)
        # Exact-tail eval: drop_tail=False wraps the final batch to keep
        # static shapes and the wrapped (duplicate) slots are masked out of
        # the count — every test node is evaluated exactly once, even when
        # the split is smaller than one global batch (which previously
        # evaluated ZERO nodes).
        ed = SeedDistributor(ds.test_idx, batch_size=B, local_size=n_dev,
                             num_parts=1, mode="baseline",
                             shuffle_seed=args.seed, drop_tail=False)
        es = DistributionScheduler(ed, part_id=0, local_rank=0)
        correct = total = 0
        n_test, gb = len(ds.test_idx), ed.global_batch
        for it in range(ed.num_iters):
            grid = es.run_domain().reshape(n_dev, B).astype(np.int32)
            valid = es.domain_valid.reshape(n_dev, B)
            key, k1 = jax.random.split(key)
            resolved = rt.resolve(rt.begin(grid, k1))
            n_real = min(gb, n_test - it * gb)
            correct += rt.eval_step(params, resolved, valid=valid)
            total += n_real
        print(f"Test accuracy: {correct / max(total, 1):.4f} ({total} nodes)")
    run["params"], run["opt_state"] = params, opt_state
    return run


def main(argv=None):
    """Train; returns the resident pipeline's run record (see
    ``_run_resident``), or None for the host pipeline."""
    args = parse_args(argv)
    from coala_gnn.utils.jaxconfig import setup as jax_setup
    jax_setup(args.platform)
    import jax
    import jax.numpy as jnp
    import optax

    from coala_gnn.graph.datasets import load_dataset, load_ogbn_arxiv, synthetic_graph
    from coala_gnn.sampling.neighbor import NeighborSampler
    from coala_gnn.models import blocks_to_device, make_model
    from coala_gnn.parallel.train import init_state, make_eval_step, make_train_step
    from coala_gnn.distribution import DistributionScheduler, SeedDistributor
    from coala_gnn.coloring import load_color_metadata

    print(f"jax backend: {jax.default_backend()}, devices: {jax.devices()}")

    fanouts = [int(f) for f in args.fan_out.split(",")]
    num_layers = args.num_layers or len(fanouts)
    assert num_layers == len(fanouts), "--num_layers must match fan_out"

    if args.data == "synthetic":
        ds = synthetic_graph(num_nodes=args.num_nodes, avg_degree=args.avg_degree,
                             feature_dim=args.feature_dim,
                             num_classes=args.num_classes, seed=args.seed)
    elif args.data == "ogbn-arxiv":
        ds = load_ogbn_arxiv(args.path or "data/ogb")
    else:
        ds = load_dataset(args.data, path=args.path,
                          dataset_size=args.dataset_size,
                          num_classes=args.num_classes)
    hetero = args.model_type in ("rsage", "rgcn", "rgat")
    if hetero and ds.graph.edge_types is None:
        if args.num_edge_types < 2:
            args.num_edge_types = 3
        et_rng = np.random.default_rng(args.seed)
        ds.graph.edge_types = et_rng.integers(
            0, args.num_edge_types, ds.graph.num_edges).astype(np.int32)
        ds.graph.num_edge_types = args.num_edge_types
    print(f"dataset {ds.name}: {ds.graph.num_nodes} nodes, "
          f"{ds.graph.num_edges} edges, dim {ds.feature_dim}, "
          f"{ds.num_classes} classes, {len(ds.train_idx)} train"
          + (f", {ds.graph.num_edge_types} edge types" if hetero else ""))

    B = args.batch_size
    sampler = NeighborSampler(ds.graph, fanouts, B, seed=args.seed)
    print(f"sampler native: {sampler._native is not None}")

    # Process topology: one process per host, all local devices on the mesh
    # data axis (replaces the reference's one-process-per-GPU + MPI split,
    # Shared_Tensor.py:24-56). "part" in the distributor == host.
    from coala_gnn.parallel.mesh import DATA_AXIS, make_mesh
    from coala_gnn.parallel.multihost import (
        initialize_distributed, make_meta_exchange_fn, topology)

    initialize_distributed()
    n_hosts, host_id, _ = topology()
    devices = jax.local_devices()
    if args.devices:
        devices = devices[: args.devices]
    n_dev = len(devices)
    mesh = make_mesh(jax.devices() if n_hosts > 1 else devices)
    print(f"hosts: {n_hosts} (this={host_id}), local devices: {n_dev}")

    meta = None
    if args.distribution == "node_color":
        meta = load_color_metadata(args.color_dir)
    distributor = SeedDistributor(
        ds.train_idx, batch_size=B, local_size=n_dev, num_parts=n_hosts,
        mode=args.distribution,
        color=None if meta is None else meta.color,
        topk_colors=None if meta is None else meta.topk,
        affinity=None if meta is None else meta.score,
        shuffle_seed=args.seed,
        drop_tail=not (args.keep_tail or args.mask_tail))
    scheduler = DistributionScheduler(
        distributor, part_id=host_id, local_rank=0,
        meta_exchange_fn=(make_meta_exchange_fn(meta.num_colors)
                          if meta is not None else None),
        refresh_counter=args.refresh_counter)

    dtype = jnp.bfloat16 if args.dtype == "bfloat16" else jnp.float32
    if hetero:
        from coala_gnn.models.hetero import (
            hetero_blocks_to_device, make_hetero_model)
        model = make_hetero_model(args.model_type, hidden=args.hidden_channels,
                                  num_classes=ds.num_classes,
                                  num_rels=ds.graph.num_edge_types,
                                  num_layers=num_layers,
                                  num_heads=args.num_heads, dtype=dtype)
        to_device = hetero_blocks_to_device
    else:
        model = make_model(args.model_type, hidden=args.hidden_channels,
                           num_classes=ds.num_classes, num_layers=num_layers,
                           num_heads=args.num_heads, dtype=dtype)
        to_device = blocks_to_device
    tx = optax.adamw(args.learning_rate, weight_decay=args.decay) \
        if args.decay else optax.adam(args.learning_rate)

    from jax.sharding import NamedSharding, PartitionSpec as P

    from coala_gnn.cache.host_tier import HostFeatureStore
    from coala_gnn.data.loader import CoalaDataLoader
    from coala_gnn.models.hetero import DeviceHeteroBlock
    from coala_gnn.models.layers import DeviceBlock
    from coala_gnn.parallel.sharded_cache import ShardedFeatureCache
    from coala_gnn.parallel.train import (
        make_sharded_eval_step, make_sharded_train_step)
    from coala_gnn.utils.rng import make_root_key

    store = HostFeatureStore(ds.features)
    cache = None
    if args.cache_size > 0:
        from coala_gnn.cache import feature_cache as fc

        # backend names accept the reference's (Cache_compare_script.sh:28-34):
        # nvshmem/nccl -> the one all_to_all sharded exchange; isolated ->
        # private; node_local -> per-host exchange groups
        mode = {"nvshmem": "sharded", "nccl": "sharded",
                "sharded": "sharded", "isolated": "isolated",
                "node_local": "node_local"}[args.cache_backend]
        shards = {"sharded": mesh.devices.size, "isolated": 1,
                  "node_local": max(mesh.devices.size // n_hosts, 1)}[mode]
        cfg = fc.make_config(cache_mb=args.cache_size, dim=ds.feature_dim,
                             num_colors=0 if meta is None else meta.num_colors,
                             num_shards=shards,
                             dtype=dtype, quantize=args.quantize)
        cache = ShardedFeatureCache(cfg=cfg, mesh=mesh, mode=mode)
        scheduler.meta_fn = cache.local_color_meta
        print(f"cache[{mode}]: {cfg.num_sets} sets x {cfg.ways} ways "
              f"({cfg.size_mb:.0f} MB per device"
              + (", int8 lines)" if args.quantize else ")"))

    if args.pipeline == "resident":
        from coala_gnn.sampling.device_sampler import fits_device_graph
        if cache is None:
            raise SystemExit("--pipeline resident requires --cache_size > 0")
        if (not args.shard_topology
                and not fits_device_graph(ds.graph.num_nodes,
                                          ds.graph.num_edges)):
            if n_dev > 1:
                # shard the topology over the mesh (E/n_dev per device)
                print(f"graph ({ds.graph.num_nodes} nodes, "
                      f"{ds.graph.num_edges} edges) exceeds the replicated "
                      "device-topology limits; auto-enabling "
                      "--shard_topology")
                args.shard_topology = True
                return _run_resident(args, ds, meta, cache, store, model,
                                     tx, scheduler, fanouts, B, n_dev, jax)
            print(f"WARNING: graph ({ds.graph.num_nodes} nodes, "
                  f"{ds.graph.num_edges} edges) exceeds the device-resident "
                  "topology limits; falling back to the host pipeline")
        else:
            return _run_resident(args, ds, meta, cache, store, model, tx,
                                 scheduler, fanouts, B, n_dev, jax)

    if args.window > 1:
        # benchmark-config foot-gun guard: --window is
        # a resident-pipeline knob; silently accepting it in host mode made
        # A/B configs lie about what they measured.
        print(f"WARNING: --window {args.window} only applies to "
              "--pipeline resident; the host pipeline runs unfused steps")
    loader = CoalaDataLoader(scheduler=scheduler, sampler=sampler,
                             labels=ds.labels, local_size=n_dev, prefetch=2)
    sh = NamedSharding(mesh, P(DATA_AXIS))

    # Per-host-local batch slices onto the (possibly multi-host) global
    # mesh: put_local assembles them with make_array_from_process_local_data
    # when process_count > 1 (plain device_put is wrong there — each host
    # holds DIFFERENT rows of the global batch).
    from coala_gnn.parallel.multihost import put_local

    def put(a):
        return put_local(mesh, P(DATA_AXIS), np.asarray(a))

    def to_device_stacked(hb):
        if hetero:
            return [DeviceHeteroBlock(adj=put(a), mask=put(m), rel=put(r))
                    for a, m, r in zip(hb.adjs, hb.masks, hb.rels)]
        return [DeviceBlock(adj=put(a), mask=put(m))
                for a, m in zip(hb.adjs, hb.masks)]

    def fetch_batch(hb):
        if cache is None:
            x = np.stack([store.fetch(ids) for ids in hb.input_ids])
            return put(x)
        return cache.fetch(hb.input_ids, hb.num_input, store.fetch,
                           colors=None if meta is None else meta.color)

    train_step = make_sharded_train_step(model, tx, mesh, B,
                                         masked=args.mask_tail)
    key = make_root_key(args.seed, getattr(args, 'rng_impl', ''))

    steps_per_epoch = len(loader)
    if args.max_steps:
        steps_per_epoch = min(steps_per_epoch, args.max_steps)

    params = opt_state = None
    sampled_total = 0
    start_epoch = 0
    if args.resume and args.save_dir:
        # Build params from one probe batch, restore, and skip the epochs
        # the checkpoint already covers (resuming must not re-train them or
        # rewrite history at stale step numbers).
        from coala_gnn.utils import checkpoint as ckpt
        hb0 = next(iter(loader))
        single = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)[0]),
                              to_device_stacked(hb0))
        params = model.init(jax.random.key(args.seed), single,
                            jnp.asarray(np.asarray(fetch_batch(hb0))[0]))
        opt_state = tx.init(params)
        like = {"params": params, "opt_state": opt_state, "step": 0}
        restored = ckpt.restore(args.save_dir, like)
        if restored is not None:
            params, opt_state, step0 = restored
            # restored arrays land committed to one device; the DP step
            # expects them replicated over the mesh
            from jax.sharding import NamedSharding, PartitionSpec
            rep = NamedSharding(mesh, PartitionSpec())
            params, opt_state = jax.tree.map(
                lambda a: jax.device_put(np.asarray(a), rep),
                (params, opt_state))
            start_epoch = min(step0 // max(steps_per_epoch, 1), args.epochs)
            print(f"resumed from step {step0} -> starting at epoch "
                  f"{start_epoch}")
        if start_epoch:
            loader.reset(args.seed + start_epoch)
        else:
            loader.reset(args.seed)
    for epoch in range(start_epoch, args.epochs):
        if args.profile_dir and epoch == 0:
            jax.profiler.start_trace(args.profile_dir)
        t0 = time.perf_counter()
        agg_time = 0.0
        loss = acc = None
        for it, hb in enumerate(loader):
            if it >= steps_per_epoch:
                break
            dblocks = to_device_stacked(hb)
            ta = time.perf_counter()
            x = fetch_batch(hb)
            agg_time += time.perf_counter() - ta
            labels = put(hb.labels)
            if params is None:
                single = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)[0]),
                                      dblocks)
                params = model.init(jax.random.key(args.seed), single,
                                    jnp.asarray(np.asarray(x)[0]))
                opt_state = tx.init(params)
            key, sub = jax.random.split(key)
            extra = ()
            if args.mask_tail:
                v = hb.valid if hb.valid is not None else \
                    np.ones((n_dev, B), bool)
                extra = (put(v),)
            params, opt_state, loss, acc = train_step(params, opt_state, sub,
                                                      dblocks, x, labels,
                                                      *extra)
            sampled_total += hb.sampled_nodes
        jax.block_until_ready(loss)
        if args.profile_dir and epoch == 0:
            jax.profiler.stop_trace()
            print(f"profiler trace written to {args.profile_dir}")
        dt = time.perf_counter() - t0
        # Per-epoch print parity (sbatch_ssd_gnn_train.py:147-150).
        print(f"Epoch {epoch} | loss {float(loss):.4f} | batch acc "
              f"{float(acc):.4f} | Epoch Time: {dt:.3f}s | feature agg time "
              f"{agg_time:.3f}s | sampled nodes {sampled_total}")
        if cache is not None:
            # per-epoch stats print parity (COALA_GNN_DataLoader.py:170-174)
            s = cache.stats()
            print(f"Cache hit ratio: {s['hit_ratio']:.3f} "
                  f"({s['hits']} hits / {s['misses']} misses)")
        loader.reset(args.seed + epoch + 1)
        if args.save_dir:
            from coala_gnn.utils import checkpoint as ckpt
            ckpt.save(args.save_dir, params, opt_state,
                      step=(epoch + 1) * steps_per_epoch)
            print(f"checkpoint saved to {args.save_dir}")

    if args.eval:
        # Fresh distributor + loader over the test split, matching the
        # reference eval path (sbatch_ssd_gnn_train.py:156-195).
        # Exact-tail accounting: the final batch wraps (static shapes) and
        # wrapped duplicate slots are masked from the per-slot correctness
        # grid — every test node counts exactly once, even for splits
        # smaller than one global batch (previously: zero nodes).
        from coala_gnn.parallel.multihost import read_local_shards
        eval_distributor = SeedDistributor(
            ds.test_idx, batch_size=B, local_size=n_dev, num_parts=n_hosts,
            mode="baseline", shuffle_seed=args.seed, drop_tail=False)
        eval_sched = DistributionScheduler(eval_distributor, part_id=host_id,
                                           local_rank=0)
        eval_loader = CoalaDataLoader(scheduler=eval_sched, sampler=sampler,
                                      labels=ds.labels, local_size=n_dev,
                                      prefetch=2)
        eval_slot = make_sharded_eval_step(model, mesh, B, per_slot=True)
        correct = total = 0
        n_test, gb = len(ds.test_idx), eval_distributor.global_batch
        for it, hb in enumerate(eval_loader):
            dblocks = to_device_stacked(hb)
            x = fetch_batch(hb)
            labels = put(hb.labels)
            ok = eval_slot(params, dblocks, x, labels)  # [n_dev*n_hosts, B]
            n_real = min(gb, n_test - it * gb)
            # this host's slots' validity, threaded through the loader
            # (rides the distribution like the train mask; global row g is
            # this host's local device g - host_id*n_dev)
            valid = hb.valid
            idxs, rows = read_local_shards(ok)
            local_c = sum(int((np.asarray(rows[i])
                               & valid[g - host_id * n_dev]).sum())
                          for i, g in enumerate(idxs))
            if n_hosts > 1:
                from jax.experimental import multihost_utils
                local_c = int(multihost_utils.process_allgather(
                    np.asarray([local_c], np.int64)).sum())
            correct += local_c
            total += n_real
        print(f"Test accuracy: {correct / max(total, 1):.4f} ({total} nodes)")


if __name__ == "__main__":
    main()
