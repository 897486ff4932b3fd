#!/usr/bin/env python
"""Affinity-distribution effectiveness experiment.

The COALA hypothesis (reference README.md:1-3): assigning each minibatch
seed to the compute node whose cache already holds its neighborhood's
colors raises cache hit rates versus contiguous striping. This experiment
reproduces that A/B end-to-end with our machinery:

  - P "hosts", each with its own (capacity-constrained) feature cache
  - a community-structured graph, colored by the BFS pipeline
  - the same shuffled seed stream distributed per iteration by
    (a) baseline striping  (b) greedy color-affinity scoring fed by the
    live per-host cache color-occupancy counters on the refresh cadence

Reports per-host and aggregate hit ratios for both modes (the measurement
the reference's Distribution_compare_script.sh makes across SLURM jobs).

  python examples/affinity_ab.py --platform cpu
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def run_mode(mode, ds, meta, parts, B, fanouts, cache_mb, iters, refresh,
             seed=0, epochs=1):
    import jax

    from coala_gnn.cache import feature_cache as fc
    from coala_gnn.cache.host_tier import HostFeatureStore
    from coala_gnn.distribution import SeedDistributor
    from coala_gnn.parallel.mesh import make_mesh
    from coala_gnn.parallel.sharded_cache import ShardedFeatureCache
    from coala_gnn.sampling.neighbor import NeighborSampler

    store = HostFeatureStore(ds.features)
    mesh = make_mesh(jax.devices()[:1])
    cfg = fc.make_config(cache_mb=cache_mb, dim=ds.feature_dim,
                         num_colors=meta.num_colors)
    caches = [ShardedFeatureCache(cfg=cfg, mesh=mesh, mode="isolated")
              for _ in range(parts)]
    sampler = NeighborSampler(ds.graph, fanouts, B, seed=seed)
    distributor = SeedDistributor(
        ds.train_idx, batch_size=B, local_size=1, num_parts=parts,
        mode=mode, color=meta.color, topk_colors=meta.topk,
        affinity=meta.score, shuffle_seed=seed)

    cache_meta = np.zeros((parts, meta.num_colors + 1), np.int32)
    n_iters = min(iters, distributor.num_iters)
    for ep in range(epochs):
        if ep:
            # fresh shuffle per epoch (reference parity: train nids are
            # reshuffled every epoch, sbatch_ssd_gnn_train.py:65); caches
            # persist across epochs — that is the warm-up being measured
            distributor = SeedDistributor(
                ds.train_idx, batch_size=B, local_size=1, num_parts=parts,
                mode=mode, color=meta.color, topk_colors=meta.topk,
                affinity=meta.score, shuffle_seed=seed + ep)
        if epochs > 1 and ep == epochs - 1:
            for c in caches:
                c.stats()   # reset-on-read: measure the final epoch only
        for it in range(n_iters):
            if it % refresh == 0:
                cache_meta = np.stack([c.color_meta() for c in caches])
            domains = distributor.distribute(it, cache_meta)
            for p in range(parts):
                batch = sampler.sample(domains[p][:B])
                caches[p].fetch(batch.input_ids[None, :],
                                np.asarray([batch.num_input], np.int32),
                                store.fetch, colors=meta.color)
    stats = [c.stats() for c in caches]
    agg_h = sum(s["hits"] for s in stats)
    agg_m = sum(s["misses"] for s in stats)
    return {"per_host": [round(s["hit_ratio"], 4) for s in stats],
            "aggregate": round(agg_h / max(agg_h + agg_m, 1), 4),
            "capacity_per_host": cfg.capacity,
            "iters": n_iters, "epochs": epochs,
            "measured": "final epoch" if epochs > 1 else "all iterations"}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--platform", default="gpu")
    p.add_argument("--num_nodes", type=int, default=30000)
    p.add_argument("--feature_dim", type=int, default=64)
    p.add_argument("--parts", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--fan_out", default="5,5")
    p.add_argument("--cache_mb", type=int, default=8)
    p.add_argument("--iters", type=int, default=40)
    p.add_argument("--refresh_counter", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--epochs", type=int, default=1,
                   help=">1: warm the caches for epochs-1 reshuffled "
                        "epochs, measure the final epoch only (steady "
                        "state)")
    p.add_argument("--clustered", action="store_true", default=True,
                   help="community-structured graph (COALA's regime)")
    p.add_argument("--no-clustered", dest="clustered", action="store_false")
    p.add_argument("--communities", type=int, default=64)
    p.add_argument("--path", default="",
                   help="preprocessed on-disk graph dir (e.g. the "
                        "reference-scale 10M-node artifact); colors load "
                        "from <path>/colors or --color_dir")
    p.add_argument("--color_dir", default="")
    p.add_argument("--num_classes", type=int, default=19)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    from coala_gnn.utils.jaxconfig import setup
    setup(args.platform)

    from coala_gnn.coloring import (generate_color_metadata,
                                        load_color_metadata)
    from coala_gnn.graph.datasets import clustered_graph, synthetic_graph

    if args.path:
        from coala_gnn.graph.datasets import load_preprocessed
        ds = load_preprocessed(args.path, num_classes=args.num_classes)
        meta = load_color_metadata(
            args.color_dir or os.path.join(args.path, "colors"))
    elif args.clustered:
        ds = clustered_graph(num_nodes=args.num_nodes,
                             num_communities=args.communities,
                             avg_degree=10, p_intra=0.95,
                             feature_dim=args.feature_dim, seed=args.seed)
    else:
        ds = synthetic_graph(num_nodes=args.num_nodes, avg_degree=10,
                             feature_dim=args.feature_dim, num_classes=16,
                             seed=args.seed)
    if not args.path:
        meta = generate_color_metadata(ds.graph, ds.train_idx,
                                       seed=args.seed)
    print(f"graph: {ds.graph.num_nodes} nodes, {meta.num_colors} colors",
          file=sys.stderr)

    fanouts = [int(f) for f in args.fan_out.split(",")]
    out = {}
    for mode in ("baseline", "node_color"):
        r = run_mode(mode, ds, meta, args.parts, args.batch_size, fanouts,
                     args.cache_mb, args.iters, args.refresh_counter,
                     args.seed, epochs=args.epochs)
        out[mode] = r
        print(f"{mode:12s} aggregate hit {r['aggregate']:.3f}  "
              f"per-host {r['per_host']}", file=sys.stderr, flush=True)
    gain = out["node_color"]["aggregate"] - out["baseline"]["aggregate"]
    out["hit_ratio_gain"] = round(gain, 4)
    out["config"] = {"parts": args.parts, "batch_size": args.batch_size,
                     "fan_out": args.fan_out, "cache_mb": args.cache_mb,
                     "iters": args.iters,
                     "refresh_counter": args.refresh_counter,
                     "graph": args.path or
                     f"clustered:{args.num_nodes}" if args.clustered
                     else f"synthetic:{args.num_nodes}"}
    txt = json.dumps(out)
    print(txt)
    if args.out:
        with open(args.out, "w") as f:
            f.write(txt)
    return out


if __name__ == "__main__":
    main()
