#!/usr/bin/env python
"""Scaling-efficiency measurement: edges/s across mesh sizes.

BASELINE.md north star: ">80% edges/s scaling efficiency 1->2 hosts" at
measurement points 1 chip / 1 host / N hosts. On real multi-chip hardware
this script measures exactly that; on a single-chip or CPU environment it
runs the identical code path over virtual devices as a *structural* check
(collectives execute, shapes hold — wall-clock efficiency there reflects
host emulation, not device links).

  COALA_CPU_DEVICES=8 python examples/bench_scaling.py --platform cpu
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def run_mesh(n_dev, ds, B, fanouts, hidden, steps, seed=0):
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from coala_gnn.cache import feature_cache as fc
    from coala_gnn.cache.host_tier import HostFeatureStore
    from coala_gnn.data.loader import CoalaDataLoader
    from coala_gnn.distribution import DistributionScheduler, SeedDistributor
    from coala_gnn.models import DeviceBlock, make_model
    from coala_gnn.parallel.mesh import DATA_AXIS
    from coala_gnn.parallel.sharded_cache import ShardedFeatureCache
    from coala_gnn.parallel.train import make_sharded_train_step

    mesh = Mesh(np.asarray(jax.devices()[:n_dev]), (DATA_AXIS,))
    store = HostFeatureStore(ds.features)
    cfg = fc.make_config(cache_mb=64, dim=ds.feature_dim, num_colors=0,
                         num_shards=n_dev)
    cache = ShardedFeatureCache(cfg=cfg, mesh=mesh, mode="sharded")
    cache.prewarm(np.arange(min(ds.graph.num_nodes, cfg.capacity),
                            dtype=np.int32), store.fetch)

    distributor = SeedDistributor(ds.train_idx, batch_size=B,
                                  local_size=n_dev, num_parts=1,
                                  mode="baseline", shuffle_seed=seed)
    scheduler = DistributionScheduler(distributor, part_id=0, local_rank=0)
    sampler_mod = __import__("coala_gnn.sampling.neighbor",
                             fromlist=["NeighborSampler"])
    sampler = sampler_mod.NeighborSampler(ds.graph, fanouts, B, seed=seed)
    loader = CoalaDataLoader(scheduler=scheduler, sampler=sampler,
                             labels=ds.labels, local_size=n_dev, prefetch=2)

    model = make_model("sage", hidden=hidden, num_classes=ds.num_classes,
                       num_layers=len(fanouts))
    tx = optax.adam(1e-3)
    step = make_sharded_train_step(model, tx, mesh, B)
    sh = NamedSharding(mesh, P(DATA_AXIS))

    params = opt_state = None
    key = jax.random.key(seed)
    warmup = 3
    edges = 0
    t0 = None
    loss = None
    for i, hb in enumerate(loader):
        if i >= warmup + steps:
            break
        blocks = [DeviceBlock(adj=jax.device_put(a, sh),
                              mask=jax.device_put(m, sh))
                  for a, m in zip(hb.adjs, hb.masks)]
        x = cache.fetch(hb.input_ids, hb.num_input, store.fetch)
        labels = jax.device_put(hb.labels, sh)
        if params is None:
            single = [DeviceBlock(adj=jnp.asarray(hb.adjs[l][0]),
                                  mask=jnp.asarray(hb.masks[l][0]))
                      for l in range(len(fanouts))]
            params = model.init(jax.random.key(1), single,
                                jnp.asarray(np.asarray(x)[0]))
            opt_state = tx.init(params)
        key, sub = jax.random.split(key)
        params, opt_state, loss, acc = step(params, opt_state, sub,
                                            blocks, x, labels)
        if i == warmup - 1:
            float(loss)
            t0 = time.perf_counter()
            edges = 0
        if i >= warmup:
            edges += sum(int(m.sum()) for m in hb.masks)
    float(loss)
    dt = time.perf_counter() - t0
    return edges / dt, cache.stats()


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--platform", default="gpu")
    p.add_argument("--num_nodes", type=int, default=30000)
    p.add_argument("--feature_dim", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--fan_out", default="5,5")
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--mesh_sizes", default="")
    p.add_argument("--json", default="",
                   help="append this run (keyed by backend) into a JSON "
                        "file")
    args = p.parse_args()

    from coala_gnn.utils.jaxconfig import setup
    setup(args.platform)
    import jax

    from coala_gnn.graph.datasets import synthetic_graph

    n_avail = len(jax.devices())
    sizes = ([int(x) for x in args.mesh_sizes.split(",") if x]
             or [n for n in (1, 2, 4, 8) if n <= n_avail])
    fanouts = [int(f) for f in args.fan_out.split(",")]
    ds = synthetic_graph(num_nodes=args.num_nodes, avg_degree=10,
                         feature_dim=args.feature_dim, num_classes=16, seed=0)

    results = {}
    base = None
    for n in sizes:
        eps, stats = run_mesh(n, ds, args.batch_size, fanouts, args.hidden,
                              args.steps)
        if base is None:
            base = eps
        eff = eps / (base * n)
        results[n] = {"edges_per_s": round(eps, 1),
                      "scaling_efficiency": round(eff, 3),
                      "hit_ratio": round(stats["hit_ratio"], 3)}
        print(f"mesh={n}: {eps:,.0f} edges/s  efficiency={eff:.2%}  "
              f"hit={stats['hit_ratio']:.3f}", file=sys.stderr, flush=True)
    print(json.dumps(results))
    if args.json:
        doc = {}
        if os.path.exists(args.json):
            with open(args.json) as f:
                doc = json.load(f)
        backend = jax.default_backend()
        note = ("structural: virtual devices on one host — collectives "
                "execute, wall-clock reflects host emulation, not links"
                if backend == "cpu" else
                "real single chip (multi-chip hardware unavailable; the "
                "first pod run diffs against this anchor)")
        doc[backend] = {
            "config": {"num_nodes": args.num_nodes,
                       "feature_dim": args.feature_dim,
                       "batch_size": args.batch_size,
                       "fan_out": args.fan_out, "hidden": args.hidden,
                       "steps": args.steps},
            "note": note,
            "results": {str(k): v for k, v in results.items()},
        }
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=1)
        print(f"wrote {args.json}", file=sys.stderr)


if __name__ == "__main__":
    main()
