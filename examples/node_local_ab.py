#!/usr/bin/env python
"""node_local vs sharded on identical hardware: the zero-overhead claim.

the hierarchical node_local mode (exchange all_to_alls
scoped to each host's device group — NVSHMEM per-node world parity,
nvshmem_manager.cuh:15-28) must cost NOTHING over the flat sharded mode
when the group is degenerate. This measures both modes' full-coverage
training throughput with the SAME single-chip mesh (group_size=1: the
exchange collapses to local lookups in both). The structural half of the
claim — cross-group feature bytes are zero by construction at any group
size — is asserted by examples/comm_reconcile.py on the virtual mesh.

  python examples/node_local_ab.py --out chiprun_out/node_local_ab.json
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np


def run_mode(mode, ds, B, fanouts, dim, hidden, cache_mb, warmup, steps,
             window):
    import jax
    import jax.numpy as jnp
    import optax

    from coala_gnn.cache import feature_cache as fc
    from coala_gnn.cache.host_tier import HostFeatureStore
    from coala_gnn.models import DeviceBlock, make_model
    from coala_gnn.parallel.mesh import make_mesh
    from coala_gnn.parallel.sharded_cache import ShardedFeatureCache
    from coala_gnn.parallel.sharded_resident import (
        ShardedResidentTrainer)
    from coala_gnn.sampling.neighbor import block_capacities

    store = HostFeatureStore(ds.features)
    mesh = make_mesh(jax.devices()[:1])
    cfg = fc.make_config(cache_mb=cache_mb, dim=dim, num_colors=0,
                         num_shards=1)
    cache = ShardedFeatureCache(cfg=cfg, mesh=mesh, mode=mode,
                                group_size=1 if mode == "node_local" else 0)
    model = make_model("sage", hidden=hidden, num_classes=ds.num_classes,
                       num_layers=len(fanouts))
    rt = ShardedResidentTrainer(graph=ds.graph, host_fetch=store.fetch,
                                labels=ds.labels, cache=cache, model=model,
                                tx=optax.adam(1e-3), fanouts=fanouts,
                                batch_size=B)
    cache.prewarm(np.arange(ds.graph.num_nodes, dtype=np.int32),
                  store.fetch)
    rt.full_coverage = True

    caps = block_capacities(B, fanouts)
    blocks0 = [DeviceBlock(adj=None, mask=jnp.ones((caps[l][0], fanouts[l]),
                                                   jnp.float32))
               for l in range(len(fanouts))]
    params = model.init(jax.random.key(1), blocks0,
                        jnp.zeros((caps[0][1], dim), jnp.float32))
    opt_state = rt.tx.init(params)

    rng = np.random.default_rng(0)
    K = window

    def grids(n_win):
        return rng.choice(ds.train_idx,
                          (n_win, 1, K, B)).astype(np.int32)

    warm_w = max(max(warmup, steps) // K, 1)
    meas_w = max(steps // K, 1)
    warm_w = max(warm_w, meas_w)
    params, opt_state, losses, _ = rt.train_windows(
        params, opt_state, grids(warm_w), jax.random.key(2))
    float(np.asarray(losses)[-1])
    rt.stats()
    t0 = time.perf_counter()
    params, opt_state, losses, edges = rt.train_windows(
        params, opt_state, grids(meas_w), jax.random.key(3))
    float(np.asarray(losses)[-1])
    dt = time.perf_counter() - t0
    edges = float(np.asarray(edges).sum())
    s = rt.stats()
    return {"mode": mode, "edges_per_s": round(edges / dt, 1),
            "ms_per_step": round(1000 * dt / (meas_w * K), 3),
            "hit_ratio": round(s["hit_ratio"], 4)}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--nodes", type=int, default=200_000)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--fanout", default="10,5")
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--cache_mb", type=int, default=1024)
    p.add_argument("--warmup", type=int, default=16)
    p.add_argument("--steps", type=int, default=128)
    p.add_argument("--window", type=int, default=8)
    p.add_argument("--platform", default="gpu")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    from coala_gnn.utils.jaxconfig import setup as jax_setup
    jax_setup(args.platform)
    from coala_gnn.graph.datasets import synthetic_graph

    fanouts = [int(f) for f in args.fanout.split(",")]
    ds = synthetic_graph(num_nodes=args.nodes, avg_degree=15,
                         feature_dim=args.dim, num_classes=16, seed=0)
    rows = [run_mode(m, ds, args.batch, fanouts, args.dim, args.hidden,
                     args.cache_mb, args.warmup, args.steps, args.window)
            for m in ("sharded", "node_local")]
    ratio = rows[1]["edges_per_s"] / rows[0]["edges_per_s"]
    art = {"config": {"nodes": args.nodes, "dim": args.dim,
                      "batch": args.batch, "fanout": fanouts,
                      "cache_mb": args.cache_mb, "window": args.window,
                      "devices": 1, "group_size": 1},
           "rows": rows,
           "node_local_over_sharded": round(ratio, 3),
           "claim": "degenerate-group node_local has zero overhead vs "
                    "sharded (|1 - ratio| judged against run-to-run "
                    "noise); cross-group bytes = 0 is asserted "
                    "structurally by comm_reconcile.py"}
    txt = json.dumps(art, indent=1)
    print(txt)
    if args.out:
        with open(args.out, "w") as f:
            f.write(txt)


if __name__ == "__main__":
    main()
