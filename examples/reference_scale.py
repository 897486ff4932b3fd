#!/usr/bin/env python
"""Reference-scale end-to-end run: a >=10M-node, dim-1024 graph from disk.

the reference's bench grid is IGB-medium (10M nodes,
dim 1024, examples/4GB_script.sh:28-37) and ogbn-papers100M
(ssd_gnn_dataloader.py:819); the repo had never trained past 200k nodes.
This script generates an IGB-medium-CLASS graph once to disk (memmapped
topology + features, the on-disk layout load_preprocessed consumes), then
runs the resident pipeline against it for real:

  --generate   write the graph (clustered/homophilous: contiguous
               communities, p_intra of edges stay inside — the locality
               regime graph caches exist for; features = class embedding
               + noise so training is learnable, labels = community%C)
  --run        single-chip capacity-pressure training (cache_mb << 41 GB
               of features — the 4GB/16GB reference analog). Records
               prewarm time, per-window phase timers (incl. the 10 MB
               probe-bitmap readback at 10M nodes), epoch-time projection,
               peak host RSS.
  --mesh       virtual 8-device CPU mesh leg with --shard_topology (the
               papers100M-class layout: E/n_dev edges per device), a few
               real windows.

  python examples/reference_scale.py --generate
  python examples/reference_scale.py --run --out chiprun_out/refscale.json
  COALA_CPU_DEVICES=8 python examples/reference_scale.py --mesh \
      --platform cpu --out chiprun_out/refscale.json
"""

import argparse
import json
import os
import resource
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np

DEFAULT_DIR = "data/refscale10m"


def generate(path: str, num_nodes: int, avg_degree: int, dim: int,
             num_classes: int, community_size: int, p_intra: float,
             seed: int) -> dict:
    """Write the on-disk graph (load_preprocessed layout)."""
    from coala_gnn.graph.csc import coo_to_csc, save_csc
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()

    num_edges = num_nodes * avg_degree
    src = rng.integers(0, num_nodes, size=num_edges, dtype=np.int64)
    # contiguous communities: intra edges pick a uniform node of src's
    # community — fully vectorized, homophilous like IGB citation locality
    dst = rng.integers(0, num_nodes, size=num_edges, dtype=np.int64)
    intra = rng.random(num_edges) < p_intra
    base = (src[intra] // community_size) * community_size
    dst[intra] = np.minimum(
        base + rng.integers(0, community_size, size=int(intra.sum())),
        num_nodes - 1)
    graph = coo_to_csc(src, dst, num_nodes)
    del src, dst, intra, base
    save_csc(graph, path)
    t_topo = time.perf_counter() - t0

    labels = ((np.arange(num_nodes, dtype=np.int64) // community_size)
              % num_classes).astype(np.int32)
    np.save(os.path.join(path, "labels.npy"), labels)
    # train split: 1% random (papers100M-like label sparsity)
    n_train = num_nodes // 100
    perm = rng.permutation(num_nodes)
    np.save(os.path.join(path, "train_idx.npy"),
            np.sort(perm[:n_train]).astype(np.int64))
    np.save(os.path.join(path, "val_idx.npy"),
            np.sort(perm[n_train:n_train + n_train // 4]).astype(np.int64))
    np.save(os.path.join(path, "test_idx.npy"),
            np.sort(perm[n_train + n_train // 4:
                         n_train + n_train // 2]).astype(np.int64))

    t0 = time.perf_counter()
    emb = rng.normal(0, 1, size=(num_classes, dim)).astype(np.float32)
    feat = np.lib.format.open_memmap(
        os.path.join(path, "features.npy"), mode="w+",
        dtype=np.float32, shape=(num_nodes, dim))
    chunk = 1 << 20
    for lo in range(0, num_nodes, chunk):
        hi = min(lo + chunk, num_nodes)
        feat[lo:hi] = emb[labels[lo:hi]] + rng.normal(
            0, 1.0, size=(hi - lo, dim)).astype(np.float32)
    feat.flush()
    del feat
    t_feat = time.perf_counter() - t0

    meta = {"num_nodes": num_nodes, "num_edges": int(num_edges), "dim": dim,
            "num_classes": num_classes, "community_size": community_size,
            "p_intra": p_intra, "train_frac": 0.01,
            "feature_bytes": num_nodes * dim * 4,
            "gen_topology_s": round(t_topo, 1),
            "gen_features_s": round(t_feat, 1)}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    print(f"generated {path}: {meta}", file=sys.stderr)
    return meta


def _rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def run_single(path: str, cache_mb: int, batch: int, fanout: str,
               hidden: int, window: int, windows: int, warm_windows: int,
               transport: str, quantize: bool = False) -> dict:
    """Single-chip capacity-pressure training off the memmapped graph."""
    import jax
    import optax

    from coala_gnn.cache import feature_cache as fc
    from coala_gnn.cache.host_tier import HostFeatureStore
    from coala_gnn.graph.datasets import load_preprocessed
    from coala_gnn.models import make_model
    from coala_gnn.parallel.resident import ResidentTrainer

    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    ds = load_preprocessed(path, num_classes=meta["num_classes"])
    fanouts = [int(f) for f in fanout.split(",")]
    dim = meta["dim"]
    store = HostFeatureStore(ds.features)
    cfg = fc.make_config(cache_mb=cache_mb, dim=dim, num_colors=0,
                         quantize=quantize)
    model = make_model("sage", hidden=hidden, num_classes=ds.num_classes,
                       num_layers=len(fanouts))
    rt = ResidentTrainer(graph=ds.graph, host_fetch=store.fetch,
                         labels=ds.labels, cache_cfg=cfg, model=model,
                         tx=optax.adam(1e-3), fanouts=fanouts,
                         batch_size=batch, priorities="degree",
                         stage_transport=transport)
    coverage = cfg.capacity / ds.graph.num_nodes
    print(f"cache {cache_mb} MB = {cfg.capacity} lines "
          f"({100 * coverage:.1f}% of {ds.graph.num_nodes} nodes); "
          f"features on disk: {meta['feature_bytes'] / 2**30:.1f} GiB",
          file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    deg = np.diff(np.asarray(ds.graph.indptr))
    top = np.argpartition(deg, -cfg.capacity)[-cfg.capacity:]
    rt.prewarm(top.astype(np.int32))
    t_prewarm = time.perf_counter() - t0
    print(f"prewarm {cfg.capacity} hub lines in {t_prewarm:.1f}s",
          file=sys.stderr, flush=True)

    rng = np.random.default_rng(0)
    K = window

    def grids(n_win):
        need = n_win * K * batch
        reps = -(-need // ds.train_idx.size)
        perm = np.concatenate(
            [rng.permutation(ds.train_idx) for _ in range(reps)])
        return np.ascontiguousarray(
            perm[:need].astype(np.int32).reshape(n_win, K, batch))

    key = jax.random.key(0)
    resolved = rt.resolve(rt.begin(
        rng.choice(ds.train_idx, batch, replace=False).astype(np.int32),
        jax.random.key(9)))
    params = model.init(jax.random.key(1), resolved[0], resolved[1])
    opt_state = rt.tx.init(params)

    import jax.random as jr
    key, sub = jr.split(key)
    t0 = time.perf_counter()
    params, opt_state, losses, _ = rt.train_windows(
        params, opt_state, grids(warm_windows), sub)
    float(np.asarray(losses)[-1])
    t_compile = time.perf_counter() - t0
    print(f"compile+warm ({warm_windows} windows): {t_compile:.1f}s",
          file=sys.stderr, flush=True)
    rt.stats()
    rt.timers.reset()

    key, sub = jr.split(key)
    g = grids(windows)
    t0 = time.perf_counter()
    params, opt_state, losses, edges = rt.train_windows(
        params, opt_state, g, sub)
    losses = np.asarray(losses)
    dt = time.perf_counter() - t0
    edges = float(np.asarray(edges).sum())
    s = rt.stats()
    steps = windows * K
    steps_per_epoch = ds.train_idx.size // batch
    epoch_s = dt / steps * steps_per_epoch
    timer_rows = {k: {"total_s": round(v, 2),
                      "calls": int(rt.timers.counts.get(k, 0))}
                  for k, v in rt.timers.totals.items()}
    out = {
        "graph": {k: meta[k] for k in ("num_nodes", "num_edges", "dim",
                                       "num_classes")},
        "cache_mb": cache_mb, "coverage": round(coverage, 4),
        "batch": batch, "fanout": fanouts, "window": K,
        "stage_transport": rt.stage_transport,
        "prewarm_s": round(t_prewarm, 1),
        "compile_warm_s": round(t_compile, 1),
        "measured_steps": steps,
        "measured_s": round(dt, 2),
        "edges_per_s": round(edges / dt, 1),
        "ms_per_step": round(1000 * dt / steps, 1),
        "hit_ratio": round(s["hit_ratio"], 4),
        "loss_first_last": [round(float(losses[0]), 3),
                            round(float(losses[-1]), 3)],
        "steps_per_epoch": steps_per_epoch,
        "epoch_time_projected_s": round(epoch_s, 1),
        "phase_timers": timer_rows,
        "probe_bitmap_mb": round((meta["num_nodes"] + 1) / 2**20, 1),
        "peak_rss_gb": round(_rss_gb(), 2),
    }
    print(json.dumps(out, indent=1), file=sys.stderr, flush=True)
    return out


def run_mesh(path: str, batch: int, fanout: str, hidden: int, cache_mb: int,
             window: int, windows: int) -> dict:
    """Virtual 8-device mesh leg: sharded topology (E/n_dev edges per
    device) + sharded cache, a few real training windows on CPU."""
    import jax
    import optax

    from coala_gnn.cache import feature_cache as fc
    from coala_gnn.cache.host_tier import HostFeatureStore
    from coala_gnn.graph.datasets import load_preprocessed
    from coala_gnn.models import make_model
    from coala_gnn.parallel.mesh import make_mesh
    from coala_gnn.parallel.sharded_cache import ShardedFeatureCache
    from coala_gnn.parallel.sharded_resident import (
        ShardedResidentTrainer)

    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    ds = load_preprocessed(path, num_classes=meta["num_classes"])
    fanouts = [int(f) for f in fanout.split(",")]
    n_dev = len(jax.devices())
    mesh = make_mesh(jax.devices())
    cfg = fc.make_config(cache_mb=cache_mb, dim=meta["dim"], num_colors=0)
    cache = ShardedFeatureCache(cfg=cfg, mesh=mesh, mode="sharded")
    store = HostFeatureStore(ds.features)
    model = make_model("sage", hidden=hidden, num_classes=ds.num_classes,
                       num_layers=len(fanouts))
    rt = ShardedResidentTrainer(
        graph=ds.graph, host_fetch=store.fetch, labels=ds.labels,
        cache=cache, model=model, tx=optax.adam(1e-3), fanouts=fanouts,
        batch_size=batch, shard_topology=True)

    from coala_gnn.models.layers import DeviceBlock
    from coala_gnn.sampling.neighbor import block_capacities
    import jax.numpy as jnp
    caps = block_capacities(batch, fanouts)
    blocks0 = [DeviceBlock(adj=None,
                           mask=jnp.ones((caps[l][0], fanouts[l]),
                                         jnp.float32))
               for l in range(len(fanouts))]
    params = model.init(jax.random.key(1), blocks0,
                        jnp.zeros((caps[0][1], meta["dim"]), jnp.float32))
    opt_state = rt.tx.init(params)

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    seeds = rng.choice(ds.train_idx,
                       (windows, n_dev, window, batch)).astype(np.int32)
    params, opt_state, losses, edges = rt.train_windows(
        params, opt_state, seeds, jax.random.key(2))
    losses = np.asarray(losses)
    dt = time.perf_counter() - t0
    out = {
        "devices": n_dev, "platform": jax.default_backend(),
        "shard_topology": True,
        "edges_per_device": int(meta["num_edges"] / n_dev),
        "steps": windows * window,
        "wall_s_incl_compile": round(dt, 1),
        "loss_first_last": [round(float(losses[0]), 3),
                            round(float(losses[-1]), 3)],
        "hit_stats": {k: round(v, 4) if isinstance(v, float) else v
                      for k, v in rt.stats().items()},
        "peak_rss_gb": round(_rss_gb(), 2),
    }
    print(json.dumps(out, indent=1), file=sys.stderr, flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--path", default=DEFAULT_DIR)
    p.add_argument("--generate", action="store_true")
    p.add_argument("--run", action="store_true")
    p.add_argument("--mesh", action="store_true")
    p.add_argument("--num_nodes", type=int, default=10_000_000)
    p.add_argument("--avg_degree", type=int, default=15)
    p.add_argument("--dim", type=int, default=1024)
    p.add_argument("--num_classes", type=int, default=19)
    p.add_argument("--community_size", type=int, default=2048)
    p.add_argument("--p_intra", type=float, default=0.9)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cache_mb", type=int, default=4096)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--fanout", default="10,5")
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--window", type=int, default=32)
    p.add_argument("--windows", type=int, default=4)
    p.add_argument("--warm_windows", type=int, default=2)
    p.add_argument("--stage_transport", default="int8")
    p.add_argument("--quantize", action="store_true",
                   help="int8 cache lines (+ per-line scale): ~4x the "
                        "lines per MB at dim 1024 -> ~42%% coverage from "
                        "the same 4 GiB budget")
    p.add_argument("--platform", default="gpu")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    from coala_gnn.utils.jaxconfig import setup as jax_setup
    jax_setup(args.platform)

    art = {}
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            art = json.load(f)
    if args.generate:
        art["generate"] = generate(args.path, args.num_nodes,
                                   args.avg_degree, args.dim,
                                   args.num_classes, args.community_size,
                                   args.p_intra, args.seed)
    if args.run:
        key = "single_chip_int8_lines" if args.quantize else "single_chip"
        art[key] = run_single(
            args.path, args.cache_mb, args.batch, args.fanout, args.hidden,
            args.window, args.windows, args.warm_windows,
            args.stage_transport, quantize=args.quantize)
    if args.mesh:
        art["mesh_8dev"] = run_mesh(args.path, args.batch // 4, args.fanout,
                                    args.hidden, args.cache_mb // 4,
                                    window=4, windows=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(json.dumps(art, indent=1))
    else:
        print(json.dumps(art, indent=1))


if __name__ == "__main__":
    main()
