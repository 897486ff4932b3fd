"""Worker for the two-process multi-host tests (spawned by
test_multiprocess.py). Forces the CPU backend BEFORE any jax operation, so
the workers never reach for an accelerator. Each mode prints
machine-checkable lines to stdout.

Run: python mp_worker.py <mode> <coordinator> <num_procs> <proc_id>
"""

import sys

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def main():
    mode, coordinator, n_procs, pid = (sys.argv[1], sys.argv[2],
                                       int(sys.argv[3]), int(sys.argv[4]))
    sys.path.insert(0, __file__.rsplit("/", 2)[0])

    from coala_gnn.parallel.multihost import (
        initialize_distributed, make_meta_exchange_fn, put_local,
        read_replicated, topology)

    initialize_distributed(coordinator, n_procs, pid)
    n_hosts, host_id, local = topology()
    print(f"TOPOLOGY {n_hosts} {host_id} {local}", flush=True)

    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    from coala_gnn.parallel.mesh import DATA_AXIS, make_mesh

    mesh = make_mesh(jax.devices())
    n_dev = mesh.devices.size

    if mode == "collectives":
        # (1) cache-meta exchange (process_allgather path)
        fn = make_meta_exchange_fn(num_colors=3)
        meta = fn(np.arange(4, dtype=np.int32) + 10 * host_id)
        print(f"META {meta.tolist()}", flush=True)

        # (2) put_local: per-process [local_dev, 4] -> global [n_dev, 4],
        # then a shard_map psum over the full mesh
        local_rows = (np.arange(local * 4, dtype=np.float32)
                      .reshape(local, 4) + 100 * host_id)
        garr = put_local(mesh, P(DATA_AXIS, None), local_rows)

        def body(x):
            return jax.lax.psum(x.sum(), DATA_AXIS)[None]

        out = jax.jit(shard_map(body, mesh=mesh,
                                in_specs=(P(DATA_AXIS, None),),
                                out_specs=P(DATA_AXIS)))(garr)
        print(f"PSUM {float(read_replicated(out)[0])}", flush=True)

        # (3) all_to_all over the global mesh (the cache-exchange primitive)
        def a2a(x):
            return jax.lax.all_to_all(x[0], DATA_AXIS, split_axis=0,
                                      concat_axis=0, tiled=True)[None]

        vals = put_local(
            mesh, P(DATA_AXIS, None, None),
            np.stack([np.full((n_dev, 1),
                              100 * host_id + d, np.int32)
                      for d in range(local)]))
        out = jax.jit(shard_map(a2a, mesh=mesh,
                                in_specs=(P(DATA_AXIS, None, None),),
                                out_specs=P(DATA_AXIS, None, None)))(vals)
        from coala_gnn.parallel.multihost import read_local_shards
        idxs, rows = read_local_shards(out)
        print(f"A2A {idxs} {np.asarray(rows).reshape(-1).tolist()}",
              flush=True)

    elif mode == "train":
        # Data-parallel host-pipeline training over the global mesh: every
        # host feeds ITS devices' batch slices; losses must match the
        # single-process run bit-for-bit (printed for comparison).
        losses = run_train(mesh, n_dev, local, host_id)
        print("LOSSES " + " ".join(f"{v:.8f}" for v in losses), flush=True)

    elif mode == "cache":
        run_cache(mesh, n_dev, local, host_id)

    elif mode == "nodelocal":
        run_node_local(mesh, n_dev, local, host_id)

    elif mode in ("resident", "residenttopo"):
        # The flagship multi-chip pipeline across real processes
        #: staged fused windows + presample bitmap
        # probe + a cross-process node_color refresh cycle, with the
        # topology optionally mesh-sharded.
        run_resident(mesh, n_dev, local, host_id,
                     shard_topo=(mode == "residenttopo"))

    else:
        raise SystemExit(f"unknown mode {mode}")


def run_resident(mesh, n_dev, local, host_id, shard_topo):
    """ShardedResidentTrainer across processes under capacity pressure:
    every process computes the same global seed assignment (deterministic
    distributor contract), the staged windows run on the global mesh, and
    the node_color refresh exchanges real cache color counters between
    processes mid-run. Printed losses must match the single-process run
    on the same global mesh exactly."""
    import optax
    import jax
    import jax.numpy as jnp

    from coala_gnn.cache import feature_cache as fc
    from coala_gnn.cache.host_tier import HostFeatureStore
    from coala_gnn.coloring.coloring import generate_color_metadata
    from coala_gnn.distribution import SeedDistributor
    from coala_gnn.graph.datasets import synthetic_graph
    from coala_gnn.models import make_model
    from coala_gnn.models.layers import DeviceBlock
    from coala_gnn.parallel.multihost import read_local_shards
    from coala_gnn.parallel.sharded_cache import ShardedFeatureCache
    from coala_gnn.parallel.sharded_resident import ShardedResidentTrainer
    from coala_gnn.sampling.neighbor import block_capacities

    B, K, M, n_parts = 16, 2, 3, 2
    per_part = n_dev // n_parts
    fanouts = [4, 3]
    ds = synthetic_graph(num_nodes=3000, avg_degree=8, feature_dim=24,
                         num_classes=4, seed=91)
    cmeta = generate_color_metadata(ds.graph, ds.train_idx, seed=5)
    store = HostFeatureStore(ds.features)
    # capacity pressure: 8 sets x 32 ways x n_dev shards < 3000 nodes
    cfg = fc.CacheConfig(num_sets=8, ways=fc.WAYS, dim=24,
                         cache_dim=fc.round_cache_dim(24),
                         num_colors=cmeta.num_colors, num_shards=n_dev)
    cache = ShardedFeatureCache(cfg=cfg, mesh=mesh, mode="sharded")
    model = make_model("sage", hidden=16, num_classes=4, num_layers=2,
                       dropout=0.0)
    rt = ShardedResidentTrainer(
        graph=ds.graph, host_fetch=store.fetch, labels=ds.labels,
        cache=cache, model=model, tx=optax.adam(1e-2), fanouts=fanouts,
        batch_size=B, colors=cmeta.color.astype(np.int32),
        shard_topology=shard_topo)

    # node_color distributor over n_parts fixed "hosts" (topology-
    # independent so the 1-process comparison run assigns identically)
    dist = SeedDistributor(ds.train_idx, batch_size=B, local_size=per_part,
                           num_parts=n_parts, mode="node_color",
                           color=cmeta.color, topk_colors=cmeta.topk,
                           affinity=cmeta.score, shuffle_seed=3)

    def part_meta():
        """int32 [n_parts, C+1]: per-part color-counter sums, identical on
        every process and across process topologies (the cross-process
        half rides process_allgather — Shared_Tensor.py:96-100 parity)."""
        C = cmeta.num_colors
        idxs, rows = read_local_shards(cache.state.color_counts)
        blk = np.zeros((n_dev, C + 1), np.int64)
        for i, g in enumerate(idxs):
            blk[g] = rows[i]
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils
            blk = multihost_utils.process_allgather(
                blk.astype(np.int64)).reshape(-1, n_dev, C + 1).sum(axis=0)
        return blk.astype(np.int32).reshape(n_parts, per_part, C + 1) \
            .sum(axis=1)

    def grids(step0, meta_now):
        """[M_here, n_dev, K, B] global seed grid from the distributor."""
        out = np.empty((1, n_dev, K, B), np.int64)
        for k in range(K):
            dom = dist.distribute(step0 + k, meta_now)   # [n_parts, pp*B]
            out[0, :, k] = dom.reshape(n_parts * per_part, B)
        return out.astype(np.int32)

    # deterministic init: contiguous-layout placeholder blocks (identical
    # on every process; no device readback needed)
    caps = block_capacities(B, fanouts)
    blocks0 = [DeviceBlock(adj=None,
                           mask=jnp.ones((caps[l][0], fanouts[l]),
                                         jnp.float32))
               for l in range(len(fanouts))]
    x0 = jnp.zeros((caps[0][1], cfg.dim), jnp.float32)
    params = model.init(jax.random.key(0), blocks0, x0)
    opt = rt.tx.init(params)

    losses = []
    key = jax.random.key(42)
    keys = list(jax.random.split(key, M))
    # window 0: no cache meta yet (cold counters) -> striped assignment
    params, opt, l0, _ = rt.train_windows(params, opt, grids(0, None),
                                          keys[0])
    losses += [float(v) for v in np.asarray(l0)]
    # cross-process refresh cycle: exchange real color counters, then
    # node_color-assign the remaining windows with them
    meta_now = part_meta()
    print(f"RMETA {int(meta_now.sum())} {meta_now.shape[0]}", flush=True)
    for w in range(1, M):
        params, opt, lw, _ = rt.train_windows(params, opt,
                                              grids(w * K, meta_now),
                                              keys[w])
        losses += [float(v) for v in np.asarray(lw)]
    s = rt.stats()
    print("RLOSSES " + " ".join(f"{v:.8f}" for v in losses), flush=True)
    print(f"RSTATS {s['hits']} {s['misses']} "
          f"{int(rt.timers.tallies.get('stage_rows', 0))}", flush=True)


def run_cache(mesh, n_dev, local, host_id):
    """ShardedFeatureCache across processes: prewarm (owner-partitioned
    loads on each process's own devices), fetch with the two-phase
    exchange, miss repair via the replicated-counter protocol, stats."""
    from coala_gnn.cache import feature_cache as fc
    from coala_gnn.cache.host_tier import HostFeatureStore
    from coala_gnn.parallel.sharded_cache import ShardedFeatureCache

    N, DIM, B = 512, 8, 16
    rng = np.random.default_rng(9)
    feats = rng.standard_normal((N, DIM)).astype(np.float32)
    store = HostFeatureStore(feats)
    cfg = fc.CacheConfig(num_sets=8, ways=fc.WAYS, dim=DIM,
                         cache_dim=fc.round_cache_dim(DIM), num_colors=0,
                         num_shards=n_dev)
    cache = ShardedFeatureCache(cfg=cfg, mesh=mesh, mode="sharded")

    # prewarm HALF the id space -> later requests mix hits and misses
    cache.prewarm(np.arange(0, N, 2, dtype=np.int32), store.fetch)

    # deterministic GLOBAL request grid; each process feeds its OWN
    # devices' slices (the public API's per-local-device contract, same as
    # the trainer's loader). Rows interleave resident (even) and missing
    # (odd) ids.
    ids_global = (np.arange(n_dev * B, dtype=np.int32)
                  .reshape(n_dev, B) * 3) % N
    ids = ids_global[cache.local_positions]             # [n_local, B]
    num_valid = np.full(cache.n_local, B, np.int32)
    out = cache.fetch(ids, num_valid, store.fetch)

    # every process checks ITS devices' rows against the host truth
    from coala_gnn.parallel.multihost import read_local_shards
    idxs, rows = read_local_shards(out)
    ok = all(np.allclose(np.asarray(rows[i])[:, :DIM], feats[ids_global[g]],
                         atol=1e-6)
             for i, g in enumerate(idxs))
    print(f"CACHEOK {int(ok)} {idxs}", flush=True)
    s = cache.stats()
    print(f"CACHESTATS {s['hits']} {s['misses']}", flush=True)

    # second fetch of the same ids must now fully hit (misses were filled)
    out2 = cache.fetch(ids, num_valid, store.fetch)
    idxs2, rows2 = read_local_shards(out2)
    ok2 = all(np.allclose(np.asarray(rows2[i])[:, :DIM],
                          feats[ids_global[g]], atol=1e-6)
              for i, g in enumerate(idxs2))
    s2 = cache.stats()
    print(f"CACHEOK2 {int(ok2)} {s2['hits']} {s2['misses']}", flush=True)


def run_node_local(mesh, n_dev, local, host_id):
    """node_local hierarchical cache across REAL processes: the exchange is
    scoped to each process's (host's) devices via axis_index_groups — the
    reference's NVSHMEM-world-per-node topology (nvshmem_manager.cuh:15-28).
    Checks: (1) rows fetched by host 0 are resident for host 0's whole
    group but MISS on host 1 (features never cross hosts); (2) every output
    row is exact everywhere (host-tier fallback); (3) hit/miss accounting
    is identical when the same global mesh runs as one process."""
    from coala_gnn.cache import feature_cache as fc
    from coala_gnn.cache.host_tier import HostFeatureStore
    from coala_gnn.parallel.multihost import read_local_shards
    from coala_gnn.parallel.sharded_cache import ShardedFeatureCache

    N, DIM, B = 512, 8, 16
    n_groups = 2
    L = n_dev // n_groups
    rng = np.random.default_rng(13)
    feats = rng.standard_normal((N, DIM)).astype(np.float32)
    store = HostFeatureStore(feats)
    cfg = fc.CacheConfig(num_sets=8, ways=fc.WAYS, dim=DIM,
                         cache_dim=fc.round_cache_dim(DIM), num_colors=0,
                         num_shards=L)
    cache = ShardedFeatureCache(cfg=cfg, mesh=mesh, mode="node_local",
                                group_size=L)

    # Round 1: only GROUP 0's devices request rows 100..100+B.
    want = np.arange(100, 100 + B, dtype=np.int32)
    ids_global = np.zeros((n_dev, B), np.int32)
    nv_global = np.zeros(n_dev, np.int32)
    ids_global[:L] = want
    nv_global[:L] = B
    ids = ids_global[cache.local_positions]
    nv = nv_global[cache.local_positions]
    cache.fetch(ids, nv, store.fetch)
    cache.stats()

    # Round 2: EVERY device requests the same rows (no fill): group 0 all
    # hit, group 1 all miss.
    ids2 = np.tile(want, (cache.n_local, 1))
    nv2 = np.full(cache.n_local, B, np.int32)
    out = cache.fetch(ids2, nv2, store.fetch, fill=False)
    idxs, rows = read_local_shards(out)
    ok = all(np.allclose(np.asarray(rows[i])[:, :DIM], feats[want],
                         atol=1e-6) for i, _ in enumerate(idxs))
    s = cache.stats()
    # stats are per-process sums -> allgather for the global picture
    import jax
    h, m = s["hits"], s["misses"]
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        hm = multihost_utils.process_allgather(
            np.asarray([h, m], np.int64)).reshape(-1, 2).sum(axis=0)
        h, m = int(hm[0]), int(hm[1])
    print(f"NLOK {int(ok)}", flush=True)
    print(f"NLSTATS {h} {m} {L}", flush=True)


def run_train(mesh, n_dev, local, host_id):
    import optax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from coala_gnn.graph.datasets import synthetic_graph
    from coala_gnn.cache.host_tier import HostFeatureStore
    from coala_gnn.distribution import (DistributionScheduler,
                                            SeedDistributor)
    from coala_gnn.models import make_model
    from coala_gnn.models.layers import DeviceBlock
    from coala_gnn.parallel.mesh import DATA_AXIS
    from coala_gnn.parallel.multihost import put_local, read_replicated
    from coala_gnn.parallel.train import make_sharded_train_step
    from coala_gnn.sampling.neighbor import NeighborSampler

    B = 16
    ds = synthetic_graph(num_nodes=2000, avg_degree=8, feature_dim=16,
                         num_classes=4, seed=71)
    n_hosts = n_dev // local
    # every host computes the full deterministic global assignment
    # (reference contract) and slices its part
    dist = SeedDistributor(ds.train_idx, batch_size=B, local_size=local,
                           num_parts=n_hosts, mode="baseline",
                           shuffle_seed=3)
    sched = DistributionScheduler(dist, part_id=host_id, local_rank=0)
    # per-(step, global device) deterministic sampling so process topology
    # cannot change the sample draw
    model = make_model("sage", hidden=16, num_classes=4, num_layers=2,
                       dropout=0.0)
    tx = optax.adam(1e-2)
    step_fn = make_sharded_train_step(model, tx, mesh, B)
    store = HostFeatureStore(ds.features)

    import jax
    params = opt_state = None
    losses = []
    for it in range(4):
        domain = sched.run_domain().reshape(local, B).astype(np.int64)
        # deterministic per-(step, global-device) sampler seeds
        hbs = []
        for d in range(local):
            gdev = host_id * local + d
            sampler = NeighborSampler(ds.graph, [4, 3], B,
                                      seed=1000 * it + gdev)
            hbs.append(sampler.sample(domain[d]))
        adjs = [np.stack([hb.blocks[l].adj for hb in hbs])
                for l in range(2)]
        masks = [np.stack([hb.blocks[l].mask for hb in hbs])
                 for l in range(2)]
        x = np.stack([store.fetch(hb.input_ids.astype(np.int64))
                      for hb in hbs])
        labels = np.stack([ds.labels[domain[d]] for d in range(local)])
        dblocks = [DeviceBlock(adj=put_local(mesh, P(DATA_AXIS, None, None),
                                             adjs[l]),
                               mask=put_local(mesh, P(DATA_AXIS, None, None),
                                              masks[l]))
                   for l in range(2)]
        dx = put_local(mesh, P(DATA_AXIS, None, None),
                       x.astype(np.float32))
        dy = put_local(mesh, P(DATA_AXIS, None), labels.astype(np.int32))
        if params is None:
            single = [DeviceBlock(adj=jnp.asarray(adjs[l][0]),
                                  mask=jnp.asarray(masks[l][0]))
                      for l in range(2)]
            params = model.init(jax.random.key(0), single,
                                jnp.asarray(x[0]))
            opt_state = tx.init(params)
        params, opt_state, loss, acc = step_fn(params, opt_state,
                                               jax.random.key(it),
                                               dblocks, dx, dy)
        losses.append(float(read_replicated(loss)))
    return losses


if __name__ == "__main__":
    main()
