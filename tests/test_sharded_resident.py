"""Multi-device device-resident pipeline on the 8-device virtual mesh."""

import numpy as np
import jax
import optax
import pytest

from coala_gnn.cache import feature_cache as fc
from coala_gnn.cache.host_tier import HostFeatureStore
from coala_gnn.graph.datasets import synthetic_graph
from coala_gnn.models import make_model
from coala_gnn.parallel.mesh import make_mesh
from coala_gnn.parallel.sharded_cache import ShardedFeatureCache
from coala_gnn.parallel.sharded_resident import ShardedResidentTrainer


@pytest.fixture(scope="module")
def setup():
    ds = synthetic_graph(num_nodes=4000, avg_degree=8, feature_dim=32,
                         num_classes=8, seed=31)
    store = HostFeatureStore(ds.features)
    mesh = make_mesh()
    n_dev = mesh.devices.size
    cfg = fc.CacheConfig(num_sets=64, ways=fc.WAYS, dim=32,
                         cache_dim=fc.round_cache_dim(32), num_colors=0,
                         num_shards=n_dev)
    cache = ShardedFeatureCache(cfg=cfg, mesh=mesh, mode="sharded")
    model = make_model("sage", hidden=24, num_classes=8, num_layers=2,
                       dropout=0.0)
    rt = ShardedResidentTrainer(graph=ds.graph, host_fetch=store.fetch,
                                labels=ds.labels, cache=cache, model=model,
                                tx=optax.adam(1e-2), fanouts=[4, 3],
                                batch_size=16)
    return ds, store, rt, model, mesh


def _seed_grid(ds, rng, n_dev, B):
    return np.stack([rng.choice(ds.train_idx, B, replace=False)
                     for _ in range(n_dev)]).astype(np.int32)


def test_sharded_resident_features_exact(setup):
    ds, store, rt, model, mesh = setup
    n_dev = mesh.devices.size
    rng = np.random.default_rng(0)
    for trial in range(3):
        grid = _seed_grid(ds, rng, n_dev, 16)
        h = rt.begin(grid, jax.random.key(trial))
        blocks, feats, y = rt.resolve(h)
        ids = np.asarray(h[1])
        valid = np.asarray(h[2])
        feats_np = np.asarray(feats)
        for d in range(n_dev):
            np.testing.assert_allclose(
                feats_np[d][valid[d]], ds.features[ids[d][valid[d]]],
                rtol=1e-5, atol=1e-6, err_msg=f"trial {trial} dev {d}")
        np.testing.assert_array_equal(np.asarray(y), ds.labels[grid])


def test_sharded_resident_trains_and_hits(setup):
    ds, store, rt, model, mesh = setup
    n_dev = mesh.devices.size
    rng = np.random.default_rng(1)
    params = opt = None
    key = jax.random.key(5)
    losses = []
    rt.cache.stats()
    for i in range(8):
        grid = _seed_grid(ds, rng, n_dev, 16)
        key, k1, k2 = jax.random.split(key, 3)
        resolved = rt.resolve(rt.begin(grid, k1))
        if params is None:
            import jax.numpy as jnp
            blocks0 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)[0]),
                                   resolved[0])
            params = model.init(jax.random.key(0), blocks0,
                                jnp.asarray(np.asarray(resolved[1])[0]))
            opt = rt.tx.init(params)
        params, opt, loss, acc = rt.train_step(params, opt, k2, resolved)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    s = rt.cache.stats()
    assert s["hits"] > 0      # sharded cache serves repeat requests


def test_sharded_resident_padded_topology_trains(setup):
    """nbr_cap (padded neighbor table): the resident pipeline samples from
    dense [P]-rows — features stay exact against the host store and
    training converges. nbr_cap < max(fanout) and nbr_cap+shard_topology
    are refused."""
    import jax.numpy as jnp
    import optax

    ds, store, _, model, mesh = setup
    n_dev = mesh.devices.size
    cfg = fc.CacheConfig(num_sets=64, ways=fc.WAYS, dim=32,
                         cache_dim=fc.round_cache_dim(32), num_colors=0,
                         num_shards=n_dev)
    cache = ShardedFeatureCache(cfg=cfg, mesh=mesh, mode="sharded")
    rt = ShardedResidentTrainer(graph=ds.graph, host_fetch=store.fetch,
                                labels=ds.labels, cache=cache, model=model,
                                tx=optax.adam(1e-2), fanouts=[4, 3],
                                batch_size=16, nbr_cap=8)
    rng = np.random.default_rng(3)
    params = opt = None
    losses = []
    for i in range(6):
        grid = _seed_grid(ds, rng, n_dev, 16)
        h = rt.begin(grid, jax.random.key(i))
        resolved = rt.resolve(h)
        ids, valid = np.asarray(h[1]), np.asarray(h[2])
        feats_np = np.asarray(resolved[1])
        for d in range(n_dev):
            np.testing.assert_allclose(
                feats_np[d][valid[d]], ds.features[ids[d][valid[d]]],
                rtol=1e-5, atol=1e-6)
        if params is None:
            blocks0 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)[0]),
                                   resolved[0])
            params = model.init(jax.random.key(0), blocks0,
                                jnp.asarray(np.asarray(resolved[1])[0]))
            opt = rt.tx.init(params)
        params, opt, loss, acc = rt.train_step(params, opt,
                                               jax.random.key(50 + i),
                                               resolved)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]

    with pytest.raises(ValueError):
        ShardedResidentTrainer(graph=ds.graph, host_fetch=store.fetch,
                               labels=ds.labels, cache=cache, model=model,
                               tx=optax.adam(1e-2), fanouts=[4, 3],
                               batch_size=16, nbr_cap=2)
    with pytest.raises(ValueError):
        ShardedResidentTrainer(graph=ds.graph, host_fetch=store.fetch,
                               labels=ds.labels, cache=cache, model=model,
                               tx=optax.adam(1e-2), fanouts=[4, 3],
                               batch_size=16, nbr_cap=8,
                               shard_topology=True)


def test_sharded_resident_masked_tail_exactness(setup):
    """The resident masked DP step (--mask_tail's tail route) zeroes
    invalid slots' contribution exactly: (a) the update is invariant to
    the CONTENT of invalid slots, (b) an all-true mask matches the
    unmasked step's global mean."""
    import jax.numpy as jnp

    ds, store, rt, model, mesh = setup
    n_dev = mesh.devices.size
    B = 16
    rng = np.random.default_rng(23)
    resolved = rt.resolve(rt.begin(_seed_grid(ds, rng, n_dev, B),
                                   jax.random.key(0)))
    blocks0 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)[0]),
                           resolved[0])
    params = model.init(jax.random.key(0), blocks0,
                        jnp.asarray(np.asarray(resolved[1])[0]))
    opt = rt.tx.init(params)

    valid = np.ones((n_dev, B), bool)
    valid[-1, B // 2:] = False          # wrapped-duplicate tail slots
    key = jax.random.key(3)

    # (a) invalid-slot content invariance: corrupt the masked labels
    p1, _, l1, a1 = rt.train_step(params, opt, key, resolved, valid=valid)
    blocks, feats, y = resolved
    y_np = np.asarray(y).copy()
    y_np[~valid] = (y_np[~valid] + 3) % ds.num_classes
    y2 = jax.device_put(y_np, y.sharding)
    p2, _, l2, a2 = rt.train_step(params, opt, key, (blocks, feats, y2),
                                  valid=valid)
    assert float(l1) == float(l2) and float(a1) == float(a2)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), np.asarray(b)), p1, p2)

    # (b) all-true mask == unmasked global mean
    pm, _, lm, am = rt.train_step(params, opt, key, resolved,
                                  valid=np.ones((n_dev, B), bool))
    pu, _, lu, au = rt.train_step(params, opt, key, resolved)
    assert np.isclose(float(lm), float(lu), rtol=1e-5)
    assert np.isclose(float(am), float(au), rtol=1e-5)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=2e-5, atol=2e-6), pm, pu)


def test_sharded_window_cold_cache_staged():
    """Cold sharded cache: the bitmap probe stages every unserved row so
    the fused multi-device window runs exactly (no replay), deterministic
    vs a de-novo run. Stage-served rows count as misses (they came from
    the backing store — reference hit/miss semantics)."""
    import jax.numpy as jnp
    import optax

    ds = synthetic_graph(num_nodes=3000, avg_degree=8, feature_dim=24,
                         num_classes=4, seed=41)
    store = HostFeatureStore(ds.features)
    mesh = make_mesh()
    n_dev = mesh.devices.size
    model = make_model("sage", hidden=16, num_classes=4, num_layers=2,
                       dropout=0.0)

    def mk():
        cfg = fc.CacheConfig(num_sets=64, ways=fc.WAYS, dim=24,
                             cache_dim=fc.round_cache_dim(24), num_colors=0,
                             num_shards=n_dev)
        cache = ShardedFeatureCache(cfg=cfg, mesh=mesh, mode="sharded")
        return ShardedResidentTrainer(graph=ds.graph, host_fetch=store.fetch,
                                      labels=ds.labels, cache=cache,
                                      model=model, tx=optax.adam(1e-2),
                                      fanouts=[4, 3], batch_size=16)

    rng = np.random.default_rng(9)
    grid = np.stack([np.stack([rng.choice(ds.train_idx, 16, replace=False)
                               for _ in range(n_dev)])
                     for _ in range(3)], axis=1)      # [n_dev, K, B]

    def run(rt):
        g0 = grid[:, 0]
        resolved = rt.resolve(rt.begin(g0, jax.random.key(0)))
        blocks0 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)[0]),
                               resolved[0])
        params = model.init(jax.random.key(0), blocks0,
                            jnp.asarray(np.asarray(resolved[1])[0]))
        opt = rt.tx.init(params)
        rt.stats()   # reset: the cold init batch above legitimately missed
        _, _, losses, edges = rt.train_window(params, opt, grid,
                                              jax.random.key(1))
        return np.asarray(losses)

    rt1, rt2 = mk(), mk()
    l1, l2 = run(rt1), run(rt2)
    assert np.isfinite(l1).all()
    np.testing.assert_allclose(l1, l2, rtol=1e-6)
    s = rt1.stats()   # fused-window counters accumulate on the trainer
    assert s["misses"] > 0    # cold cache: the stage served those rows
    assert rt1.timers.tallies.get("stage_rows", 0) > 0


def test_window_overflow_served_without_replay():
    """Bucket-overflow slots cannot be repaired by owner insertion; the
    presample must return them as host rows merged inside the fused window.
    A trainer with a pathologically small bucket must (a) not replay and
    (b) produce EXACTLY the losses of a trainer with roomy buckets."""
    import jax.numpy as jnp
    import optax

    ds = synthetic_graph(num_nodes=2000, avg_degree=8, feature_dim=16,
                         num_classes=4, seed=51)
    store = HostFeatureStore(ds.features)
    mesh = make_mesh()
    n_dev = mesh.devices.size
    model = make_model("sage", hidden=16, num_classes=4, num_layers=2,
                       dropout=0.0)

    def mk(slack):
        cfg = fc.CacheConfig(num_sets=64, ways=fc.WAYS, dim=16,
                             cache_dim=fc.round_cache_dim(16), num_colors=0,
                             num_shards=n_dev)
        cache = ShardedFeatureCache(cfg=cfg, mesh=mesh, mode="sharded",
                                    bucket_slack=slack)
        return ShardedResidentTrainer(graph=ds.graph, host_fetch=store.fetch,
                                      labels=ds.labels, cache=cache,
                                      model=model, tx=optax.adam(1e-2),
                                      fanouts=[4, 3], batch_size=16)

    rng = np.random.default_rng(13)
    grid = np.stack([np.stack([rng.choice(ds.train_idx, 16, replace=False)
                               for _ in range(n_dev)])
                     for _ in range(3)], axis=1)      # [n_dev, K, B]

    def run(rt):
        g0 = grid[:, 0]
        resolved = rt.resolve(rt.begin(g0, jax.random.key(0)))
        blocks0 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)[0]),
                               resolved[0])
        params = model.init(jax.random.key(0), blocks0,
                            jnp.asarray(np.asarray(resolved[1])[0]))
        opt = rt.tx.init(params)
        rt.stats()
        _, _, losses, _ = rt.train_window(params, opt, grid,
                                          jax.random.key(2))
        return np.asarray(losses), rt.stats()

    rt_small = mk(0.02)          # bucket_cap ~1: heavy overflow
    # confirm overflow actually occurs in this configuration
    import jax as _jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from coala_gnn.parallel.mesh import DATA_AXIS
    seeds_dev = _jax.device_put(
        np.ascontiguousarray(grid, np.int32),
        NamedSharding(mesh, P(DATA_AXIS, None, None)))
    keys = _jax.random.key_data(_jax.random.split(jax.random.key(2), 3))
    _, n_ovf, _, _ = rt_small._presample(rt_small._g, rt_small.cache.state,
                                         seeds_dev, keys)
    assert int(np.asarray(n_ovf)[0]) > 0

    l_small, s_small = run(rt_small)
    l_big, s_big = run(mk(8.0))  # roomy buckets: no overflow
    # overflow slots were stage-served inside the window — never replayed
    assert "replay" not in rt_small.timers.totals
    np.testing.assert_allclose(l_small, l_big, rtol=1e-5, atol=1e-6)


def test_sharded_fused_window(setup):
    ds, store, rt, model, mesh = setup
    n_dev = mesh.devices.size
    rng = np.random.default_rng(7)
    import jax.numpy as jnp

    # init params
    grid0 = _seed_grid(ds, rng, n_dev, 16)
    resolved = rt.resolve(rt.begin(grid0, jax.random.key(0)))
    blocks0 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)[0]), resolved[0])
    params = model.init(jax.random.key(0), blocks0,
                        jnp.asarray(np.asarray(resolved[1])[0]))
    opt = rt.tx.init(params)

    K = 3
    losses_all = []
    for w in range(4):
        grid = np.stack([_seed_grid(ds, rng, n_dev, 16) for _ in range(K)],
                        axis=1)             # [n_dev, K, B]
        params, opt, losses, edges = rt.train_window(params, opt, grid,
                                                     jax.random.key(w + 1))
        losses = np.asarray(losses)
        assert losses.shape == (K,)
        assert np.isfinite(losses).all()
        losses_all.extend(losses.tolist())
    assert losses_all[-1] < losses_all[0]


def test_sharded_hetero_resident_trains():
    """rgcn through the multi-device resident pipeline: typed blocks flow
    through shard_map stage_a and the fused window."""
    from coala_gnn.models.hetero import make_hetero_model

    ds = synthetic_graph(num_nodes=3000, avg_degree=8, feature_dim=16,
                         num_classes=4, seed=41)
    rng = np.random.default_rng(5)
    ds.graph.edge_types = rng.integers(0, 3,
                                       ds.graph.num_edges).astype(np.int32)
    ds.graph.num_edge_types = 3
    store = HostFeatureStore(ds.features)
    mesh = make_mesh()
    n_dev = mesh.devices.size
    cfg = fc.CacheConfig(num_sets=64, ways=fc.WAYS, dim=16,
                         cache_dim=fc.round_cache_dim(16), num_colors=0,
                         num_shards=n_dev)
    cache = ShardedFeatureCache(cfg=cfg, mesh=mesh, mode="sharded")
    model = make_hetero_model("rgcn", hidden=16, num_classes=4, num_rels=3,
                              num_layers=2, dropout=0.0)
    rt = ShardedResidentTrainer(graph=ds.graph, host_fetch=store.fetch,
                                labels=ds.labels, cache=cache, model=model,
                                tx=optax.adam(1e-2), fanouts=[4, 3],
                                batch_size=16)
    B = 16
    resolved = rt.resolve(rt.begin(_seed_grid(ds, rng, n_dev, B),
                                   jax.random.key(0)))
    assert resolved[0][0].rel is not None
    import jax.numpy as jnp
    single = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)[0]),
                          resolved[0])
    params = model.init(jax.random.key(1), single,
                        jnp.asarray(np.asarray(resolved[1])[0]))
    opt_state = rt.tx.init(params)
    losses = []
    for i in range(3):
        resolved = rt.resolve(rt.begin(_seed_grid(ds, rng, n_dev, B),
                                       jax.random.key(10 + i)))
        params, opt_state, loss, acc = rt.train_step(
            params, opt_state, jax.random.key(20 + i), resolved)
        losses.append(float(np.asarray(loss).reshape(-1)[0]))
    assert np.isfinite(losses).all()

    # fused window with typed blocks
    grid = np.stack([_seed_grid(ds, rng, n_dev, B) for _ in range(2)],
                    axis=1)   # [n_dev, K=2, B]
    params, opt_state, wl, we = rt.train_window(params, opt_state, grid,
                                                jax.random.key(30))
    assert np.isfinite(np.asarray(wl)).all()


def _mk_pressure_trainer(ds, store, mesh, model, num_sets, transport,
                         prewarm_all=False):
    import jax.numpy as jnp  # noqa: F401

    n_dev = mesh.devices.size
    cfg = fc.CacheConfig(num_sets=num_sets, ways=fc.WAYS, dim=24,
                         cache_dim=fc.round_cache_dim(24), num_colors=0,
                         num_shards=n_dev)
    cache = ShardedFeatureCache(cfg=cfg, mesh=mesh, mode="sharded")
    rt = ShardedResidentTrainer(graph=ds.graph, host_fetch=store.fetch,
                                labels=ds.labels, cache=cache, model=model,
                                tx=optax.adam(1e-2), fanouts=[4, 3],
                                batch_size=16, stage_transport=transport)
    if prewarm_all:
        cache.prewarm(np.arange(ds.graph.num_nodes, dtype=np.int32),
                      store.fetch)
        rt.full_coverage = True
    return rt


def _run_staged_windows(rt, ds, model):
    import jax.numpy as jnp

    from coala_gnn.models.layers import DeviceBlock
    from coala_gnn.sampling.neighbor import block_capacities

    n_dev = rt.mesh.devices.size
    B, K, M = 16, 2, 3
    caps = block_capacities(B, [4, 3])
    blocks0 = [DeviceBlock(adj=None, mask=jnp.ones((caps[l][0], [4, 3][l]),
                                                   jnp.float32))
               for l in range(2)]
    params = model.init(jax.random.key(0), blocks0,
                        jnp.zeros((caps[0][1], 24), jnp.float32))
    opt = rt.tx.init(params)
    rng = np.random.default_rng(17)
    grids = np.stack([np.stack([
        np.stack([rng.choice(ds.train_idx, B, replace=False)
                  for _ in range(K)])
        for _ in range(n_dev)]) for _ in range(M)]).astype(np.int32)
    params, opt, losses, edges = rt.train_windows(params, opt, grids,
                                                  jax.random.key(7))
    return np.asarray(losses)


def test_sharded_staged_pressure_exact_vs_full_coverage():
    """Capacity pressure on the mesh: the staged trainer (cache covering a
    fraction of the nodes, f32 stage transport) must produce EXACTLY the
    losses of a fully-prewarmed full-coverage trainer — staged windows are
    exact at any hit ratio, with no replay."""
    ds = synthetic_graph(num_nodes=3000, avg_degree=8, feature_dim=24,
                         num_classes=4, seed=61)
    store = HostFeatureStore(ds.features)
    mesh = make_mesh()
    model = make_model("sage", hidden=16, num_classes=4, num_layers=2,
                       dropout=0.0)
    rt_p = _mk_pressure_trainer(ds, store, mesh, model, num_sets=8,
                                transport="float32")
    rt_f = _mk_pressure_trainer(ds, store, mesh, model, num_sets=256,
                                transport="float32", prewarm_all=True)
    l_p = _run_staged_windows(rt_p, ds, model)
    l_f = _run_staged_windows(rt_f, ds, model)
    assert np.isfinite(l_p).all()
    np.testing.assert_array_equal(l_p, l_f)
    assert "replay" not in rt_p.timers.totals
    s = rt_p.stats()
    assert s["misses"] > 0          # pressure was real
    assert rt_p.timers.tallies.get("stage_rows", 0) > 0
    sf = rt_f.stats()
    assert sf["misses"] == 0        # full coverage never missed


def test_sharded_staged_bf16_transport_close():
    """bf16 stage transport: same schedule, losses within bf16 tolerance
    of the f32-transport run (4x less host-link traffic for 2-byte rows)."""
    ds = synthetic_graph(num_nodes=3000, avg_degree=8, feature_dim=24,
                         num_classes=4, seed=62)
    store = HostFeatureStore(ds.features)
    mesh = make_mesh()
    model = make_model("sage", hidden=16, num_classes=4, num_layers=2,
                       dropout=0.0)
    l_f32 = _run_staged_windows(
        _mk_pressure_trainer(ds, store, mesh, model, 8, "float32"),
        ds, model)
    l_bf16 = _run_staged_windows(
        _mk_pressure_trainer(ds, store, mesh, model, 8, "bfloat16"),
        ds, model)
    np.testing.assert_allclose(l_f32, l_bf16, rtol=0.05, atol=0.05)


def test_sharded_staged_overlap_matches_serial():
    """Mesh overlap schedule (probe before window + replicated evicted-id
    patching, r3) must train EXACTLY like the serial schedule — both are
    exact at any hit ratio — and never trip the replay net."""
    ds = synthetic_graph(num_nodes=3000, avg_degree=8, feature_dim=24,
                         num_classes=4, seed=67)
    store = HostFeatureStore(ds.features)
    mesh = make_mesh()
    model = make_model("sage", hidden=16, num_classes=4, num_layers=2,
                       dropout=0.0)
    losses = {}
    for overlap in (True, False):
        rt = _mk_pressure_trainer(ds, store, mesh, model, num_sets=8,
                                  transport="int8")
        rt.stage_overlap = overlap
        losses[overlap] = _run_staged_windows(rt, ds, model)
        assert "replay" not in rt.timers.totals
        s = rt.stats()
        assert s["misses"] > 0
        if overlap:
            assert "evict_patch" in rt.timers.totals
    np.testing.assert_array_equal(losses[True], losses[False])


def test_sharded_resident_node_local_exact_and_group_scoped():
    """Resident pipeline over a node_local cache (2 emulated hosts x 4
    devices): features stay exact, training converges, and the exchange
    never leaves the group (group-scoped hit accounting: after a prewarm
    both groups serve the working set at 100% from their own devices)."""
    ds = synthetic_graph(num_nodes=4000, avg_degree=8, feature_dim=32,
                         num_classes=8, seed=33)
    store = HostFeatureStore(ds.features)
    mesh = make_mesh()
    n_dev = mesh.devices.size
    if n_dev < 8:
        pytest.skip("needs 8 virtual devices (2 groups of 4)")
    L = 4
    cfg = fc.CacheConfig(num_sets=64, ways=fc.WAYS, dim=32,
                         cache_dim=fc.round_cache_dim(32), num_colors=0,
                         num_shards=L)
    cache = ShardedFeatureCache(cfg=cfg, mesh=mesh, mode="node_local",
                                group_size=L)
    model = make_model("sage", hidden=24, num_classes=8, num_layers=2,
                       dropout=0.0)
    rt = ShardedResidentTrainer(graph=ds.graph, host_fetch=store.fetch,
                                labels=ds.labels, cache=cache, model=model,
                                tx=optax.adam(1e-2), fanouts=[4, 3],
                                batch_size=16)
    cache.prewarm(np.arange(ds.graph.num_nodes, dtype=np.int32), store.fetch)
    rng = np.random.default_rng(2)
    params = opt = None
    key = jax.random.key(7)
    losses = []
    cache.stats()
    import jax.numpy as jnp
    for i in range(6):
        grid = _seed_grid(ds, rng, n_dev, 16)
        key, k1, k2 = jax.random.split(key, 3)
        h = rt.begin(grid, k1)
        resolved = rt.resolve(h)
        # exactness against the host store
        ids, valid = np.asarray(h[1]), np.asarray(h[2])
        feats_np = np.asarray(resolved[1])
        for d in range(n_dev):
            np.testing.assert_allclose(
                feats_np[d][valid[d]], ds.features[ids[d][valid[d]]],
                rtol=1e-5, atol=1e-6)
        if params is None:
            blocks0 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)[0]),
                                   resolved[0])
            params = model.init(jax.random.key(0), blocks0,
                                jnp.asarray(np.asarray(resolved[1])[0]))
            opt = rt.tx.init(params)
        params, opt, loss, acc = rt.train_step(params, opt, k2, resolved)
        losses.append(float(loss))
    s = cache.stats()
    assert s["hit_ratio"] == 1.0        # every group self-serves after warm
    assert losses[-1] < losses[0]
