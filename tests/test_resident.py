"""Device-resident pipeline: correctness of the two-stage sample+probe/train
loop, including the miss-repair path."""

import numpy as np
import jax
import optax
import pytest

from coala_gnn.cache import feature_cache as fc
from coala_gnn.cache.host_tier import HostFeatureStore
from coala_gnn.graph.datasets import synthetic_graph
from coala_gnn.models import make_model
from coala_gnn.parallel.resident import ResidentTrainer


@pytest.fixture(scope="module")
def setup():
    ds = synthetic_graph(num_nodes=3000, avg_degree=8, feature_dim=32,
                         num_classes=8, seed=21)
    store = HostFeatureStore(ds.features)
    cfg = fc.CacheConfig(num_sets=128, ways=fc.WAYS, dim=32,
                         cache_dim=fc.round_cache_dim(32), num_colors=0)
    model = make_model("sage", hidden=32, num_classes=8, num_layers=2,
                       dropout=0.0)
    rt = ResidentTrainer(graph=ds.graph, host_fetch=store.fetch,
                         labels=ds.labels, cache_cfg=cfg, model=model,
                         tx=optax.adam(1e-2), fanouts=[5, 4], batch_size=32,
                         direct=False)   # exercise the associative engine
    return ds, store, rt, model


def test_resident_features_are_exact(setup):
    """Features resolved through sample+probe+repair match direct gather."""
    ds, store, rt, model = setup
    rng = np.random.default_rng(0)
    for trial in range(4):   # cold cache first, then warming
        seeds = rng.choice(ds.train_idx, 32, replace=False)
        h = rt.begin(seeds, jax.random.key(trial))
        blocks, feats, y = rt.resolve(h)
        ids = np.asarray(h[1])
        valid = np.asarray(h[2])
        np.testing.assert_allclose(np.asarray(feats)[valid],
                                   ds.features[ids[valid]], rtol=1e-6,
                                   err_msg=f"trial {trial}")
        np.testing.assert_array_equal(np.asarray(y), ds.labels[seeds])


def test_resident_cache_warms(setup):
    ds, store, rt, model = setup
    rt.stats()
    rng = np.random.default_rng(1)
    seeds = rng.choice(ds.train_idx, 32, replace=False)
    h = rt.begin(seeds, jax.random.key(100))
    rt.resolve(h)
    # same seeds again: everything previously admitted should hit
    h2 = rt.begin(seeds, jax.random.key(100))
    blocks, feats, y = rt.resolve(h2)
    s = rt.stats()
    assert s["hits"] > 0


def test_resident_training_learns(setup):
    ds, store, rt, model = setup
    rt.prewarm(np.arange(ds.graph.num_nodes))
    seeds0 = ds.train_idx[:32]
    h = rt.begin(seeds0, jax.random.key(0))
    blocks, feats, y = rt.resolve(h)
    params = model.init(jax.random.key(0), blocks, feats)
    opt = rt.tx.init(params)

    rng = np.random.default_rng(2)
    losses = []
    key = jax.random.key(7)
    for i in range(25):
        seeds = rng.choice(ds.train_idx, 32, replace=False)
        key, k1, k2 = jax.random.split(key, 3)
        resolved = rt.resolve(rt.begin(seeds, k1))
        params, opt, loss, acc = rt.train_step(params, opt, k2, resolved)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    s = rt.stats()
    assert s["hit_ratio"] > 0.95  # prewarmed: virtually all hits

    # eval path
    resolved = rt.resolve(rt.begin(ds.test_idx[:32], jax.random.key(9)))
    correct = rt.eval_step(params, resolved)
    assert 0 <= correct <= 32


def test_fused_window_trains(setup):
    ds, store, rt, model = setup
    rt.prewarm(np.arange(ds.graph.num_nodes))
    rng = np.random.default_rng(4)
    grid0 = np.stack([rng.choice(ds.train_idx, 32, replace=False)
                      for _ in range(4)]).astype(np.int32)
    resolved = rt.resolve(rt.begin(grid0[0], jax.random.key(0)))
    params = model.init(jax.random.key(0), resolved[0], resolved[1])
    opt = rt.tx.init(params)

    first = last = None
    for w in range(5):
        grid = np.stack([rng.choice(ds.train_idx, 32, replace=False)
                         for _ in range(4)]).astype(np.int32)
        params, opt, losses, edges = rt.train_window(
            params, opt, grid, jax.random.key(w + 1))
        losses = np.asarray(losses)
        assert losses.shape == (4,)
        assert np.isfinite(losses).all()
        assert (np.asarray(edges) > 0).all()
        if first is None:
            first = losses[0]
        last = losses[-1]
    assert last < first        # learning across fused windows


def test_direct_tier_features_exact_and_matches_associative(setup):
    """The auto-selected flat tier (capacity >= nodes) must (a) resolve
    exact features through the per-step miss path and (b) produce EXACTLY
    the fused-window losses of the associative engine given the same seeds,
    keys and prewarm."""
    ds, store, _, _ = setup
    cfg = fc.CacheConfig(num_sets=128, ways=fc.WAYS, dim=32,
                         cache_dim=fc.round_cache_dim(32), num_colors=0)
    model = make_model("sage", hidden=32, num_classes=8, num_layers=2,
                       dropout=0.0)

    def mk(direct):
        return ResidentTrainer(graph=ds.graph, host_fetch=store.fetch,
                               labels=ds.labels, cache_cfg=cfg, model=model,
                               tx=optax.adam(1e-2), fanouts=[5, 4],
                               batch_size=32, direct=direct)

    rt_d = mk(None)            # auto: capacity 4096 >= 3000 -> flat
    assert rt_d.direct
    rng = np.random.default_rng(17)
    # (a) per-step exactness on a cold flat store (miss path + admission)
    for trial in range(3):
        seeds = rng.choice(ds.train_idx, 32, replace=False)
        h = rt_d.begin(seeds, jax.random.key(trial))
        blocks, feats, y = rt_d.resolve(h)
        ids, valid = np.asarray(h[1]), np.asarray(h[2])
        np.testing.assert_allclose(np.asarray(feats)[valid],
                                   ds.features[ids[valid]], rtol=1e-6)

    # (b) fused-window equivalence vs the associative engine
    grids = np.stack([
        np.stack([rng.choice(ds.train_idx, 32, replace=False)
                  for _ in range(4)]) for _ in range(2)]).astype(np.int32)

    def run(rt):
        rt.prewarm(np.arange(ds.graph.num_nodes))
        resolved = rt.resolve(rt.begin(grids[0, 0], jax.random.key(0)))
        params = model.init(jax.random.key(0), resolved[0], resolved[1])
        opt = rt.tx.init(params)
        _, _, losses, _ = rt.train_windows(params, opt, grids,
                                           jax.random.key(5))
        return np.asarray(losses)

    l_direct = run(mk(True))
    l_assoc = run(mk(False))
    np.testing.assert_allclose(l_direct, l_assoc, rtol=1e-5, atol=1e-6)


def test_scan_unroll_matches_rolled(setup):
    """scan_unroll is a pure scheduling knob: unrolled fused windows must
    reproduce the rolled scan's losses and params exactly (same math, the
    unroll only exposes cross-step overlap to the XLA scheduler). Covers
    both the flat-tier window and the staged window (partial prewarm)."""
    ds, store, _, _ = setup
    model = make_model("sage", hidden=32, num_classes=8, num_layers=2,
                       dropout=0.0)
    rng = np.random.default_rng(23)
    M, K = 2, 4
    grids = np.stack([
        np.stack([rng.choice(ds.train_idx, 32, replace=False)
                  for _ in range(K)])
        for _ in range(M)]).astype(np.int32)

    def run(direct, unroll, prewarm_all):
        cfg = fc.CacheConfig(num_sets=128, ways=fc.WAYS, dim=32,
                             cache_dim=fc.round_cache_dim(32), num_colors=0)
        rt = ResidentTrainer(graph=ds.graph, host_fetch=store.fetch,
                             labels=ds.labels, cache_cfg=cfg, model=model,
                             tx=optax.adam(1e-2), fanouts=[5, 4],
                             batch_size=32, direct=direct,
                             scan_unroll=unroll)
        if prewarm_all:
            rt.prewarm(np.arange(ds.graph.num_nodes))
        else:   # partial prewarm -> staged windows (associative tier)
            rt.prewarm(np.arange(0, ds.graph.num_nodes, 2))
        resolved = rt.resolve(rt.begin(grids[0, 0], jax.random.key(0)))
        params = model.init(jax.random.key(0), resolved[0], resolved[1])
        opt = rt.tx.init(params)
        p, o, losses, _ = rt.train_windows(params, opt, grids,
                                           jax.random.key(31))
        return np.asarray(losses), p

    for direct, prewarm_all in ((True, True), (False, False)):
        l1, p1 = run(direct, 1, prewarm_all)
        l4, p4 = run(direct, 4, prewarm_all)
        np.testing.assert_allclose(l1, l4, rtol=1e-6,
                                   err_msg=f"direct={direct}")
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6), p1, p4)


def test_train_windows_pipelined_matches_sequential(setup):
    """train_windows (deferred miss checks) must produce exactly the same
    losses as the equivalent sequence of train_window calls."""
    ds, store, rt, model = setup
    rt.prewarm(np.arange(ds.graph.num_nodes))
    rng = np.random.default_rng(6)
    M, K = 3, 4
    grids = np.stack([
        np.stack([rng.choice(ds.train_idx, 32, replace=False)
                  for _ in range(K)])
        for _ in range(M)]).astype(np.int32)
    resolved = rt.resolve(rt.begin(grids[0, 0], jax.random.key(0)))
    params = model.init(jax.random.key(0), resolved[0], resolved[1])
    opt = rt.tx.init(params)

    key = jax.random.key(11)
    p1, o1, losses1, edges1 = rt.train_windows(params, opt, grids, key)
    losses1 = np.asarray(losses1)
    assert losses1.shape == (M * K,)

    p2, o2 = params, opt
    seq = []
    for w, sub in enumerate(jax.random.split(key, M)):
        p2, o2, lw, _ = rt.train_window(p2, o2, grids[w], sub)
        seq.append(np.asarray(lw))
    np.testing.assert_allclose(losses1, np.concatenate(seq), rtol=1e-6)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6), p1, p2)


def test_train_windows_replay_on_miss(setup):
    """Force the deferred-check rollback: full_coverage=True on a cold cache
    makes every window miss, so train_windows must discard the speculative
    windows and replay each one per-step with exact features."""
    import optax

    ds, store, _, model4 = setup
    cfg = fc.CacheConfig(num_sets=128, ways=fc.WAYS, dim=32,
                         cache_dim=fc.round_cache_dim(32), num_colors=0)
    model = make_model("sage", hidden=16, num_classes=8, num_layers=2,
                       dropout=0.0)
    rt = ResidentTrainer(graph=ds.graph, host_fetch=store.fetch,
                         labels=ds.labels, cache_cfg=cfg, model=model,
                         tx=optax.adam(1e-2), fanouts=[5, 4], batch_size=32,
                         direct=False)   # the replay net is associative-only
    rt.full_coverage = True    # lie: skip presample-prefetch -> cold misses
    rng = np.random.default_rng(7)
    M, K = 2, 3
    grids = np.stack([
        np.stack([rng.choice(ds.train_idx, 32, replace=False)
                  for _ in range(K)])
        for _ in range(M)]).astype(np.int32)
    resolved = rt.resolve(rt.begin(grids[0, 0], jax.random.key(0)))
    params = model.init(jax.random.key(0), resolved[0], resolved[1])
    opt = rt.tx.init(params)
    rt.stats()
    params, opt, losses, edges = rt.train_windows(params, opt, grids,
                                                  jax.random.key(3))
    losses = np.asarray(losses)
    assert losses.shape == (M * K,)
    assert np.isfinite(losses).all()
    s = rt.stats()
    assert s["misses"] > 0     # the speculative windows did miss
    # the replay admitted rows: a rerun over the same grids now hits
    rt.stats()
    params, opt, losses2, _ = rt.train_windows(params, opt, grids,
                                               jax.random.key(4))
    assert rt.stats()["hit_ratio"] > 0.9


def test_fused_window_cold_cache_prefetches(setup):
    """A cold cache triggers the presample-prefetch: the window still runs
    fused (no replay misses), and the prefetched ids become residents."""
    import optax
    from coala_gnn.cache import feature_cache as fc
    from coala_gnn.models import make_model
    from coala_gnn.parallel.resident import ResidentTrainer

    ds, store, _, _ = setup
    cfg = fc.CacheConfig(num_sets=128, ways=fc.WAYS, dim=32,
                         cache_dim=fc.round_cache_dim(32), num_colors=0)
    model = make_model("sage", hidden=16, num_classes=8, num_layers=2,
                       dropout=0.0)

    def mk():
        return ResidentTrainer(graph=ds.graph, host_fetch=store.fetch,
                               labels=ds.labels, cache_cfg=cfg, model=model,
                               tx=optax.adam(1e-2), fanouts=[5, 4],
                               batch_size=32)

    rt = mk()
    # NO prewarm: the presample must discover and prefetch every id
    rng = np.random.default_rng(5)
    grid = np.stack([rng.choice(ds.train_idx, 32, replace=False)
                     for _ in range(3)]).astype(np.int32)
    resolved = rt.resolve(rt.begin(grid[0], jax.random.key(0)))
    params = model.init(jax.random.key(0), resolved[0], resolved[1])
    opt = rt.tx.init(params)
    rt.stats()
    params, opt, losses, edges = rt.train_window(params, opt, grid,
                                                 jax.random.key(1))
    assert np.isfinite(np.asarray(losses)).all()
    s = rt.stats()
    # fused pass hit everything (prefetch guaranteed it) — no window misses
    assert s["misses"] == 0
    assert s["hits"] > 0
    # the prefetched ids became residents (auto-selected flat tier here:
    # capacity covers the graph)
    from coala_gnn.cache import feature_cache as fcache
    assert isinstance(rt.cache, fcache.FlatState)
    assert int(np.asarray(rt.cache.admitted.sum())) > 0

    # determinism: a de-novo run from the same state + key matches exactly
    rt2 = mk()
    resolved2 = rt2.resolve(rt2.begin(grid[0], jax.random.key(0)))
    params2 = model.init(jax.random.key(0), resolved2[0], resolved2[1])
    opt2 = rt2.tx.init(params2)
    _, _, losses2, _ = rt2.train_window(params2, opt2, grid, jax.random.key(1))
    np.testing.assert_allclose(np.asarray(losses), np.asarray(losses2),
                               rtol=1e-6)


def test_hetero_resident_trains():
    """rgcn through the device-resident pipeline: the
    device sampler carries per-slot edge types, the fused window runs, and
    loss decreases."""
    from coala_gnn.models.hetero import make_hetero_model

    ds = synthetic_graph(num_nodes=2000, avg_degree=8, feature_dim=16,
                         num_classes=4, seed=31)
    rng = np.random.default_rng(2)
    ds.graph.edge_types = rng.integers(0, 3,
                                       ds.graph.num_edges).astype(np.int32)
    ds.graph.num_edge_types = 3
    store = HostFeatureStore(ds.features)
    cfg = fc.make_config(cache_mb=8, dim=16, num_colors=0)
    model = make_hetero_model("rgcn", hidden=16, num_classes=4, num_rels=3,
                              num_layers=2, dropout=0.0)
    rt = ResidentTrainer(graph=ds.graph, host_fetch=store.fetch,
                         labels=ds.labels, cache_cfg=cfg, model=model,
                         tx=optax.adam(1e-2), fanouts=[4, 3], batch_size=32)
    rt.prewarm(np.arange(2000, dtype=np.int32))
    assert rt.g.edge_types is not None

    resolved = rt.resolve(rt.begin(ds.train_idx[:32], jax.random.key(0)))
    # blocks carry edge types on the device path
    assert resolved[0][0].rel is not None
    import jax.numpy as jnp
    params = model.init(jax.random.key(1), resolved[0], resolved[1])
    opt_state = rt.tx.init(params)

    grids = np.stack([
        np.stack([rng.choice(ds.train_idx, 32, replace=False)
                  .astype(np.int32) for _ in range(4)])
        for _ in range(3)])
    params, opt_state, losses, edges = rt.train_windows(
        params, opt_state, grids, jax.random.key(2))
    larr = np.asarray(losses)
    assert np.isfinite(larr).all()
    assert larr[-3:].mean() < larr[:3].mean()   # learning
    assert float(np.asarray(edges).sum()) > 0


def test_quantized_associative_under_pressure_trains():
    """int8 lines in the ASSOCIATIVE tier (capacity < num_nodes): the
    presample-repair miss path quantizes on insert, dequantizes on lookup,
    and fused windows still learn."""
    import jax
    import numpy as np
    import optax

    import coala_gnn.cache.feature_cache as fc
    from coala_gnn.cache.host_tier import HostFeatureStore
    from coala_gnn.graph.datasets import synthetic_graph
    from coala_gnn.models import make_model
    from coala_gnn.parallel.resident import ResidentTrainer

    ds = synthetic_graph(num_nodes=12000, avg_degree=8, feature_dim=32,
                         num_classes=4, seed=21)
    store = HostFeatureStore(ds.features)
    cfg = fc.make_config(cache_mb=1, dim=32, quantize=True)
    assert cfg.capacity < 12000         # genuine pressure
    rt = ResidentTrainer(graph=ds.graph, host_fetch=store.fetch,
                         labels=ds.labels, cache_cfg=cfg,
                         model=make_model("sage", hidden=16, num_classes=4,
                                          num_layers=2, dropout=0.0),
                         tx=optax.adam(1e-2), fanouts=[4, 3], batch_size=32)
    assert not rt.direct                # associative engine selected
    assert rt.cache.base.data.dtype == jax.numpy.int8

    rng = np.random.default_rng(0)
    key = jax.random.key(0)
    resolved = rt.resolve(rt.begin(
        rng.choice(12000, 32, replace=False).astype(np.int32),
        jax.random.key(9)))
    params = rt.model.init(jax.random.key(1), resolved[0], resolved[1])
    opt_state = rt.tx.init(params)
    K = 3
    losses = []
    for w in range(6):                  # window API: seeds_grid [K, B]
        key, kw = jax.random.split(key)
        grid = np.stack([rng.choice(12000, 32, replace=False)
                         for _ in range(K)]).astype(np.int32)
        params, opt_state, wl, _ = rt.train_window(params, opt_state, grid,
                                                   kw)
        losses.append(float(np.asarray(wl).mean()))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    s = rt.stats()
    assert s["hits"] > 0


def test_staged_windows_exact_under_pressure(setup):
    """The staged fused window (associative tier, capacity << nodes) must
    produce EXACTLY the losses of a full-coverage flat run on the same
    seeds and keys: stage-overlaid miss rows are bit-identical to resident
    rows (f32 transport), so capacity pressure changes transfer volume,
    never training results — and the replay safety net must never fire."""
    ds, store, _, _ = setup
    model = make_model("sage", hidden=16, num_classes=8, num_layers=2,
                       dropout=0.0)

    def mk(num_sets, direct):
        cfg = fc.CacheConfig(num_sets=num_sets, ways=fc.WAYS, dim=32,
                             cache_dim=fc.round_cache_dim(32), num_colors=0)
        return ResidentTrainer(graph=ds.graph, host_fetch=store.fetch,
                               labels=ds.labels, cache_cfg=cfg, model=model,
                               tx=optax.adam(1e-2), fanouts=[5, 4],
                               batch_size=32, direct=direct)

    rng = np.random.default_rng(23)
    M, K = 3, 4
    grids = np.stack([
        np.stack([rng.choice(ds.train_idx, 32, replace=False)
                  for _ in range(K)]) for _ in range(M)]).astype(np.int32)

    def run(rt, prewarm_ids):
        rt.prewarm(prewarm_ids)
        resolved = rt.resolve(rt.begin(grids[0, 0], jax.random.key(0)))
        params = model.init(jax.random.key(0), resolved[0], resolved[1])
        opt = rt.tx.init(params)
        rt.stats()
        out = rt.train_windows(params, opt, grids, jax.random.key(5))
        return np.asarray(out[2]), rt.stats()

    # reference: flat tier, every row resident
    ref_losses, _ = run(mk(128, True), np.arange(ds.graph.num_nodes))
    # pressure: 8 sets x 32 ways = 256 lines for 3000 nodes
    rt_p = mk(8, False)
    assert rt_p.cache_cfg.capacity < ds.graph.num_nodes
    p_losses, s = run(rt_p, np.arange(rt_p.cache_cfg.capacity))
    np.testing.assert_allclose(p_losses, ref_losses, rtol=1e-5, atol=1e-6)
    assert s["misses"] > 0            # pressure was real
    assert "replay" not in rt_p.timers.totals   # safety net never fired
    assert rt_p.timers.totals.get("host_gather", 0) > 0


def test_staged_windows_int8_transport_trains(setup):
    """int8 stage transport under pressure: 4x less host-link traffic,
    training still converges, and a staged row dequantizes to exactly what
    an int8 cache hit would serve (same symmetric absmax quantizer)."""
    from coala_gnn.parallel.resident import encode_stage_rows

    import jax.numpy as jnp

    ds, store, _, _ = setup
    rows = ds.features[:64]
    q, scale = encode_stage_rows(rows, "int8")
    qq, ss = fc.quantize_rows(jnp.asarray(rows))
    np.testing.assert_array_equal(q, np.asarray(qq))
    np.testing.assert_allclose(scale, np.asarray(ss), rtol=1e-6)

    model = make_model("sage", hidden=16, num_classes=8, num_layers=2,
                       dropout=0.0)
    cfg = fc.CacheConfig(num_sets=8, ways=fc.WAYS, dim=32,
                         cache_dim=fc.round_cache_dim(32), num_colors=0)
    rt = ResidentTrainer(graph=ds.graph, host_fetch=store.fetch,
                         labels=ds.labels, cache_cfg=cfg, model=model,
                         tx=optax.adam(1e-2), fanouts=[5, 4], batch_size=32,
                         direct=False, stage_transport="int8")
    rng = np.random.default_rng(29)
    grids = np.stack([
        np.stack([rng.choice(ds.train_idx, 32, replace=False)
                  for _ in range(3)]) for _ in range(4)]).astype(np.int32)
    resolved = rt.resolve(rt.begin(grids[0, 0], jax.random.key(0)))
    params = model.init(jax.random.key(0), resolved[0], resolved[1])
    opt = rt.tx.init(params)
    params, opt, losses, _ = rt.train_windows(params, opt, grids,
                                              jax.random.key(1))
    larr = np.asarray(losses)
    assert np.isfinite(larr).all()
    assert larr[-3:].mean() < larr[:3].mean()


def test_degree_priorities_resist_scans(setup):
    """priorities="degree" keeps prewarmed hub lines resident through
    windows full of cold one-touch rows (scan resistance — the fix for the
    r2 capacity-pressure thrashing)."""
    ds, store, _, _ = setup
    model = make_model("sage", hidden=16, num_classes=8, num_layers=2,
                       dropout=0.0)
    cfg = fc.CacheConfig(num_sets=8, ways=fc.WAYS, dim=32,
                         cache_dim=fc.round_cache_dim(32), num_colors=0)
    rt = ResidentTrainer(graph=ds.graph, host_fetch=store.fetch,
                         labels=ds.labels, cache_cfg=cfg, model=model,
                         tx=optax.adam(1e-2), fanouts=[5, 4], batch_size=32,
                         direct=False, priorities="degree")
    deg = np.diff(ds.graph.indptr)
    hubs = np.argpartition(deg, -cfg.capacity)[-cfg.capacity:]
    rt.prewarm(hubs.astype(np.int32))
    import jax.numpy as jnp
    hit0 = np.asarray(fc.probe(cfg, rt.cache.base,
                               jnp.asarray(hubs.astype(np.int32)),
                               jnp.ones(hubs.size, bool)))
    resident0 = hit0.sum()
    assert resident0 > 0

    rng = np.random.default_rng(31)
    grids = np.stack([
        np.stack([rng.choice(ds.train_idx, 32, replace=False)
                  for _ in range(3)]) for _ in range(4)]).astype(np.int32)
    resolved = rt.resolve(rt.begin(grids[0, 0], jax.random.key(0)))
    params = model.init(jax.random.key(0), resolved[0], resolved[1])
    opt = rt.tx.init(params)
    rt.train_windows(params, opt, grids, jax.random.key(1))

    hit1 = np.asarray(fc.probe(cfg, rt.cache.base,
                               jnp.asarray(hubs.astype(np.int32)),
                               jnp.ones(hubs.size, bool)))
    # a hub line may only be displaced by a HIGHER-degree hub, never by the
    # cold scan: residency of the hub set must not shrink
    assert hit1.sum() >= resident0


def test_staged_overlap_matches_serial_schedule(setup):
    """The overlapped staged schedule (probe w+1 before window w +
    evicted-row patching, r3) must train EXACTLY like the serial schedule
    (probe after insert): both are exact at any hit ratio, so losses are
    bitwise-equal even though their stage contents differ (the overlap
    probe runs on pre-insert state and stages a superset). The replay
    safety net must fire in neither."""
    ds, store, _, _ = setup
    model = make_model("sage", hidden=16, num_classes=8, num_layers=2,
                       dropout=0.0)

    def mk(overlap):
        cfg = fc.CacheConfig(num_sets=8, ways=fc.WAYS, dim=32,
                             cache_dim=fc.round_cache_dim(32), num_colors=0)
        return ResidentTrainer(graph=ds.graph, host_fetch=store.fetch,
                               labels=ds.labels, cache_cfg=cfg, model=model,
                               tx=optax.adam(1e-2), fanouts=[5, 4],
                               batch_size=32, direct=False,
                               stage_overlap=overlap)

    rng = np.random.default_rng(31)
    M, K = 4, 3
    grids = np.stack([
        np.stack([rng.choice(ds.train_idx, 32, replace=False)
                  for _ in range(K)]) for _ in range(M)]).astype(np.int32)

    def run(rt):
        assert rt.cache_cfg.capacity < ds.graph.num_nodes
        rt.prewarm(np.arange(rt.cache_cfg.capacity))
        resolved = rt.resolve(rt.begin(grids[0, 0], jax.random.key(0)))
        params = model.init(jax.random.key(0), resolved[0], resolved[1])
        opt = rt.tx.init(params)
        rt.stats()
        out = rt.train_windows(params, opt, grids, jax.random.key(5))
        s = rt.stats()
        assert s["misses"] > 0                       # pressure was real
        assert "replay" not in rt.timers.totals      # exactness held
        return np.asarray(out[2])

    np.testing.assert_array_equal(run(mk(True)), run(mk(False)))


def test_staged_overlap_with_priorities(setup):
    """Overlap + degree-priority admission (the bench pressure config):
    the evict-reporting insert must thread priorities, stay exact, and
    never trip the replay net."""
    ds, store, _, _ = setup
    model = make_model("sage", hidden=16, num_classes=8, num_layers=2,
                       dropout=0.0)
    cfg = fc.CacheConfig(num_sets=8, ways=fc.WAYS, dim=32,
                         cache_dim=fc.round_cache_dim(32), num_colors=0)
    rt = ResidentTrainer(graph=ds.graph, host_fetch=store.fetch,
                         labels=ds.labels, cache_cfg=cfg, model=model,
                         tx=optax.adam(1e-2), fanouts=[5, 4], batch_size=32,
                         direct=False, priorities="degree",
                         stage_transport="int8", stage_overlap=True)
    rt.prewarm(np.arange(rt.cache_cfg.capacity))
    rng = np.random.default_rng(7)
    grids = np.stack([
        np.stack([rng.choice(ds.train_idx, 32, replace=False)
                  for _ in range(3)]) for _ in range(3)]).astype(np.int32)
    resolved = rt.resolve(rt.begin(grids[0, 0], jax.random.key(0)))
    params = model.init(jax.random.key(0), resolved[0], resolved[1])
    opt = rt.tx.init(params)
    rt.stats()
    params, opt, losses, edges = rt.train_windows(params, opt, grids,
                                                  jax.random.key(5))
    assert np.isfinite(np.asarray(losses)).all()
    assert "replay" not in rt.timers.totals
    s = rt.stats()
    assert s["misses"] > 0


def test_staged_windows_bf16_transport_trains(setup):
    """bf16 stage transport on the single-device trainer (the bench's
    pressure_bf16_transport block): near-f32 fidelity at half the upload."""
    ds, store, _, _ = setup
    model = make_model("sage", hidden=16, num_classes=8, num_layers=2,
                       dropout=0.0)
    cfg = fc.CacheConfig(num_sets=8, ways=fc.WAYS, dim=32,
                         cache_dim=fc.round_cache_dim(32), num_colors=0)
    rt = ResidentTrainer(graph=ds.graph, host_fetch=store.fetch,
                         labels=ds.labels, cache_cfg=cfg, model=model,
                         tx=optax.adam(1e-2), fanouts=[5, 4], batch_size=32,
                         direct=False, stage_transport="bfloat16")
    rt.prewarm(np.arange(rt.cache_cfg.capacity))
    rng = np.random.default_rng(13)
    grids = np.stack([
        np.stack([rng.choice(ds.train_idx, 32, replace=False)
                  for _ in range(3)]) for _ in range(3)]).astype(np.int32)
    resolved = rt.resolve(rt.begin(grids[0, 0], jax.random.key(0)))
    params = model.init(jax.random.key(0), resolved[0], resolved[1])
    opt = rt.tx.init(params)
    rt.stats()
    params, opt, losses, edges = rt.train_windows(params, opt, grids,
                                                  jax.random.key(5))
    losses = np.asarray(losses)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]            # learning through bf16 stages
    assert "replay" not in rt.timers.totals
    assert rt.stats()["misses"] > 0


def test_rbg_rng_impl_trains_and_is_deterministic(setup):
    """utils/rng.wrap_key_any threads the PRNG impl through the fused
    window's raw key_data scan: an rbg root key must run the whole
    sample+lookup+train path (different stream, same distribution) and be
    bit-reproducible across dispatches. The threefry default elsewhere in
    this file is the parity-pinned stream; rbg is the measurement-gated
    perf knob (BENCH_RNG_IMPL / --rng_impl)."""
    ds, store, rt, model = setup
    rt.prewarm(np.arange(ds.graph.num_nodes))
    rng = np.random.default_rng(11)
    grid = np.stack([rng.choice(ds.train_idx, 32, replace=False)
                     for _ in range(4)]).astype(np.int32)
    root = jax.random.key(7, impl="rbg")
    resolved = rt.resolve(rt.begin(grid[0], root))
    params = model.init(jax.random.key(0), resolved[0], resolved[1])
    opt = rt.tx.init(params)

    p1, _, losses1, edges1 = rt.train_window(params, opt, grid, root)
    losses1 = np.asarray(losses1)
    assert np.isfinite(losses1).all() and (np.asarray(edges1) > 0).all()

    p2, _, losses2, _ = rt.train_window(params, opt, grid, root)
    np.testing.assert_array_equal(losses1, np.asarray(losses2))
    l1 = jax.tree_util.tree_leaves(p1)
    for a, b in zip(l1, jax.tree_util.tree_leaves(p2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # and the stream really is different from threefry's at the same seed
    _, _, losses3, _ = rt.train_window(params, opt, grid, jax.random.key(7))
    assert not np.array_equal(losses1, np.asarray(losses3))
