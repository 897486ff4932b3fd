import numpy as np
import jax
import jax.numpy as jnp
import pytest

from coala_gnn.cache import feature_cache as fc
from coala_gnn.cache.host_tier import HostFeatureStore


def small_cfg(dim=16, num_sets=4, num_colors=0, num_shards=1):
    return fc.CacheConfig(num_sets=num_sets, ways=fc.WAYS, dim=dim,
                          cache_dim=fc.round_cache_dim(dim),
                          num_colors=num_colors, num_shards=num_shards)


def test_geometry_parity():
    # cache_dim rounding {128,256,512,1024} (ssd_gnn_cache.cuh:34-47)
    assert fc.round_cache_dim(100) == 128
    assert fc.round_cache_dim(128) == 128
    assert fc.round_cache_dim(129) == 256
    assert fc.round_cache_dim(1024) == 1024
    assert fc.round_cache_dim(1500) == 1536
    # num_sets = MB*2^20/page/32 (ssd_gnn_cache.cuh:96-97), ways=32
    cfg = fc.make_config(cache_mb=4, dim=128, num_colors=0)
    assert cfg.ways == 32
    assert cfg.num_sets == 4 * 2**20 // (128 * 4) // 32
    assert cfg.capacity == cfg.num_sets * 32


def test_miss_then_hit_roundtrip(rng):
    cfg = small_cfg()
    state = fc.init_state(cfg)
    ids = jnp.asarray(np.arange(10, dtype=np.int32))
    valid = jnp.ones(10, dtype=bool)
    feats = jnp.asarray(rng.normal(size=(10, cfg.dim)).astype(np.float32))

    state, out, hit = fc.lookup(cfg, state, ids, valid)
    assert not bool(hit.any())
    np.testing.assert_array_equal(np.asarray(out), 0)

    state = fc.insert(cfg, state, ids, feats, valid)
    state, out, hit = fc.lookup(cfg, state, ids, valid)
    assert bool(hit.all())
    np.testing.assert_allclose(np.asarray(out), np.asarray(feats), rtol=1e-6)

    state, s = fc.stats(state)
    assert s["hits"] == 10 and s["misses"] == 10 and s["hit_ratio"] == 0.5
    _, s2 = fc.stats(state)
    assert s2["hits"] == 0  # reset-on-read parity


def test_insert_same_set_claims_distinct_ways(rng):
    cfg = small_cfg(num_sets=2)
    state = fc.init_state(cfg)
    # ids 0,2,4,...: all map to set 0 (id % 2)
    ids = jnp.asarray((np.arange(8) * 2).astype(np.int32))
    feats = jnp.asarray(rng.normal(size=(8, cfg.dim)).astype(np.float32))
    state = fc.insert(cfg, state, ids, feats, jnp.ones(8, bool))
    state, out, hit = fc.lookup(cfg, state, ids, jnp.ones(8, bool))
    assert bool(hit.all())  # no slot collision lost a line
    np.testing.assert_allclose(np.asarray(out), np.asarray(feats), rtol=1e-6)


def test_round_robin_eviction(rng):
    cfg = small_cfg(num_sets=1)  # one set, 32 ways
    state = fc.init_state(cfg)
    n = cfg.ways + 8
    ids = jnp.asarray(np.arange(n, dtype=np.int32))
    feats = jnp.asarray(rng.normal(size=(n, cfg.dim)).astype(np.float32))
    # fill 32 ways, then 8 more evict the first 8 round-robin
    state = fc.insert(cfg, state, ids[: cfg.ways], feats[: cfg.ways],
                      jnp.ones(cfg.ways, bool))
    state = fc.insert(cfg, state, ids[cfg.ways:], feats[cfg.ways:],
                      jnp.ones(8, bool))
    state, _, hit = fc.lookup(cfg, state, ids, jnp.ones(n, bool))
    hit = np.asarray(hit)
    assert not hit[:8].any()      # evicted (rr from cursor 0)
    assert hit[8:].all()          # survivors + new lines


def test_refresh_does_not_duplicate(rng):
    cfg = small_cfg(num_sets=2)
    state = fc.init_state(cfg)
    ids = jnp.asarray(np.array([4, 6], dtype=np.int32))
    f1 = jnp.asarray(rng.normal(size=(2, cfg.dim)).astype(np.float32))
    f2 = jnp.asarray(rng.normal(size=(2, cfg.dim)).astype(np.float32))
    state = fc.insert(cfg, state, ids, f1, jnp.ones(2, bool))
    state = fc.insert(cfg, state, ids, f2, jnp.ones(2, bool))  # refresh in place
    tags = np.asarray(state.tags)
    assert (tags == 4).sum() == 1 and (tags == 6).sum() == 1
    state, out, hit = fc.lookup(cfg, state, ids, jnp.ones(2, bool))
    np.testing.assert_allclose(np.asarray(out), np.asarray(f2), rtol=1e-6)


def test_color_occupancy_tracking(rng):
    cfg = small_cfg(num_sets=1, num_colors=5)
    cs = fc.init_colored_state(cfg)
    ids = jnp.asarray(np.arange(cfg.ways, dtype=np.int32))
    feats = jnp.zeros((cfg.ways, cfg.dim), jnp.float32)
    colors = jnp.asarray((np.arange(cfg.ways) % 5 + 1).astype(np.int32))
    cs = fc.insert_with_colors(cfg, cs, ids, feats, jnp.ones(cfg.ways, bool), colors)
    counts = np.asarray(cs.base.color_counts)
    # 32 lines over colors 1..5: 7,7,6,6,6 in insertion pattern (32%5=2)
    assert counts.sum() == cfg.ways
    np.testing.assert_array_equal(counts[1:], [7, 7, 6, 6, 6])

    # evicting decrements the victim's color and increments the new one
    new_ids = jnp.asarray(np.arange(100, 104, dtype=np.int32))
    new_colors = jnp.asarray(np.full(4, 5, dtype=np.int32))
    cs = fc.insert_with_colors(cfg, cs, new_ids, jnp.zeros((4, cfg.dim)),
                               jnp.ones(4, bool), new_colors)
    counts2 = np.asarray(cs.base.color_counts)
    assert counts2.sum() == cfg.ways  # occupancy conserved
    assert counts2[5] == 6 + 4       # four new color-5 lines
    np.testing.assert_array_equal(counts2[1:3], [6, 6])  # victims were colors 1,2


def test_invalid_rows_dropped(rng):
    cfg = small_cfg()
    state = fc.init_state(cfg)
    ids = jnp.asarray(np.array([1, 2, 3], dtype=np.int32))
    valid = jnp.asarray(np.array([True, False, True]))
    feats = jnp.asarray(rng.normal(size=(3, cfg.dim)).astype(np.float32))
    state = fc.insert(cfg, state, ids, feats, valid)
    state, _, hit = fc.lookup(cfg, state, ids, jnp.ones(3, bool))
    np.testing.assert_array_equal(np.asarray(hit), [True, False, True])


def test_host_tier_gather_and_async(rng):
    feats = rng.normal(size=(100, 8)).astype(np.float32)
    store = HostFeatureStore(feats)
    ids = np.array([3, 7, -1, 99])
    out = store.fetch(ids)
    np.testing.assert_allclose(out[[0, 1, 3]], feats[[3, 7, 99]])
    np.testing.assert_array_equal(out[2], 0)
    fut = store.fetch_async(ids)
    np.testing.assert_allclose(fut.result(), out)


def test_refresh_clobbered_by_new_arrival_is_consistent(rng):
    """A same-batch (refresh, new-insert) pair targeting one (set, way) must
    resolve to ONE writer: the new line wins, the refreshed id is evicted,
    and tags/data never diverge."""
    cfg = fc.CacheConfig(num_sets=1, ways=2, dim=4, cache_dim=128,
                         num_colors=4)
    st = fc.init_colored_state(cfg)
    feats = np.arange(5 * 4, dtype=np.float32).reshape(5, 4) + 1

    def ins(st, ids, colors):
        ids = np.asarray(ids, np.int32)
        return fc.insert_with_colors(
            cfg, st, jnp.asarray(ids), jnp.asarray(feats[ids]),
            jnp.ones(len(ids), bool), jnp.asarray(colors, dtype=jnp.int32))

    st = ins(st, [0], [1])                     # id 0 -> way 0, rr -> 1
    # batch: refresh id 0 (way 0) + new ids 1, 2 (ways 1, 0): id 2's claim
    # of way 0 collides with the refresh of id 0 -> id 0 must be evicted.
    st = ins(st, [0, 1, 2], [1, 2, 3])
    tags = np.asarray(st.base.tags)[0]
    data = np.asarray(st.base.data)[0, :, :4]
    assert set(tags.tolist()) == {1, 2}
    for w in range(2):
        np.testing.assert_allclose(data[w], feats[tags[w]],
                                   err_msg=f"way {w} tag/data diverged")
    # color occupancy: id 0 (color 1) evicted; ids 1, 2 present
    cc = np.asarray(st.base.color_counts)
    assert cc[1] == 0 and cc[2] == 1 and cc[3] == 1


def test_insert_overflowing_set_keeps_first_ways_ranks(rng):
    """More new arrivals than ways in one batch: only `ways` survive and no
    (set, way) slot is written twice."""
    cfg = fc.CacheConfig(num_sets=1, ways=2, dim=4, cache_dim=128,
                         num_colors=0)
    st = fc.init_state(cfg)
    ids = np.arange(5, dtype=np.int32)
    feats = rng.normal(size=(5, 4)).astype(np.float32)
    st = fc.insert(cfg, st, jnp.asarray(ids), jnp.asarray(feats),
                   jnp.ones(5, bool))
    tags = np.asarray(st.tags)[0]
    data = np.asarray(st.data)[0, :, :4]
    assert (tags >= 0).all() and len(set(tags.tolist())) == 2
    for w in range(2):
        np.testing.assert_allclose(data[w], feats[tags[w]])


def test_quantized_flat_tier_roundtrip():
    """int8 flat tier: insert -> lookup reproduces rows within absmax/127
    per-row quantization error; capacity math counts 1-byte lines."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    N, D = 200, 32
    rows = (rng.standard_normal((N, D)) * rng.uniform(0.1, 10, (N, 1))
            ).astype(np.float32)
    cfg = fc.CacheConfig(num_sets=8, ways=fc.WAYS, dim=D,
                         cache_dim=fc.round_cache_dim(D), num_colors=0,
                         quantize=True)
    st = fc.flat_init(cfg, N)
    assert st.data.dtype == jnp.int8 and st.scale is not None

    ids = jnp.arange(N, dtype=jnp.int32)
    st = fc.flat_insert(cfg, st, ids, jnp.asarray(rows),
                        jnp.ones(N, bool), jnp.zeros(N, jnp.int32))
    st, feats, hit = fc.flat_lookup(st, ids, jnp.ones(N, bool))
    assert bool(hit.all())
    tol = (np.abs(rows).max(axis=1, keepdims=True) / 127) * 0.5 + 1e-7
    assert (np.abs(np.asarray(feats) - rows) <= tol + 1e-6).all()

    # quantized capacity: ~4x the f32 line count per MB
    c32 = fc.make_config(cache_mb=4, dim=128)
    cq = fc.make_config(cache_mb=4, dim=128, quantize=True)
    assert cq.capacity > 3.5 * c32.capacity


def test_quantized_resident_trains():
    """ResidentTrainer on the int8 flat tier: fused windows run and learn
    (quantization noise must not break convergence on separable data)."""
    import jax
    import optax
    from coala_gnn.graph.datasets import synthetic_graph
    from coala_gnn.cache.host_tier import HostFeatureStore
    from coala_gnn.models import make_model
    from coala_gnn.parallel.resident import ResidentTrainer

    ds = synthetic_graph(num_nodes=2000, avg_degree=8, feature_dim=16,
                         num_classes=4, seed=17)
    store = HostFeatureStore(ds.features)
    cfg = fc.make_config(cache_mb=8, dim=16, quantize=True)
    assert cfg.capacity >= 2000
    model = make_model("sage", hidden=16, num_classes=4, num_layers=2,
                       dropout=0.0)
    rt = ResidentTrainer(graph=ds.graph, host_fetch=store.fetch,
                         labels=ds.labels, cache_cfg=cfg, model=model,
                         tx=optax.adam(1e-2), fanouts=[4, 3], batch_size=32)
    assert rt.direct
    rt.prewarm(np.arange(2000, dtype=np.int32))

    rng = np.random.default_rng(0)
    resolved = rt.resolve(rt.begin(ds.train_idx[:32], jax.random.key(0)))
    import jax.numpy as jnp
    params = model.init(jax.random.key(1), resolved[0], resolved[1])
    opt_state = rt.tx.init(params)
    grids = np.stack([
        np.stack([rng.choice(ds.train_idx, 32, replace=False)
                  .astype(np.int32) for _ in range(4)]) for _ in range(4)])
    params, opt_state, losses, edges = rt.train_windows(
        params, opt_state, grids, jax.random.key(2))
    larr = np.asarray(losses)
    assert np.isfinite(larr).all()
    assert larr[-4:].mean() < larr[:4].mean()


def test_quantized_associative_roundtrip_and_eviction():
    """int8 set-associative lines: insert -> lookup dequantizes within
    per-row absmax/127 error; eviction rewrites both line and scale."""
    import jax.numpy as jnp

    rng = np.random.default_rng(9)
    cfg = fc.CacheConfig(num_sets=4, ways=fc.WAYS, dim=16,
                         cache_dim=fc.round_cache_dim(16), num_colors=0,
                         quantize=True)
    st = fc.init_state(cfg)
    assert st.data.dtype == jnp.int8 and st.scales is not None

    n = 64
    ids = jnp.arange(n, dtype=jnp.int32)
    rows = (rng.standard_normal((n, 16)) *
            rng.uniform(0.1, 20, (n, 1))).astype(np.float32)
    st = fc.insert(cfg, st, ids, jnp.asarray(rows), jnp.ones(n, bool))
    st, feats, hit = fc.lookup(cfg, st, ids, jnp.ones(n, bool))
    assert bool(hit.all())
    tol = np.abs(rows).max(axis=1, keepdims=True) / 127 * 0.5 + 1e-6
    assert (np.abs(np.asarray(feats) - rows) <= tol + 1e-6).all()

    # overwrite id 3's line with a much larger-magnitude row: the scale
    # must be rewritten too or dequant would be wildly off
    big = (rng.standard_normal((1, 16)) * 1000).astype(np.float32)
    st = fc.insert(cfg, st, jnp.asarray([3], jnp.int32), jnp.asarray(big),
                   jnp.ones(1, bool))
    st, feats, hit = fc.lookup(cfg, st, jnp.asarray([3], jnp.int32),
                               jnp.ones(1, bool))
    assert bool(hit.all())
    tol = np.abs(big).max() / 127 * 0.5 + 1e-6
    assert (np.abs(np.asarray(feats) - big) <= tol).all()


def test_quantized_sharded_cache_fetch():
    """Quantized lines through the full sharded exchange: prewarm + fetch
    reproduces host rows within quantization error on the 8-device mesh."""
    from coala_gnn.cache.host_tier import HostFeatureStore
    from coala_gnn.parallel.mesh import make_mesh
    from coala_gnn.parallel.sharded_cache import ShardedFeatureCache

    mesh8 = make_mesh()
    n_dev = mesh8.devices.size
    N, D = 2048, 32
    rng = np.random.default_rng(4)
    feats = (rng.standard_normal((N, D)) *
             rng.uniform(0.5, 5, (N, 1))).astype(np.float32)
    store = HostFeatureStore(feats)
    cfg = fc.make_config(cache_mb=4, dim=D, num_shards=n_dev, quantize=True)
    cache = ShardedFeatureCache(cfg=cfg, mesh=mesh8, mode="sharded")
    cache.prewarm(np.arange(N, dtype=np.int32), store.fetch)

    ids = rng.integers(0, N, size=(n_dev, 64)).astype(np.int32)
    num = np.full(n_dev, 64, np.int32)
    out = np.asarray(cache.fetch(ids, num, store.fetch))
    want = feats[ids]
    tol = np.abs(want).max(axis=-1, keepdims=True) / 127 * 0.5 + 1e-6
    assert (np.abs(out - want) <= tol).all()
    s = cache.stats()
    assert s["hit_ratio"] == 1.0


def test_priority_admission_protects_hubs(rng):
    """Priority-aware eviction: with line priorities
    tracked, a full set rejects lower-priority arrivals outright and a
    higher-priority arrival evicts the set's LOWEST-priority way — one-touch
    cold rows can never displace hub lines."""
    cfg = small_cfg(num_sets=1, num_colors=4)
    st = fc.init_colored_state(cfg, track_prio=True)
    n = cfg.ways
    hub_ids = jnp.asarray(np.arange(n, dtype=np.int32))
    feats = jnp.asarray(rng.normal(size=(n, cfg.dim)).astype(np.float32))
    hub_prio = jnp.asarray(np.arange(10.0, 10.0 + n, dtype=np.float32))
    colors = jnp.ones(n, jnp.int32)
    st = fc.insert_with_colors(cfg, st, hub_ids, feats, jnp.ones(n, bool),
                               colors, prios=hub_prio)
    assert int(st.base.color_counts[1]) == n

    # cold rows with prio below every resident line: all rejected
    cold_ids = jnp.asarray(np.arange(100, 100 + n, dtype=np.int32))
    st2 = fc.insert_with_colors(cfg, st, cold_ids, feats,
                                jnp.ones(n, bool),
                                2 * jnp.ones(n, jnp.int32),
                                prios=jnp.ones(n, jnp.float32))
    hit = fc.probe(cfg, st2.base, hub_ids, jnp.ones(n, bool))
    assert bool(hit.all()), "cold scan evicted a hub line"
    assert int(st2.base.color_counts[1]) == n      # occupancy untouched
    assert int(st2.base.color_counts[2]) == 0      # rejects not counted

    # one high-priority arrival evicts exactly the lowest-priority way
    vip = jnp.asarray(np.asarray([999], np.int32))
    st3 = fc.insert_with_colors(cfg, st2, vip, feats[:1],
                                jnp.ones(1, bool),
                                3 * jnp.ones(1, jnp.int32),
                                prios=jnp.asarray([1000.0], jnp.float32))
    assert bool(fc.probe(cfg, st3.base, vip, jnp.ones(1, bool)).all())
    hit3 = np.asarray(fc.probe(cfg, st3.base, hub_ids, jnp.ones(n, bool)))
    assert not hit3[0], "should have evicted the lowest-priority line"
    assert hit3[1:].all(), "evicted more than the lowest-priority line"
    assert int(st3.base.color_counts[1]) == n - 1  # victim decremented
    assert int(st3.base.color_counts[3]) == 1


def test_priority_admission_strongest_arrival_wins(rng):
    """When several arrivals target one set, ranks pair them by DESCENDING
    priority with ascending victims: the strongest arrival must get in even
    if listed last."""
    cfg = small_cfg(num_sets=1)
    st = fc.init_colored_state(cfg, track_prio=True)
    n = cfg.ways
    feats = jnp.asarray(rng.normal(size=(n, cfg.dim)).astype(np.float32))
    st = fc.insert_with_colors(cfg, st, jnp.arange(n, dtype=jnp.int32),
                               feats, jnp.ones(n, bool),
                               jnp.zeros(n, jnp.int32),
                               prios=5.0 * jnp.ones(n, jnp.float32))
    # arrivals: [weak, strong] — the strong one (listed second) outranks
    # every resident; the weak one outranks none
    ids = jnp.asarray(np.asarray([200, 201], np.int32))
    st2 = fc.insert_with_colors(cfg, st, ids, feats[:2], jnp.ones(2, bool),
                                jnp.zeros(2, jnp.int32),
                                prios=jnp.asarray([1.0, 99.0], jnp.float32))
    hit = np.asarray(fc.probe(cfg, st2.base, ids, jnp.ones(2, bool)))
    assert not hit[0] and hit[1]


def test_rr_parity_without_priorities(rng):
    """prios=None preserves the reference round-robin policy byte-for-byte
    (nvshmem_cache.h:200-212) even on a prio-tracking state."""
    cfg = small_cfg(num_sets=2)
    ids = jnp.asarray((np.arange(8) * 2).astype(np.int32))
    feats = jnp.asarray(rng.normal(size=(8, cfg.dim)).astype(np.float32))
    a = fc.insert_with_colors(cfg, fc.init_colored_state(cfg), ids, feats,
                              jnp.ones(8, bool), jnp.zeros(8, jnp.int32))
    b = fc.insert_with_colors(cfg, fc.init_colored_state(cfg,
                                                         track_prio=True),
                              ids, feats, jnp.ones(8, bool),
                              jnp.zeros(8, jnp.int32))
    np.testing.assert_array_equal(np.asarray(a.base.tags),
                                  np.asarray(b.base.tags))
    np.testing.assert_array_equal(np.asarray(a.base.rr),
                                  np.asarray(b.base.rr))


def test_prios_without_track_prio_raises(rng):
    """Passing prios to a state built without track_prio=True
    must fail loudly, not silently fall back to round-robin."""
    import pytest
    cfg = small_cfg(num_sets=2)
    ids = jnp.asarray(np.arange(4, dtype=np.int32))
    feats = jnp.asarray(rng.normal(size=(4, cfg.dim)).astype(np.float32))
    with pytest.raises(ValueError, match="track_prio"):
        fc.insert_with_colors(cfg, fc.init_colored_state(cfg), ids, feats,
                              jnp.ones(4, bool), jnp.zeros(4, jnp.int32),
                              prios=jnp.ones(4, jnp.float32))
