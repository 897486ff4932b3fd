"""Sharded cache exchange on the 8-device virtual CPU mesh."""

import numpy as np
import jax
import pytest

from coala_gnn.cache import feature_cache as fc
from coala_gnn.cache.host_tier import HostFeatureStore
from coala_gnn.parallel.mesh import make_mesh
from coala_gnn.parallel.sharded_cache import ShardedFeatureCache


N_NODES, DIM = 5000, 16


@pytest.fixture(scope="module")
def store(request):
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(N_NODES, DIM)).astype(np.float32)
    return HostFeatureStore(feats)


GROUP = 4   # node_local: emulate 2 hosts x 4 devices on the 8-device mesh


def make_cache(mode, num_colors=0):
    mesh = make_mesh()
    n_dev = mesh.devices.size
    shards = {"sharded": n_dev, "isolated": 1,
              "node_local": min(GROUP, n_dev)}[mode]
    cfg = fc.CacheConfig(num_sets=8, ways=fc.WAYS, dim=DIM,
                         cache_dim=fc.round_cache_dim(DIM),
                         num_colors=num_colors, num_shards=shards)
    kw = {"group_size": min(GROUP, n_dev)} if mode == "node_local" else {}
    return ShardedFeatureCache(cfg=cfg, mesh=mesh, mode=mode, **kw), mesh


def _request(rng, n_dev, n_req, n_valid):
    ids = np.zeros((n_dev, n_req), dtype=np.int32)
    num_valid = np.full(n_dev, n_valid, dtype=np.int32)
    for d in range(n_dev):
        ids[d, :n_valid] = rng.choice(N_NODES, size=n_valid, replace=False)
    return ids, num_valid


@pytest.mark.parametrize("mode", ["sharded", "isolated", "node_local"])
def test_fetch_returns_correct_features(store, mode):
    cache, mesh = make_cache(mode)
    n_dev = mesh.devices.size
    rng = np.random.default_rng(1)
    ids, num_valid = _request(rng, n_dev, 64, 50)
    feats = np.asarray(cache.fetch(ids, num_valid, store.fetch))
    assert feats.shape == (n_dev, 64, DIM)
    for d in range(n_dev):
        np.testing.assert_allclose(feats[d, :50], store.features[ids[d, :50]],
                                   rtol=1e-6)
        np.testing.assert_array_equal(feats[d, 50:], 0)


@pytest.mark.parametrize("mode", ["sharded", "isolated", "node_local"])
def test_cache_hits_on_refetch(store, mode):
    cache, mesh = make_cache(mode)
    n_dev = mesh.devices.size
    rng = np.random.default_rng(2)
    ids, num_valid = _request(rng, n_dev, 32, 32)
    cache.fetch(ids, num_valid, store.fetch)
    s1 = cache.stats()
    assert s1["hits"] == 0 and s1["misses"] == n_dev * 32

    feats = np.asarray(cache.fetch(ids, num_valid, store.fetch))
    s2 = cache.stats()
    assert s2["hits"] > 0
    for d in range(n_dev):
        np.testing.assert_allclose(feats[d], store.features[ids[d]], rtol=1e-6)
    if mode in ("sharded", "node_local"):
        # every request was filled into its owner shard on round 1
        # (node_local: the owner within the requester's OWN group)
        assert s2["hit_ratio"] == 1.0


def test_sharded_cache_shares_capacity_across_devices(store):
    """In sharded mode a row cached by one requester serves all devices."""
    cache, mesh = make_cache("sharded")
    n_dev = mesh.devices.size
    if n_dev < 2:
        pytest.skip("needs multi-device mesh")
    ids = np.zeros((n_dev, 16), dtype=np.int32)
    num_valid = np.zeros(n_dev, dtype=np.int32)
    # only device 0 requests rows 100..115
    ids[0, :] = np.arange(100, 116)
    num_valid[0] = 16
    cache.fetch(ids, num_valid, store.fetch)
    cache.stats()

    # now EVERY device requests the same rows -> all hits (served remotely)
    ids2 = np.tile(np.arange(100, 116, dtype=np.int32), (n_dev, 1))
    nv2 = np.full(n_dev, 16, dtype=np.int32)
    feats = np.asarray(cache.fetch(ids2, nv2, store.fetch, fill=False))
    s = cache.stats()
    assert s["hits"] == n_dev * 16
    assert s["misses"] == 0
    for d in range(n_dev):
        np.testing.assert_allclose(feats[d], store.features[100:116], rtol=1e-6)


def test_isolated_cache_is_private(store):
    cache, mesh = make_cache("isolated")
    n_dev = mesh.devices.size
    if n_dev < 2:
        pytest.skip("needs multi-device mesh")
    ids = np.zeros((n_dev, 16), dtype=np.int32)
    num_valid = np.zeros(n_dev, dtype=np.int32)
    ids[0, :] = np.arange(200, 216)
    num_valid[0] = 16
    cache.fetch(ids, num_valid, store.fetch)
    cache.stats()
    # other devices requesting the same ids MISS (no sharing)
    ids2 = np.tile(np.arange(200, 216, dtype=np.int32), (n_dev, 1))
    nv2 = np.full(n_dev, 16, dtype=np.int32)
    cache.fetch(ids2, nv2, store.fetch, fill=False)
    s = cache.stats()
    assert s["hits"] == 16            # only device 0 hits
    assert s["misses"] == (n_dev - 1) * 16


def test_node_local_scopes_residency_to_the_group(store):
    """node_local parity with the reference's NVSHMEM-world-per-node
    scoping (nvshmem_manager.cuh:15-28): a row fetched by one group is
    shared WITHIN that group (any member hits) but never crosses groups —
    the other group misses and must fill its own copy. Features never
    move between groups; only this control metadata would cross hosts."""
    cache, mesh = make_cache("node_local")
    n_dev = mesh.devices.size
    if n_dev < 2 * GROUP:
        pytest.skip("needs 2 groups")
    ids = np.zeros((n_dev, 16), dtype=np.int32)
    num_valid = np.zeros(n_dev, dtype=np.int32)
    # only device 0 (group 0) requests rows 300..315
    ids[0, :] = np.arange(300, 316)
    num_valid[0] = 16
    cache.fetch(ids, num_valid, store.fetch)
    cache.stats()

    # every device requests the same rows: group-0 members all hit
    # (intra-group sharing), group-1 members all miss (no cross-group leak)
    ids2 = np.tile(np.arange(300, 316, dtype=np.int32), (n_dev, 1))
    nv2 = np.full(n_dev, 16, dtype=np.int32)
    feats = np.asarray(cache.fetch(ids2, nv2, store.fetch, fill=False))
    s = cache.stats()
    assert s["hits"] == GROUP * 16
    assert s["misses"] == (n_dev - GROUP) * 16
    for d in range(n_dev):      # host fallback keeps every output exact
        np.testing.assert_allclose(feats[d], store.features[300:316],
                                   rtol=1e-6)


def test_node_local_prewarm_warms_every_group(store):
    """prewarm partitions ids within each group: afterwards BOTH groups
    serve the warm set entirely from their own host's devices."""
    cache, mesh = make_cache("node_local")
    n_dev = mesh.devices.size
    rng = np.random.default_rng(9)
    warm = rng.choice(N_NODES, size=500, replace=False).astype(np.int32)
    cache.prewarm(warm, store.fetch)
    ids = np.stack([rng.choice(warm, size=32, replace=False)
                    for _ in range(n_dev)]).astype(np.int32)
    nv = np.full(n_dev, 32, np.int32)
    feats = np.asarray(cache.fetch(ids, nv, store.fetch, fill=False))
    s = cache.stats()
    assert s["hit_ratio"] == 1.0
    for d in range(n_dev):
        np.testing.assert_allclose(feats[d], store.features[ids[d]],
                                   rtol=1e-6)


def test_pipelined_begin_complete_matches_sync(store):
    """fetch_begin/fetch_complete one-batch-ahead pipelining returns the
    same features as the synchronous path."""
    cache, mesh = make_cache("sharded")
    n_dev = mesh.devices.size
    rng = np.random.default_rng(7)
    batches = [_request(rng, n_dev, 32, 30) for _ in range(4)]

    handles = []
    outs = []
    pending = None
    for ids, nv in batches:
        h = cache.fetch_begin(ids, nv)
        if pending is not None:
            outs.append(np.asarray(cache.fetch_complete(pending, store.fetch)))
        pending = h
    outs.append(np.asarray(cache.fetch_complete(pending, store.fetch)))

    for (ids, nv), feats in zip(batches, outs):
        for d in range(n_dev):
            np.testing.assert_allclose(feats[d, :30], store.features[ids[d, :30]],
                                       rtol=1e-6)


def test_color_meta_aggregation(store):
    num_colors = 6
    cache, mesh = make_cache("sharded", num_colors=num_colors)
    n_dev = mesh.devices.size
    rng = np.random.default_rng(3)
    colors = rng.integers(1, num_colors + 1, size=N_NODES).astype(np.int64)
    ids, num_valid = _request(rng, n_dev, 32, 32)
    cache.fetch(ids, num_valid, store.fetch, colors=colors)
    meta = cache.color_meta()
    assert meta.shape == (num_colors + 1,)
    assert meta[0] == 0
    # every distinct inserted id is tracked exactly once
    uniq = np.unique(ids.reshape(-1))
    assert meta.sum() == len(uniq)
    # counts match the color histogram of the cached ids
    want = np.bincount(colors[uniq], minlength=num_colors + 1)
    np.testing.assert_array_equal(meta, want)


def test_int8_response_exchange_matches_f32_response():
    """Quantized caches ship int8 lines + scales through the two-phase
    all_to_all and dequantize at the requester (this
    replaces the reference's raw-page response put, nvshmem_cache.h:381-385
    at ~3.9x less interconnect traffic). Dequantize is elementwise, so the int8
    response must equal the dequant-at-owner f32 response BITWISE, and
    both must match the host truth within quantization error."""
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    from coala_gnn.parallel.mesh import DATA_AXIS
    from coala_gnn.parallel.sharded_cache import (_to_local,
                                                      exchange_lookup)

    rng = np.random.default_rng(11)
    feats = rng.normal(size=(N_NODES, DIM)).astype(np.float32)
    qstore = HostFeatureStore(feats)
    mesh = make_mesh()
    n_dev = mesh.devices.size
    cfg = fc.CacheConfig(num_sets=32, ways=fc.WAYS, dim=DIM,
                         cache_dim=fc.round_cache_dim(DIM), num_colors=0,
                         num_shards=n_dev, quantize=True)
    cache = ShardedFeatureCache(cfg=cfg, mesh=mesh, mode="sharded")
    warm = rng.choice(N_NODES, size=2000, replace=False).astype(np.int32)
    cache.prewarm(warm, qstore.fetch)

    n_req = 64
    ids = np.stack([rng.choice(warm, size=n_req, replace=False)
                    for _ in range(n_dev)]).astype(np.int32)
    state_specs = jax.tree.map(lambda _: P(DATA_AXIS), cache.state)

    def body(state, ids, int8_response):
        local = _to_local(state)
        _, out, hit, ovf = exchange_lookup(cfg, n_req, n_dev, local,
                                           ids[0], ids[0] >= 0,
                                           int8_response=int8_response)
        return out[None], hit[None]

    def run(int8_response):
        k = jax.jit(shard_map(
            lambda s, i: body(s, i, int8_response), mesh=mesh,
            in_specs=(state_specs, P(DATA_AXIS)),
            out_specs=(P(DATA_AXIS), P(DATA_AXIS)), check_vma=False))
        sh = NamedSharding(mesh, P(DATA_AXIS))
        out, hit = k(cache.state, jax.device_put(ids, sh))
        return np.asarray(out), np.asarray(hit)

    out8, hit8 = run(True)
    out32, hit32 = run(False)
    np.testing.assert_array_equal(hit8, hit32)
    assert hit8.all()                      # all requested ids were warm
    np.testing.assert_array_equal(out8, out32)   # bitwise-identical
    # and both match the host truth within symmetric-int8 error
    want = feats[ids]
    err = np.abs(out8 - want).max()
    scale = np.abs(want).max(axis=-1).max()
    assert err <= scale / 127 + 1e-6


@pytest.mark.parametrize("mode", ["sharded", "isolated"])
def test_insert_rows_reports_evicted(mode):
    """insert_rows(return_evicted=True): the replicated evicted-id arrays
    name exactly the resident lines the insert displaced (the overlapped
    staged schedule's patch source), in both routing modes. In isolated
    mode every device holds identical state, so the all_gathered report
    contains n_dev copies that dedup to one set."""
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(N_NODES, DIM)).astype(np.float32)
    mesh = make_mesh()
    n_dev = mesh.devices.size
    cfg = fc.CacheConfig(num_sets=4, ways=fc.WAYS, dim=DIM,
                         cache_dim=fc.round_cache_dim(DIM), num_colors=0,
                         num_shards=n_dev)
    cache = ShardedFeatureCache(cfg=cfg, mesh=mesh, mode=mode)
    store = HostFeatureStore(feats)
    warm = np.arange(4 * fc.WAYS * n_dev, dtype=np.int32)  # fill every set
    cache.prewarm(warm, store.fetch)

    new_ids = (warm.max() + 1 + np.arange(64)).astype(np.int32)
    handles = cache.insert_rows(new_ids, feats[new_ids],
                                return_evicted=True)
    assert handles
    ev = np.concatenate([np.asarray(h).ravel() for h in handles])
    ev = np.unique(ev[ev >= 0])
    assert ev.size > 0                       # full sets -> evictions
    assert np.isin(ev, warm).all()           # victims were resident lines
    assert not np.isin(ev, new_ids).any()    # never the inserted ids
