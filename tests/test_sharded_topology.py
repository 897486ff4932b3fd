"""Mesh-sharded topology: shard build, frontier-routed sampling parity
with the replicated device sampler, and end-to-end resident training."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from coala_gnn.graph.datasets import synthetic_graph
from coala_gnn.parallel.mesh import DATA_AXIS, make_mesh
from coala_gnn.sampling import sharded_topology as st
from coala_gnn.sampling.device_sampler import to_device_graph


@pytest.fixture(scope="module")
def mesh():
    return make_mesh()


def _csc_neighbors(graph, v):
    s, e = int(graph.indptr[v]), int(graph.indptr[v + 1])
    return set(np.asarray(graph.indices[s:e]).tolist())


def test_shard_build_partitions_edges():
    ds = synthetic_graph(num_nodes=501, avg_degree=7, feature_dim=4,
                         num_classes=3, seed=0)
    n_dev = 8
    ptrs, idx, et = st.shard_topology_arrays(ds.graph, n_dev)
    rows = -(-501 // n_dev)
    assert ptrs.shape == (n_dev, rows + 1)
    assert et is None
    total = 0
    for d in range(n_dev):
        own = np.arange(d, 501, n_dev)
        deg = np.asarray(ds.graph.indptr)[own + 1] - \
            np.asarray(ds.graph.indptr)[own]
        # local offsets reproduce each owned node's degree
        ldeg = ptrs[d, 1:own.size + 1] - ptrs[d, :own.size]
        np.testing.assert_array_equal(ldeg, deg)
        total += int(deg.sum())
        # local adjacency content matches the global CSC slice per node
        for v in own[:5]:
            li = v // n_dev
            got = set(idx[d, ptrs[d, li]:ptrs[d, li + 1]].tolist())
            assert got == _csc_neighbors(ds.graph, int(v))
    assert total == ds.graph.num_edges
    # sharded, not replicated: every shard holds ~E/n_dev edges
    assert idx.shape[1] < ds.graph.num_edges


def _run_sharded_layer(mesh, graph, dst_grid, fanout, key):
    """shard_map one _sample_layer_sharded call; returns global [n_dev, n, f]
    neighbor/mask grids."""
    n_dev = mesh.devices.size
    topo = st.put_sharded_topology(graph, mesh)
    specs = jax.tree.map(lambda _: P(DATA_AXIS, None), topo)
    N = graph.num_nodes

    def body(topo, dst):
        nbr, mask, _ = st._sample_layer_sharded(
            topo.indptr[0], topo.indices[0], None, dst[0], fanout,
            jax.random.fold_in(key, jax.lax.axis_index(DATA_AXIS)),
            n_dev, N)
        return nbr[None], mask[None]

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(specs, P(DATA_AXIS)),
                           out_specs=(P(DATA_AXIS), P(DATA_AXIS)),
                           check_vma=False))
    dst_dev = jax.device_put(dst_grid,
                             NamedSharding(mesh, P(DATA_AXIS, None)))
    nbr, mask = fn(topo, dst_dev)
    return np.asarray(nbr), np.asarray(mask)


def test_sharded_layer_full_fanout_exact(mesh):
    """fanout >= max degree: slots are deterministic (sequential take-all),
    so the sharded route must reproduce each node's exact adjacency list."""
    ds = synthetic_graph(num_nodes=300, avg_degree=5, feature_dim=4,
                         num_classes=3, seed=1)
    g = ds.graph
    deg = np.asarray(g.indptr[1:]) - np.asarray(g.indptr[:-1])
    fanout = int(deg.max())
    n_dev = mesh.devices.size
    rng = np.random.default_rng(0)
    dst = rng.integers(0, 300, size=(n_dev, 16)).astype(np.int32)
    # include sentinel padding rows
    dst[:, -2:] = 300
    nbr, mask = _run_sharded_layer(mesh, g, dst, fanout, jax.random.key(7))
    for d in range(n_dev):
        for i, v in enumerate(dst[d]):
            m = mask[d, i].astype(bool)
            if v == 300:                       # sentinel: degree 0
                assert not m.any()
                continue
            got = set(nbr[d, i][m].tolist())
            assert got == _csc_neighbors(g, int(v))
            assert int(m.sum()) == deg[v]
            # masked slots point at dst (self), matching _sample_layer
            assert (nbr[d, i][~m] == v).all()


def test_sharded_layer_sampled_slots_are_neighbors(mesh):
    """fanout < degree: every unmasked slot must hold a true neighbor of
    its dst node (uniform-with-replacement draws at the owner)."""
    ds = synthetic_graph(num_nodes=400, avg_degree=12, feature_dim=4,
                         num_classes=3, seed=2)
    n_dev = mesh.devices.size
    rng = np.random.default_rng(1)
    dst = rng.integers(0, 400, size=(n_dev, 8)).astype(np.int32)
    nbr, mask = _run_sharded_layer(mesh, ds.graph, dst, 3, jax.random.key(3))
    deg = np.asarray(ds.graph.indptr[1:]) - np.asarray(ds.graph.indptr[:-1])
    for d in range(n_dev):
        for i, v in enumerate(dst[d]):
            m = mask[d, i].astype(bool)
            assert int(m.sum()) == min(int(deg[v]), 3)
            allowed = _csc_neighbors(ds.graph, int(v))
            assert set(nbr[d, i][m].tolist()) <= allowed


def test_resident_trainer_shard_topology_trains(mesh):
    """End-to-end: ShardedResidentTrainer(shard_topology=True) learns on
    the 8-device mesh and the fused-window path runs."""
    import coala_gnn.cache.feature_cache as fc
    from coala_gnn.cache.host_tier import HostFeatureStore
    from coala_gnn.models import make_model
    from coala_gnn.parallel.sharded_cache import ShardedFeatureCache
    from coala_gnn.parallel.sharded_resident import (
        ShardedResidentTrainer)

    n_dev = mesh.devices.size
    ds = synthetic_graph(num_nodes=4000, avg_degree=8, feature_dim=16,
                         num_classes=4, seed=5)
    store = HostFeatureStore(ds.features)
    cfg = fc.make_config(cache_mb=4, dim=16, num_shards=n_dev)
    cache = ShardedFeatureCache(cfg=cfg, mesh=mesh, mode="sharded")
    model = make_model("sage", hidden=16, num_classes=4, num_layers=2,
                       dropout=0.0)
    B = 16
    rt = ShardedResidentTrainer(
        graph=ds.graph, host_fetch=store.fetch, labels=ds.labels,
        cache=cache, model=model, tx=optax.adam(1e-2), fanouts=[4, 3],
        batch_size=B, shard_topology=True)
    assert rt.shard_topology
    # per-device topology shard is ~E/n_dev, not E
    assert rt._g.indices.shape[1] < ds.graph.num_edges

    key = jax.random.key(0)
    rng = np.random.default_rng(0)
    grid = rng.permutation(4000)[:n_dev * B].reshape(n_dev, B) \
        .astype(np.int32)
    handle = rt.begin(grid, key)
    resolved = rt.resolve(handle)
    params = model.init(jax.random.key(1),
                        jax.tree.map(lambda a: jnp.asarray(np.asarray(a)[0]),
                                     resolved[0]),
                        jnp.asarray(np.asarray(resolved[1])[0]), train=False)
    opt_state = optax.adam(1e-2).init(params)

    losses = []
    for i in range(12):
        key, k1, k2 = jax.random.split(key, 3)
        grid = rng.permutation(4000)[:n_dev * B].reshape(n_dev, B) \
            .astype(np.int32)
        handle = rt.begin(grid, k1)
        resolved = rt.resolve(handle)
        params, opt_state, loss, acc = rt.train_step(params, opt_state, k2,
                                                     resolved)
        losses.append(float(loss))
    assert losses[-1] < losses[0]

    # fused window path on the sharded topology
    K = 3
    grids = np.stack([rng.permutation(4000)[:n_dev * B].reshape(n_dev, B)
                      for _ in range(K)], axis=1).astype(np.int32)
    key, kw = jax.random.split(key)
    params, opt_state, wlosses, _ = rt.train_window(params, opt_state,
                                                    grids, kw)
    assert np.isfinite(np.asarray(wlosses)).all()


def test_sharded_layer_hetero_edge_types(mesh):
    """Edge-typed graphs: the rel grid rides the same reduce-scatter and
    each unmasked slot's type matches the (dst, nbr) edge's type."""
    ds = synthetic_graph(num_nodes=200, avg_degree=5, feature_dim=4,
                         num_classes=3, seed=4)
    g = ds.graph
    rng = np.random.default_rng(2)
    g.edge_types = rng.integers(0, 3, g.num_edges).astype(np.int32)
    g.num_edge_types = 3
    deg = np.asarray(g.indptr[1:]) - np.asarray(g.indptr[:-1])
    fanout = int(deg.max())          # deterministic take-all slots
    n_dev = mesh.devices.size

    topo = st.put_sharded_topology(g, mesh)
    assert topo.edge_types is not None
    specs = jax.tree.map(lambda _: P(DATA_AXIS, None), topo)
    dst = rng.integers(0, 200, size=(n_dev, 8)).astype(np.int32)
    key = jax.random.key(11)

    def body(topo, dst):
        nbr, mask, rel = st._sample_layer_sharded(
            topo.indptr[0], topo.indices[0], topo.edge_types[0], dst[0],
            fanout, jax.random.fold_in(key, jax.lax.axis_index(DATA_AXIS)),
            n_dev, 200)
        return nbr[None], mask[None], rel[None]

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(specs, P(DATA_AXIS)),
                           out_specs=(P(DATA_AXIS),) * 3, check_vma=False))
    dst_dev = jax.device_put(dst, NamedSharding(mesh, P(DATA_AXIS, None)))
    nbr, mask, rel = (np.asarray(a) for a in fn(topo, dst_dev))

    indptr = np.asarray(g.indptr)
    for d in range(n_dev):
        for i, v in enumerate(dst[d]):
            m = mask[d, i].astype(bool)
            s, e = indptr[v], indptr[v + 1]
            # take-all order: slot k holds edge s+k, so types align exactly
            np.testing.assert_array_equal(rel[d, i][m],
                                          g.edge_types[s:e])
            assert (rel[d, i][~m] == 0).all()


def test_chunked_shard_build_large_offsets_bounded_memory():
    """papers100M structural readiness: build shards
    for a mocked graph whose edge OFFSETS exceed 2^31 (int32) without ever
    materializing the edge array or per-device repeat temporaries. The
    lazy indices array serves fancy-index reads from a closed-form pattern,
    so correctness is checkable; tracemalloc bounds the transient
    footprint."""
    import tracemalloc

    import numpy as np

    from coala_gnn.sampling.sharded_topology import shard_topology_arrays

    N = 1 << 16          # 65536 nodes
    DEG = 40000          # uniform degree -> 2.62e9 edges, offsets > 2^31

    class LazyIndices:
        """indices[e] = e % 9973 — never materialized."""
        dtype = np.int64

        def __getitem__(self, pos):
            return np.asarray(pos) % 9973

    class MockGraph:
        num_nodes = N
        indptr = np.arange(N + 1, dtype=np.int64) * DEG
        indices = LazyIndices()
        edge_types = None

    n_dev = 4096          # pod-scale mesh: ~640k edges per device
    assert MockGraph.indptr[-1] > np.iinfo(np.int32).max

    tracemalloc.start()
    ptrs, idx, et = shard_topology_arrays(MockGraph, n_dev,
                                          device_ids=[0, 4095],
                                          chunk_rows=4)
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    # outputs: 2 devices x 16 rows x 40000 edges x 4B = 5.1 MB; allow
    # generous slack for the O(chunk) temporaries, nowhere near E-scale
    assert peak < 64 << 20, f"peak {peak / 2**20:.0f} MB — not streaming"

    rows = -(-N // n_dev)
    assert ptrs.shape == (2, rows + 1)
    # global offsets exceed int32, but each device's LOCAL offsets are
    # small — sharding is exactly what keeps device arrays narrow
    assert ptrs.dtype == np.int32
    # device 0 owns nodes 0, 4096, 8192, ...: local row r = node r*4096,
    # global edge window [node*DEG, (node+1)*DEG)
    own0 = np.arange(0, N, n_dev, dtype=np.int64)
    np.testing.assert_array_equal(
        ptrs[0][: own0.size + 1].astype(np.int64),
        np.arange(own0.size + 1, dtype=np.int64) * DEG)
    # spot-check edge values for both devices against the closed form
    for i, d in enumerate((0, 4095)):
        own = np.arange(d, N, n_dev, dtype=np.int64)
        for r in (0, own.size - 1):
            lo = int(ptrs[i][r])
            want = (own[r] * DEG + np.arange(5)) % 9973
            np.testing.assert_array_equal(idx[i, lo: lo + 5], want)
    # padded local rows carry degree 0
    assert int(ptrs[0][rows]) == int(ptrs[0][own0.size])


def test_chunked_build_matches_reference_build():
    """The chunked/subset builder must produce byte-identical shards to a
    straightforward per-device build on a real graph (with edge types)."""
    import numpy as np

    from coala_gnn.graph.datasets import synthetic_graph
    from coala_gnn.sampling.sharded_topology import shard_topology_arrays

    ds = synthetic_graph(num_nodes=999, avg_degree=7, feature_dim=8,
                         num_classes=4, seed=3)
    rng = np.random.default_rng(0)
    ds.graph.edge_types = rng.integers(
        0, 3, ds.graph.num_edges).astype(np.int32)
    n_dev = 4
    full_p, full_i, full_e = shard_topology_arrays(ds.graph, n_dev)

    # naive reference build
    indptr = np.asarray(ds.graph.indptr, np.int64)
    for d in range(n_dev):
        own = np.arange(d, 999, n_dev, dtype=np.int64)
        chunks = [np.asarray(ds.graph.indices[indptr[o]: indptr[o + 1]])
                  for o in own]
        flat = np.concatenate(chunks).astype(np.int32)
        np.testing.assert_array_equal(full_i[d][: flat.size], flat)
        deg = indptr[own + 1] - indptr[own]
        np.testing.assert_array_equal(
            full_p[d][: own.size + 1].astype(np.int64),
            np.concatenate([[0], np.cumsum(deg)]))

    # subset build slices identically
    sub_p, sub_i, sub_e = shard_topology_arrays(ds.graph, n_dev,
                                                device_ids=[2],
                                                chunk_rows=16)
    np.testing.assert_array_equal(sub_p[0], full_p[2])
    np.testing.assert_array_equal(sub_i[0], full_i[2])
    np.testing.assert_array_equal(sub_e[0], full_e[2])
