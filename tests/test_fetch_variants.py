"""Packed request fetch + request train step + degree prewarm coverage."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from coala_gnn.cache import feature_cache as fc
from coala_gnn.cache.host_tier import HostFeatureStore
from coala_gnn.data.packing import batch_layout, pack_request
from coala_gnn.graph.datasets import synthetic_graph
from coala_gnn.models import blocks_to_device, make_model
from coala_gnn.parallel.mesh import DATA_AXIS, make_mesh
from coala_gnn.parallel.sharded_cache import ShardedFeatureCache
from coala_gnn.parallel.train import (
    make_request_train_step,
    make_train_step,
)
from coala_gnn.sampling.neighbor import NeighborSampler


@pytest.fixture(scope="module")
def ds():
    return synthetic_graph(num_nodes=3000, avg_degree=10, feature_dim=24,
                           num_classes=8, seed=13)


def test_packed_fetch_matches_direct(ds):
    store = HostFeatureStore(ds.features)
    mesh = make_mesh(jax.devices()[:1])
    cfg = fc.make_config(cache_mb=8, dim=24, num_colors=0)
    cache = ShardedFeatureCache(cfg=cfg, mesh=mesh, mode="isolated")

    B, fanouts = 16, [4, 3]
    sampler = NeighborSampler(ds.graph, fanouts, B, seed=0)
    n_req = sampler.caps[0][1]
    for trial in range(3):
        batch = sampler.sample(ds.train_idx[trial * B:(trial + 1) * B])
        vec = pack_request(batch.input_ids.astype(np.int32), batch.num_input,
                           [b.adj for b in batch.blocks],
                           [b.mask for b in batch.blocks],
                           ds.labels[batch.seeds].astype(np.int32))
        dbuf = jax.device_put(vec[None, :],
                              NamedSharding(mesh, P(DATA_AXIS, None)))
        h = cache.fetch_begin_packed(batch.input_ids[None, :],
                                     np.asarray([batch.num_input], np.int32),
                                     dbuf, n_req)
        feats = np.asarray(cache.fetch_complete(h, store.fetch))[0]
        nv = batch.num_input
        np.testing.assert_allclose(feats[:nv], ds.features[batch.input_ids[:nv]],
                                   rtol=1e-6, err_msg=f"trial {trial}")


def test_request_step_matches_classic(ds):
    B, fanouts = 16, [4, 3]
    sampler = NeighborSampler(ds.graph, fanouts, B, seed=2)
    batch = sampler.sample(ds.train_idx[:B])
    labels = ds.labels[batch.seeds].astype(np.int32)
    dblocks = blocks_to_device(batch.blocks)
    x = jnp.asarray(ds.features[batch.input_ids])

    model = make_model("sage", hidden=8, num_classes=8, num_layers=2,
                       dropout=0.0)
    tx = optax.adam(1e-2)
    params = model.init(jax.random.key(0), dblocks, x)
    opt = tx.init(params)

    layout = batch_layout(sampler.caps, fanouts)
    n_req = sampler.caps[0][1]
    vec = pack_request(batch.input_ids.astype(np.int32), batch.num_input,
                       [b.adj for b in batch.blocks],
                       [b.mask for b in batch.blocks], labels)

    key = jax.random.key(3)
    pa, _, la, _ = make_train_step(model, tx, B)(
        params, opt, key, dblocks, x, jnp.asarray(labels))
    pb, _, lb, _ = make_request_train_step(model, tx, B, layout, n_req)(
        params, opt, key, jnp.asarray(vec), x)
    assert abs(float(la) - float(lb)) < 1e-6
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6), pa, pb)


def test_degree_prewarm_admits_hubs(ds):
    store = HostFeatureStore(ds.features)
    mesh = make_mesh(jax.devices()[:1])
    # tiny cache: capacity < num_nodes forces a choice
    cfg = fc.CacheConfig(num_sets=32, ways=fc.WAYS, dim=24,
                         cache_dim=fc.round_cache_dim(24), num_colors=0)
    cache = ShardedFeatureCache(cfg=cfg, mesh=mesh, mode="isolated")
    n = cache.prewarm_by_degree(ds.graph, store.fetch)
    assert n == cfg.capacity < ds.graph.num_nodes

    deg = ds.graph.in_degrees()
    hubs = np.argsort(deg)[-64:].astype(np.int32)          # top hubs
    ids = np.tile(hubs, (1, 1))
    nv = np.asarray([64], np.int32)
    cache.stats()
    cache.fetch(ids, nv, store.fetch, fill=False)
    s = cache.stats()
    # hubs should mostly be resident (minus set-conflict evictions)
    assert s["hit_ratio"] > 0.5
