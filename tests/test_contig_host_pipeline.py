"""Contiguous slot-major host pipeline.

The host sampler's contiguous mode mirrors the device sampler's
dedup=False layout (slot (i,k) at input row cap_dst + k*cap_dst + i,
sentinel id num_nodes marks invalid slots) so the batch crosses the
host->device link as [n_valid | ids | labels] with no explicit
adjacency. These tests pin:
  - semantic equivalence with the dedup layout (take-all regime where
    sampling is deterministic),
  - wire roundtrip (unpacked masks == sampler masks, labels intact),
  - sentinel-convention cache fetch (valid rows == host features),
  - the contiguous train step against the classic step on identical
    blocks.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from coala_gnn.cache import feature_cache as fc
from coala_gnn.cache.host_tier import HostFeatureStore
from coala_gnn.data.packing import (batch_layout, pack_request_contig,
                                        unpack_request_contig)
from coala_gnn.graph.datasets import synthetic_graph
from coala_gnn.models import blocks_to_device, make_model
from coala_gnn.parallel.mesh import DATA_AXIS, make_mesh
from coala_gnn.parallel.sharded_cache import ShardedFeatureCache
from coala_gnn.parallel.train import (make_contig_train_step,
                                          make_train_step)
from coala_gnn.sampling.neighbor import NeighborSampler


@pytest.fixture(scope="module")
def ds():
    # avg_degree 3 << fanouts below: every layer takes ALL in-neighbors,
    # so both layouts sample the identical multiset deterministically.
    return synthetic_graph(num_nodes=2000, avg_degree=3, feature_dim=16,
                           num_classes=6, seed=7)


B, FANOUTS = 16, [8, 8]


def _x_for(ds, ids):
    sent = ds.graph.num_nodes
    return jnp.asarray(ds.features[np.minimum(np.asarray(ids), sent - 1)])


def test_contig_layout_invariants(ds):
    sent = ds.graph.num_nodes
    s = NeighborSampler(ds.graph, FANOUTS, B, seed=0, contiguous=True)
    batch = s.sample(ds.train_idx[:B])
    for l, blk in enumerate(batch.blocks):
        cap_dst, cap_src = s.caps[l]
        assert blk.adj is None
        assert blk.src_ids.shape == (cap_src,)
        assert blk.mask.shape == (cap_dst, FANOUTS[l])
        # dst prefix of layer l is layer l+1's whole id vector
        if l + 1 < len(batch.blocks):
            np.testing.assert_array_equal(
                blk.src_ids[:cap_dst], batch.blocks[l + 1].src_ids)
        # slot (i, k) at row cap_dst + k*cap_dst + i; mask == not sentinel
        slots = blk.src_ids[cap_dst:].reshape(FANOUTS[l], cap_dst).T
        np.testing.assert_array_equal(blk.mask > 0, slots != sent)
    assert batch.num_input == int((batch.input_ids != sent).sum())


def test_contig_forward_matches_dedup(ds):
    """Take-all regime: SAGE forward over the contiguous layout equals the
    forward over the dedup layout on the same seeds."""
    seeds = ds.train_idx[:B]
    sd = NeighborSampler(ds.graph, FANOUTS, B, seed=0).sample(seeds)
    sc = NeighborSampler(ds.graph, FANOUTS, B, seed=0,
                         contiguous=True).sample(seeds)

    model = make_model("sage", hidden=8, num_classes=6, num_layers=2,
                       dropout=0.0)
    bd, bc = blocks_to_device(sd.blocks), blocks_to_device(sc.blocks)
    xd, xc = _x_for(ds, sd.input_ids), _x_for(ds, sc.input_ids)
    params = model.init(jax.random.key(0), bd, xd)
    out_d = np.asarray(model.apply(params, bd, xd, train=False))[:B]
    out_c = np.asarray(model.apply(params, bc, xc, train=False))[:B]
    np.testing.assert_allclose(out_c, out_d, rtol=1e-5, atol=1e-5)


def test_contig_request_roundtrip(ds):
    s = NeighborSampler(ds.graph, FANOUTS, B, seed=1, contiguous=True)
    batch = s.sample(ds.train_idx[B:2 * B])
    labels = ds.labels[batch.seeds].astype(np.int32)
    vec = pack_request_contig(batch.input_ids.astype(np.int32),
                              batch.num_input, labels)
    n_req = s.caps[0][1]
    assert vec.shape == (1 + n_req + B,)
    layout = batch_layout(s.caps, FANOUTS)
    blocks, lab = jax.jit(lambda b: unpack_request_contig(
        b, n_req, layout, B, ds.graph.num_nodes))(jnp.asarray(vec))
    np.testing.assert_array_equal(np.asarray(lab), labels)
    for blk, host_blk in zip(blocks, batch.blocks):
        assert blk.adj is None
        np.testing.assert_array_equal(np.asarray(blk.mask), host_blk.mask)


def test_contig_fetch_sentinel_convention(ds):
    store = HostFeatureStore(ds.features)
    mesh = make_mesh(jax.devices()[:1])
    cfg = fc.make_config(cache_mb=4, dim=16, num_colors=0)
    cache = ShardedFeatureCache(cfg=cfg, mesh=mesh, mode="isolated")
    sent = ds.graph.num_nodes

    s = NeighborSampler(ds.graph, FANOUTS, B, seed=2, contiguous=True)
    n_req = s.caps[0][1]
    for trial in range(3):
        batch = s.sample(ds.train_idx[trial * B:(trial + 1) * B])
        labels = ds.labels[batch.seeds].astype(np.int32)
        vec = pack_request_contig(batch.input_ids.astype(np.int32),
                                  batch.num_input, labels)
        dbuf = jax.device_put(vec[None, :],
                              NamedSharding(mesh, P(DATA_AXIS, None)))
        h = cache.fetch_begin_packed(batch.input_ids[None, :],
                                     np.asarray([batch.num_input], np.int32),
                                     dbuf, n_req, sentinel=sent)
        feats = np.asarray(cache.fetch_complete(h, store.fetch))[0]
        valid = batch.input_ids != sent
        np.testing.assert_allclose(
            feats[valid], ds.features[batch.input_ids[valid]], rtol=1e-6,
            err_msg=f"trial {trial}")


def test_contig_train_step_matches_classic(ds):
    s = NeighborSampler(ds.graph, FANOUTS, B, seed=3, contiguous=True)
    batch = s.sample(ds.train_idx[:B])
    labels = ds.labels[batch.seeds].astype(np.int32)
    dblocks = blocks_to_device(batch.blocks)
    x = _x_for(ds, batch.input_ids)

    model = make_model("sage", hidden=8, num_classes=6, num_layers=2,
                       dropout=0.0)
    tx = optax.adam(1e-2)
    params = model.init(jax.random.key(0), dblocks, x)
    opt = tx.init(params)

    layout = batch_layout(s.caps, FANOUTS)
    n_req = s.caps[0][1]
    vec = pack_request_contig(batch.input_ids.astype(np.int32),
                              batch.num_input, labels)

    key = jax.random.key(4)
    pa, _, la, _ = make_train_step(model, tx, B)(
        params, opt, key, dblocks, x, jnp.asarray(labels))
    pb, _, lb, _ = make_contig_train_step(
        model, tx, B, layout, n_req, ds.graph.num_nodes)(
        params, opt, key, jnp.asarray(vec), x)
    assert abs(float(la) - float(lb)) < 1e-6
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6), pa, pb)


def test_contig_hetero_refused(ds):
    g = ds.graph
    import dataclasses
    hg = dataclasses.replace(
        g, edge_types=np.zeros(g.indices.shape[0], np.int32))
    with pytest.raises(NotImplementedError):
        NeighborSampler(hg, FANOUTS, B, contiguous=True)
