"""End-to-end multi-device training on the 8-device virtual CPU mesh:
distribution -> sampling -> sharded cache fetch -> DP train step."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from coala_gnn.cache import feature_cache as fc
from coala_gnn.cache.host_tier import HostFeatureStore
from coala_gnn.coloring import generate_color_metadata
from coala_gnn.data.loader import CoalaDataLoader
from coala_gnn.distribution import DistributionScheduler, SeedDistributor
from coala_gnn.graph.datasets import synthetic_graph
from coala_gnn.models import DeviceBlock, make_model
from coala_gnn.parallel.mesh import DATA_AXIS, make_mesh
from coala_gnn.parallel.sharded_cache import ShardedFeatureCache
from coala_gnn.parallel.train import make_sharded_train_step
from coala_gnn.sampling.neighbor import NeighborSampler


def test_multidevice_end_to_end():
    mesh = make_mesh()
    n_dev = mesh.devices.size
    assert n_dev == 8, "conftest should provide 8 virtual devices"

    ds = synthetic_graph(num_nodes=4000, avg_degree=10, feature_dim=32,
                         num_classes=8, seed=11)
    meta = generate_color_metadata(ds.graph, ds.train_idx, base_rate=0.02, seed=0)
    store = HostFeatureStore(ds.features)

    B, fanouts = 16, [4, 3]
    cfg = fc.CacheConfig(num_sets=16, ways=fc.WAYS, dim=ds.feature_dim,
                         cache_dim=fc.round_cache_dim(ds.feature_dim),
                         num_colors=meta.num_colors, num_shards=n_dev)
    cache = ShardedFeatureCache(cfg=cfg, mesh=mesh, mode="sharded")

    distributor = SeedDistributor(ds.train_idx, batch_size=B,
                                  local_size=n_dev, num_parts=1,
                                  mode="node_color", color=meta.color,
                                  topk_colors=meta.topk, affinity=meta.score,
                                  shuffle_seed=0)
    scheduler = DistributionScheduler(
        distributor, part_id=0, local_rank=0,
        meta_fn=cache.color_meta, refresh_counter=2)
    sampler = NeighborSampler(ds.graph, fanouts, B, seed=0)
    loader = CoalaDataLoader(scheduler=scheduler, sampler=sampler,
                             labels=ds.labels, local_size=n_dev, prefetch=2)

    model = make_model("sage", hidden=16, num_classes=ds.num_classes,
                       num_layers=2)
    tx = optax.adam(1e-2)
    step = make_sharded_train_step(model, tx, mesh, B)

    sh_blocks = NamedSharding(mesh, P(DATA_AXIS))
    params = None
    opt_state = None
    key = jax.random.key(0)
    losses = []
    n_steps = min(len(loader), 6)

    it = iter(loader)
    for i in range(n_steps):
        hb = next(it)
        blocks = [DeviceBlock(adj=jax.device_put(a, sh_blocks),
                              mask=jax.device_put(m, sh_blocks))
                  for a, m in zip(hb.adjs, hb.masks)]
        x = cache.fetch(hb.input_ids, hb.num_input, store.fetch,
                        colors=meta.color)
        labels = jax.device_put(hb.labels, sh_blocks)
        if params is None:
            single_blocks = [DeviceBlock(adj=jnp.asarray(hb.adjs[l][0]),
                                         mask=jnp.asarray(hb.masks[l][0]))
                             for l in range(len(hb.adjs))]
            params = model.init(jax.random.key(1), single_blocks,
                                jnp.asarray(np.asarray(x)[0]))
            opt_state = tx.init(params)
        key, sub = jax.random.split(key)
        params, opt_state, loss, acc = step(params, opt_state, sub,
                                            blocks, x, labels)
        losses.append(float(loss))

    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]          # learning across 8 devices

    s = cache.stats()
    assert s["hits"] + s["misses"] > 0
    assert s["hits"] > 0                   # affinity + sharing produce hits

    # color meta is live and consistent
    cm = cache.color_meta()
    assert cm.sum() > 0
    assert cm.shape == (meta.num_colors + 1,)


def test_feature_fetch_matches_direct_gather():
    """Cached fetch must be exact: per-row allclose vs direct feature gather
    (the reference's commented-out manual check, nvshmem_homogeneous_train.py
    :188-196, promoted to a real test per SURVEY.md §4)."""
    mesh = make_mesh()
    n_dev = mesh.devices.size
    ds = synthetic_graph(num_nodes=3000, avg_degree=8, feature_dim=24,
                         num_classes=4, seed=5)
    store = HostFeatureStore(ds.features)
    cfg = fc.CacheConfig(num_sets=8, ways=fc.WAYS, dim=24,
                         cache_dim=fc.round_cache_dim(24), num_colors=0,
                         num_shards=n_dev)
    cache = ShardedFeatureCache(cfg=cfg, mesh=mesh, mode="sharded")

    sampler = NeighborSampler(ds.graph, [5, 4], 8, seed=3)
    rng = np.random.default_rng(0)
    for trial in range(3):
        ids_list, nums = [], []
        for d in range(n_dev):
            batch = sampler.sample(rng.choice(ds.train_idx, 8, replace=False))
            ids_list.append(batch.input_ids)
            nums.append(batch.num_input)
        ids = np.stack(ids_list)
        num_valid = np.asarray(nums, np.int32)
        feats = np.asarray(cache.fetch(ids, num_valid, store.fetch))
        for d in range(n_dev):
            nv = num_valid[d]
            np.testing.assert_allclose(feats[d, :nv],
                                       ds.features[ids[d, :nv]], rtol=1e-6,
                                       err_msg=f"trial {trial} dev {d}")


def test_masked_train_step_tail_exactness():
    """The masked DP step (--mask_tail) zeroes wrapped-duplicate slots'
    contribution exactly: (a) the update is invariant to the CONTENT of
    invalid slots, (b) with an all-true mask it matches the unmasked step's
    global mean."""
    mesh = make_mesh()
    n_dev = mesh.devices.size
    ds = synthetic_graph(num_nodes=4000, avg_degree=10, feature_dim=32,
                         num_classes=8, seed=11)
    store = HostFeatureStore(ds.features)
    B, fanouts = 4, [4, 3]
    sampler = NeighborSampler(ds.graph, fanouts, B, seed=0)
    # 100 seeds, global_batch = 32 -> 4 iterations, final wraps 28 slots
    d = SeedDistributor(ds.train_idx[:100], batch_size=B, local_size=n_dev,
                        num_parts=1, shuffle_seed=0, drop_tail=False)
    sched = DistributionScheduler(d, part_id=0, local_rank=0)
    loader = CoalaDataLoader(scheduler=sched, sampler=sampler,
                             labels=ds.labels, local_size=n_dev, prefetch=0)
    hb = list(loader)[-1]                      # the wrapped tail batch
    assert hb.valid is not None and (~hb.valid).any() and hb.valid.any()

    sh = NamedSharding(mesh, P(DATA_AXIS))
    blocks = [DeviceBlock(adj=jax.device_put(a, sh),
                          mask=jax.device_put(m, sh))
              for a, m in zip(hb.adjs, hb.masks)]
    x = jax.device_put(
        np.stack([store.fetch(ids) for ids in hb.input_ids]), sh)
    labels = hb.labels

    model = make_model("sage", hidden=16, num_classes=ds.num_classes,
                       num_layers=2)
    tx = optax.adam(1e-2)
    single_blocks = [DeviceBlock(adj=jnp.asarray(hb.adjs[l][0]),
                                 mask=jnp.asarray(hb.masks[l][0]))
                     for l in range(len(hb.adjs))]
    params = model.init(jax.random.key(1), single_blocks,
                        jnp.asarray(np.asarray(x)[0]))
    opt_state = tx.init(params)

    step_m = make_sharded_train_step(model, tx, mesh, B, masked=True)
    step_u = make_sharded_train_step(model, tx, mesh, B)
    key = jax.random.key(7)
    vput = jax.device_put(hb.valid, sh)

    # (a) invalid-slot content invariance: corrupt the wrapped labels
    p1, _, l1, a1 = step_m(params, opt_state, key, blocks, x,
                           jax.device_put(labels, sh), vput)
    corrupted = labels.copy()
    corrupted[~hb.valid] = (corrupted[~hb.valid] + 3) % ds.num_classes
    p2, _, l2, a2 = step_m(params, opt_state, key, blocks, x,
                           jax.device_put(corrupted, sh), vput)
    assert float(l1) == float(l2) and float(a1) == float(a2)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), np.asarray(b)), p1, p2)

    # (b) all-true mask == unmasked global mean
    ones = jax.device_put(np.ones_like(hb.valid), sh)
    pm, _, lm, am = step_m(params, opt_state, key, blocks, x,
                           jax.device_put(labels, sh), ones)
    pu, _, lu, au = step_u(params, opt_state, key, blocks, x,
                           jax.device_put(labels, sh))
    assert np.isclose(float(lm), float(lu), rtol=1e-5)
    assert np.isclose(float(am), float(au), rtol=1e-5)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=2e-5, atol=2e-6), pm, pu)
