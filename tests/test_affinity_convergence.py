"""Affinity distribution must not change what the model learns.

tie AFFINITY_AB's hit-ratio gain to trained-model
quality. Both distribution modes see the SAME shuffled seed stream each
iteration — node_color only re-partitions it across hosts — so with
equal-size parts and data-parallel gradient averaging the training
trajectory must reach the same accuracy while node_color sustains its
hit-ratio gain. A silent seed drop/duplication in the affinity path (the
class of bug that would quietly alter training) breaks the accuracy
assertion; a regression in the affinity mechanism breaks the hit one.

Reference anchor: Distribution_compare_script.sh:26-34 runs the same A/B
as separate SLURM trainings and compares test accuracy + hit rate.
"""

import sys

import numpy as np
import pytest


def _train_mode(mode, ds, meta, parts, B, fanouts, cache_mb, iters, refresh,
                seed=0):
    """Train one SAGE data-parallel over `parts` hosts, features served
    through each part's capacity-constrained cache. Returns (eval_acc,
    aggregate_hit_ratio)."""
    import jax
    import jax.numpy as jnp
    import optax

    from coala_gnn.cache import feature_cache as fc
    from coala_gnn.cache.host_tier import HostFeatureStore
    from coala_gnn.distribution import SeedDistributor
    from coala_gnn.models import make_model
    from coala_gnn.models.layers import blocks_to_device
    from coala_gnn.parallel.mesh import make_mesh
    from coala_gnn.parallel.sharded_cache import ShardedFeatureCache
    from coala_gnn.sampling.neighbor import NeighborSampler

    store = HostFeatureStore(ds.features)
    mesh = make_mesh(jax.devices()[:1])
    cfg = fc.make_config(cache_mb=cache_mb, dim=ds.feature_dim,
                         num_colors=meta.num_colors)
    caches = [ShardedFeatureCache(cfg=cfg, mesh=mesh, mode="isolated")
              for _ in range(parts)]
    sampler = NeighborSampler(ds.graph, fanouts, B, seed=seed)
    distributor = SeedDistributor(
        ds.train_idx, batch_size=B, local_size=1, num_parts=parts,
        mode=mode, color=meta.color, topk_colors=meta.topk,
        affinity=meta.score, shuffle_seed=seed)

    # dropout 0: the two modes must be bit-comparable up to partition
    # order (mean-of-equal-size-part-means == global batch mean)
    model = make_model("sage", hidden=32, num_classes=ds.num_classes,
                       num_layers=len(fanouts), dropout=0.0)
    tx = optax.adam(5e-3)

    @jax.jit
    def grad_step(params, blocks, x, y):
        def loss_fn(p):
            logits = model.apply(p, blocks, x, train=False)[: B]
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, y).mean()
        return jax.value_and_grad(loss_fn)(params)

    params = None
    opt_state = None
    cache_meta = np.zeros((parts, meta.num_colors + 1), np.int32)
    n_iters = min(iters, distributor.num_iters)
    for it in range(n_iters):
        if it % refresh == 0:
            cache_meta = np.stack([c.color_meta() for c in caches])
        domains = distributor.distribute(it, cache_meta)
        grads_acc = None
        loss_acc = 0.0
        for p in range(parts):
            batch = sampler.sample(domains[p][:B])
            x = caches[p].fetch(batch.input_ids[None, :].astype(np.int32),
                                np.asarray([batch.num_input], np.int32),
                                store.fetch, colors=meta.color)[0]
            blocks = blocks_to_device(batch.blocks)
            y = jnp.asarray(ds.labels[batch.seeds].astype(np.int32))
            if params is None:
                params = model.init(jax.random.key(1), blocks, x)
                opt_state = tx.init(params)
            loss, grads = grad_step(params, blocks, x, y)
            loss_acc += float(loss)
            grads_acc = grads if grads_acc is None else jax.tree.map(
                lambda a, b: a + b, grads_acc, grads)
        grads_mean = jax.tree.map(lambda g: g / parts, grads_acc)
        updates, opt_state = tx.update(grads_mean, opt_state, params)
        params = optax.apply_updates(params, updates)

    stats = [c.stats() for c in caches]
    agg_h = sum(s["hits"] for s in stats)
    agg_m = sum(s["misses"] for s in stats)

    # eval on held-out nodes, features straight from the store (no cache:
    # the cached path's exactness is pinned elsewhere)
    rng = np.random.default_rng(0)
    correct = total = 0
    for _ in range(4):
        seeds = rng.choice(ds.test_idx, B, replace=False)
        batch = sampler.sample(seeds)
        x = jnp.asarray(store.fetch(batch.input_ids.astype(np.int64)))
        blocks = blocks_to_device(batch.blocks)
        logits = model.apply(params, blocks, x, train=False)[: B]
        correct += int((np.asarray(logits).argmax(-1)
                        == ds.labels[seeds]).sum())
        total += B
    return correct / total, agg_h / max(agg_h + agg_m, 1)


@pytest.mark.slow
def test_affinity_convergence_matches_baseline():
    from coala_gnn.coloring import generate_color_metadata
    from coala_gnn.graph.datasets import clustered_graph

    ds = clustered_graph(num_nodes=8000, num_communities=32, avg_degree=8,
                         p_intra=0.95, feature_dim=32, seed=3)
    meta = generate_color_metadata(ds.graph, ds.train_idx, seed=3)

    kwargs = dict(ds=ds, meta=meta, parts=2, B=64, fanouts=[4, 4],
                  cache_mb=1, iters=48, refresh=8, seed=3)
    acc_base, hit_base = _train_mode("baseline", **kwargs)
    acc_node, hit_node = _train_mode("node_color", **kwargs)

    # the affinity gain must persist under live training traffic...
    assert hit_node > hit_base + 0.02, (hit_node, hit_base)
    # ...and both modes must actually learn, to the same quality
    assert acc_base > 0.5 and acc_node > 0.5, (acc_base, acc_node)
    assert abs(acc_base - acc_node) < 0.08, (acc_base, acc_node)
