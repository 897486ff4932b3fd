"""Full-training-run parity: the resident block pipeline vs a dense
full-graph reference trainer (a stronger offline
oracle than one-layer allclose).

With fanout >= max in-degree the sampler takes every in-edge
deterministically, so the block model computes exactly the dense
message-passing math; starting from IDENTICAL params and seeds, the entire
training trajectory (losses, updates, final params) of the production
pipeline — device sampling, HBM cache under CAPACITY PRESSURE with the
staged miss path live, fused lax.scan windows — must match a from-scratch
dense full-graph trainer step for step. This is the offline stand-in for
the reference's real-dataset accuracy oracle
(reference: examples/sbatch_ssd_gnn_train.py:178-193)."""

import numpy as np
import jax
import jax.numpy as jnp
import optax

from coala_gnn.cache import feature_cache as fc
from coala_gnn.cache.host_tier import HostFeatureStore
from coala_gnn.graph.datasets import synthetic_graph
from coala_gnn.models import make_model
from coala_gnn.models.layers import DeviceBlock
from coala_gnn.parallel.resident import ResidentTrainer
from coala_gnn.sampling.neighbor import block_capacities


def test_resident_pipeline_training_run_matches_dense_reference():
    B, K, M = 16, 4, 3
    ds = synthetic_graph(num_nodes=250, avg_degree=4, feature_dim=8,
                         num_classes=4, seed=5)
    g = ds.graph
    max_deg = int(g.in_degrees().max())
    fanouts = [max_deg, max_deg]
    store = HostFeatureStore(ds.features)

    # capacity pressure: cache holds ~128 of 250 nodes -> staged path live
    cfg = fc.CacheConfig(num_sets=4, ways=fc.WAYS, dim=8,
                         cache_dim=fc.round_cache_dim(8), num_colors=0)
    assert cfg.capacity < g.num_nodes

    model = make_model("sage", hidden=8, num_classes=4, num_layers=2,
                       dropout=0.0)
    tx = optax.adam(1e-2)
    rt = ResidentTrainer(graph=g, host_fetch=store.fetch, labels=ds.labels,
                         cache_cfg=cfg, model=model, tx=tx, fanouts=fanouts,
                         batch_size=B, stage_transport="float32")

    caps = block_capacities(B, fanouts)
    blocks0 = [DeviceBlock(adj=None, mask=jnp.ones((caps[l][0], fanouts[l]),
                                                   jnp.float32))
               for l in range(2)]
    params0 = model.init(jax.random.key(0), blocks0,
                         jnp.zeros((caps[0][1], 8), jnp.float32))

    rng = np.random.default_rng(3)
    grids = np.stack([np.stack([rng.choice(ds.train_idx, B, replace=False)
                                for _ in range(K)])
                      for _ in range(M)]).astype(np.int32)

    # ---- pipeline run -------------------------------------------------
    params = params0
    opt = tx.init(params)
    params, opt, losses_pipe, _ = rt.train_windows(params, opt, grids,
                                                   jax.random.key(7))
    losses_pipe = np.asarray(losses_pipe)
    s = rt.stats()
    assert s["misses"] > 0, "pressure was not real — oracle would be weak"

    # ---- dense full-graph reference trainer ---------------------------
    deg = np.diff(g.indptr)
    A = np.zeros((g.num_nodes, g.num_nodes), np.float32)
    dst = np.repeat(np.arange(g.num_nodes), deg)
    np.add.at(A, (dst, np.asarray(g.indices)), 1.0)
    A_mean = jnp.asarray(A / np.maximum(deg, 1)[:, None])
    feats_dev = jnp.asarray(ds.features)
    labels_dev = jnp.asarray(ds.labels.astype(np.int32))

    def dense_forward(p, seeds):
        h = feats_dev
        for l, name in enumerate(["layer_0", "layer_1"]):
            pp = p["params"][name]
            agg = A_mean @ h
            h = (h @ pp["fc_self"]["kernel"] + pp["fc_self"]["bias"]
                 + agg @ pp["fc_neigh"]["kernel"])
            if l == 0:
                h = jax.nn.relu(h)
        return h[seeds]

    @jax.jit
    def dense_step(p, o, seeds):
        def lfn(p):
            logits = dense_forward(p, seeds)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, labels_dev[seeds]).mean()

        loss, grads = jax.value_and_grad(lfn)(p)
        updates, o = tx.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss

    p_d, o_d = params0, tx.init(params0)
    losses_dense = []
    for seeds in grids.reshape(-1, B):
        p_d, o_d, loss = dense_step(p_d, o_d, jnp.asarray(seeds))
        losses_dense.append(float(loss))

    # whole trajectory + final params parity
    np.testing.assert_allclose(losses_pipe, losses_dense, rtol=2e-3,
                               atol=2e-4)
    flat_p = jax.tree.leaves(params)
    flat_d = jax.tree.leaves(p_d)
    for a, b in zip(flat_p, flat_d):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=5e-3,
                                   atol=5e-4)

    # final full-graph predictions agree on every test node
    pred_pipe = np.asarray(
        dense_forward(params, jnp.asarray(ds.test_idx))).argmax(-1)
    pred_dense = np.asarray(
        dense_forward(p_d, jnp.asarray(ds.test_idx))).argmax(-1)
    assert (pred_pipe == pred_dense).mean() > 0.99


def test_padded_table_pipeline_trajectory_bit_identical():
    """nbr_cap >= max in-degree: the padded-table pipeline must reproduce
    the CSR pipeline's ENTIRE training trajectory bit-for-bit (same keys
    -> same offset draws -> same neighbors; stricter than allclose)."""
    B, K, M = 16, 4, 2
    ds = synthetic_graph(num_nodes=250, avg_degree=4, feature_dim=8,
                         num_classes=4, seed=5)
    g = ds.graph
    max_deg = int(g.in_degrees().max())
    fanouts = [3, 3]
    store = HostFeatureStore(ds.features)
    cfg = fc.CacheConfig(num_sets=4, ways=fc.WAYS, dim=8,
                         cache_dim=fc.round_cache_dim(8), num_colors=0)
    model = make_model("sage", hidden=8, num_classes=4, num_layers=2,
                       dropout=0.0)
    tx = optax.adam(1e-2)
    caps = block_capacities(B, fanouts)
    blocks0 = [DeviceBlock(adj=None, mask=jnp.ones((caps[l][0], fanouts[l]),
                                                   jnp.float32))
               for l in range(2)]
    params0 = model.init(jax.random.key(0), blocks0,
                         jnp.zeros((caps[0][1], 8), jnp.float32))
    rng = np.random.default_rng(3)
    grids = np.stack([np.stack([rng.choice(ds.train_idx, B, replace=False)
                                for _ in range(K)])
                      for _ in range(M)]).astype(np.int32)

    def run(nbr_cap):
        rt = ResidentTrainer(graph=g, host_fetch=store.fetch,
                             labels=ds.labels, cache_cfg=cfg, model=model,
                             tx=tx, fanouts=fanouts, batch_size=B,
                             stage_transport="float32", nbr_cap=nbr_cap)
        params, opt = params0, tx.init(params0)
        params, opt, losses, _ = rt.train_windows(params, opt, grids,
                                                  jax.random.key(7))
        return np.asarray(losses), params

    l_csr, p_csr = run(None)
    l_pad, p_pad = run(1 << (max_deg - 1).bit_length())
    np.testing.assert_array_equal(l_csr, l_pad)
    for a, b in zip(jax.tree.leaves(p_csr), jax.tree.leaves(p_pad)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
