"""Per-layer activation validation against a dense full-graph reference.

BASELINE.md north star: "Per-layer activations allclose vs reference". The
oracle is models/reference.py: the exact message passing over an explicit
edge list with segment sums. Over the full CSC graph, sampling with fanout
>= max in-degree takes every edge, so the block path must reproduce the
dense math exactly; over one sampled block's edges, the model must agree
with it for any fanout (the check chip_smoke.py repeats on the card).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from coala_gnn.graph.datasets import synthetic_graph
from coala_gnn.models import blocks_to_device, make_model
from coala_gnn.models.reference import (block_edges, full_graph_edges,
                                        gat_layer, reference_forward)
from coala_gnn.sampling.device_sampler import (sample_blocks_device,
                                               to_device_graph)
from coala_gnn.sampling.neighbor import NeighborSampler


def _full_fanout_case(num_nodes, avg_degree, feature_dim, seed, B,
                      sampler_seed, layers=1):
    ds = synthetic_graph(num_nodes=num_nodes, avg_degree=avg_degree,
                         feature_dim=feature_dim, num_classes=4, seed=seed)
    max_deg = int(ds.graph.in_degrees().max())
    sampler = NeighborSampler(ds.graph, [max_deg] * layers, B,
                              seed=sampler_seed, use_native=False)
    seeds = ds.train_idx[:B]
    batch = sampler.sample(seeds)
    dblocks = blocks_to_device(batch.blocks)
    x = jnp.asarray(ds.features[batch.input_ids])
    return ds, seeds, dblocks, x


def _full_graph_reference(ds, model, params, layers):
    src, dst = full_graph_edges(ds.graph)
    n = ds.graph.num_nodes
    return np.asarray(reference_forward(model, params, [(src, dst, n)] * layers,
                                        ds.features))


def test_sage_layer_matches_dense_reference():
    ds, seeds, dblocks, x = _full_fanout_case(400, 6, 16, 9, 32, 0)
    model = make_model("sage", hidden=8, num_classes=8, num_layers=1)
    params = model.init(jax.random.key(0), dblocks, x)
    out_block = np.asarray(model.apply(params, dblocks, x))[:32]
    want = _full_graph_reference(ds, model, params, 1)[seeds]
    np.testing.assert_allclose(out_block, want, rtol=2e-4, atol=2e-4)


def test_gcn_layer_matches_dense_reference():
    ds, seeds, dblocks, x = _full_fanout_case(300, 5, 12, 4, 16, 1)
    model = make_model("gcn", hidden=8, num_classes=8, num_layers=1)
    params = model.init(jax.random.key(0), dblocks, x)
    out_block = np.asarray(model.apply(params, dblocks, x))[:16]
    want = _full_graph_reference(ds, model, params, 1)[seeds]
    np.testing.assert_allclose(out_block, want, rtol=2e-4, atol=2e-4)


def test_two_layer_sage_matches_dense_reference():
    """Full 2-layer model: blocks with full fanout == dense propagation."""
    ds, seeds, dblocks, x = _full_fanout_case(250, 4, 8, 5, 16, 2, layers=2)
    model = make_model("sage", hidden=8, num_classes=4, num_layers=2,
                       dropout=0.0)
    params = model.init(jax.random.key(3), dblocks, x)
    out_block = np.asarray(model.apply(params, dblocks, x))[:16]
    want = _full_graph_reference(ds, model, params, 2)[seeds]
    np.testing.assert_allclose(out_block, want, rtol=5e-3, atol=5e-4)


def test_gat_layer_matches_dense_reference():
    """Exact per-edge attention math: full-fanout block GATConv == the
    edge-softmax attention over ALL in-edges."""
    from coala_gnn.models.layers import GATConv

    ds, seeds, dblocks, x = _full_fanout_case(300, 5, 12, 6, 16, 3)
    H, F = 2, 8
    layer = GATConv(features=F, num_heads=H)
    params = layer.init(jax.random.key(2), dblocks[0], x)
    out_block = np.asarray(layer.apply(params, dblocks[0], x))[:16]

    src, dst = full_graph_edges(ds.graph)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(gat_layer(params["params"],
                                    jnp.asarray(ds.features), src, dst,
                                    ds.graph.num_nodes, H))[seeds]
    np.testing.assert_allclose(out_block, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("layout", ["host_adj", "device_contiguous"])
@pytest.mark.parametrize("model_type", ["sage", "gcn", "gat"])
def test_model_matches_reference_on_sampled_blocks(model_type, layout):
    """Fanout below the degree: the model on one sampled batch equals the
    reference over that batch's block edges, in both block layouts (the
    host sampler's explicit adj and the device sampler's slot-major
    contiguous one that the resident trainer runs)."""
    ds = synthetic_graph(num_nodes=600, avg_degree=10, feature_dim=16,
                         num_classes=4, seed=11)
    B, fanouts = 16, [4, 3]
    if layout == "host_adj":
        batch = NeighborSampler(ds.graph, fanouts, B, seed=5,
                                use_native=False).sample(ds.train_idx[:B])
        blocks = blocks_to_device(batch.blocks)
        ids = batch.input_ids
    else:
        blocks, ids, _ = sample_blocks_device(
            to_device_graph(ds.graph), jnp.asarray(ds.train_idx[:B]),
            fanouts, B, jax.random.key(5), dedup=False)
        ids = np.asarray(ids)
    x = jnp.asarray(ds.features[np.clip(ids, 0, ds.graph.num_nodes - 1)])
    model = make_model(model_type, hidden=8, num_classes=4, num_layers=2,
                       num_heads=2)
    params = model.init(jax.random.key(1), blocks, x)
    got = np.asarray(model.apply(params, blocks, x))[:B]
    want = np.asarray(reference_forward(
        model, params, [block_edges(b) for b in blocks], x))[:B]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_rgcn_layer_matches_dense_reference():
    """Exact per-edge relational math: full-fanout hetero block
    RelGraphConv == numpy per-relation mean + per-relation dense."""
    from coala_gnn.models.hetero import (RelGraphConv,
                                             hetero_blocks_to_device)

    ds = synthetic_graph(num_nodes=250, avg_degree=5, feature_dim=10,
                         num_classes=4, seed=8)
    g = ds.graph
    rng = np.random.default_rng(1)
    g.edge_types = rng.integers(0, 3, g.num_edges).astype(np.int32)
    g.num_edge_types = 3
    max_deg = int(g.in_degrees().max())
    B = 16
    sampler = NeighborSampler(g, [max_deg], B, seed=4, use_native=False)
    seeds = ds.train_idx[:B]
    batch = sampler.sample(seeds)
    dblocks = hetero_blocks_to_device(batch.blocks)
    x = jnp.asarray(ds.features[batch.input_ids])

    layer = RelGraphConv(features=8, num_rels=3)
    params = layer.init(jax.random.key(5), dblocks[0], x)
    out_block = np.asarray(layer.apply(params, dblocks[0], x))[:B]

    p = params["params"]
    deg_all = np.diff(g.indptr)
    want = np.zeros((B, 8))
    for i, v in enumerate(seeds):
        lo, hi = g.indptr[int(v)], g.indptr[int(v) + 1]
        nbrs = np.asarray(g.indices[lo:hi])
        types = g.edge_types[lo:hi]
        for r in range(3):
            Wr = np.asarray(p[f"fc_r{r}"]["kernel"]).astype(np.float64)
            br = np.asarray(p[f"fc_r{r}"]["bias"]).astype(np.float64)
            sel = nbrs[types == r]
            agg = (ds.features[sel].astype(np.float64).mean(axis=0)
                   if sel.size else np.zeros(ds.features.shape[1]))
            want[i] += agg @ Wr + br   # Dense bias applies per relation
    np.testing.assert_allclose(out_block, want, rtol=2e-4, atol=2e-4)
