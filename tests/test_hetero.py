import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

from coala_gnn.graph.datasets import synthetic_graph
from coala_gnn.models.hetero import (
    hetero_blocks_to_device,
    make_hetero_model,
)
from coala_gnn.sampling.neighbor import NeighborSampler


@pytest.fixture(scope="module")
def hetero_dataset():
    ds = synthetic_graph(num_nodes=1500, avg_degree=8, feature_dim=16,
                         num_classes=4, seed=2)
    rng = np.random.default_rng(0)
    ds.graph.edge_types = rng.integers(0, 3, ds.graph.num_edges).astype(np.int32)
    ds.graph.num_edge_types = 3
    return ds


def test_sampler_carries_edge_types(hetero_dataset):
    ds = hetero_dataset
    s = NeighborSampler(ds.graph, [4, 3], 8, seed=0)
    batch = s.sample(ds.train_idx[:8])
    for blk in batch.blocks:
        assert blk.rel is not None
        assert blk.rel.shape == blk.adj.shape
        # valid slots carry the true type of the sampled edge
        for i in range(min(blk.num_dst, 5)):
            dst = blk.src_ids[i]
            lo, hi = ds.graph.indptr[dst], ds.graph.indptr[dst + 1]
            types_of_dst = set(ds.graph.edge_types[lo:hi].tolist())
            for k in range(blk.fanout):
                if blk.mask[i, k] > 0:
                    assert blk.rel[i, k] in types_of_dst
        # masked slots are type 0
        assert (blk.rel[blk.mask == 0] == 0).all()


@pytest.mark.parametrize("model_type", ["rsage", "rgcn", "rgat"])
def test_hetero_models_forward_and_learn(hetero_dataset, model_type):
    ds = hetero_dataset
    B = 16
    s = NeighborSampler(ds.graph, [4, 3], B, seed=1)
    model = make_hetero_model(model_type, hidden=16, num_classes=4,
                              num_rels=3, num_layers=2, dropout=0.0)
    tx = optax.adam(1e-2)

    batch = s.sample(ds.train_idx[:B])
    blocks = hetero_blocks_to_device(batch.blocks)
    x = jnp.asarray(ds.features[batch.input_ids])
    params = model.init(jax.random.key(0), blocks, x)
    logits = model.apply(params, blocks, x)
    assert logits.shape[-1] == 4
    assert np.isfinite(np.asarray(logits[:B])).all()

    # a few steps reduce the loss
    opt = tx.init(params)

    @jax.jit
    def step(params, opt, blocks, x, labels):
        def loss_fn(p):
            lg = model.apply(p, blocks, x)[:B]
            return optax.softmax_cross_entropy_with_integer_labels(lg, labels).mean()
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, updates), opt, loss

    rng = np.random.default_rng(0)
    losses = []
    for i in range(10):
        seeds = rng.choice(ds.train_idx, B, replace=False)
        batch = s.sample(seeds)
        blocks = hetero_blocks_to_device(batch.blocks)
        x = jnp.asarray(ds.features[batch.input_ids])
        labels = jnp.asarray(ds.labels[batch.seeds].astype(np.int32))
        params, opt, loss = step(params, opt, blocks, x, labels)
        losses.append(float(loss))
    assert losses[-1] < losses[0]


def test_relation_masking_is_exact(hetero_dataset):
    """RGCN with all edges of type 0 == type-0-only weights active."""
    ds = hetero_dataset
    B = 8
    s = NeighborSampler(ds.graph, [3], B, seed=3)
    batch = s.sample(ds.train_idx[:B])
    blk = batch.blocks[0]
    # force all sampled edges to type 2
    blk.rel[:] = np.where(blk.mask > 0, 2, 0)
    blocks = hetero_blocks_to_device([blk])
    x = jnp.asarray(ds.features[batch.input_ids])
    model = make_hetero_model("rgcn", hidden=8, num_classes=8, num_rels=3,
                              num_layers=1)
    params = model.init(jax.random.key(0), blocks, x)
    out = model.apply(params, blocks, x)
    # zeroing the type-2 weights must zero the output (only r=2 is active,
    # and RelGraphConv has no self/bias term outside per-rel Dense bias)
    p2 = jax.tree.map(lambda a: a, params)
    zeroed = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.zeros_like(a) if "fc_r2" in str(path) else a, p2)
    out2 = model.apply(zeroed, blocks, x)
    np.testing.assert_allclose(np.asarray(out2[:B]), 0.0, atol=1e-6)
    assert np.abs(np.asarray(out[:B])).max() > 0