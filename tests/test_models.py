import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

from coala_gnn.models import blocks_to_device, make_model
from coala_gnn.parallel.train import init_state, make_eval_step, make_train_step
from coala_gnn.sampling.neighbor import NeighborSampler


def _batch_inputs(ds, batch):
    dblocks = blocks_to_device(batch.blocks)
    x = jnp.asarray(ds.features[np.clip(batch.input_ids, 0, ds.graph.num_nodes - 1)])
    labels = jnp.asarray(ds.labels[batch.seeds].astype(np.int32))
    return dblocks, x, labels


@pytest.mark.parametrize("model_type", ["sage", "gcn", "gat"])
def test_forward_shapes(small_dataset, model_type):
    ds = small_dataset
    B, fanouts = 16, [4, 3]
    sampler = NeighborSampler(ds.graph, fanouts, B, seed=0, use_native=False)
    batch = sampler.sample(ds.train_idx[:B])
    dblocks, x, labels = _batch_inputs(ds, batch)

    model = make_model(model_type, hidden=16, num_classes=ds.num_classes,
                       num_layers=2, num_heads=2)
    params = model.init(jax.random.key(0), dblocks, x)
    logits = model.apply(params, dblocks, x)
    assert logits.shape[0] == batch.blocks[-1].cap_dst
    assert logits.shape[-1] == ds.num_classes
    assert np.isfinite(np.asarray(logits[:B])).all()


def test_sage_mean_matches_manual(small_dataset):
    """One SAGEConv layer == W_self x_dst + W_neigh masked-mean(x_nbr)."""
    ds = small_dataset
    B = 8
    sampler = NeighborSampler(ds.graph, [5], B, seed=0, use_native=False)
    batch = sampler.sample(ds.train_idx[:B])
    blk = batch.blocks[0]
    dblocks, x, _ = _batch_inputs(ds, batch)

    model = make_model("sage", hidden=12, num_classes=12, num_layers=1)
    params = model.init(jax.random.key(1), dblocks, x)
    out = np.asarray(model.apply(params, dblocks, x))[:B]

    p = params["params"]["layer_0"]
    W_self, b = np.asarray(p["fc_self"]["kernel"]), np.asarray(p["fc_self"]["bias"])
    W_neigh = np.asarray(p["fc_neigh"]["kernel"])
    xs = np.asarray(x)
    for i in range(B):
        nbrs = [xs[blk.adj[i, k]] for k in range(blk.fanout) if blk.mask[i, k] > 0]
        h_n = np.mean(nbrs, axis=0) if nbrs else np.zeros(xs.shape[1])
        want = xs[i] @ W_self + b + h_n @ W_neigh
        np.testing.assert_allclose(out[i], want, rtol=1e-4, atol=1e-4)


def test_gat_attention_normalized(small_dataset):
    ds = small_dataset
    B = 8
    sampler = NeighborSampler(ds.graph, [4], B, seed=2, use_native=False)
    batch = sampler.sample(ds.train_idx[:B])
    dblocks, x, _ = _batch_inputs(ds, batch)
    model = make_model("gat", hidden=8, num_classes=8, num_layers=1, num_heads=2)
    params = model.init(jax.random.key(0), dblocks, x)
    logits = model.apply(params, dblocks, x)
    assert np.isfinite(np.asarray(logits[:B])).all()


def test_end_to_end_training_learns(small_dataset):
    """Minimum end-to-end slice (SURVEY.md §7 step 3): SAGE 2-layer learns on
    the homophilous synthetic graph — loss falls, accuracy beats chance."""
    ds = small_dataset
    B, fanouts = 64, [5, 5]
    sampler = NeighborSampler(ds.graph, fanouts, B, seed=0, use_native=False)
    model = make_model("sage", hidden=32, num_classes=ds.num_classes, num_layers=2)
    tx = optax.adam(1e-2)

    batch0 = sampler.sample(ds.train_idx[:B])
    dblocks, x, labels = _batch_inputs(ds, batch0)
    state = init_state(model, tx, dblocks, x)
    train_step = make_train_step(model, tx, B)

    key = jax.random.key(0)
    params, opt_state = state.params, state.opt_state
    losses, accs = [], []
    steps = 30
    rng = np.random.default_rng(0)
    for i in range(steps):
        seeds = rng.choice(ds.train_idx, size=B, replace=False)
        batch = sampler.sample(seeds)
        dblocks, x, labels = _batch_inputs(ds, batch)
        key, sub = jax.random.split(key)
        params, opt_state, loss, acc = train_step(params, opt_state, sub,
                                                  dblocks, x, labels)
        losses.append(float(loss))
        accs.append(float(acc))

    assert losses[-1] < losses[0]
    assert np.mean(accs[-5:]) > 2.0 / ds.num_classes  # well above chance

    # eval path
    eval_step = make_eval_step(model, B)
    seeds = ds.test_idx[:B]
    batch = sampler.sample(seeds)
    dblocks, x, labels = _batch_inputs(ds, batch)
    correct, total = eval_step(params, dblocks, x, labels)
    assert 0 <= int(correct) <= int(total) == B


def _expected_tree(model_type, d_in, hidden, classes, heads, rels):
    """Parameter shapes the flax modules these models replace built."""
    tree = {}
    for i, d_out in enumerate([hidden, classes]):
        if model_type == "sage":
            lp = {"fc_self": {"kernel": (d_in, d_out), "bias": (d_out,)},
                  "fc_neigh": {"kernel": (d_in, d_out)}}
        elif model_type == "gcn":
            lp = {"fc": {"kernel": (d_in, d_out), "bias": (d_out,)}}
        elif model_type == "gat":
            lp = {"fc": {"kernel": (d_in, heads * d_out)},
                  "attn_l": (heads, d_out), "attn_r": (heads, d_out)}
        elif model_type == "rsage":
            lp = {"fc_self": {"kernel": (d_in, d_out), "bias": (d_out,)}}
            lp.update({f"fc_neigh_r{r}": {"kernel": (d_in, d_out)}
                       for r in range(rels)})
        elif model_type == "rgcn":
            lp = {f"fc_r{r}": {"kernel": (d_in, d_out), "bias": (d_out,)}
                  for r in range(rels)}
        else:   # rgat
            lp = {}
            for r in range(rels):
                lp[f"fc_r{r}"] = {"kernel": (d_in, heads * d_out)}
                lp[f"attn_l_r{r}"] = (heads, d_out)
                lp[f"attn_r_r{r}"] = (heads, d_out)
        tree[f"layer_{i}"] = lp
        d_in = heads * d_out if model_type == "gat" else d_out
    return {"params": tree}


@pytest.mark.parametrize("model_type",
                         ["sage", "gcn", "gat", "rsage", "rgcn", "rgat"])
def test_param_tree_and_finite_grad(model_type):
    """The plain-JAX models keep flax's parameter tree (names, shapes,
    float32 storage, zero biases) and give finite gradients with dropout
    on (train=True)."""
    from coala_gnn.models.hetero import DeviceHeteroBlock, make_hetero_model
    from coala_gnn.models.layers import DeviceBlock

    cap1, cap0, f0, f1, B = 4, 4 * 4, 3, 3, 4
    n_src = cap0 * (1 + f0)
    rng = np.random.default_rng(0)
    hetero = model_type.startswith("r")
    masks = [jnp.asarray((rng.random((cap0, f0)) < 0.8).astype(np.float32)),
             jnp.asarray((rng.random((cap1, f1)) < 0.8).astype(np.float32))]
    if hetero:
        blocks = [DeviceHeteroBlock(adj=None, mask=m, rel=jnp.asarray(
            rng.integers(0, 3, m.shape).astype(np.int32))) for m in masks]
        model = make_hetero_model(model_type, hidden=16, num_classes=4,
                                  num_rels=3, num_heads=2)
    else:
        blocks = [DeviceBlock(adj=None, mask=m) for m in masks]
        model = make_model(model_type, hidden=16, num_classes=4,
                           num_layers=2, num_heads=2)
    x = jnp.asarray(rng.normal(size=(n_src, 8)).astype(np.float32))
    params = model.init(jax.random.key(0), blocks, x)

    shapes = jax.tree.map(lambda a: tuple(a.shape), params)
    assert shapes == _expected_tree(model_type, 8, 16, 4, 2, 3)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        assert leaf.dtype == jnp.float32
        if "bias" in jax.tree_util.keystr(path):
            assert not np.asarray(leaf).any()

    labels = jnp.asarray(rng.integers(0, 4, B).astype(np.int32))

    def loss(p):
        logits = model.apply(p, blocks, x, train=True,
                             rngs={"dropout": jax.random.key(1)})[:B]
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, labels).mean()

    grads = jax.grad(loss)(params)
    leaves = jax.tree.leaves(grads)
    assert all(np.isfinite(np.asarray(g)).all() for g in leaves)
    assert any(np.abs(np.asarray(g)).max() > 0 for g in leaves)
