import numpy as np
import jax
import jax.numpy as jnp
import optax

from coala_gnn.data.packing import (
    batch_layout,
    pack_batch,
    packed_size,
    unpack_batch,
)
from coala_gnn.models import blocks_to_device, make_model
from coala_gnn.parallel.train import make_packed_train_step, make_train_step
from coala_gnn.sampling.neighbor import NeighborSampler


def test_pack_unpack_roundtrip(small_dataset):
    ds = small_dataset
    B, fanouts = 16, [4, 3]
    sampler = NeighborSampler(ds.graph, fanouts, B, seed=0, use_native=False)
    batch = sampler.sample(ds.train_idx[:B])
    labels = ds.labels[batch.seeds].astype(np.int32)

    layout = batch_layout(sampler.caps, fanouts)
    buf = pack_batch([b.adj for b in batch.blocks],
                     [b.mask for b in batch.blocks], labels)
    assert buf.shape == (packed_size(layout, B),)

    blocks, lab = jax.jit(
        lambda b: unpack_batch(b, layout, B))(jnp.asarray(buf))
    np.testing.assert_array_equal(np.asarray(lab), labels)
    for blk, dblk in zip(batch.blocks, blocks):
        np.testing.assert_array_equal(np.asarray(dblk.mask), blk.mask)
        # where the mask is set, adj must match exactly
        m = blk.mask > 0
        np.testing.assert_array_equal(np.asarray(dblk.adj)[m], blk.adj[m])


def test_packed_step_matches_unpacked(small_dataset):
    """Identical params/opt trajectory between packed and classic steps."""
    ds = small_dataset
    B, fanouts = 16, [4, 3]
    sampler = NeighborSampler(ds.graph, fanouts, B, seed=1, use_native=False)
    batch = sampler.sample(ds.train_idx[:B])
    labels = jnp.asarray(ds.labels[batch.seeds].astype(np.int32))
    dblocks = blocks_to_device(batch.blocks)
    x = jnp.asarray(ds.features[batch.input_ids])

    model = make_model("sage", hidden=8, num_classes=ds.num_classes,
                       num_layers=2, dropout=0.0)
    tx = optax.adam(1e-2)
    params = model.init(jax.random.key(0), dblocks, x)
    opt = tx.init(params)

    step_a = make_train_step(model, tx, B)
    layout = batch_layout(sampler.caps, fanouts)
    step_b = make_packed_train_step(model, tx, B, layout)
    buf = jnp.asarray(pack_batch([b.adj for b in batch.blocks],
                                 [b.mask for b in batch.blocks],
                                 np.asarray(labels)))

    key = jax.random.key(9)
    pa, oa, la, aa = step_a(params, opt, key, dblocks, x, labels)
    pb, ob, lb, ab = step_b(params, opt, key, buf, x)
    assert abs(float(la) - float(lb)) < 1e-6
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6), pa, pb)
