import numpy as np
import jax.numpy as jnp
import pytest

from coala_gnn.ops.aggregate import (
    agg_mean,
    agg_sum,
    neighbor_view,
    padded_gather_sum,
    padded_gather_sum_dense,
    padded_mean,
)
from coala_gnn.ops.segment import segment_softmax, spmm_coo


@pytest.mark.parametrize("shape,zero_mask", [
    ((50, 20, 6, 8), False),
    # the shapes the removed gather-sum kernels were checked at
    ((100, 40, 5, 128), False), ((64, 300, 3, 256), False),
    ((50, 17, 10, 128), False), ((128, 48, 5, 128), False),
    ((64, 33, 3, 256), False),
    # masked slots (w=0) contribute nothing regardless of adj content
    ((30, 10, 4, 128), True),
])
def test_padded_gather_sum_matches_dense_and_numpy(rng, shape, zero_mask):
    n_src, n_dst, fanout, dim = shape
    x = rng.normal(size=(n_src, dim)).astype(np.float32)
    adj = rng.integers(0, n_src, size=(n_dst, fanout)).astype(np.int32)
    w = rng.normal(size=(n_dst, fanout)).astype(np.float32)
    if zero_mask:
        w[:, 1:] = 0.0

    want = np.einsum("nfd,nf->nd", x[adj], w)
    got_loop = padded_gather_sum(jnp.asarray(x), jnp.asarray(adj), jnp.asarray(w))
    got_dense = padded_gather_sum_dense(jnp.asarray(x), jnp.asarray(adj), jnp.asarray(w))
    np.testing.assert_allclose(np.asarray(got_loop), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got_dense), want, rtol=1e-5, atol=1e-5)
    if zero_mask:
        np.testing.assert_allclose(np.asarray(got_loop),
                                   x[adj[:, 0]] * w[:, :1], rtol=1e-6)


def test_padded_mean_masked(rng):
    x = rng.normal(size=(10, 4)).astype(np.float32)
    adj = np.array([[0, 1, 2], [3, 0, 0]], dtype=np.int32)
    mask = np.array([[1, 1, 0], [0, 0, 0]], dtype=np.float32)
    out = np.asarray(padded_mean(jnp.asarray(x), jnp.asarray(adj), jnp.asarray(mask)))
    np.testing.assert_allclose(out[0], (x[0] + x[1]) / 2, rtol=1e-6)
    # fully-masked row (isolated node) -> zeros
    np.testing.assert_allclose(out[1], np.zeros(4), atol=0)


def test_contiguous_agg_matches_gather(rng):
    """adj=None (the device sampler's dedup=False layout) must equal the
    explicit arange adjacency through every aggregate entry point."""
    cap_dst, fanout, dim = 12, 5, 8
    n_src = cap_dst + cap_dst * fanout
    x = rng.normal(size=(n_src, dim)).astype(np.float32)
    # slot-major contiguous layout (r3): slot (i, k) at cap + k*cap + i
    adj = (cap_dst + np.arange(fanout, dtype=np.int32)[None, :] * cap_dst
           + np.arange(cap_dst, dtype=np.int32)[:, None])
    w = rng.normal(size=(cap_dst, fanout)).astype(np.float32)
    mask = (rng.random((cap_dst, fanout)) < 0.7).astype(np.float32)

    xj, adjj = jnp.asarray(x), jnp.asarray(adj)
    np.testing.assert_allclose(
        np.asarray(agg_sum(xj, None, jnp.asarray(w))),
        np.asarray(padded_gather_sum(xj, adjj, jnp.asarray(w))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(agg_mean(xj, None, jnp.asarray(mask))),
        np.asarray(padded_mean(xj, adjj, jnp.asarray(mask))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        np.asarray(neighbor_view(xj, None, (cap_dst, fanout))),
        x[adj])


def test_contiguous_blocks_model_equivalence(rng):
    """A model applied to contiguous (adj=None) blocks must match the same
    model applied to the equivalent explicit-adjacency blocks."""
    import jax
    from coala_gnn.models import make_model
    from coala_gnn.models.layers import DeviceBlock

    B, fanouts, dim = 8, [4, 3], 6
    caps = [(B * (fanouts[1] + 1), fanouts[0]), (B, fanouts[1])]
    blocks_c, blocks_g = [], []
    n_src0 = caps[0][0] * (fanouts[0] + 1)
    for cap_dst, f in caps:
        mask = (rng.random((cap_dst, f)) < 0.8).astype(np.float32)
        adj = (cap_dst + np.arange(f, dtype=np.int32)[None, :] * cap_dst
               + np.arange(cap_dst, dtype=np.int32)[:, None])
        blocks_c.append(DeviceBlock(adj=None, mask=jnp.asarray(mask)))
        blocks_g.append(DeviceBlock(adj=jnp.asarray(adj),
                                    mask=jnp.asarray(mask)))
    x = jnp.asarray(rng.normal(size=(n_src0, dim)).astype(np.float32))
    for mt in ("sage", "gcn", "gat"):
        model = make_model(mt, hidden=16, num_classes=5, num_layers=2,
                           dropout=0.0)
        params = model.init(jax.random.key(0), blocks_g, x)
        out_g = model.apply(params, blocks_g, x)
        out_c = model.apply(params, blocks_c, x)
        np.testing.assert_allclose(np.asarray(out_c), np.asarray(out_g),
                                   rtol=2e-5, atol=2e-5, err_msg=mt)


def test_spmm_coo(rng):
    n_src, n_dst, n_edges, dim = 30, 25, 100, 6
    x = rng.normal(size=(n_src, dim)).astype(np.float32)
    es = rng.integers(0, n_src, n_edges)
    ed = rng.integers(0, n_dst, n_edges)
    w = rng.normal(size=n_edges).astype(np.float32)
    out = np.asarray(spmm_coo(jnp.asarray(x), jnp.asarray(es), jnp.asarray(ed),
                              n_dst, jnp.asarray(w)))
    want = np.zeros((n_dst, dim), np.float32)
    for e in range(n_edges):
        want[ed[e]] += w[e] * x[es[e]]
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)


def test_segment_softmax(rng):
    scores = rng.normal(size=12).astype(np.float32)
    seg = np.array([0, 0, 0, 1, 1, 2, 2, 2, 2, 3, 3, 3])
    out = np.asarray(segment_softmax(jnp.asarray(scores), jnp.asarray(seg), 4))
    for s in range(4):
        m = seg == s
        np.testing.assert_allclose(out[m], np.exp(scores[m] - scores[m].max())
                                   / np.exp(scores[m] - scores[m].max()).sum(),
                                   rtol=1e-5)
        np.testing.assert_allclose(out[m].sum(), 1.0, rtol=1e-5)


def test_bf16_aggregation_accumulates_in_f32(rng):
    """Bf16 features must not chain fanout bf16 adds — both
    aggregation paths accumulate in f32 and match the f32 result to within
    a single bf16 rounding of the output."""
    cap_dst, fanout, dim = 64, 12, 32
    n_src = cap_dst + cap_dst * fanout
    x = rng.normal(size=(n_src, dim)).astype(np.float32)
    adj = (cap_dst + np.arange(fanout, dtype=np.int32)[None, :] * cap_dst
           + np.arange(cap_dst, dtype=np.int32)[:, None])
    w = rng.normal(size=(cap_dst, fanout)).astype(np.float32)

    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.einsum("nfd,nf->nd",
                     np.asarray(xb.astype(jnp.float32))[adj], w)
    for got in (agg_sum(xb, None, jnp.asarray(w)),
                padded_gather_sum(xb, jnp.asarray(adj), jnp.asarray(w))):
        assert got.dtype == jnp.bfloat16
        # one output rounding step of bf16 (~2^-8 relative), NOT the
        # ~fanout*2^-8 drift a bf16 accumulation chain would show
        np.testing.assert_allclose(np.asarray(got.astype(jnp.float32)),
                                   want, rtol=2**-7, atol=2**-7 * 4)
