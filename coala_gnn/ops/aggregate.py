"""Neighborhood aggregation over padded dense blocks.

The static-shape replacement for DGL's ragged SpMM message passing
(reference models call SAGEConv/GraphConv/GATConv over DGL blocks,
reference: examples/models.py:71-81). With the dense ``adj [n_dst, fanout]``
block layout (see coala_gnn/sampling/neighbor.py) aggregation becomes a
small, static number of row gathers + fused multiply-adds — shapes are fully
static, XLA fuses the weighting into the gather consumer, and nothing ragged
ever reaches the device.

Three formulations:
  - ``padded_gather_sum``: unrolled loop of ``fanout`` row-gathers of
    [n_dst, dim] each — avoids materializing the [n_dst, fanout, dim]
    neighbor tensor in HBM; the right default for feature dims >= 128.
  - ``padded_gather_sum_dense``: one gather producing [n_dst, fanout, dim]
    then a weighted reduce — better for small dims / when the 3-D tensor is
    needed anyway (GAT attention).
  - **contiguous blocks** (``adj is None``): the device sampler's
    ``dedup=False`` layout places the sampled neighbor of slot (i, k) at
    row ``cap_dst + k*cap_dst + i`` of the layer input (SLOT-major, r3) —
    a *static* arange. The weighted fanout sum is then ``fanout``
    streaming FMAs over contiguous ``[cap_dst, dim]`` planes — no random
    gather reaches the model at all (the only random access per step is
    the cache lookup). Slot-major instead of dst-major so that each
    fanout term is one contiguous plane even for non-pow2 fanouts (the
    common case: 10, 15). This is the fast path the resident pipeline rides;
    ``agg_sum``/``agg_mean``/``neighbor_view`` dispatch on it.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp


def padded_gather_sum(x_src: jax.Array, adj: jax.Array,
                      weights: jax.Array) -> jax.Array:
    """out[i] = sum_k weights[i, k] * x_src[adj[i, k]].

    x_src   : [n_src, dim]
    adj     : int32 [n_dst, fanout] indices into x_src
    weights : [n_dst, fanout] (mask, normalized coefficients, or attention)
    returns : [n_dst, dim]
    """
    fanout = adj.shape[1]
    # accumulate in f32: chaining 10-15 bf16 adds loses ~2-3 mantissa bits
    # vs the einsum form (dot_general accumulates in f32)
    acc_t = jnp.float32 if x_src.dtype == jnp.bfloat16 else x_src.dtype
    acc = jnp.zeros((adj.shape[0], x_src.shape[1]), dtype=acc_t)
    for k in range(fanout):  # static unroll: fanout is small (<= ~15)
        acc = acc + x_src[adj[:, k]].astype(acc_t) * weights[:, k][:, None].astype(acc_t)
    return acc.astype(x_src.dtype)


def padded_gather_sum_dense(x_src: jax.Array, adj: jax.Array,
                            weights: jax.Array) -> jax.Array:
    """Same contract as padded_gather_sum via one 3-D gather + reduce."""
    nbr = x_src[adj]                                   # [n_dst, fanout, dim]
    return jnp.einsum("nfd,nf->nd", nbr, weights.astype(x_src.dtype))


def padded_mean(x_src: jax.Array, adj: jax.Array, mask: jax.Array) -> jax.Array:
    """Masked neighborhood mean (the SAGE 'mean' aggregator; zero for
    isolated nodes — matching DGL SAGEConv behavior on zero-degree dst)."""
    count = jnp.maximum(mask.sum(axis=1), 1.0)
    s = padded_gather_sum(x_src, adj, mask)
    return s / count[:, None].astype(s.dtype)


# ---- block-aware dispatch (contiguous fast path) -------------------------

def slot_planes(x_src: jax.Array, shape: tuple) -> jax.Array:
    """[fanout, cap_dst, *] slot-major neighbor planes for a contiguous
    block (slot (i, k) at row cap_dst + k*cap_dst + i): a zero-cost
    reshape of a contiguous slice."""
    cap_dst, fanout = shape
    sl = jax.lax.slice_in_dim(x_src, cap_dst, cap_dst + cap_dst * fanout)
    return sl.reshape(fanout, cap_dst, *x_src.shape[1:])


def neighbor_view(x_src: jax.Array, adj: Optional[jax.Array],
                  shape: tuple) -> jax.Array:
    """[n_dst, fanout, *] neighbor tensor for a block.

    shape = (cap_dst, fanout). ``adj is None`` marks the contiguous
    slot-major layout: a reshape + logical transpose (XLA fuses it into
    elementwise consumers; reduction-heavy consumers should prefer
    ``slot_planes`` and keep the fanout axis leading). Otherwise one 3-D
    gather."""
    if adj is None:
        planes = slot_planes(x_src, shape)
        return jnp.swapaxes(planes, 0, 1)
    return x_src[adj]


def agg_sum(x_src: jax.Array, adj: Optional[jax.Array],
            weights: jax.Array) -> jax.Array:
    """Weighted neighbor sum; dispatches to the contiguous streaming path
    when ``adj is None`` (see module docstring)."""
    if adj is None:
        cap_dst, fanout = weights.shape
        # accumulate in f32 (bf16 chains of fanout adds regress precision
        # vs the f32-accumulated einsum this path replaced)
        acc_t = jnp.float32 if x_src.dtype == jnp.bfloat16 else x_src.dtype
        w = weights.astype(acc_t)
        # fanout static plane-FMAs: each term streams one contiguous
        # [cap, dim] slice
        acc = jnp.zeros((cap_dst, x_src.shape[1]), acc_t)
        for k in range(fanout):
            plane = jax.lax.slice_in_dim(
                x_src, cap_dst * (1 + k), cap_dst * (2 + k))
            acc = acc + plane.astype(acc_t) * w[:, k][:, None]
        return acc.astype(x_src.dtype)
    return padded_gather_sum(x_src, adj, weights)


def agg_mean(x_src: jax.Array, adj: Optional[jax.Array],
             mask: jax.Array) -> jax.Array:
    """Masked neighborhood mean with contiguous dispatch."""
    if adj is None:
        count = jnp.maximum(mask.sum(axis=1), 1.0)
        s = agg_sum(x_src, None, mask)
        return s / count[:, None].astype(s.dtype)
    return padded_mean(x_src, adj, mask)
