"""Graph convolution layers over padded dense blocks, in plain JAX.

Re-implementations (not ports) of the DGL conv layers the reference stacks in
its models (reference: examples/models.py — SAGEConv 'mean' at :68-70,
GraphConv at :88-91, GATConv multi-head at :133-149), reformulated for the
static-shape block layout so every layer is a few gathers + dense matmuls.

Weight layout convention: features [n, d_in] x kernel [d_in, d_out].
Compute dtype is configurable; parameters are stored in float32 (as flax's
``Dense`` keeps them), and bfloat16 activations accumulate in float32.

Every module is a frozen dataclass with the two-call contract the trainers
use: ``init(key, block(s), x) -> {"params": tree}`` and
``apply(variables, block(s), x, ...)``. The parameter tree keeps the names
and initialisers of the flax modules these replace: ``Dense`` kernels are
lecun-normal, biases zero, attention vectors glorot-uniform.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Sequence

import jax
import jax.numpy as jnp

from coala_gnn.ops.aggregate import (agg_mean, agg_sum, neighbor_view,
                                     slot_planes)

lecun_normal = jax.nn.initializers.lecun_normal()
glorot_uniform = jax.nn.initializers.glorot_uniform()


def dense_params(key, d_in: int, d_out: int, bias: bool = True) -> dict:
    """{"kernel": [d_in, d_out] lecun-normal, "bias": [d_out] zeros} f32."""
    p = {"kernel": lecun_normal(key, (d_in, d_out), jnp.float32)}
    if bias:
        p["bias"] = jnp.zeros((d_out,), jnp.float32)
    return p


def dense(p: dict, x: jax.Array, dtype) -> jax.Array:
    """x @ kernel (+ bias), inputs and params cast to the compute dtype."""
    y = jnp.dot(x.astype(dtype), p["kernel"].astype(dtype))
    if "bias" in p:
        y = y + p["bias"].astype(dtype)
    return y


class Module:
    """``init``/``apply`` over a module's own ``params``/``__call__``."""

    def init(self, key, blocks, x, **call_kwargs) -> dict:
        """Parameters for inputs like ``x``. ``call_kwargs`` (``train``,
        ``rngs``) are accepted as flax's ``init`` took them; the
        parameters do not depend on them."""
        return {"params": self.params(key, x.shape[-1])}

    def apply(self, variables, *args, **kwargs):
        return self(variables["params"], *args, **kwargs)


def dropout(h: jax.Array, rate: float, train: bool, rngs, index: int):
    """Inverted dropout; layer ``index`` folds into the caller's key."""
    if not train or rate == 0.0:
        return h
    if not rngs or "dropout" not in rngs:
        raise ValueError("train=True with dropout needs rngs={'dropout': key}")
    keep = 1.0 - rate
    mask = jax.random.bernoulli(jax.random.fold_in(rngs["dropout"], index),
                                keep, h.shape)
    return jnp.where(mask, h / keep, jnp.zeros_like(h))


class DeviceBlock(NamedTuple):
    """Device-side view of one sampled layer (see sampling.neighbor.Block).

    ``adj is None`` marks the device sampler's contiguous layout
    (dedup=False, SLOT-major r3: slot (i, k) lives at input row
    cap_dst + k*cap_dst + i), in which case every neighbor access is a free
    reshape instead of a gather —
    see ops/aggregate.py. None is an empty pytree so both layouts trace
    through jit/shard_map with the same code."""

    adj: Any          # int32 [cap_dst, fanout] local indices, or None
    mask: jax.Array   # float32 [cap_dst, fanout]

    @property
    def cap_dst(self) -> int:
        return self.mask.shape[0]

    @property
    def fanout(self) -> int:
        return self.mask.shape[1]


def blocks_to_device(blocks: Sequence[Any]) -> List[DeviceBlock]:
    """Host Block list -> DeviceBlock pytree list (jnp arrays).
    adj=None (contiguous slot-major layout) passes through."""
    return [DeviceBlock(adj=None if b.adj is None else jnp.asarray(b.adj),
                        mask=jnp.asarray(b.mask))
            for b in blocks]


@dataclasses.dataclass(frozen=True)
class SAGEConv(Module):
    """GraphSAGE 'mean' aggregator: W_self h_v + W_neigh mean_u h_u.

    Equivalent of dgl.nn.SAGEConv(aggregator_type='mean') used by the
    reference's DistSAGE/SAGE (examples/models.py:68-70, :17-19)."""

    features: int
    dtype: Any = jnp.float32

    @property
    def out_dim(self) -> int:
        return self.features

    def params(self, key, d_in: int) -> dict:
        k_self, k_neigh = jax.random.split(key)
        return {"fc_self": dense_params(k_self, d_in, self.features),
                "fc_neigh": dense_params(k_neigh, d_in, self.features,
                                         bias=False)}

    def __call__(self, p, block: DeviceBlock, x: jax.Array) -> jax.Array:
        h_dst = x[: block.cap_dst]
        h_neigh = agg_mean(x, block.adj, block.mask)
        return (dense(p["fc_self"], h_dst, self.dtype)
                + dense(p["fc_neigh"], h_neigh, self.dtype))


@dataclasses.dataclass(frozen=True)
class GraphConv(Module):
    """GCN layer with right (mean) normalization over sampled in-degrees:
    agg_v = (1/deg_v) * sum_u h_u.

    Counterpart of dgl.nn.GraphConv(allow_zero_in_degree=True) in the
    reference's GCN (examples/models.py:88-91). NOTE a deliberate semantic
    divergence: DGL's default norm='both' applies D^-1/2 A D^-1/2 using the
    block's degrees, but sampled blocks give every src node out-degree ~1,
    collapsing the src-side factor to a constant — under fanout sampling the
    right-norm mean is the standard, well-defined estimator (it is also what
    SAGEConv uses). Degrees are the block's *sampled* in-degrees;
    zero-in-degree destinations aggregate to zero rather than erroring."""

    features: int
    dtype: Any = jnp.float32

    @property
    def out_dim(self) -> int:
        return self.features

    def params(self, key, d_in: int) -> dict:
        return {"fc": dense_params(key, d_in, self.features)}

    def __call__(self, p, block: DeviceBlock, x: jax.Array) -> jax.Array:
        deg = block.mask.sum(axis=1)                       # sampled in-degree
        norm = jnp.where(deg > 0, 1.0 / deg, 0.0)
        agg = agg_sum(x, block.adj, block.mask * norm[:, None])
        return dense(p["fc"], agg, self.dtype)


@dataclasses.dataclass(frozen=True)
class GATConv(Module):
    """Multi-head graph attention over the padded block.

    Equivalent of dgl.nn.GATConv(num_heads) in the reference's GAT
    (examples/models.py:133-149). With dense blocks the edge-softmax is just a
    masked softmax over the fanout axis — no segment ops needed. Scores stay
    [n_dst, fanout, heads] (tiny); the [*, fanout, *] feature tensor for the
    weighted combine is formed per-slot to bound the memory footprint.
    Returns [n_dst, heads, features]."""

    features: int          # per-head output features
    num_heads: int = 4
    negative_slope: float = 0.2
    dtype: Any = jnp.float32

    @property
    def out_dim(self) -> int:
        return self.num_heads * self.features

    def params(self, key, d_in: int) -> dict:
        H, F = self.num_heads, self.features
        k_fc, k_l, k_r = jax.random.split(key, 3)
        # attention vectors live in the compute dtype (flax's self.param
        # with an explicit dtype), the fc kernel in float32
        return {"fc": dense_params(k_fc, d_in, H * F, bias=False),
                "attn_l": glorot_uniform(k_l, (H, F), self.dtype),
                "attn_r": glorot_uniform(k_r, (H, F), self.dtype)}

    def __call__(self, p, block: DeviceBlock, x: jax.Array) -> jax.Array:
        H, F = self.num_heads, self.features
        feat = dense(p["fc"], x, self.dtype).reshape(x.shape[0], H, F)

        # scores by kernel folding: el = feat·attn_l == x @ (W·attn_l) —
        # algebraically identical, but a [d_in, H] matvec on x instead of
        # a second full pass over the [n_src, H, F] feat tensor
        W = p["fc"]["kernel"].astype(self.dtype).reshape(-1, H, F)
        xc = x.astype(self.dtype)
        el = xc @ jnp.einsum("dhf,hf->dh", W, p["attn_l"].astype(self.dtype))
        er = xc[: block.cap_dst] @ jnp.einsum(
            "dhf,hf->dh", W, p["attn_r"].astype(self.dtype))

        # e[i,k,h] = leaky_relu(el[adj[i,k],h] + er[i,h]); masked softmax over k.
        shape = (block.cap_dst, block.fanout)
        e = neighbor_view(el, block.adj, shape) + er[:, None, :]
        e = jax.nn.leaky_relu(e, negative_slope=self.negative_slope)
        neg_inf = jnp.asarray(-1e9, e.dtype)
        e = jnp.where(block.mask[:, :, None] > 0, e, neg_inf)
        alpha = jax.nn.softmax(e, axis=1)
        alpha = alpha * block.mask[:, :, None]             # all-masked rows -> 0

        acc_t = jnp.float32 if feat.dtype == jnp.bfloat16 else feat.dtype
        if block.adj is None:                              # contiguous layout
            # slot-major plane FMAs (the agg_sum fast path, with per-head
            # weights): each term streams one contiguous [cap_dst, H, F]
            # slice — no transpose of the big neighbor tensor and no
            # [f]x[k] batched matvec
            planes = slot_planes(feat, shape)              # [f, n_dst, H, F]
            acc = jnp.zeros((block.cap_dst, H, F), acc_t)
            for k in range(block.fanout):                  # static unroll
                acc = acc + (planes[k].astype(acc_t)
                             * alpha[:, k, :, None].astype(acc_t))
            return acc.astype(feat.dtype)
        out = jnp.zeros((block.cap_dst, H, F), dtype=acc_t)
        for k in range(block.fanout):                      # static unroll
            out = out + (feat[block.adj[:, k]].astype(acc_t)
                         * alpha[:, k, :, None].astype(acc_t))
        return out.astype(feat.dtype)                      # [n_dst, H, F]
