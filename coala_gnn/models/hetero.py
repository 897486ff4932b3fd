"""Relational (heterogeneous) conv layers and model stacks: RGCN/RSAGE/RGAT.

Re-implementations of the reference's hetero model family
(reference: examples/models.py — RGCN :181-206, RSAGE :208-233, RGAT
:252-280, built on dgl.nn.HeteroGraphConv with one conv per edge type and
'sum' cross-type aggregation; defined in the reference but not wired into
its main trainer).

Dense-block formulation: each block carries a per-slot edge type
``rel int32 [n_dst, fanout]``; a relation-typed layer runs its aggregation
once per relation with the mask restricted to that relation
(mask * (rel == r)) and applies a per-relation weight — R small dense
aggregations instead of ragged per-type subgraphs, all static shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Sequence

import jax
import jax.numpy as jnp

from coala_gnn.models.gnn import Stack
from coala_gnn.models.layers import (Module, dense, dense_params,
                                     glorot_uniform)
from coala_gnn.ops.aggregate import agg_sum, neighbor_view


class DeviceHeteroBlock(NamedTuple):
    """``adj is None`` marks the device sampler's contiguous layout (slot-major
    r3: slot (i, k) at input row cap_dst + k*cap_dst + i) — neighbor access
    is a free
    reshape, same fast path as DeviceBlock (ops/aggregate.py)."""

    adj: Any          # int32 [cap_dst, fanout] local indices, or None
    mask: jax.Array   # float32 [cap_dst, fanout]
    rel: jax.Array    # int32 [cap_dst, fanout]

    @property
    def cap_dst(self) -> int:
        return self.mask.shape[0]

    @property
    def fanout(self) -> int:
        return self.mask.shape[1]


def hetero_blocks_to_device(blocks: Sequence[Any]) -> List[DeviceHeteroBlock]:
    out = []
    for b in blocks:
        if b.rel is None:
            raise ValueError("block has no edge types; sample from a hetero "
                             "graph (CSCGraph.edge_types set)")
        out.append(DeviceHeteroBlock(adj=jnp.asarray(b.adj),
                                     mask=jnp.asarray(b.mask),
                                     rel=jnp.asarray(b.rel)))
    return out


@dataclasses.dataclass(frozen=True)
class RelSAGEConv(Module):
    """Per-relation mean aggregation + per-relation neighbor weight, summed
    across relations (HeteroGraphConv(SAGEConv, aggregate='sum') parity,
    models.py:208-233)."""

    features: int
    num_rels: int
    dtype: Any = jnp.float32

    @property
    def out_dim(self) -> int:
        return self.features

    def params(self, key, d_in: int) -> dict:
        keys = jax.random.split(key, self.num_rels + 1)
        p = {"fc_self": dense_params(keys[0], d_in, self.features)}
        for r in range(self.num_rels):
            p[f"fc_neigh_r{r}"] = dense_params(keys[r + 1], d_in,
                                               self.features, bias=False)
        return p

    def __call__(self, p, block: DeviceHeteroBlock, x: jax.Array) -> jax.Array:
        out = dense(p["fc_self"], x[: block.cap_dst], self.dtype)
        for r in range(self.num_rels):
            m = block.mask * (block.rel == r)
            count = jnp.maximum(m.sum(axis=1), 1.0)
            h = agg_sum(x, block.adj, m) / count[:, None].astype(x.dtype)
            out = out + dense(p[f"fc_neigh_r{r}"], h, self.dtype)
        return out


@dataclasses.dataclass(frozen=True)
class RelGraphConv(Module):
    """RGCN layer: per-relation degree-normalized sum with per-relation
    weights (models.py:181-206)."""

    features: int
    num_rels: int
    dtype: Any = jnp.float32

    @property
    def out_dim(self) -> int:
        return self.features

    def params(self, key, d_in: int) -> dict:
        keys = jax.random.split(key, self.num_rels)
        return {f"fc_r{r}": dense_params(keys[r], d_in, self.features)
                for r in range(self.num_rels)}

    def __call__(self, p, block: DeviceHeteroBlock, x: jax.Array) -> jax.Array:
        out = jnp.zeros((block.cap_dst, self.features), dtype=self.dtype)
        for r in range(self.num_rels):
            m = block.mask * (block.rel == r)
            deg = m.sum(axis=1)
            norm = jnp.where(deg > 0, 1.0 / deg, 0.0)
            agg = agg_sum(x, block.adj, m * norm[:, None])
            out = out + dense(p[f"fc_r{r}"], agg, self.dtype)
        return out


@dataclasses.dataclass(frozen=True)
class RelGATConv(Module):
    """Per-relation masked attention, summed across relations
    (models.py:252-280). Heads are meaned inside the layer (the reference's
    RGAT flattens; we mean for a fixed output dim across relations)."""

    features: int
    num_rels: int
    num_heads: int = 2
    negative_slope: float = 0.2
    dtype: Any = jnp.float32

    @property
    def out_dim(self) -> int:
        return self.features

    def params(self, key, d_in: int) -> dict:
        H, F = self.num_heads, self.features
        p = {}
        for r, k in enumerate(jax.random.split(key, self.num_rels)):
            k_fc, k_l, k_r = jax.random.split(k, 3)
            p[f"fc_r{r}"] = dense_params(k_fc, d_in, H * F, bias=False)
            p[f"attn_l_r{r}"] = glorot_uniform(k_l, (H, F), self.dtype)
            p[f"attn_r_r{r}"] = glorot_uniform(k_r, (H, F), self.dtype)
        return p

    def __call__(self, p, block: DeviceHeteroBlock, x: jax.Array) -> jax.Array:
        H, F = self.num_heads, self.features
        out = jnp.zeros((block.cap_dst, F), dtype=self.dtype)
        for r in range(self.num_rels):
            feat = dense(p[f"fc_r{r}"], x, self.dtype).reshape(x.shape[0], H, F)
            el = jnp.einsum("nhf,hf->nh", feat, p[f"attn_l_r{r}"])
            er = jnp.einsum("nhf,hf->nh", feat[: block.cap_dst],
                            p[f"attn_r_r{r}"])
            shape = (block.cap_dst, block.fanout)
            e = neighbor_view(el, block.adj, shape) + er[:, None, :]
            e = jax.nn.leaky_relu(e, negative_slope=self.negative_slope)
            m = (block.mask * (block.rel == r))[:, :, None]
            e = jnp.where(m > 0, e, jnp.asarray(-1e9, e.dtype))
            alpha = jax.nn.softmax(e, axis=1) * m
            if block.adj is None:              # contiguous fast path
                nbr = neighbor_view(feat, None, shape)
                agg = jnp.einsum("nkhf,nkh->nhf", nbr,
                                 alpha.astype(feat.dtype))
            else:
                agg = jnp.zeros((block.cap_dst, H, F), dtype=feat.dtype)
                for k in range(block.fanout):
                    agg = agg + feat[block.adj[:, k]] * alpha[:, k, :, None]
            out = out + agg.mean(axis=1)
        return out


_REL_CONVS = {"rsage": RelSAGEConv, "rgcn": RelGraphConv, "rgat": RelGATConv}


@dataclasses.dataclass(frozen=True)
class RelStack(Stack):
    """``num_layers`` relational convs; ``num_heads`` is used by rgat only."""

    kind: str = "rgcn"
    num_rels: int = 1
    num_heads: int = 2

    def conv(self, i: int):
        kw = {"num_heads": self.num_heads} if self.kind == "rgat" else {}
        return _REL_CONVS[self.kind](features=self.features(i),
                                     num_rels=self.num_rels,
                                     dtype=self.dtype, **kw)


def make_hetero_model(model_type: str, hidden: int, num_classes: int,
                      num_rels: int, num_layers: int = 2, num_heads: int = 2,
                      dropout: float = 0.5, dtype: Any = jnp.float32):
    """rsage | rgcn | rgat — reference hetero zoo (models.py:181-280)."""
    if model_type not in _REL_CONVS:
        raise ValueError(f"unknown hetero model {model_type!r}")
    return RelStack(hidden=hidden, num_classes=num_classes,
                    num_layers=num_layers, dropout=dropout, dtype=dtype,
                    kind=model_type, num_rels=num_rels, num_heads=num_heads)
