"""Model stacks: GraphSAGE / GCN / GAT over sampled blocks.

Re-implementations of the reference model zoo (reference: examples/models.py —
DistSAGE :8-60, SAGE :62-81, GCN :83-101, GAT :126-178), selected by the same
``model_type`` switch the trainer exposes (sbatch_ssd_gnn_train.py:97-110).
Forward contract matches the reference: per layer
``h_dst = h[:num_dst]; h = conv(block, h)`` with ReLU + dropout between hidden
layers; GAT flattens heads between layers and means heads at the output
(models.py:172-178).

Parameters: ``{"params": {"layer_<i>": <conv params>}}``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import jax
import jax.numpy as jnp

from coala_gnn.models.layers import (DeviceBlock, GATConv, GraphConv,
                                     Module, SAGEConv, dropout)


@dataclasses.dataclass(frozen=True)
class Stack(Module):
    """``num_layers`` convs of one kind; the last maps to ``num_classes``."""

    hidden: int
    num_classes: int
    num_layers: int = 2
    dropout: float = 0.5
    dtype: Any = jnp.float32

    def conv(self, i: int):
        raise NotImplementedError

    def is_last(self, i: int) -> bool:
        return i == self.num_layers - 1

    def features(self, i: int) -> int:
        return self.num_classes if self.is_last(i) else self.hidden

    def params(self, key, d_in: int) -> dict:
        out = {}
        for i, k in enumerate(jax.random.split(key, self.num_layers)):
            conv = self.conv(i)
            out[f"layer_{i}"] = conv.params(k, d_in)
            d_in = conv.out_dim
        return out

    def finish(self, i: int, h: jax.Array) -> jax.Array:
        """Per-layer output reshaping (identity except GAT's heads)."""
        return h

    def __call__(self, p, blocks: Sequence[DeviceBlock], x: jax.Array,
                 train: bool = False, rngs=None) -> jax.Array:
        h = x.astype(self.dtype)
        for i, block in enumerate(blocks):
            h = self.finish(i, self.conv(i)(p[f"layer_{i}"], block, h))
            if not self.is_last(i):
                h = jax.nn.relu(h)
                h = dropout(h, self.dropout, train, rngs, i)
        return h.astype(jnp.float32)


@dataclasses.dataclass(frozen=True)
class SAGE(Stack):
    """GraphSAGE (mean) — the reference's flagship DistSAGE/SAGE."""

    def conv(self, i: int):
        return SAGEConv(self.features(i), dtype=self.dtype)


@dataclasses.dataclass(frozen=True)
class GCN(Stack):
    def conv(self, i: int):
        return GraphConv(self.features(i), dtype=self.dtype)


@dataclasses.dataclass(frozen=True)
class GAT(Stack):
    """Multi-head GAT; heads flattened between layers, meaned at output
    (reference: examples/models.py:172-178). ``hidden`` is per head."""

    num_heads: int = 4

    def conv(self, i: int):
        return GATConv(self.features(i), num_heads=self.num_heads,
                       dtype=self.dtype)

    def finish(self, i: int, h: jax.Array) -> jax.Array:
        if self.is_last(i):
            return h.mean(axis=1)                        # mean over heads
        return h.reshape(h.shape[0], -1)                 # flatten heads


def make_model(model_type: str, hidden: int, num_classes: int,
               num_layers: int, num_heads: int = 4, dropout: float = 0.5,
               dtype: Any = jnp.float32) -> Stack:
    """Model switch matching the reference trainer's --model_type
    (sbatch_ssd_gnn_train.py:97-110: sage | gcn | gat)."""
    if model_type in ("sage", "distsage"):
        return SAGE(hidden=hidden, num_classes=num_classes,
                    num_layers=num_layers, dropout=dropout, dtype=dtype)
    if model_type == "gcn":
        return GCN(hidden=hidden, num_classes=num_classes,
                   num_layers=num_layers, dropout=dropout, dtype=dtype)
    if model_type == "gat":
        return GAT(hidden=hidden, num_classes=num_classes,
                   num_layers=num_layers, num_heads=num_heads,
                   dropout=dropout, dtype=dtype)
    raise ValueError(f"unknown model_type {model_type!r}")
