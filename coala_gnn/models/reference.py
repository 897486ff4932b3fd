"""Dense float32 reference for the GNN stacks, over explicit edge lists.

An independent formulation of the models' math: every layer is written
with segment sums over a (src, dst) edge list — no padded blocks, no slot
planes, no gathers shaped like the model's — so it can judge the block
path. Edges come from the full graph (``full_graph_edges``: exact
message passing) or from one sampled block (``block_edges``: the same
neighbours the model saw). Matmuls run at ``"highest"`` precision.

Used by the tests on the CPU and by ``chip_smoke.py`` on the card.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

Edges = Tuple[np.ndarray, np.ndarray, int]   # (src, dst, n_dst)


def full_graph_edges(graph) -> Tuple[np.ndarray, np.ndarray]:
    """(src, dst) of every in-edge of a CSC graph."""
    deg = np.diff(graph.indptr)
    dst = np.repeat(np.arange(graph.num_nodes), deg)
    return np.asarray(graph.indices), dst


def block_edges(block) -> Edges:
    """The valid slots of one block as (src, dst, n_dst): explicit ``adj``
    indices, or the contiguous slot-major layout's implied ones (slot
    (i, k) at input row cap_dst + k*cap_dst + i)."""
    mask = np.asarray(block.mask)
    cap_dst, fanout = mask.shape
    if block.adj is None:
        k, i = np.meshgrid(np.arange(fanout), np.arange(cap_dst))
        src = cap_dst + k * cap_dst + i
    else:
        src = np.asarray(block.adj)
    dst = np.broadcast_to(np.arange(cap_dst)[:, None], mask.shape)
    keep = mask > 0
    return src[keep].astype(np.int32), dst[keep].astype(np.int32), cap_dst


def _mean_agg(h, src, dst, n_dst):
    s = jax.ops.segment_sum(h[src], dst, n_dst)
    deg = jax.ops.segment_sum(jnp.ones(src.shape, h.dtype), dst, n_dst)
    return s / jnp.maximum(deg, 1.0)[:, None]


def gat_layer(p, h, src, dst, n_dst, num_heads: int, negative_slope=0.2):
    """One GATConv: edge softmax per destination. Returns [n_dst, H, F]."""
    W = jnp.asarray(p["fc"]["kernel"], jnp.float32)
    feat = (h @ W).reshape(h.shape[0], num_heads, -1)
    el = jnp.einsum("nhf,hf->nh", feat,
                    jnp.asarray(p["attn_l"], jnp.float32))
    er = jnp.einsum("nhf,hf->nh", feat[:n_dst],
                    jnp.asarray(p["attn_r"], jnp.float32))
    e = jax.nn.leaky_relu(el[src] + er[dst], negative_slope)   # [E, H]
    e = jnp.exp(e - jax.ops.segment_max(e, dst, n_dst)[dst])
    alpha = e / jax.ops.segment_sum(e, dst, n_dst)[dst]
    return jax.ops.segment_sum(feat[src] * alpha[:, :, None], dst, n_dst)


def reference_forward(model, params, layer_edges: Sequence[Edges],
                      x) -> jax.Array:
    """Logits of a SAGE / GCN / GAT stack (``models.make_model``) in
    float32 at highest matmul precision. ``layer_edges[l]`` is layer l's
    (src, dst, n_dst); the first n_dst rows of a layer's input are its
    destinations (the blocks' prefix contract; for the full graph every
    node is a destination)."""
    from coala_gnn.models.gnn import GAT, GCN, SAGE

    p = params["params"]
    with jax.default_matmul_precision("highest"):
        h = jnp.asarray(x, jnp.float32)
        for i, (src, dst, n_dst) in enumerate(layer_edges):
            src, dst = jnp.asarray(src), jnp.asarray(dst)
            lp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                              p[f"layer_{i}"])
            last = i == len(layer_edges) - 1
            if isinstance(model, SAGE):
                h = (h[:n_dst] @ lp["fc_self"]["kernel"]
                     + lp["fc_self"]["bias"]
                     + _mean_agg(h, src, dst, n_dst)
                     @ lp["fc_neigh"]["kernel"])
            elif isinstance(model, GCN):
                h = (_mean_agg(h, src, dst, n_dst) @ lp["fc"]["kernel"]
                     + lp["fc"]["bias"])
            elif isinstance(model, GAT):
                h = gat_layer(lp, h, src, dst, n_dst, model.num_heads)
                h = h.mean(axis=1) if last else h.reshape(n_dst, -1)
            else:
                raise TypeError(f"no reference for {type(model).__name__}")
            if not last:
                h = jax.nn.relu(h)
        return h
