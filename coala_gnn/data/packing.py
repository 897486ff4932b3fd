"""Host->device batch packing.

Over a high-latency host<->device link every `device_put` is a round trip;
a training step that ships adj / mask / labels separately pays 5+ of them.
This module packs a whole batch into ONE int32 buffer and unpacks it inside
the consuming jit:

  - the fanout mask is folded into the adjacency sign: invalid slots become
    -1, so ``mask = adj >= 0`` is reconstructed on device for free (the
    reference uses -1 sentinels in its request buffers the same way,
    ssd_gnn_cache.cuh:119);
  - labels ride in the same buffer.

This cuts per-step host->device traffic ~3x and transactions to 1.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from coala_gnn.models.layers import DeviceBlock

Layout = Tuple[Tuple[int, int], ...]   # ((cap_dst, fanout), ...) per layer


def batch_layout(caps: Sequence[Tuple[int, int]],
                 fanouts: Sequence[int]) -> Layout:
    """Layout from sampler capacities: [(cap_dst, fanout)] per layer."""
    return tuple((cap_dst, f) for (cap_dst, _), f in zip(caps, fanouts))


def packed_size(layout: Layout, batch_size: int) -> int:
    return sum(cd * f for cd, f in layout) + batch_size


def pack_batch(adjs: Sequence[np.ndarray], masks: Sequence[np.ndarray],
               labels: np.ndarray) -> np.ndarray:
    """Host side: one int32 vector [sum(cap_dst*fanout) + B].

    adjs/masks are per-layer [cap_dst, fanout] (single device)."""
    parts = []
    for adj, mask in zip(adjs, masks):
        enc = np.where(mask > 0, adj, -1).astype(np.int32)
        parts.append(enc.reshape(-1))
    parts.append(np.ascontiguousarray(labels, dtype=np.int32))
    return np.concatenate(parts)


def unpack_batch(buf: jax.Array, layout: Layout, batch_size: int,
                 offset: int = 0) -> Tuple[List[DeviceBlock], jax.Array]:
    """Device side (inside jit): buffer -> (blocks, labels)."""
    blocks = []
    off = offset
    for cap_dst, fanout in layout:
        n = cap_dst * fanout
        enc = jax.lax.dynamic_slice_in_dim(buf, off, n).reshape(cap_dst, fanout)
        off += n
        mask = (enc >= 0).astype(jnp.float32)
        adj = jnp.maximum(enc, 0)
        blocks.append(DeviceBlock(adj=adj, mask=mask))
    labels = jax.lax.dynamic_slice_in_dim(buf, off, batch_size)
    return blocks, labels


# ---- full-request packing: [num_input | input_ids(n_req) | blocks | labels]
# One buffer per batch serves BOTH the cache probe (ids prefix) and the train
# step (blocks+labels suffix): a single host->device transaction per step.

def request_size(n_req: int, layout: Layout, batch_size: int) -> int:
    return 1 + n_req + packed_size(layout, batch_size)


def pack_request(input_ids: np.ndarray, num_input: int,
                 adjs: Sequence[np.ndarray], masks: Sequence[np.ndarray],
                 labels: np.ndarray) -> np.ndarray:
    head = np.empty(1 + input_ids.shape[0], dtype=np.int32)
    head[0] = num_input
    head[1:] = input_ids
    return np.concatenate([head, pack_batch(adjs, masks, labels)])


def unpack_request_ids(buf: jax.Array, n_req: int
                       ) -> Tuple[jax.Array, jax.Array]:
    """(ids [n_req] int32, num_valid scalar) from a request buffer."""
    return jax.lax.dynamic_slice_in_dim(buf, 1, n_req), buf[0]


def unpack_request_batch(buf: jax.Array, n_req: int, layout: Layout,
                         batch_size: int) -> Tuple[List[DeviceBlock], jax.Array]:
    return unpack_batch(buf, layout, batch_size, offset=1 + n_req)


# ---- contiguous (slot-major) request packing: [n_valid | ids | labels] ----
# Under the dedup-free layout (sampling/neighbor._sample_contiguous /
# sampling/device_sampler dedup=False) the adjacency is pure structure —
# slot (i, k) of layer l lives at row cap_dst_l + k*cap_dst_l + i of the id
# vector, and invalid slots hold the sentinel id num_nodes — so masks are
# derivable ON DEVICE from the ids alone. The wire format drops the
# explicit adjacency entirely: ~2x fewer bytes per step on the
# link-bound host pipeline.

def request_size_contig(n_req: int, batch_size: int) -> int:
    return 1 + n_req + batch_size


def pack_request_contig(input_ids: np.ndarray, num_input: int,
                        labels: np.ndarray) -> np.ndarray:
    """[num_input | ids (slot-major cat, sentinel-marked) | labels]."""
    n_req = input_ids.shape[0]
    out = np.empty(1 + n_req + labels.shape[0], dtype=np.int32)
    out[0] = num_input
    out[1:1 + n_req] = input_ids
    out[1 + n_req:] = labels
    return out


def unpack_request_contig(buf: jax.Array, n_req: int, layout: Layout,
                          batch_size: int, sentinel: int
                          ) -> Tuple[List[DeviceBlock], jax.Array]:
    """Device side (inside jit): [n_valid | ids | labels] -> (blocks, labels).

    Layer l's mask is a reshape of its slot segment of the id vector
    compared against the sentinel — no gather, no extra transfer. Blocks
    carry adj=None (the contiguous fast path of ops/aggregate)."""
    ids = jax.lax.dynamic_slice_in_dim(buf, 1, n_req)
    blocks = []
    for cap_dst, fanout in layout:
        seg = jax.lax.dynamic_slice_in_dim(ids, cap_dst, cap_dst * fanout)
        mask = (seg.reshape(fanout, cap_dst).T != sentinel).astype(jnp.float32)
        blocks.append(DeviceBlock(adj=None, mask=mask))
    labels = jax.lax.dynamic_slice_in_dim(buf, 1 + n_req, batch_size)
    return blocks, labels
