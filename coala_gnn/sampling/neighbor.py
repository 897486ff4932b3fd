"""Fanout neighbor sampling producing static-shape padded blocks.

Capability parity: the reference delegates sampling to DGL's
``MultiLayerNeighborSampler`` over a UVA CSC graph
(reference: COALA-GNN-Setup/COALA_GNN/COALA_GNN_DataLoader.py:162,
examples/sbatch_ssd_gnn_train.py:70-72) which yields *ragged* message-flow
blocks. XLA wants static shapes, so this sampler is designed for them:

  - Every layer's block is a dense ``adj: int32 [cap_dst, fanout]`` matrix of
    *local* indices into that layer's source-node array, plus a float mask.
    Ragged neighborhoods are padded; all capacities derive from
    ``max_sample_size = batch x prod(fanout_i + 1)``, the exact buffer-sizing
    rule the reference uses for its exchange buffers
    (reference: COALA_GNN_Manager.py:79-81).
  - Destination nodes are a prefix of the source-node array (same contract as
    DGL blocks), so models can do ``h_dst = h[:num_dst]``.
  - Sampling itself runs on the host (NumPy here; the native C++ sampler in
    coala_gnn/native is a drop-in fast path). Only fixed-shape int32/float
    arrays cross to the device, so every downstream jit sees one shape.

Semantics: for a destination with degree d and fanout f,
  - d == 0      -> all slots masked out (isolated node aggregates to zero)
  - 0 < d <= f  -> all d in-neighbors taken (exact, no replacement)
  - d > f       -> f draws; without replacement via the native sampler
                   (Floyd's algorithm), with replacement in the NumPy
                   fallback (an unbiased neighborhood-mean estimator either
                   way — matches DGL's default replace=False up to estimator
                   variance).
"""

from __future__ import annotations

import dataclasses
from functools import reduce
from typing import List, Optional, Sequence, Tuple

import numpy as np

from coala_gnn.graph.csc import CSCGraph


@dataclasses.dataclass
class Block:
    """One message-passing layer: src features -> dst aggregates.

    src_ids : int64 [cap_src]        global node ids; dst ids are the prefix;
                                     padded tail repeats id 0 (never referenced
                                     by a valid adj entry)
    adj     : int32 [cap_dst, fanout] local index into src_ids per slot;
                                     masked slots point at the dst itself.
                                     ``None`` marks the contiguous slot-major
                                     layout (slot (i,k) at row
                                     cap_dst + k*cap_dst + i; invalid entries
                                     of src_ids hold the sentinel num_nodes)
    mask    : float32 [cap_dst, fanout] 1.0 = real sampled edge
    num_dst : int                     valid destination count (<= cap_dst)
    num_src : int                     valid source count (<= cap_src)
    """

    src_ids: np.ndarray
    adj: Optional[np.ndarray]
    mask: np.ndarray
    num_dst: int
    num_src: int
    rel: Optional[np.ndarray] = None  # int32 [cap_dst, fanout] edge types
                                      # (hetero graphs only; 0 elsewhere)

    @property
    def cap_dst(self) -> int:
        return self.mask.shape[0]

    @property
    def cap_src(self) -> int:
        return self.src_ids.shape[0]

    @property
    def fanout(self) -> int:
        return self.mask.shape[1]


@dataclasses.dataclass
class SampledBatch:
    """All layers for one minibatch. blocks[0] is the input-most layer."""

    blocks: List[Block]
    seeds: np.ndarray        # int64 [batch] — the labelled destination nodes
    input_ids: np.ndarray    # == blocks[0].src_ids (feature-fetch id list)
    num_input: int           # valid prefix length of input_ids


def block_capacities(batch_size: int, fanouts: Sequence[int]) -> List[Tuple[int, int]]:
    """[(cap_dst, cap_src)] per layer, input-most first.

    cap_dst[l] = B * prod_{j>l}(f_j + 1); cap_src[l] = cap_dst[l] * (f_l + 1).
    Layer L-1 (output) has cap_dst = B. The product rule is the reference's
    max_sample_size (COALA_GNN_Manager.py:79-81).
    """
    caps = []
    cap_dst = batch_size
    for f in reversed(fanouts):  # output-most -> input-most
        caps.append((cap_dst, cap_dst * (f + 1)))
        cap_dst = cap_dst * (f + 1)
    return list(reversed(caps))


def max_sample_size(batch_size: int, fanouts: Sequence[int]) -> int:
    """batch x prod(fanout_i + 1) — parity constant used to size every
    request/feature buffer (reference: COALA_GNN_Manager.py:79-81)."""
    return batch_size * reduce(lambda a, b: a * (b + 1), fanouts, 1)


def _sample_layer_numpy(graph: CSCGraph, dst_ids: np.ndarray, fanout: int,
                        rng: np.random.Generator
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized one-layer sampling. Returns (nbr_global [n,f], mask [n,f])."""
    n = dst_ids.shape[0]
    starts = graph.indptr[dst_ids]
    deg = graph.indptr[dst_ids + 1] - starts

    # Slot k valid iff k < min(deg, fanout)... except deg > fanout uses all f.
    k = np.arange(fanout, dtype=np.int64)[None, :]
    take = np.minimum(deg, fanout)[:, None]
    mask = (k < take)

    small = deg[:, None] <= fanout
    # deg<=f: offset = slot index (take all); deg>f: uniform draws w/ replacement.
    rand_off = (rng.random((n, fanout)) * np.maximum(deg, 1)[:, None]).astype(np.int64)
    offsets = np.where(small, np.minimum(k, np.maximum(deg[:, None] - 1, 0)), rand_off)
    edge_pos = starts[:, None] + offsets
    nbr = graph.indices[edge_pos].astype(np.int64)
    # Masked slots: point at the dst itself (safe local mapping, zero weight).
    nbr = np.where(mask, nbr, dst_ids[:, None])
    rel = None
    if graph.edge_types is not None:
        rel = np.where(mask, graph.edge_types[edge_pos], 0).astype(np.int32)
    return nbr, mask, rel


class NeighborSampler:
    """Multi-layer fanout sampler (DGL MultiLayerNeighborSampler equivalent).

    fanouts are input-most first, e.g. [10, 5, 5] == reference --fan_out
    "10,5,5" (sbatch_ssd_gnn_train.py:70-72). ``sample(seeds)`` walks from the
    output layer inwards, deduplicating each frontier, and pads every array to
    the static capacities so jitted consumers never recompile.
    """

    def __init__(self, graph: CSCGraph, fanouts: Sequence[int],
                 batch_size: int, seed: int = 0,
                 use_native: bool = True, contiguous: bool = False):
        self.graph = graph
        self.fanouts = list(fanouts)
        self.batch_size = batch_size
        self.caps = block_capacities(batch_size, fanouts)
        self.rng = np.random.default_rng(seed)
        self.contiguous = contiguous
        if contiguous and graph.edge_types is not None:
            raise NotImplementedError(
                "contiguous host sampling is homogeneous-only (hetero "
                "blocks need the rel plane; use the default layout)")
        self._native = None
        if use_native:
            try:
                from coala_gnn.native import lib as native_lib
                self._native = native_lib.get()
            except Exception:
                self._native = None

    def _sample_layer(self, dst_ids, fanout):
        if self._native is not None:
            from coala_gnn.native import lib as native_lib
            seed = int(self.rng.integers(0, 2**63 - 1))
            if self.graph.edge_types is None:
                nbr, mask = native_lib.sample_layer(
                    self._native, self.graph, dst_ids, fanout, seed)
                return nbr, mask, None
            return native_lib.sample_layer_typed(
                self._native, self.graph, dst_ids, fanout, seed)
        return _sample_layer_numpy(self.graph, dst_ids, fanout, self.rng)

    def sample(self, seeds: np.ndarray) -> SampledBatch:
        seeds = np.asarray(seeds, dtype=np.int64)
        if seeds.shape[0] != self.batch_size:
            raise ValueError(
                f"got {seeds.shape[0]} seeds, expected batch_size={self.batch_size}"
                " (tail batches are dropped upstream, matching the reference)")
        if self.contiguous:
            return self._sample_contiguous(seeds)
        blocks: List[Block] = []
        dst_ids = seeds
        for layer in range(len(self.fanouts) - 1, -1, -1):
            fanout = self.fanouts[layer]
            cap_dst, cap_src = self.caps[layer]
            nbr, mask, rel = self._sample_layer(dst_ids, fanout)
            blocks.insert(0, _build_block(dst_ids, nbr, mask, cap_dst, cap_src,
                                          rel))
            dst_ids = blocks[0].src_ids[: blocks[0].num_src]
        b0 = blocks[0]
        return SampledBatch(blocks=blocks, seeds=seeds,
                            input_ids=b0.src_ids, num_input=b0.num_src)

    def _sample_contiguous(self, seeds: np.ndarray) -> SampledBatch:
        """Dedup-free slot-major layout, mirroring the device sampler's
        ``dedup=False`` path (sampling/device_sampler.py): layer l's input
        row array is ``cat = [dst | nbr.T.flat]`` so slot (i, k) lives at
        row ``cap_dst + k*cap_dst + i`` — a *static* position. Blocks carry
        ``adj=None`` (ops/aggregate dispatches to the streaming
        plane-FMA path) and INVALID slots hold the sentinel id
        ``num_nodes`` instead of pointing at the dst, so masks are
        derivable from the id vector alone: the whole batch crosses the
        host->device link as ``[n_valid | ids | labels]``
        (data/packing.pack_request_contig), ~2x fewer bytes than the
        dedup layout's explicit adjacency."""
        sent = self.graph.num_nodes
        dst = np.asarray(seeds, dtype=np.int64)
        blocks: List[Block] = []
        for layer in range(len(self.fanouts) - 1, -1, -1):
            fanout = self.fanouts[layer]
            cap_dst, cap_src = self.caps[layer]
            assert dst.shape[0] == cap_dst, "contiguous layer-size invariant"
            vdst = dst != sent
            nbr, mask, _ = self._sample_layer(np.where(vdst, dst, 0), fanout)
            mask = np.asarray(mask, np.float32) * vdst[:, None]
            nbr = np.where(mask > 0, nbr, sent)
            cat = np.concatenate([dst, nbr.T.reshape(-1)])
            blocks.insert(0, Block(
                src_ids=cat, adj=None, mask=mask,
                num_dst=int(vdst.sum()), num_src=int((cat != sent).sum())))
            dst = cat
        b0 = blocks[0]
        return SampledBatch(blocks=blocks, seeds=np.asarray(seeds, np.int64),
                            input_ids=b0.src_ids, num_input=b0.num_src)


def _build_block(dst_ids: np.ndarray, nbr: np.ndarray, mask: np.ndarray,
                 cap_dst: int, cap_src: int,
                 rel: Optional[np.ndarray] = None) -> Block:
    """Dedup sampled frontier into a src array (dst prefix preserved) and
    relabel adj into local indices; pad everything to capacity."""
    n_dst, fanout = nbr.shape
    cat = np.concatenate([dst_ids, nbr.reshape(-1)])
    uniq, first_idx, inv = np.unique(cat, return_index=True, return_inverse=True)
    order = np.argsort(first_idx, kind="stable")      # first-occurrence order
    rank = np.empty_like(order)
    rank[order] = np.arange(order.shape[0])
    src_ids = uniq[order]                              # dst_ids are the prefix
    local = rank[inv]
    adj = local[n_dst:].reshape(n_dst, fanout).astype(np.int32)

    num_src = src_ids.shape[0]
    if num_src > cap_src or n_dst > cap_dst:
        raise AssertionError("capacity overflow — capacities are an invariant")

    src_pad = np.zeros(cap_src, dtype=np.int64)
    src_pad[:num_src] = src_ids
    adj_pad = np.zeros((cap_dst, fanout), dtype=np.int32)
    adj_pad[:n_dst] = adj
    mask_pad = np.zeros((cap_dst, fanout), dtype=np.float32)
    mask_pad[:n_dst] = mask
    rel_pad = None
    if rel is not None:
        rel_pad = np.zeros((cap_dst, fanout), dtype=np.int32)
        rel_pad[:n_dst] = rel
    return Block(src_ids=src_pad, adj=adj_pad, mask=mask_pad,
                 num_dst=n_dst, num_src=num_src, rel=rel_pad)
