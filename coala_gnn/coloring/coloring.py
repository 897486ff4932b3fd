"""Offline graph coloring + color-affinity metadata pipeline.

Capability parity with the reference preprocessing stage
(reference: COALA_GNN_Modules/graph_coloring.cpp driven by
examples/color_info_gen/generate_color_data.py):

  - BFS-propagated colors from sampled train seeds, hop <= 10, sampling rate
    0.005 * min(20, N/N_train)                (graph_coloring.cpp:75-79, :120)
  - per-color top-k (k=10) neighbor colors scored by sum of exp(-0.5*hop)
    over cross-color edges, normalized by the color's total in-edge count
    (graph_coloring.cpp:250-293)
  - artifacts color.npy / topk.npy / score.npy with the same shapes & dtypes
    (generate_color_data.py:59-67), so metadata interoperates both ways.

The hot loops live in the native C++ library (coala_gnn/native); a pure
NumPy/Python fallback implements identical semantics for environments without
a compiler and as a cross-check oracle in tests.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np

from coala_gnn.graph.csc import CSCGraph

# Parity constants (reference: graph_coloring.h:20-23).
GLOBAL_MAX_HOP = 10
GLOBAL_SAMPLING_RATE = 0.005
DEFAULT_TOPK = 10


@dataclasses.dataclass
class ColorMetadata:
    """color : int64 [N]      1-based color per node, 0 = uncolored
    topk  : int64 [C, K]    top-k neighbor colors per color (0-padded)
    score : float64 [C, K]  normalized affinity per (color, topk slot)
    hop   : int32 [N]       BFS hop at coloring time (not in ref artifacts)
    """

    color: np.ndarray
    topk: np.ndarray
    score: np.ndarray
    hop: Optional[np.ndarray] = None

    @property
    def num_colors(self) -> int:
        return int(self.topk.shape[0])

    @property
    def topk_k(self) -> int:
        return int(self.topk.shape[1])


def _native():
    try:
        from coala_gnn.native import lib as native_lib
        return native_lib, native_lib.get()
    except Exception:
        return None, None


def color_graph(graph: CSCGraph, train_ids: np.ndarray,
                max_hop: int = GLOBAL_MAX_HOP,
                base_rate: float = GLOBAL_SAMPLING_RATE,
                seed: int = 0, use_native: bool = True
                ) -> Tuple[int, np.ndarray, np.ndarray]:
    """BFS coloring. Returns (num_colors, color [N] int64, hop [N] int32)."""
    if use_native:
        mod, lib = _native()
        if lib is not None:
            return mod.color_graph(lib, graph, train_ids, max_hop, base_rate, seed)
    return _color_graph_py(graph, train_ids, max_hop, base_rate, seed)


def color_graph_from_seeds(graph: CSCGraph, train_ids: np.ndarray,
                           seed_nodes: np.ndarray,
                           max_hop: int = GLOBAL_MAX_HOP,
                           use_native: bool = True
                           ) -> Tuple[int, np.ndarray, np.ndarray]:
    """BFS coloring with the seed-node picks injected explicitly (seed i
    gets color i+1). Native and Python paths are EXACTLY equal given the
    same seed list — the RNG draw is the only divergence between them, and
    this entry bypasses it (tests/test_coloring.py cross-checks)."""
    if use_native:
        mod, lib = _native()
        if lib is not None:
            return mod.color_graph_seeded(lib, graph, train_ids, seed_nodes,
                                          max_hop)
    return _color_graph_py_core(graph, train_ids,
                                np.asarray(seed_nodes, np.int64), max_hop)


def _color_graph_py(graph: CSCGraph, train_ids: np.ndarray, max_hop: int,
                    base_rate: float, seed: int
                    ) -> Tuple[int, np.ndarray, np.ndarray]:
    """Pure-Python oracle with the same semantics as the native kernel
    (RNG seed sampling differs from native; inject explicit picks via
    color_graph_from_seeds for exact equality)."""
    train_ids = np.asarray(train_ids, dtype=np.int64)
    rng = np.random.default_rng(seed)
    frac = min(20.0, graph.num_nodes / max(len(train_ids), 1))
    rate = base_rate * frac
    picks = train_ids[rng.random(len(train_ids)) <= rate]
    return _color_graph_py_core(graph, train_ids, picks, max_hop)


def _color_graph_py_core(graph: CSCGraph, train_ids: np.ndarray,
                         picks: np.ndarray, max_hop: int
                         ) -> Tuple[int, np.ndarray, np.ndarray]:
    n = graph.num_nodes
    color = np.zeros(n, dtype=np.int64)
    hop_buf = np.zeros(n, dtype=np.int32)

    is_train = np.zeros(n, dtype=bool)
    is_train[np.asarray(train_ids, np.int64)] = True

    frontier = [(int(v), c + 1) for c, v in enumerate(picks)]
    num_colors = len(picks)

    # hop-0 pre-step: adopt uncolored train 1-hop neighbors.
    extra = []
    for v, c in frontier:
        for u in graph.in_neighbors(v):
            if is_train[u] and color[u] == 0:
                extra.append((int(u), c))
    frontier = frontier + extra

    for hop in range(max_hop):
        nxt = []
        while frontier:
            v, c = frontier.pop()           # LIFO, matching native
            if color[v] != 0:
                continue
            color[v] = c
            hop_buf[v] = hop + 1
            for u in graph.in_neighbors(v):
                nxt.append((int(u), c))
        frontier = nxt
    while frontier:                         # flush, no expansion
        v, c = frontier.pop()
        if color[v] == 0:
            color[v] = c
            hop_buf[v] = max_hop + 1
    return num_colors, color, hop_buf


def color_affinity(graph: CSCGraph, color: np.ndarray, hop: np.ndarray,
                   num_colors: int, topk: int = DEFAULT_TOPK,
                   use_native: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Per-color top-k neighbor colors + normalized affinity scores."""
    if use_native:
        mod, lib = _native()
        if lib is not None:
            return mod.color_affinity(lib, graph, color, hop, num_colors, topk)
    return _color_affinity_py(graph, color, hop, num_colors, topk)


def _color_affinity_py(graph: CSCGraph, color: np.ndarray, hop: np.ndarray,
                       num_colors: int, topk: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized NumPy oracle: identical scoring/normalization semantics."""
    # Per-edge (dst_color, src_color, src_hop):
    deg = np.diff(graph.indptr)
    dst_color = np.repeat(color, deg)
    src = np.asarray(graph.indices)
    src_color = color[src]
    src_score = np.exp(-0.5 * hop[src].astype(np.float64))

    valid = (dst_color != 0) & (src_color != 0) & (dst_color != src_color)
    pair = dst_color[valid] * (num_colors + 1) + src_color[valid]
    pair_sum = np.bincount(pair, weights=src_score[valid],
                           minlength=(num_colors + 1) ** 2
                           ).reshape(num_colors + 1, num_colors + 1)
    # normalization: total in-edge count of each color's nodes (all edges).
    neigh_count = np.bincount(color, weights=deg.astype(np.float64),
                              minlength=num_colors + 1)

    topk_out = np.zeros((num_colors, topk), dtype=np.int64)
    score_out = np.zeros((num_colors, topk), dtype=np.float64)
    for c in range(1, num_colors + 1):
        row = pair_sum[c]
        nz = np.flatnonzero(row)
        if nz.size == 0:
            continue
        # sort by (-score, color) — deterministic tie-break like native
        order = nz[np.lexsort((nz, -row[nz]))][:topk]
        topk_out[c - 1, : order.size] = order
        if neigh_count[c] > 0:
            score_out[c - 1, : order.size] = row[order] / neigh_count[c]
    return topk_out, score_out


def generate_color_metadata(graph: CSCGraph, train_ids: np.ndarray,
                            max_hop: int = GLOBAL_MAX_HOP,
                            base_rate: float = GLOBAL_SAMPLING_RATE,
                            topk: int = DEFAULT_TOPK, seed: int = 0,
                            use_native: bool = True) -> ColorMetadata:
    """Full offline pipeline (parity: generate_color_data.py:11-67)."""
    num_colors, color, hop = color_graph(graph, train_ids, max_hop, base_rate,
                                         seed, use_native)
    tk, sc = color_affinity(graph, color, hop, num_colors, topk, use_native)
    return ColorMetadata(color=color, topk=tk, score=sc, hop=hop)


# Artifact names match the reference outputs (generate_color_data.py:59-67).
_COLOR, _TOPK, _SCORE, _HOP = "color.npy", "topk.npy", "score.npy", "hop.npy"


def save_color_metadata(meta: ColorMetadata, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    np.save(os.path.join(path, _COLOR), meta.color)
    np.save(os.path.join(path, _TOPK), meta.topk)
    np.save(os.path.join(path, _SCORE), meta.score)
    if meta.hop is not None:
        np.save(os.path.join(path, _HOP), meta.hop)


def load_color_metadata(path: str) -> ColorMetadata:
    hop_path = os.path.join(path, _HOP)
    score = np.load(os.path.join(path, _SCORE))
    topk = np.load(os.path.join(path, _TOPK))
    if score.ndim == 1:  # reference saves score.npy flattened (1-D f64)
        score = score.reshape(topk.shape)
    return ColorMetadata(
        color=np.load(os.path.join(path, _COLOR)),
        topk=topk,
        score=score,
        hop=np.load(hop_path) if os.path.exists(hop_path) else None,
    )
