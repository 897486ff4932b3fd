"""CSC graph container and format conversion.

Capability parity with the reference's CSC pipeline:
  - reference builds csc_indptr/csc_indices/csc_edge_ids .npy artifacts from a
    COO edge_index (reference: examples/create_csc_graph.py:276-304) and loads
    them zero-copy into node-shared UVA memory
    (reference: examples/ssd_gnn_dataloader.py:453-523).

Design: one process per host, so the graph simply lives as NumPy
arrays in host RAM (no POSIX shm / UVA machinery needed). Sampling runs on the
host (NumPy or the native C++ sampler); only static-shape padded blocks and
feature rows ever move to the device.

CSC convention: for destination node v, its in-neighbors are
``indices[indptr[v]:indptr[v+1]]`` (edge direction src -> dst, matching DGL's
``adj_tensors('csc')`` layout the reference samples from).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np


@dataclasses.dataclass
class CSCGraph:
    """Compressed-sparse-column graph over ``num_nodes`` nodes.

    indptr   : int64 [num_nodes + 1]
    indices  : int32/int64 [num_edges]   in-neighbor (source) node ids per dst
    edge_ids : optional [num_edges]      original edge ids (parity with the
               reference's csc_edge_ids.npy; unused by compute paths)
    """

    indptr: np.ndarray
    indices: np.ndarray
    edge_ids: Optional[np.ndarray] = None
    edge_types: Optional[np.ndarray] = None  # int [num_edges]; hetero graphs
    num_edge_types: int = 1

    def __post_init__(self) -> None:
        self.indptr = np.ascontiguousarray(self.indptr, dtype=np.int64)
        self.indices = np.ascontiguousarray(self.indices)
        if self.indptr.ndim != 1 or self.indices.ndim != 1:
            raise ValueError("indptr/indices must be 1-D")
        if self.indptr[0] != 0 or self.indptr[-1] != self.indices.shape[0]:
            raise ValueError("indptr does not index indices")

    @property
    def num_nodes(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    def in_degrees(self, nodes: Optional[np.ndarray] = None) -> np.ndarray:
        deg = np.diff(self.indptr)
        return deg if nodes is None else deg[nodes]

    def in_neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v] : self.indptr[v + 1]]

    def reverse(self) -> "CSCGraph":
        """CSC of the reversed graph (== CSR of this graph)."""
        dst = np.repeat(np.arange(self.num_nodes, dtype=self.indices.dtype),
                        np.diff(self.indptr))
        return coo_to_csc(self.indices, dst, self.num_nodes)


def coo_to_csc(src: np.ndarray, dst: np.ndarray, num_nodes: int,
               edge_ids: Optional[np.ndarray] = None,
               edge_types: Optional[np.ndarray] = None) -> CSCGraph:
    """Build CSC (group edges by destination) from COO edge lists.

    Parity with reference examples/create_csc_graph.py:276-304 (which delegates
    to DGL ``.formats('csc')``); here a direct stable counting sort.
    ``edge_types`` (int [E], optional) rides the same permutation, making the
    result a flattened heterogeneous graph (relation id per edge — the
    static-shape form of the reference's per-etype DGL heterograph,
    dataloader.py:561-567).
    """
    src = np.asarray(src)
    dst = np.asarray(dst)
    if src.shape != dst.shape:
        raise ValueError("src/dst shape mismatch")
    if edge_types is not None and np.asarray(edge_types).shape != src.shape:
        raise ValueError("edge_types/src shape mismatch")
    counts = np.bincount(dst, minlength=num_nodes).astype(np.int64)
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    order = np.argsort(dst, kind="stable")
    indices = src[order]
    eids = None
    if edge_ids is not None:
        eids = np.asarray(edge_ids)[order]
    elif src.shape[0] > 0:
        eids = order.astype(np.int64)
    ets = None
    n_et = 1
    if edge_types is not None:
        ets = np.ascontiguousarray(np.asarray(edge_types)[order], np.int32)
        n_et = int(ets.max()) + 1 if ets.size else 1
    return CSCGraph(indptr=indptr, indices=indices, edge_ids=eids,
                    edge_types=ets, num_edge_types=n_et)


# .npy artifact names match the reference's outputs
# (create_csc_graph.py:284-286) so preprocessed reference data drops in.
_INDPTR = "csc_indptr.npy"
_INDICES = "csc_indices.npy"
_EDGE_IDS = "csc_edge_ids.npy"
_EDGE_TYPES = "csc_edge_types.npy"


def save_csc(graph: CSCGraph, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    np.save(os.path.join(path, _INDPTR), graph.indptr)
    np.save(os.path.join(path, _INDICES), graph.indices)
    if graph.edge_ids is not None:
        np.save(os.path.join(path, _EDGE_IDS), graph.edge_ids)
    if graph.edge_types is not None:
        # the hetero artifact load_csc reads back (save_csc
        # previously could never produce what load_csc consumes)
        np.save(os.path.join(path, _EDGE_TYPES), graph.edge_types)


def load_csc(path: str, mmap: bool = True) -> CSCGraph:
    """Load CSC artifacts; ``mmap`` avoids copying giant graphs into RAM."""
    mode = "r" if mmap else None
    indptr = np.load(os.path.join(path, _INDPTR), mmap_mode=mode)
    indices = np.load(os.path.join(path, _INDICES), mmap_mode=mode)
    eids_path = os.path.join(path, _EDGE_IDS)
    edge_ids = np.load(eids_path, mmap_mode=mode) if os.path.exists(eids_path) else None
    g = CSCGraph.__new__(CSCGraph)
    g.indptr = np.asarray(indptr) if not mmap else indptr
    g.indices = indices
    g.edge_ids = edge_ids
    et_path = os.path.join(path, "csc_edge_types.npy")
    g.edge_types = np.load(et_path, mmap_mode=mode) if os.path.exists(et_path) else None
    g.num_edge_types = int(g.edge_types.max()) + 1 if g.edge_types is not None else 1
    return g
