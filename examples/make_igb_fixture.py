#!/usr/bin/env python
"""Generate a tiny REFERENCE-FORMAT dataset fixture.

Writes the IGB raw .npy directory layout the reference trainer consumes
(reference: examples/dataloader.py:18-124 — node_feat.npy float32,
node_label_19.npy float32, paper__cites__paper/edge_index.npy [E, 2]), and
optionally the csc_*.npy preprocessed layout (create_csc_graph.py output
surface), from a learnable synthetic graph. De-risks load_igb_npy /
load_preprocessed and the coloring artifact interop offline — the env has
no real IGB/OGB data and no egress.

Usage:
  python examples/make_igb_fixture.py --out /tmp/igb_fixture \
      [--num_nodes 4000] [--dim 32] [--size tiny] [--csc]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from coala_gnn.graph.datasets import synthetic_graph


def write_igb_fixture(out: str, num_nodes: int = 4000, dim: int = 32,
                      size: str = "tiny", avg_degree: int = 8,
                      seed: int = 0, csc: bool = False) -> str:
    """Returns the fixture root (pass as --path with --data igb)."""
    ds = synthetic_graph(num_nodes=num_nodes, avg_degree=avg_degree,
                         feature_dim=dim, num_classes=19, seed=seed)
    paper = os.path.join(out, size, "processed", "paper")
    cites = os.path.join(out, size, "processed", "paper__cites__paper")
    os.makedirs(paper, exist_ok=True)
    os.makedirs(cites, exist_ok=True)

    np.save(os.path.join(paper, "node_feat.npy"),
            ds.features.astype(np.float32))
    # reference stores labels as float32 (dataloader.py:80-101)
    np.save(os.path.join(paper, "node_label_19.npy"),
            ds.labels.astype(np.float32))
    # [E, 2] (src, dst) pairs from the CSC graph
    deg = np.diff(ds.graph.indptr)
    dst = np.repeat(np.arange(ds.graph.num_nodes, dtype=np.int32), deg)
    src = np.asarray(ds.graph.indices, dtype=np.int32)
    np.save(os.path.join(cites, "edge_index.npy"),
            np.stack([src, dst], axis=1))

    if csc:
        from coala_gnn.graph.csc import save_csc
        pre = os.path.join(out, "preprocessed")
        os.makedirs(pre, exist_ok=True)
        save_csc(ds.graph, pre)
        np.save(os.path.join(pre, "features.npy"),
                ds.features.astype(np.float32))
        np.save(os.path.join(pre, "labels.npy"), ds.labels.astype(np.int32))
        np.save(os.path.join(pre, "train_idx.npy"),
                ds.train_idx.astype(np.int64))
    return out


def write_igb_hetero_fixture(out: str, num_paper: int = 3000, dim: int = 32,
                             size: str = "tiny", avg_degree: int = 8,
                             seed: int = 0) -> str:
    """Reference-format IGB HETERO fixture (dataloader.py:534-636 layout):
    4 node types (paper/author/institute/fos, same feature dim), 4 edge
    dirs with [E, 2] (src, dst) edge_index.npy, paper labels float32.
    Paper subgraph comes from the learnable synthetic generator so hetero
    end-to-end accuracy stays a usable oracle."""
    rng = np.random.default_rng(seed)
    ds = synthetic_graph(num_nodes=num_paper, avg_degree=avg_degree,
                         feature_dim=dim, num_classes=19, seed=seed)
    counts = {"paper": num_paper, "author": max(num_paper // 2, 8),
              "institute": max(num_paper // 20, 4),
              "fos": max(num_paper // 10, 4)}
    base = os.path.join(out, size, "processed")
    for t, n in counts.items():
        os.makedirs(os.path.join(base, t), exist_ok=True)
        feat = (ds.features if t == "paper" else
                rng.normal(0, 1, size=(n, dim)).astype(np.float32))
        np.save(os.path.join(base, t, "node_feat.npy"), feat)
    np.save(os.path.join(base, "paper", "node_label_19.npy"),
            ds.labels.astype(np.float32))

    deg = np.diff(ds.graph.indptr)
    dst = np.repeat(np.arange(num_paper, dtype=np.int32), deg)
    src = np.asarray(ds.graph.indices, dtype=np.int32)
    def _dump(d, s, t):
        os.makedirs(os.path.join(base, d), exist_ok=True)
        np.save(os.path.join(base, d, "edge_index.npy"),
                np.stack([np.asarray(s, np.int32),
                          np.asarray(t, np.int32)], axis=1))
    _dump("paper__cites__paper", src, dst)
    n_pa = num_paper * 2
    _dump("paper__written_by__author",
          rng.integers(0, counts["paper"], n_pa),
          rng.integers(0, counts["author"], n_pa))
    n_ai = counts["author"]
    _dump("author__affiliated_to__institute",
          np.arange(n_ai), rng.integers(0, counts["institute"], n_ai))
    n_pf = num_paper
    _dump("paper__topic__fos",
          rng.integers(0, counts["paper"], n_pf),
          rng.integers(0, counts["fos"], n_pf))
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--num_nodes", type=int, default=4000)
    p.add_argument("--dim", type=int, default=32)
    p.add_argument("--size", type=str, default="tiny")
    p.add_argument("--avg_degree", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--csc", action="store_true",
                   help="also write the csc_*.npy preprocessed layout")
    p.add_argument("--hetero", action="store_true",
                   help="write the 4-node-type hetero layout instead "
                        "(reference dataloader.py:534-636)")
    a = p.parse_args()
    if a.hetero:
        root = write_igb_hetero_fixture(a.out, a.num_nodes, a.dim, a.size,
                                        a.avg_degree, a.seed)
    else:
        root = write_igb_fixture(a.out, a.num_nodes, a.dim, a.size,
                                 a.avg_degree, a.seed, a.csc)
    print(f"wrote IGB-format fixture to {root}", file=sys.stderr)


if __name__ == "__main__":
    main()
