#!/usr/bin/env python
"""COO -> CSC preprocessing CLI.

Parity with the reference's offline graph converter
(reference: examples/create_csc_graph.py:276-304 — loads a COO
edge_index.npy, converts via DGL .formats('csc'), dumps
csc_indptr/csc_indices/csc_edge_ids.npy). Same artifact names/shapes, no DGL:
a direct stable counting sort (coala_gnn.graph.csc.coo_to_csc).

Heterogeneous graphs (flattened relation-id form — the artifact
examples/train.py's rsage/rgcn/rgat path consumes) additionally write
csc_edge_types.npy. Two ways to produce one:
  - several --edge_index files: file k's edges get relation id k (the
    reference's per-etype edge_index.npy dirs, dataloader.py:542-566,
    pre-flattened into one id space)
  - one --edge_index plus --edge_types (an aligned int .npy)

  python examples/create_csc_graph.py --edge_index /data/edge_index.npy \
      --num_nodes 10000000 --out /data/csc [--symmetrize]
  python examples/create_csc_graph.py --edge_index cites.npy writes.npy \
      --out /data/csc_hetero --symmetrize   # 4 relations: 2 + 2 reversed
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from coala_gnn.graph.csc import coo_to_csc, save_csc


def _load_coo(path):
    edges = np.load(path, mmap_mode="r")
    if edges.shape[0] == 2:
        return np.asarray(edges[0]), np.asarray(edges[1])
    return np.asarray(edges[:, 0]), np.asarray(edges[:, 1])


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--edge_index", type=str, nargs="+", required=True,
                   help=".npy COO edges, shape [2, E] or [E, 2]; several "
                        "files make a typed (heterogeneous) graph, file k "
                        "-> relation k")
    p.add_argument("--edge_types", type=str, default="",
                   help="int .npy aligned with a single --edge_index "
                        "(mutually exclusive with several edge files)")
    p.add_argument("--num_nodes", type=int, default=0,
                   help="0 = infer as max id + 1")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--symmetrize", action="store_true",
                   help="add reverse edges (reference does this for OGB "
                        "citation graphs, dataloader.py:455-466); on a "
                        "typed graph reverses get fresh relation ids "
                        "num_rels + r")
    args = p.parse_args(argv)

    t0 = time.perf_counter()
    if len(args.edge_index) > 1 and args.edge_types:
        p.error("--edge_types only combines with a single --edge_index")
    parts = [_load_coo(f) for f in args.edge_index]
    src = np.concatenate([s for s, _ in parts])
    dst = np.concatenate([d for _, d in parts])
    ets = None
    if len(parts) > 1:
        ets = np.concatenate([np.full(len(s), k, np.int32)
                              for k, (s, _) in enumerate(parts)])
    elif args.edge_types:
        ets = np.asarray(np.load(args.edge_types, mmap_mode="r"), np.int32)
        if ets.shape != src.shape:
            p.error("--edge_types length must match the edge count")
    n = args.num_nodes or int(max(src.max(), dst.max())) + 1
    if args.symmetrize:
        if ets is not None:
            n_rel = int(ets.max()) + 1
            ets = np.concatenate([ets, ets + n_rel])
        src, dst = (np.concatenate([src, dst]), np.concatenate([dst, src]))
    print(f"loaded {len(src)} edges over {n} nodes"
          + (f", {int(ets.max()) + 1} relations" if ets is not None else "")
          + f" in {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    g = coo_to_csc(src, dst, n, edge_types=ets)
    print(f"CSC build: {time.perf_counter() - t0:.1f}s")
    save_csc(g, args.out)
    print("wrote csc_indptr/csc_indices/csc_edge_ids"
          + ("/csc_edge_types" if ets is not None else "")
          + f".npy to {args.out}")


if __name__ == "__main__":
    main()
