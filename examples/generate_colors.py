#!/usr/bin/env python
"""Offline color-metadata generation CLI.

Equivalent of the reference's preprocessing driver
(reference: examples/color_info_gen/generate_color_data.py): colors the graph
from the train set and writes color.npy / topk.npy / score.npy (+ hop.npy).

  python examples/generate_colors.py --data synthetic --out /tmp/colors
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data", type=str, default="synthetic")
    p.add_argument("--path", type=str, default="")
    p.add_argument("--dataset_size", type=str, default="tiny")
    p.add_argument("--num_classes", type=int, default=16)
    p.add_argument("--out", type=str, required=True)
    # Parity defaults: hop 10, rate 0.005, topk 10 (graph_coloring.h:20-23).
    p.add_argument("--max_hop", type=int, default=10)
    p.add_argument("--sampling_rate", type=float, default=0.005)
    p.add_argument("--topk", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_nodes", type=int, default=100_000)
    p.add_argument("--avg_degree", type=int, default=15)
    p.add_argument("--feature_dim", type=int, default=128)
    args = p.parse_args(argv)

    from coala_gnn.graph.datasets import load_dataset, synthetic_graph
    from coala_gnn.coloring import generate_color_metadata, save_color_metadata

    if args.data == "synthetic":
        ds = synthetic_graph(num_nodes=args.num_nodes, avg_degree=args.avg_degree,
                             feature_dim=args.feature_dim,
                             num_classes=args.num_classes, seed=args.seed)
    else:
        ds = load_dataset(args.data, path=args.path,
                          dataset_size=args.dataset_size,
                          num_classes=args.num_classes)

    t0 = time.perf_counter()
    meta = generate_color_metadata(ds.graph, ds.train_idx,
                                   max_hop=args.max_hop,
                                   base_rate=args.sampling_rate,
                                   topk=args.topk, seed=args.seed)
    dt = time.perf_counter() - t0
    colored = (meta.color > 0).mean()
    print(f"colored {ds.graph.num_nodes} nodes ({colored:.1%} covered) into "
          f"{meta.num_colors} colors in {dt:.2f}s")
    save_color_metadata(meta, args.out)
    print(f"wrote color.npy/topk.npy/score.npy/hop.npy to {args.out}")


if __name__ == "__main__":
    main()
