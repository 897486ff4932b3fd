#!/usr/bin/env python
"""Host-pipeline wire-format A/B.

Measures the packed (explicit adjacency) vs contiguous (slot-major,
sentinel-marked — adjacency implicit) host pipelines at the flagship
config, cached and uncached, on one chip. The contiguous format ships
~2x fewer bytes/step on the link-bound path (DESIGN.md §2 item 2).

  python examples/host_pipe_ab.py --out chiprun_out/host_pipe_ab.json
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--nodes", type=int, default=200_000)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--fanout", default="10,5")
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--cache_mb", type=int, default=1024)
    p.add_argument("--steps", type=int, default=32)
    p.add_argument("--warmup", type=int, default=8)
    p.add_argument("--out", default="")
    p.add_argument("--platform", default="gpu")
    args = p.parse_args(argv)

    from coala_gnn.utils.jaxconfig import setup as jax_setup
    jax_setup(args.platform)
    import bench
    from coala_gnn.data.packing import (batch_layout, packed_size,
                                            request_size,
                                            request_size_contig)
    from coala_gnn.graph.datasets import synthetic_graph
    from coala_gnn.sampling.neighbor import NeighborSampler

    fanouts = [int(f) for f in args.fanout.split(",")]
    ds = synthetic_graph(num_nodes=args.nodes, avg_degree=15,
                         feature_dim=args.dim, num_classes=16, seed=0)

    s = NeighborSampler(ds.graph, fanouts, args.batch, seed=0)
    n_req = s.caps[0][1]
    layout = batch_layout(s.caps, fanouts)
    wire = {"packed_bytes_per_step":
            4 * request_size(n_req, layout, args.batch),
            "contig_bytes_per_step":
            4 * request_size_contig(n_req, args.batch)}

    rows = {}
    for tag, contig, mb in [("packed_cached", False, args.cache_mb),
                            ("contig_cached", True, args.cache_mb),
                            ("packed_uncached", False, 0),
                            ("contig_uncached", True, 0)]:
        r = bench.run_host(ds, args.batch, fanouts, args.dim, args.hidden,
                           cache_mb=mb, bf16=False, warmup=args.warmup,
                           steps=args.steps, tag=f"ab-{tag}",
                           contiguous=contig)
        rows[tag] = {"value": r["value"], "unit": r["unit"],
                     "cache_hit_ratio": r["cache_hit_ratio"]}
        print(f"host A/B {tag}: {r['value']:,.0f} edges/s",
              file=sys.stderr, flush=True)

    art = {"config": {"nodes": args.nodes, "dim": args.dim,
                      "batch": args.batch, "fanout": fanouts,
                      "cache_mb": args.cache_mb, "steps": args.steps},
           "wire": wire, "rows": rows,
           "contig_vs_packed_cached":
               round(rows["contig_cached"]["value"]
                     / max(rows["packed_cached"]["value"], 1e-9), 2),
           "contig_vs_packed_uncached":
               round(rows["contig_uncached"]["value"]
                     / max(rows["packed_uncached"]["value"], 1e-9), 2)}
    txt = json.dumps(art, indent=1)
    print(txt)
    if args.out:
        with open(args.out, "w") as f:
            f.write(txt)
    return art


if __name__ == "__main__":
    main()
