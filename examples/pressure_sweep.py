#!/usr/bin/env python
"""Capacity-pressure sweep with repeats + variance.

The r3 artifact had single runs per point, a non-monotonic 48 MB dip, and a
commit claim the data didn't support. This script makes the sweep honest:
>=3 repeats per cache size, mean/std/min/max in the artifact, and the
uncached self-baseline measured inline at the same config. Claims must
come from the spread, not a point: transfer-bound regimes vary several-fold
run to run.

  python examples/pressure_sweep.py --repeats 3 --out chiprun_out/pressure_sweep.json

Reference protocol anchor: Cache_compare_script.sh:28-34 sweeps cache sizes
across SLURM jobs; this is the same axis measured in-process.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--nodes", type=int, default=200_000)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--fanout", default="10,5")
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--window", type=int, default=32)
    p.add_argument("--steps", type=int, default=64)
    p.add_argument("--warmup", type=int, default=8)
    p.add_argument("--cache_mbs", default="195,97,48,24,12")
    p.add_argument("--stage_transport", default="int8")
    p.add_argument("--platform", default="gpu")
    p.add_argument("--out", default="")
    p.add_argument("--merge", action="store_true",
                   help="merge into an existing --out artifact: reuse its "
                        "uncached baseline and measure only the cache_mbs "
                        "points it lacks (same config assumed)")
    args = p.parse_args(argv)

    from coala_gnn.utils.jaxconfig import setup as jax_setup
    jax_setup(args.platform)
    import bench  # noqa: E402  (repo-root bench.py)
    from coala_gnn.graph.datasets import synthetic_graph

    fanouts = [int(f) for f in args.fanout.split(",")]
    ds = synthetic_graph(num_nodes=args.nodes, avg_degree=15,
                         feature_dim=args.dim, num_classes=16, seed=0)

    # merge mode: reuse the artifact's uncached baseline + measured points,
    # measure only the budgets it lacks (a deadline-clamped suite run leaves
    # a partial artifact; this completes it without re-paying ~an hour)
    prior_points = []
    base = None
    if args.merge and args.out and os.path.exists(args.out):
        with open(args.out) as f:
            prior = json.load(f)
        # a merge across mismatched configs silently mislabels every prior
        # point: refuse unless the throughput-determining keys
        # match the current invocation exactly
        pc = prior["config"]
        cur = {"nodes": args.nodes, "dim": args.dim, "batch": args.batch,
               "fanout": fanouts, "window": args.window,
               "stage_transport": args.stage_transport,
               "repeats": args.repeats, "steps_per_run": args.steps}
        mismatch = {k: (pc.get(k), v) for k, v in cur.items()
                    if pc.get(k) != v}
        if mismatch:
            raise SystemExit(
                f"--merge refused: prior artifact config differs on "
                f"{mismatch} (stored, current); re-run without --merge "
                f"or match the stored config")
        base = pc["uncached_self_baseline_edges_per_s"]
        prior_points = prior["points"]

    if base is None:
        # inline uncached baseline (one run; it is host-link bound and slow —
        # its own variance is reported by the repeated points' vs_uncached)
        unc = bench.run_host(ds, args.batch, fanouts, args.dim, args.hidden,
                             cache_mb=0, bf16=False, warmup=2, steps=8,
                             tag="sweep-uncached")
        base = unc["value"]

    points = list(prior_points)
    have = {pt["cache_mb"] for pt in points}
    for mb in [int(v) for v in args.cache_mbs.split(",")]:
        if mb in have:
            continue
        vals, hits = [], []
        for rep in range(args.repeats):
            r = bench.run_resident(
                ds, args.batch, fanouts, args.dim, args.hidden, mb,
                bf16=False, warmup=args.warmup, steps=args.steps,
                tag=f"sweep-{mb}mb-r{rep}", priorities="degree",
                stage_transport=args.stage_transport, window=args.window)
            vals.append(r["value"])
            hits.append(r["cache_hit_ratio"])
        vals = np.asarray(vals, np.float64)
        points.append({
            "cache_mb": mb,
            "edges_per_s_mean": round(float(vals.mean()), 1),
            "edges_per_s_std": round(float(vals.std(ddof=1)), 1)
            if len(vals) > 1 else 0.0,
            "edges_per_s_min": round(float(vals.min()), 1),
            "edges_per_s_max": round(float(vals.max()), 1),
            "runs": [round(float(v), 1) for v in vals],
            "hit_ratio": round(float(np.mean(hits)), 4),
            "vs_uncached_mean": round(float(vals.mean()) / base, 2),
            "vs_uncached_min": round(float(vals.min()) / base, 2),
        })
        print(f"sweep {mb} MB: {points[-1]}", file=sys.stderr, flush=True)
        if args.out:   # incremental: a timeout-killed run keeps its points
            with open(args.out, "w") as f:
                f.write(json.dumps(_artifact(args, fanouts, base, points),
                                   indent=1))

    txt = json.dumps(_artifact(args, fanouts, base, points), indent=1)
    print(txt)
    if args.out:
        with open(args.out, "w") as f:
            f.write(txt)


def _artifact(args, fanouts, base, points):
    return {
        "config": {"nodes": args.nodes, "dim": args.dim, "batch": args.batch,
                   "fanout": fanouts, "window": args.window,
                   "stage_transport": args.stage_transport,
                   "priorities": "degree", "repeats": args.repeats,
                   "steps_per_run": args.steps,
                   "uncached_self_baseline_edges_per_s": base},
        "points": points,
        # set membership, not count: a merge may carry points whose budget
        # is not in the current request
        "complete": all(
            int(v) in {pt["cache_mb"] for pt in points}
            for v in args.cache_mbs.split(",")),
        "note": "judge claims on min/max spread, not single runs",
    }


if __name__ == "__main__":
    main()
