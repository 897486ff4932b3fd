#!/usr/bin/env python
"""Flagship headline tuning grid.

Runs the full-coverage resident pipeline at the flagship config across the
candidate headline configurations on one chip and persists every row:

  - f32 lines (baseline-parity headline), scan_unroll in {1, 4, 8}
  - bf16 features + bf16 model compute
  - int8 lines (+ per-line scale) x {f32, bf16} model compute
  - int8 lines + bf16 model + scan_unroll 8

The step is cache-gather-bound (DESIGN.md §2: 67.5k x 1 KB random rows =
2.6 ms of the 2.3 ms pipelined step); narrower lines cut the gathered
bytes 2-4x and scan_unroll lets XLA overlap step i+1's gather under step
i's fwd/bwd. Exactness of every variant vs the unfused trainer is pinned
by tests (test_resident.py, test_training_parity.py).

  python examples/flagship_tune.py --out chiprun_out/flagship_tune.json
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_GRID_LEN = 14   # set from the grid in main(); used for the complete flag


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--nodes", type=int, default=200_000)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--fanout", default="10,5")
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--cache_mb", type=int, default=1024)
    p.add_argument("--steps", type=int, default=128)
    p.add_argument("--warmup", type=int, default=16)
    p.add_argument("--out", default="")
    p.add_argument("--platform", default="gpu")
    p.add_argument("--only", default="",
                   help="regex: run only matching grid tags")
    p.add_argument("--merge", action="store_true",
                   help="merge rows into an existing --out artifact")
    args = p.parse_args(argv)

    from coala_gnn.utils.jaxconfig import setup as jax_setup
    jax_setup(args.platform)
    import bench
    from coala_gnn.graph.datasets import synthetic_graph

    fanouts = [int(f) for f in args.fanout.split(",")]
    ds = synthetic_graph(num_nodes=args.nodes, avg_degree=15,
                         feature_dim=args.dim, num_classes=16, seed=0)

    # (tag, bf16 features, quantize lines, model_dtype, scan_unroll,
    #  window, nbr_cap) — nbr_cap=32 switches sampling to the padded
    # neighbor-table layout (one aligned [32]-row read per dst instead of
    # indptr + scattered indices element reads; bit-exact for deg <= 32,
    # which at avg_degree 15 covers all but ~1e-5 of the nodes)
    grid = [
        ("f32_unroll1", False, False, "float32", 1, None, None),
        ("f32_unroll4", False, False, "float32", 4, None, None),
        ("f32_unroll8", False, False, "float32", 8, None, None),
        ("f32_unroll4_K32", False, False, "float32", 4, 32, None),
        ("f32_unroll1_P32", False, False, "float32", 1, None, 32),
        ("f32_unroll4_P32", False, False, "float32", 4, None, 32),
        ("bf16_unroll4", True, False, "bfloat16", 4, None, None),
        ("bf16_unroll4_K32", True, False, "bfloat16", 4, 32, None),
        ("bf16_unroll4_P32", True, False, "bfloat16", 4, None, 32),
        ("int8_f32model_unroll4", False, True, "float32", 4, None, None),
        ("int8_bf16model_unroll4", False, True, "bfloat16", 4, None, None),
        ("int8_bf16model_unroll8", False, True, "bfloat16", 8, None, None),
        ("int8_bf16model_unroll4_K32", False, True, "bfloat16", 4, 32,
         None),
        ("int8_bf16model_unroll4_P32", False, True, "bfloat16", 4, None,
         32),
        # _rbg rows: sampler PRNG = XLA RngBitGenerator instead of
        # threefry (utils/rng.py) — different stream, same distribution;
        # isolates the threefry key-derivation cost profile_sampling.py
        # measures standalone
        ("f32_unroll4_P32_rbg", False, False, "float32", 4, None, 32),
        ("bf16_unroll4_P32_rbg", True, False, "bfloat16", 4, None, 32),
        # r4 session-2 rows: rbg on the winning CSR schedule (P32 measured
        # slower, so rbg deserves a run without it), unroll8 for bf16, and
        # the DESIGN §2 measured-optimal gather as a full config — bf16
        # cache lines with f32 model compute (0.99 ms/step standalone
        # gather vs 2.2 ms f32; the model upcasts at the first matmul)
        ("f32_unroll8_rbg", False, False, "float32", 8, None, None),
        ("bf16_unroll8", True, False, "bfloat16", 8, None, None),
        ("bf16_unroll8_rbg", True, False, "bfloat16", 8, None, None),
        ("bf16lines_f32model_unroll8", True, False, "float32", 8, None,
         None),
        ("bf16lines_f32model_unroll8_rbg", True, False, "float32", 8,
         None, None),
        # once bf16+rbg makes the step sampling-bound, re-probe the
        # sampling-side knobs that lost under the f32 gather shadow
        ("bf16_unroll16_rbg", True, False, "bfloat16", 16, None, None),
        ("bf16_P32_unroll8_rbg", True, False, "bfloat16", 8, None, 32),
    ]
    # GAT rows (GAT ran far below SAGE with zero
    # tuning): the slot-major plane-FMA combine (models/layers.py) plus the
    # knobs that bought SAGE its gain — bf16 lines/model, unroll8, rbg.
    grid = [g + ("sage",) for g in grid] + [
        ("gat_f32_unroll1", False, False, "float32", 1, None, None, "gat"),
        ("gat_f32_unroll8", False, False, "float32", 8, None, None, "gat"),
        ("gat_bf16_unroll8", True, False, "bfloat16", 8, None, None, "gat"),
        ("gat_bf16_unroll8_rbg", True, False, "bfloat16", 8, None, None,
         "gat"),
        ("gat_bf16_unroll16_rbg", True, False, "bfloat16", 16, None, None,
         "gat"),
    ]
    if args.only:
        import re
        grid = [g for g in grid if re.search(args.only, g[0])]
    global _GRID_LEN
    _GRID_LEN = len(grid)
    # supplement mode: merge newly measured rows into an existing artifact
    # (e.g. rbg rows added after the main grid already ran on-chip)
    rows = {}
    if args.out and args.merge and os.path.exists(args.out):
        with open(args.out) as f:
            rows = json.load(f).get("rows", {})
        _GRID_LEN = len(rows) + len([g for g in grid if g[0] not in rows])
    for tag, bf16, quant, mdt, unroll, win, ncap, mtype in grid:
        rng_impl = "rbg" if tag.endswith("_rbg") else ""
        r = bench.run_resident(ds, args.batch, fanouts, args.dim,
                               args.hidden, args.cache_mb, bf16,
                               args.warmup, args.steps, tag=f"tune-{tag}",
                               quantize=quant, model_dtype=mdt,
                               scan_unroll=unroll, window=win,
                               nbr_cap=ncap, rng_impl=rng_impl,
                               model_type=mtype)
        rows[tag] = {"value": r["value"], "unit": r["unit"],
                     "cache_hit_ratio": r["cache_hit_ratio"],
                     "config": {"bf16_features": bf16, "int8_lines": quant,
                                "model_dtype": mdt, "scan_unroll": unroll,
                                "window": win, "nbr_cap": ncap,
                                "rng_impl": rng_impl, "model": mtype}}
        print(f"tune {tag}: {r['value']:,.0f} edges/s", file=sys.stderr,
              flush=True)
        # incremental write: a timeout-killed run still leaves every
        # measured row (the suite clamps stage timeouts to its deadline)
        if args.out:
            with open(args.out, "w") as f:
                f.write(json.dumps(_artifact(args, fanouts, rows), indent=1))

    art = _artifact(args, fanouts, rows)
    txt = json.dumps(art, indent=1)
    print(txt)
    if args.out:
        with open(args.out, "w") as f:
            f.write(txt)
    return art


def _artifact(args, fanouts, rows):
    best = max(rows, key=lambda k: rows[k]["value"])
    return {"config": {"nodes": args.nodes, "dim": args.dim,
                       "batch": args.batch, "fanout": fanouts,
                       "cache_mb": args.cache_mb, "steps": args.steps},
            "rows": rows, "best": best,
            "best_edges_per_s": rows[best]["value"],
            "complete": len(rows) == _GRID_LEN}


if __name__ == "__main__":
    main()
