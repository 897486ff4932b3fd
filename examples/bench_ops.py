#!/usr/bin/env python
"""Op-level microbenchmarks: neighborhood aggregation bandwidth vs roofline.

The GNN aggregation hot op (padded gather-sum over dense blocks) is
HBM-bandwidth-bound: traffic ~= n_dst * fanout * dim * bytes (gathered rows)
+ n_dst * dim * bytes (output). This tool measures achieved GB/s on the
current backend so kernel work targets reality (SURVEY.md §7: "speed-of-light
lives here").

  python examples/bench_ops.py                  # on the GPU
  python examples/bench_ops.py --platform cpu   # CPU rehearsal
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

RESULTS = []


def agg_traffic_bytes(n_dst, fanout, dim, itemsize):
    """Lower-bound bytes of one weighted fanout sum: every neighbor row
    read once plus the output written once."""
    return (n_dst * fanout * dim + n_dst * dim) * itemsize


def record(name, dt_s, traffic_bytes=None, flops=None):
    row = {"name": name, "ms": round(dt_s * 1e3, 3)}
    if traffic_bytes is not None:
        row["gb_per_s"] = round(traffic_bytes / dt_s / 1e9, 1)
        print(f"{name:26s} {dt_s * 1e3:8.3f} ms   {row['gb_per_s']:8.1f} GB/s")
    if flops is not None:
        row["tflop_per_s"] = round(flops / dt_s / 1e12, 1)
        print(f"{name:26s} {dt_s * 1e3:8.3f} ms   "
              f"{row['tflop_per_s']:8.1f} TFLOP/s")
    RESULTS.append(row)


def timeit(fn, *args, warmup=1, iters=20):
    """Device-throughput timing: run `iters` executions inside ONE jit via
    fori_loop (single dispatch; per-call host RTT excluded), with the first
    operand perturbed per iteration so XLA cannot hoist the body, and a
    device sync at the end, so per-dispatch host overhead stays out of the
    per-call time. The whole output is the loop carry: a carry of one
    element would let XLA slice the op down to the rows that element
    needs."""
    import jax
    import jax.numpy as jnp

    x0, rest = args[0], args[1:]
    out = jax.eval_shape(fn, *args)

    @jax.jit
    def many(x0, *rest):
        def body(i, prev):
            xi = x0 + (i.astype(x0.dtype) * jnp.asarray(1e-30, x0.dtype)
                       if jnp.issubdtype(x0.dtype, jnp.floating) else 0)
            return fn(xi, *rest)
        return jax.lax.fori_loop(0, iters, body,
                                 jnp.zeros(out.shape, out.dtype))

    for _ in range(warmup):
        jax.block_until_ready(many(x0, *rest))
    t0 = time.perf_counter()
    jax.block_until_ready(many(x0, *rest))
    return (time.perf_counter() - t0) / iters


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--platform", type=str, default="gpu")
    p.add_argument("--n_src", type=int, default=65536)
    p.add_argument("--n_dst", type=int, default=32768)
    p.add_argument("--fanout", type=int, default=10)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--json", type=str, default="",
                   help="write results to this JSON file")
    p.add_argument("--cache_gather", action="store_true",
                   help="run the cache-gather-bound experiment (per-step "
                        "vs window-restage vs int8/bf16 lines at flagship "
                        "shapes)")
    p.add_argument("--table_rows", type=int, default=200_000)
    p.add_argument("--window", type=int, default=8)
    p.add_argument("--n_req", type=int, default=67584)
    args = p.parse_args()
    from coala_gnn.utils.jaxconfig import setup
    setup(args.platform)
    import jax
    import jax.numpy as jnp
    from coala_gnn.ops.aggregate import padded_gather_sum, padded_gather_sum_dense

    S, N, F, D = args.n_src, args.n_dst, args.fanout, args.dim
    rng = np.random.default_rng(0)
    x32 = jnp.asarray(rng.normal(size=(S, D)).astype(np.float32))
    x16 = x32.astype(jnp.bfloat16)
    adj = jnp.asarray(rng.integers(0, S, size=(N, F)).astype(np.int32))
    w = jnp.asarray(rng.random((N, F)).astype(np.float32))

    print(f"backend={jax.default_backend()} S={S} N={N} F={F} D={D}")

    for name, fn, x, bytes_per in [
        ("gather_sum_loop f32", jax.jit(padded_gather_sum), x32, 4),
        ("gather_sum_dense f32", jax.jit(padded_gather_sum_dense), x32, 4),
        ("gather_sum_loop bf16", jax.jit(padded_gather_sum), x16, 2),
        ("gather_sum_dense bf16", jax.jit(padded_gather_sum_dense), x16, 2),
    ]:
        dt = timeit(fn, x, adj, w)
        record(name, dt, agg_traffic_bytes(N, F, D, bytes_per))

    # Contiguous-block fast path (the resident pipeline's production
    # layout, ops/aggregate.py: neighbor rows at [N, N + N*F) of the layer
    # input — the weighted sum is a streaming multiply-reduce, NO gather).
    from coala_gnn.ops.aggregate import agg_sum
    xc32 = jnp.asarray(rng.normal(size=(N * (1 + F), D)).astype(np.float32))
    xc16 = xc32.astype(jnp.bfloat16)
    contig = jax.jit(lambda x, w: agg_sum(x, None, w))
    for name, x, bytes_per in [("contig agg_sum f32", xc32, 4),
                               ("contig agg_sum bf16", xc16, 2)]:
        dt = timeit(contig, x, w)
        record(name, dt, agg_traffic_bytes(N, F, D, bytes_per))

    # SDDMM + softmax + combine (the GAT hot path, models/layers.py GATConv;
    # reference analogue: DGL GATConv's edge_softmax + u_mul_e SpMM,
    # examples/models.py:77-81). score[i,k] = leaky_relu(s_dst[i] +
    # s_src[i,k]) where s_* are sampled dot products (the SDDMM), then a
    # fanout-softmax and a weighted combine. Measured on both layouts;
    # traffic lower bound = neighbor rows once + dst rows + out.
    from coala_gnn.ops.aggregate import neighbor_view
    a_src = jnp.asarray(rng.normal(size=(D,)).astype(np.float32))
    a_dst = jnp.asarray(rng.normal(size=(D,)).astype(np.float32))

    def gat_sddmm(x, adj, a_s, a_d):
        nbr = neighbor_view(x, adj, (N, F))          # [N, F, D]
        dst = x[:N]
        s = jax.nn.leaky_relu(dst @ a_d[:, None] + nbr @ a_s, 0.2)
        alpha = jax.nn.softmax(s, axis=1)            # [N, F]
        return jnp.einsum("nfd,nf->nd", nbr, alpha.astype(x.dtype))

    sd_gather = jax.jit(lambda x, adj, a_s, a_d: gat_sddmm(x, adj, a_s, a_d))
    sd_contig = jax.jit(lambda x, a_s, a_d: gat_sddmm(x, None, a_s, a_d))
    for name, fn, fargs, x in [
        ("sddmm_gat gather f32", sd_gather, (x32, adj, a_src, a_dst), x32),
        ("sddmm_gat gather bf16", sd_gather,
         (x16, adj, a_src.astype(jnp.bfloat16),
          a_dst.astype(jnp.bfloat16)), x16),
        ("sddmm_gat contig f32", sd_contig, (xc32, a_src, a_dst), xc32),
        ("sddmm_gat contig bf16", sd_contig,
         (xc16, a_src.astype(jnp.bfloat16),
          a_dst.astype(jnp.bfloat16)), xc16),
    ]:
        bpp = x.dtype.itemsize
        dt = timeit(fn, *fargs)
        traffic = (N * F * D + 2 * N * D) * bpp
        record(name, dt, traffic)

    # plain gather (roofline probe: what the backend's gather achieves)
    flat = adj.reshape(-1)
    g = jax.jit(lambda x, i: x[i])
    x8 = jnp.asarray(rng.integers(-127, 128, size=(N, D)).astype(np.int8))
    for name, x, bpp in [("plain row gather f32", x32, 4),
                         ("plain row gather bf16", x16, 2),
                         ("plain row gather int8", x8, 1)]:
        dt = timeit(g, x, flat)
        traffic = flat.shape[0] * D * bpp * 2  # read + write
        record(name, dt, traffic)

    # matmul probes (both dtypes — what the card reaches beside its
    # published peaks, utils/roofline.py)
    a32 = jnp.asarray(rng.normal(size=(4096, 4096)).astype(np.float32))
    a = a32.astype(jnp.bfloat16)
    mm = jax.jit(lambda a: a @ a)
    dt = timeit(mm, a)
    record("bf16 4096^3 matmul", dt, flops=2 * 4096**3)
    dt = timeit(mm, a32)
    record("f32 4096^3 matmul", dt, flops=2 * 4096**3)

    # ---- cache-gather-bound experiment ----------------------------------
    # The flat-tier row gather (67.5k x 1 KB random rows from a 205 MB
    # table) at the flagship shapes, against candidate fixes:
    #   per_step   — K independent gathers from the big table (status quo)
    #   restage    — gather the window's UNIQUE rows once into a dense
    #                [U, D] buffer, then K gathers from the (smaller)
    #                stage (the staged-window position map makes the
    #                positions free in the real trainer)
    #   int8/bf16  — narrower lines: 4x/2x fewer gathered bytes (int8
    #                includes the dequant multiply, the production path
    #                of the quantized tier)
    if args.cache_gather:
        Ntab = args.table_rows
        K = args.window
        nreq = args.n_req
        tab32 = jnp.asarray(rng.normal(size=(Ntab, D)).astype(np.float32))
        tab16 = tab32.astype(jnp.bfloat16)
        tab8 = jnp.asarray(
            rng.integers(-127, 128, size=(Ntab, D)).astype(np.int8))
        scale = jnp.asarray(rng.random(Ntab).astype(np.float32) + 0.5)
        cats = np.asarray(
            rng.integers(0, Ntab, size=(K, nreq)).astype(np.int32))
        uniq, inv = np.unique(cats.reshape(-1), return_inverse=True)
        U = uniq.shape[0]
        pos = jnp.asarray(inv.reshape(K, nreq).astype(np.int32))
        cats_d = jnp.asarray(cats)
        uniq_d = jnp.asarray(uniq.astype(np.int32))
        print(f"cache-gather: table {Ntab}x{D}, window K={K}, "
              f"n_req {nreq}, unique/window {U} "
              f"({U / (K * nreq):.2f}x dedup)")

        def per_step(tab, cats):
            def body(k, acc):
                x = tab[jax.lax.dynamic_index_in_dim(cats, k, keepdims=False)]
                return acc + x.sum(0, dtype=jnp.float32)
            return jax.lax.fori_loop(0, K, body, jnp.zeros(D, jnp.float32))

        def restage(tab, uniq_ids, pos):
            stage = tab[uniq_ids]                       # one [U, D] gather
            def body(k, acc):
                x = stage[jax.lax.dynamic_index_in_dim(pos, k,
                                                       keepdims=False)]
                return acc + x.sum(0, dtype=jnp.float32)
            return jax.lax.fori_loop(0, K, body, jnp.zeros(D, jnp.float32))

        def per_step_i8(tab, scl, cats):
            def body(k, acc):
                ids = jax.lax.dynamic_index_in_dim(cats, k, keepdims=False)
                x = tab[ids].astype(jnp.float32) * scl[ids][:, None]
                return acc + x.sum(0, dtype=jnp.float32)
            return jax.lax.fori_loop(0, K, body, jnp.zeros(D, jnp.float32))

        per_window_rows = K * nreq
        for name, fn, fargs, bpp in [
            ("cache gather/step f32", jax.jit(per_step), (tab32, cats_d), 4),
            ("cache gather/step bf16", jax.jit(per_step), (tab16, cats_d), 2),
            ("cache gather/step int8+deq", jax.jit(per_step_i8),
             (tab8, scale, cats_d), 1),
            ("cache restage window f32", jax.jit(restage),
             (tab32, uniq_d, pos), 4),
            ("cache restage window bf16", jax.jit(restage),
             (tab16, uniq_d, pos), 2),
        ]:
            dt = timeit(fn, *fargs, iters=5)
            rows = (per_window_rows + (U if "restage" in name else 0))
            traffic = rows * D * bpp + per_window_rows * D * bpp  # rd+wr
            row_ms = dt / K
            record(f"{name} (K={K})", dt, traffic)
            RESULTS[-1]["ms_per_step"] = round(row_ms * 1e3, 3)

    if args.json:
        out = {"backend": jax.default_backend(),
               "device": str(jax.devices()[0]),
               "config": {"n_src": S, "n_dst": N, "fanout": F, "dim": D},
               "traffic_model": "lower-bound bytes: neighbor rows once + "
                                "dst rows + output",
               "results": RESULTS}
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
