#!/usr/bin/env python
"""Micro-profile of on-device sampling internals (what's inside the
1.3 ms/step the window profiler attributes to sampling).

Variants isolate: threefry RNG, indptr degree reads, the indices element
gather, and block assembly. All grids/keys pregenerated; K-step scans inside
one jit; chained deps; final readback (docs/DESIGN.md §6)."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from coala_gnn.utils.jaxconfig import setup as jax_setup

jax_setup(os.environ.get("BENCH_PLATFORM", ""))

import jax
import jax.numpy as jnp

from coala_gnn.graph.datasets import synthetic_graph
from coala_gnn.sampling.device_sampler import to_device_graph
from coala_gnn.sampling.neighbor import block_capacities

B = int(os.environ.get("BENCH_BATCH", 1024))
FANOUTS = [int(f) for f in os.environ.get("BENCH_FANOUT", "10,5").split(",")]
NODES = int(os.environ.get("BENCH_NODES", 200_000))
K = 8
N_WINDOWS = 12


def main():
    print(f"devices={jax.devices()}", flush=True)
    ds = synthetic_graph(num_nodes=NODES, avg_degree=15, feature_dim=8,
                         num_classes=4, seed=0)
    g = to_device_graph(ds.graph)
    sentinel = g.num_nodes
    caps = block_capacities(B, FANOUTS)
    rng = np.random.default_rng(0)

    # dense padded neighbor table [N+1, P]: row i holds node i's neighbor
    # list wrapped modulo its degree (deg-0 rows self-loop). Measures the
    # LAYOUT cost of CSR sampling (indptr read + 2-level indices gather)
    # against one uniform-stride gather — semantics differ for deg > P, so
    # this is a roofline probe, not a drop-in sampler.
    P_TBL = 16
    indptr_np = np.asarray(ds.graph.indptr)
    indices_np = np.asarray(ds.graph.indices)
    deg_np = np.diff(indptr_np)
    tbl_np = np.empty((NODES + 1, P_TBL), np.int32)
    col = np.arange(P_TBL)
    safe_deg = np.maximum(deg_np, 1)
    gather_pos = indptr_np[:-1, None] + col[None, :] % safe_deg[:, None]
    tbl_np[:-1] = np.where(deg_np[:, None] > 0,
                           indices_np[np.minimum(gather_pos,
                                                 indices_np.size - 1)],
                           np.arange(NODES)[:, None])
    tbl_np[-1] = NODES  # sentinel row
    tbl = jnp.asarray(tbl_np)

    def sample_variant(g, dst, fanout, key, mode):
        n = dst.shape[0]
        k = jnp.arange(fanout, dtype=jnp.int32)[None, :]
        if mode == "padded_table":
            bits = jax.random.bits(key, (n, fanout), jnp.uint32)
            off = (bits % jnp.uint32(P_TBL)).astype(jnp.int32)
            nbr = tbl[dst[:, None], off]
            mask = jnp.ones((n, fanout), jnp.float32)
            return nbr, mask
        if mode == "padded_rowgather":
            # the production padded-table form (device_sampler nbr_cap):
            # one contiguous [P]-row gather per dst + row-local
            # take_along_axis
            bits = jax.random.bits(key, (n, fanout), jnp.uint32)
            off = (bits % jnp.uint32(P_TBL)).astype(jnp.int32)
            rows = tbl[dst]
            nbr = jnp.take_along_axis(rows, off, axis=1)
            mask = jnp.ones((n, fanout), jnp.float32)
            return nbr, mask
        if mode == "no_indptr":
            starts = dst.astype(jnp.int32) * 0
            deg = jnp.full((n,), fanout, jnp.int32)
        else:
            starts = g.indptr[dst]
            deg = g.indptr[dst + 1] - starts
        mask = k < jnp.minimum(deg, fanout)[:, None]
        if mode == "no_rng":
            rand_off = jnp.zeros((n, fanout), jnp.int32)
        elif mode == "bits_mod":
            bits = jax.random.bits(key, (n, fanout), jnp.uint32)
            rand_off = (bits % jnp.maximum(deg, 1)[:, None]
                        .astype(jnp.uint32)).astype(jnp.int32)
        else:
            rand = jax.random.uniform(key, (n, fanout))
            rand_off = (rand * jnp.maximum(deg, 1)[:, None]).astype(jnp.int32)
        seq_off = jnp.minimum(k, jnp.maximum(deg[:, None] - 1, 0))
        offsets = jnp.where(deg[:, None] <= fanout, seq_off, rand_off)
        if mode == "no_gather":
            nbr = dst[:, None] + offsets
        elif mode == "sorted_gather":
            # coalesce the HBM access: gather g.indices at SORTED edge
            # positions (sequential-ish granules), then unsort. The unsort
            # is itself a gather, but from a small [n*f]-element array —
            # the cheap small-table regime.
            pos = (starts[:, None] + offsets).reshape(-1)
            order = jnp.argsort(pos)
            vals = g.indices[pos[order]]
            inv = jnp.zeros_like(order).at[order].set(
                jnp.arange(pos.shape[0], dtype=order.dtype))
            nbr = vals[inv].reshape(n, fanout)
        else:
            nbr = g.indices[starts[:, None] + offsets]
        nbr = jnp.where(mask, nbr, dst[:, None])
        return nbr, mask.astype(jnp.float32)

    def make_fn(mode, impl=None):
        def one(seeds, key):
            dst = seeds.astype(jnp.int32)
            total = jnp.float32(0)
            for layer in range(len(FANOUTS) - 1, -1, -1):
                fanout = FANOUTS[layer]
                cap_dst = caps[layer][0]
                pad = cap_dst - dst.shape[0]
                if pad:
                    dst = jnp.concatenate(
                        [dst, jnp.full(pad, sentinel, jnp.int32)])
                key, sub = jax.random.split(key)
                nbr, mask = sample_variant(g, dst, fanout, sub, mode)
                cat = jnp.concatenate([dst, nbr.reshape(-1)])
                total = total + mask.sum()
                dst = cat
            return dst, total

        def window(seeds_grid, keys):
            def body(carry, inp):
                seeds, kd = inp
                ids, tot = one(seeds, jax.random.wrap_key_data(kd, impl=impl))
                return carry + tot + ids.sum().astype(jnp.float32) * 1e-9, tot
            return jax.lax.scan(body, jnp.float32(0), (seeds_grid, keys))

        return jax.jit(window)

    grids = [jnp.asarray(rng.choice(ds.train_idx, (K, B)).astype(np.int32))
             for _ in range(N_WINDOWS)]
    keysets = [jax.random.key_data(jax.random.split(jax.random.key(w), K))
               for w in range(N_WINDOWS)]
    # rbg: XLA's hardware-friendly counter PRNG — isolates how much of the
    # sampling step is threefry key-derivation + bit generation cost
    keysets_rbg = [
        jax.random.key_data(jax.random.split(
            jax.random.key(w, impl="rbg"), K)) for w in range(N_WINDOWS)]

    for mode, impl in (("full", None), ("full_rbg", "rbg"),
                       ("bits_mod", None), ("no_rng", None),
                       ("no_gather", None), ("no_indptr", None),
                       ("sorted_gather", None),
                       ("padded_table", None), ("padded_rowgather", None),
                       ("padded_rowgather_rbg", "rbg")):
        fn = make_fn(mode.replace("_rbg", ""), impl=impl)
        ks = keysets_rbg if impl == "rbg" else keysets
        out = None
        t0 = None
        for w in range(N_WINDOWS):
            out, _ = fn(grids[w], ks[w])
            if w == 1:
                float(out)
                t0 = time.perf_counter()
        float(out)
        dt = time.perf_counter() - t0
        print(f"{mode:20s}: {dt / ((N_WINDOWS - 2) * K) * 1e3:6.3f} ms/step",
              flush=True)


if __name__ == "__main__":
    main()
