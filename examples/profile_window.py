#!/usr/bin/env python
"""Stage decomposition of the fused resident training window on the GPU.

Times window variants (full / no-train / no-lookup / no-sample / sample-only)
at the bench config to attribute ms/step to sampling, cache lookup and
model fwd/bwd — the data that drives kernel-level optimization (closing the
aggregation-fusion gap).

Timing discipline per docs/DESIGN.md §6: fused K-step scans inside one jit,
chained data deps, final host readback.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from coala_gnn.utils.jaxconfig import setup as jax_setup

jax_setup()

import jax
import jax.numpy as jnp
import optax

from coala_gnn.cache import feature_cache as fc
from coala_gnn.cache.host_tier import HostFeatureStore
from coala_gnn.graph.datasets import synthetic_graph
from coala_gnn.models import make_model
from coala_gnn.parallel.resident import ResidentTrainer
from coala_gnn.sampling.device_sampler import sample_blocks_device
from coala_gnn.utils.rng import make_root_key, wrap_key_any

B = int(os.environ.get("BENCH_BATCH", 1024))
FANOUTS = [int(f) for f in os.environ.get("BENCH_FANOUT", "10,5").split(",")]
DIM = int(os.environ.get("BENCH_DIM", 256))
HIDDEN = int(os.environ.get("BENCH_HIDDEN", 256))
NODES = int(os.environ.get("BENCH_NODES", 200_000))
CACHE_MB = int(os.environ.get("BENCH_CACHE_MB", 1024))
K = int(os.environ.get("BENCH_WINDOW", 8))
BF16 = bool(int(os.environ.get("BENCH_BF16", 0)))
# match the tuned flagship config (flagship_tune.py): padded-table
# sampling layout + PRNG family
NBR_CAP = int(os.environ.get("BENCH_NBR_CAP", 0)) or None
RNG_IMPL = os.environ.get("BENCH_RNG_IMPL", "")
N_WINDOWS = 8


def main():
    print(f"profile: devices={jax.devices()} bf16={BF16}", flush=True)
    ds = synthetic_graph(num_nodes=NODES, avg_degree=15, feature_dim=DIM,
                         num_classes=16, seed=0)
    store = HostFeatureStore(ds.features)
    cfg = fc.make_config(cache_mb=CACHE_MB, dim=DIM, num_colors=0,
                         dtype=jnp.bfloat16 if BF16 else jnp.float32)
    model_dtype = jnp.bfloat16 if BF16 else jnp.float32
    model = make_model("sage", hidden=HIDDEN, num_classes=ds.num_classes,
                       num_layers=len(FANOUTS), dtype=model_dtype)
    rt = ResidentTrainer(graph=ds.graph, host_fetch=store.fetch,
                         labels=ds.labels, cache_cfg=cfg, model=model,
                         tx=optax.adam(1e-3), fanouts=FANOUTS, batch_size=B,
                         nbr_cap=NBR_CAP)
    rt.prewarm(np.arange(min(cfg.capacity, NODES), dtype=np.int32))
    g, labels_dev, tx = rt.g, rt.labels_dev, rt.tx
    sentinel = g.num_nodes
    rng = np.random.default_rng(0)

    resolved = rt.resolve(rt.begin(
        rng.choice(ds.train_idx, B, replace=False).astype(np.int32),
        jax.random.key(9)))
    params = model.init(jax.random.key(1), resolved[0], resolved[1])
    opt_state = tx.init(params)

    def loss_fn(p, key, blocks, x, y):
        logits = model.apply(p, blocks, x, train=True,
                             rngs={"dropout": key})[:B]
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()

    def make_window(do_sample, do_lookup, do_train):
        def window(g, labels_dev, cache, params, opt_state, seeds_grid, keys):
            def body(carry, inp):
                cache, params, opt_state, chain = carry
                seeds, k = inp
                k1, k2 = jax.random.split(wrap_key_any(k))
                # perturb seeds with chain so nothing hoists out of the scan
                seeds = jnp.where(seeds == chain.astype(jnp.int32) - 7,
                                  seeds, seeds)
                if do_sample:
                    blocks, ids, _ = sample_blocks_device(
                        g, seeds, FANOUTS, B, k1, dedup=False)
                else:
                    blocks, ids, _ = static_blocks
                    ids = ids + (chain.astype(jnp.int32) * 0)
                valid = ids != sentinel
                if do_lookup:
                    base, feats, hit = fc.lookup(
                        cfg, cache.base, jnp.where(valid, ids, 0), valid)
                    cache = fc.ColoredCacheState(base=base,
                                                 line_colors=cache.line_colors)
                else:
                    feats = jnp.zeros((ids.shape[0], DIM),
                                      dtype=cfg.dtype) + chain.astype(cfg.dtype)
                y = labels_dev[seeds]
                if do_train:
                    loss, grads = jax.value_and_grad(loss_fn)(
                        params, k2, blocks, feats, y)
                    updates, opt_state = tx.update(grads, opt_state, params)
                    params = optax.apply_updates(params, updates)
                else:
                    loss = feats.sum() + sum(b.mask.sum() for b in blocks)
                chain = chain + loss.astype(jnp.float32) * 0 + 1
                return (cache, params, opt_state, chain), loss

            (cache, params, opt_state, chain), losses = jax.lax.scan(
                body, (cache, params, opt_state, jnp.float32(0)),
                (seeds_grid, keys))
            return cache, params, opt_state, losses

        return jax.jit(window)

    # static blocks for the no-sample variant
    static_blocks = sample_blocks_device(
        g, jnp.asarray(rng.choice(ds.train_idx, B, False).astype(np.int32)),
        FANOUTS, B, jax.random.key(3), dedup=False)
    static_blocks = jax.tree.map(jax.device_put, static_blocks)

    variants = {
        "full (sample+lookup+train)": (True, True, True),
        "no-train (sample+lookup)": (True, True, False),
        "sample-only": (True, False, False),
        "no-sample (lookup+train)": (False, True, True),
        "no-lookup (sample+train)": (True, False, True),
    }
    results = {}
    for name, flags in variants.items():
        win = make_window(*flags)
        t_measure = None
        for w in range(N_WINDOWS):
            seeds_grid = jnp.asarray(np.stack([
                rng.choice(ds.train_idx, B, replace=False).astype(np.int32)
                for _ in range(K)]))
            keys = jax.random.key_data(
                jax.random.split(make_root_key(w, RNG_IMPL), K))
            cache, p_out, o_out, losses = win(
                g, labels_dev, rt.cache, params, opt_state, seeds_grid, keys)
            if flags[2]:
                params, opt_state = p_out, o_out
            if w == 1:  # compiled + warm
                float(np.asarray(losses)[-1])
                t_measure = time.perf_counter()
                n0 = w
        float(np.asarray(losses)[-1])
        dt = time.perf_counter() - t_measure
        per_step = dt / ((N_WINDOWS - 1 - n0) * K) * 1e3
        results[name] = per_step
        print(f"{name:32s}: {per_step:6.2f} ms/step", flush=True)

    full = results["full (sample+lookup+train)"]
    so = results["sample-only"]
    print("--- attribution (ms/step) ---")
    print(f"sampling             : {so:6.2f}")
    print(f"lookup (no-train - sample-only) : "
          f"{results['no-train (sample+lookup)'] - so:6.2f}")
    print(f"train (full - no-train)         : "
          f"{full - results['no-train (sample+lookup)']:6.2f}")
    print(f"train+sample (no-lookup)        : "
          f"{results['no-lookup (sample+train)']:6.2f}")
    print(f"lookup+train (no-sample)        : "
          f"{results['no-sample (lookup+train)']:6.2f}")


if __name__ == "__main__":
    main()
