#!/usr/bin/env python
"""Smoke run of the resident GNN trainer on the GPU, through its own entry
points, in one process (a second JAX process on the card would find its
memory taken).

  python chip_smoke.py          # one GPU: every phase below but the mesh
  python chip_smoke.py --four   # four GPUs: the mesh phase only

Phases (one GPU):
  device     the platform must be "gpu"; prints device_kind and the card's
             name and power limit. Never continues on the CPU.
  native     the host library, built on this machine from the source.
  coverage   examples/train.py --pipeline resident at the flagship shape
             (200k nodes, degree 15, dim 256, hidden 256, batch 1024,
             fanout 10,5, a cache that holds every node), SAGE and GAT:
             set-up time, ms/step and edges/s of the last epoch, the window
             step's memory analysis, peak device memory, finite falling
             losses.
  reference  the first step's blocks and features: the timed path's logits
             and loss against the dense float32 reference
             (coala_gnn/models/reference.py) at "highest" precision.
  pressure   IGB-medium feature width (1M nodes, dim 1024, fanout 10,5,5,
             a 512 MB cache ~12% coverage) through the same entry, f32 and
             int8 (--quantize) lines; then one fixed run of windows with the
             HostScratch pool and again with fresh host buffers, whose
             losses must be bitwise equal.
  aggregate  XLA's padded gather-sum and contiguous agg_sum at the shape the
             removed gather-sum kernels were tried at, in GB/s.
  four       (--four) ShardedResidentTrainer on a 1-D mesh of 4 GPUs at the
             pressure graph, node_color seeds, caches "sharded",
             "isolated" and "node_local" (two groups of two); exchanged
             rows against host rows, and one data-parallel step against the
             same four blocks stepped on one card.

Timings are smoke figures labelled with the card, not benchmark results.
Any failure raises: the script then exits non-zero without its last line,
``{"ok": true, "device": {...}}``.
"""

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Shapes of every phase; ``FULL`` on the card, tiny ones in tests."""

    nodes: int = 200_000
    dim: int = 256
    hidden: int = 256
    batch: int = 1024
    fanout: str = "10,5"
    cache_mb: int = 1024
    window: int = 8
    max_steps: int = 32
    epochs: int = 3
    p_nodes: int = 1_000_000
    p_dim: int = 1024
    p_fanout: str = "10,5,5"
    p_cache_mb: int = 512
    p_epochs: int = 2
    scratch_windows: int = 4
    agg_n_src: int = 65_536
    agg_n_dst: int = 32_768
    agg_fanout: int = 10
    agg_dim: int = 256
    four_warm_windows: int = 2
    four_windows: int = 4
    lr: float = 1e-3          # examples/train.py's default


FULL = Sizes()

# Relative tolerance of the timed path against the float32 reference, by
# the arithmetic the timed path runs: TF32 keeps a 10-bit mantissa (~5e-4
# per product) and errors grow with the 256-1024-long dot products; true
# float32 differs from the reference only in summation order; bfloat16
# lines carry an 8-bit mantissa. The absolute part scales with the largest
# reference value: matmul rounding is relative to the operands, not to
# each (possibly near-zero) output element.
TOLERANCE = {"tf32": 2e-2, "float32": 1e-4, "bfloat16": 5e-2}


def log(*a):
    print(*a, flush=True)


def card() -> str:
    """``nvidia-smi`` name and power limit (a child process, off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip())


class CompileCounter:
    """JAX's compile events: one lowering per new compile, and the seconds
    spent tracing, lowering and compiling, each with the time it ended."""

    _PHASES = ("/jax/core/compile/jaxpr_trace_duration",
               "/jax/core/compile/jaxpr_to_mlir_module_duration",
               "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax.monitoring
        self.events = []   # (name, end time, seconds)

        def on_event(name, secs, **kw):
            if name in self._PHASES:
                self.events.append((name, time.perf_counter(), secs))

        jax.monitoring.register_event_duration_secs_listener(on_event)

    def since(self, t0: float):
        """(compiles, seconds spent compiling) after ``t0``."""
        ev = [e for e in self.events if e[1] >= t0]
        return (sum(e[0] == self._PHASES[1] for e in ev),
                sum(e[2] for e in ev))


def phase_device(platform: str, need: int):
    from coala_gnn.utils.jaxconfig import setup
    setup(platform)
    import jax
    devs = jax.devices()
    if devs[0].platform != platform or len(devs) < need:
        raise SystemExit(f"need {need} {platform} device(s), found "
                         f"{[(d.platform, d.device_kind) for d in devs]}")
    log(f"[device] platform={devs[0].platform} kind={devs[0].device_kind} "
        f"count={len(devs)}")
    return devs


def phase_native():
    from coala_gnn.native import lib
    lib.get()
    info = lib.build_info()
    log(f"[native] {'built now' if info['built_now'] else 'reused'} on "
        f"{info['cpu']!r} from coala_native.cpp sha256 "
        f"{info['source_sha256'][:16]} -> {info['path']}")


def _train(argv, platform):
    from examples import train
    return train.main(["--platform", platform, "--devices", "1",
                       "--pipeline", "resident", "--data", "synthetic",
                       "--avg_degree", "15"] + argv)


def _common(s: Sizes):
    return ["--hidden_channels", str(s.hidden), "--batch_size",
            str(s.batch), "--window", str(s.window), "--max_steps",
            str(s.max_steps), "--learning_rate", str(s.lr)]


def _check_losses(tag, run, k=8):
    losses = np.concatenate([e["losses"] for e in run["epochs"]])
    if not np.isfinite(losses).all():
        raise AssertionError(f"[{tag}] non-finite losses: {losses}")
    first, last = losses[:k].mean(), losses[-k:].mean()
    if not last < first:
        raise AssertionError(f"[{tag}] losses not falling: first {k} mean "
                             f"{first:.4f}, last {k} mean {last:.4f}")
    log(f"[{tag}] losses finite, falling: first {k} mean {first:.4f} -> "
        f"last {k} mean {last:.4f} ({losses.size} steps)")


def _report_epochs(tag, run, counter, label):
    for i, e in enumerate(run["epochs"]):
        kind = "set-up (compiles included)" if i == 0 else "steady"
        log(f"[{tag}] epoch {i} {kind}: {e['seconds']:.3f} s, "
            f"{e['steps']} steps, hit ratio {e['hit_ratio']:.4f}")
    e = run["epochs"][-1]
    n, secs = counter.since(e["started"])
    log(f"[{tag}] last epoch: {1e3 * e['seconds'] / e['steps']:.3f} ms/step, "
        f"{e['edges'] / e['seconds']:,.0f} edges/s; {n} compiles inside it "
        f"took {secs:.3f} s, without them "
        f"{1e3 * (e['seconds'] - secs) / e['steps']:.3f} ms/step, "
        f"{e['edges'] / (e['seconds'] - secs):,.0f} edges/s "
        f"(smoke figure, {label})")


def _window_memory(run, sizes_window, batch, seed=0):
    """compiled.memory_analysis() of the staged fused window the trainer
    dispatches, lowered at one window of seeds."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from coala_gnn.parallel.mesh import DATA_AXIS

    rt, params, opt = run["trainer"], run["params"], run["opt_state"]
    n_dev = rt.mesh.devices.size
    grid = np.random.default_rng(seed).integers(
        0, rt.graph.num_nodes, (n_dev, sizes_window, batch)).astype(np.int32)
    seeds = jax.device_put(grid, NamedSharding(rt.mesh, P(DATA_AXIS, None,
                                                          None)))
    keys = jax.random.key_data(jax.random.split(jax.random.key(seed),
                                                sizes_window))
    stage = rt._build_stage(rt._probe_window_staged(seeds, keys))
    fn = rt._window_staged_jit(params, opt, stage[2] is not None)
    args = (rt._g, rt._labels_dev, rt.cache.state,
            *(s for s in stage[:3] if s is not None), params, opt, seeds,
            keys)
    return fn.lower(*args).compile().memory_analysis()


def _peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", "not reported")


def phase_coverage(model_type, s: Sizes, platform, counter, label):
    tag = f"coverage/{model_type}"
    run = _train(_common(s) + [
        "--model_type", model_type, "--num_nodes", str(s.nodes),
        "--feature_dim", str(s.dim), "--fan_out", s.fanout,
        "--cache_size", str(s.cache_mb), "--epochs", str(s.epochs)],
        platform)
    _report_epochs(tag, run, counter, label)
    _check_losses(tag, run)
    log(f"[{tag}] window step memory_analysis: "
        f"{_window_memory(run, s.window, s.batch)}")
    log(f"[{tag}] peak_bytes_in_use (process so far): {_peak_bytes()}")
    return run


def timed_matmul_precision() -> str:
    """What a float32 matmul at JAX's default precision runs as on this
    device: "tf32" when it loses bits against "highest", else "float32"."""
    import jax
    import jax.numpy as jnp
    a = jax.random.normal(jax.random.key(0), (512, 512), jnp.float32)
    d = np.asarray(jnp.dot(a, a))
    h = np.asarray(jnp.dot(a, a, precision="highest"))
    return "tf32" if np.abs(d - h).max() / np.abs(h).max() > 1e-5 \
        else "float32"


def phase_reference(model_type, run):
    """The timed path's first-step logits and loss (eval mode: dropout is
    the only difference from the training forward, and the reference has
    none) against the dense float32 reference over the same blocks."""
    import jax
    import jax.numpy as jnp
    import optax

    from coala_gnn.models.reference import block_edges, reference_forward

    tag = f"reference/{model_type}"
    rt = run["trainer"]
    params, (blocks, feats, y) = run["first_step"]
    blocks = jax.tree.map(lambda a: np.asarray(a)[0], blocks)
    x, y = np.asarray(feats)[0], np.asarray(y)[0]
    B = y.shape[0]
    # The timed path runs its float32 matmuls at JAX's default precision,
    # which on this card is TF32 (measured here, not assumed).
    precision = ("bfloat16" if x.dtype == jnp.bfloat16
                 else timed_matmul_precision())
    rtol = TOLERANCE[precision]
    fwd = jax.jit(lambda p, b, x: rt.model.apply(p, b, x, train=False))
    got = np.asarray(fwd(params, blocks, x))[:B]
    want = np.asarray(reference_forward(
        rt.model, params, [block_edges(b) for b in blocks], x))[:B]

    def ce(logits):
        return float(optax.softmax_cross_entropy_with_integer_labels(
            jnp.asarray(logits), jnp.asarray(y)).mean())

    atol = rtol * float(np.abs(want).max())
    err = np.abs(got - want)
    bad = err > atol + rtol * np.abs(want)
    loss_got, loss_want = ce(got), ce(want)
    log(f"[{tag}] timed path precision {precision} -> rtol {rtol}, atol "
        f"{atol:.3e}; logits [{B}, {got.shape[1]}] max |diff| "
        f"{err.max():.3e}; loss {loss_got:.6f} vs reference {loss_want:.6f}")
    if bad.any() or abs(loss_got - loss_want) > rtol * abs(loss_want):
        raise AssertionError(f"[{tag}] mismatch: {int(bad.sum())} logits "
                             f"outside tolerance, loss {loss_got} vs "
                             f"{loss_want}")
    log(f"[{tag}] matches the reference")


class FreshScratch:
    """A HostScratch stand-in that allocates new buffers on every call."""

    def get(self, name, shape, dtype):
        return np.zeros(shape, dtype)


def check_scratch_reuse(run, windows: int, K: int, B: int, seed=0):
    """The same windows from the same state, once with the rotating
    HostScratch pool and once with fresh host buffers: a buffer the pool
    rewrites while an asynchronous host-to-device copy still reads it would
    change the staged rows, so the losses must be bitwise equal."""
    import jax

    rt, params, opt = run["trainer"], run["params"], run["opt_state"]
    n_dev = rt.mesh.devices.size
    grids = np.random.default_rng(seed).integers(
        0, rt.graph.num_nodes, (windows, n_dev, K, B)).astype(np.int32)
    key = jax.random.key(seed)
    state0 = rt.cache.state
    rows0 = rt.timers.tallies["stage_rows"]
    p1, _, l1, _ = rt.train_windows(params, opt, grids, key)
    staged = rt.timers.tallies["stage_rows"] - rows0
    pool = rt._scratch
    rt.cache.state = state0
    rt._scratch = FreshScratch()
    try:
        p2, _, l2, _ = rt.train_windows(params, opt, grids, key)
    finally:
        rt._scratch = pool
    l1, l2 = np.asarray(l1), np.asarray(l2)
    same = (l1.tobytes() == l2.tobytes() and all(
        np.asarray(a).tobytes() == np.asarray(b).tobytes()
        for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p2))))
    log(f"[pressure/scratch] {windows} windows x {K} steps, {staged:.0f} "
        f"staged rows, native fast path {rt._store is not None}: pool vs "
        f"fresh buffers {'bitwise equal' if same else 'DIFFER'}")
    if not staged or not same:
        raise AssertionError("HostScratch reuse check failed")


def phase_pressure(s: Sizes, platform, counter, label):
    base = _common(s) + [
        "--model_type", "sage", "--num_nodes", str(s.p_nodes),
        "--feature_dim", str(s.p_dim), "--fan_out", s.p_fanout,
        "--cache_size", str(s.p_cache_mb), "--epochs", str(s.p_epochs)]
    for quant in (False, True):
        tag = f"pressure/{'int8' if quant else 'f32'}"
        run = _train(base + (["--quantize"] if quant else []), platform)
        rt = run["trainer"]
        log(f"[{tag}] cache capacity {rt.cache.cfg.capacity} lines for "
            f"{rt.graph.num_nodes} nodes, stage transport "
            f"{rt.stage_transport}")
        _report_epochs(tag, run, counter, label)
        t = run["epochs"][-1]["timers"]
        log(f"[{tag}] last-epoch phase timers (s): " + ", ".join(
            f"{k} {t.get(k, 0.0):.3f}" for k in
            ("probe_wait", "host_gather", "stage_encode", "stage_upload",
             "insert_dispatch", "window_dispatch")))
        _check_losses(tag, run)
        if not quant:
            check_scratch_reuse(run, s.scratch_windows, s.window, s.batch)
        del run, rt
        gc.collect()   # free this run's device arrays before the next
    log(f"[pressure] peak_bytes_in_use (process so far): {_peak_bytes()}")


# Aggregation tolerance by input dtype, relative to the largest reference
# value: float32 sums of 10 products differ from the float64 reference in
# rounding only; bfloat16 inputs and output carry an 8-bit mantissa.
AGG_TOLERANCE = {"float32": 1e-5, "bfloat16": 1e-2}


def phase_aggregate(s: Sizes, label, check_rows=1024):
    """XLA's two aggregation forms: each checked against a float64 numpy
    sum over its first ``check_rows`` destinations, then timed."""
    import jax
    import jax.numpy as jnp

    from coala_gnn.ops.aggregate import agg_sum, padded_gather_sum
    from examples.bench_ops import agg_traffic_bytes, timeit

    S, N, F, D = s.agg_n_src, s.agg_n_dst, s.agg_fanout, s.agg_dim
    rng = np.random.default_rng(0)
    adj_h = rng.integers(0, S, size=(N, F)).astype(np.int32)
    w_h = rng.random((N, F)).astype(np.float32)
    adj, w = jnp.asarray(adj_h), jnp.asarray(w_h)
    x = jnp.asarray(rng.normal(size=(S, D)).astype(np.float32))
    xc = jnp.asarray(rng.normal(size=(N * (1 + F), D)).astype(np.float32))
    gather = jax.jit(padded_gather_sum)
    contig = jax.jit(lambda x, w: agg_sum(x, None, w))
    r = min(check_rows, N)
    for dt in (jnp.float32, jnp.bfloat16):
        name = jnp.dtype(dt).name
        xs, xcs = x.astype(dt), xc.astype(dt)
        # slot (i, k) of the contiguous layout is input row N + k*N + i
        contig_adj = N + np.arange(F)[None, :] * N + np.arange(r)[:, None]
        for what, fn, args, src, rows in (
                ("padded gather-sum", gather, (xs, adj, w), xs, adj_h[:r]),
                ("contiguous agg_sum", contig, (xcs, w), xcs, contig_adj)):
            src64 = np.asarray(src.astype(jnp.float32), np.float64)
            want = np.einsum("nfd,nf->nd", src64[rows], w_h[:r])
            got = np.asarray(fn(*args)[:r].astype(jnp.float32))
            tol = AGG_TOLERANCE[name] * float(np.abs(want).max())
            err = float(np.abs(got - want).max())
            if not err <= tol:
                raise AssertionError(f"[aggregate] {what} {name}: max |diff| "
                                     f"{err:.3e} > {tol:.3e}")
            sec = timeit(fn, *args)
            gbs = agg_traffic_bytes(N, F, D, jnp.dtype(dt).itemsize) / sec
            log(f"[aggregate] {what} {name} S={S} N={N} F={F} D={D}: "
                f"max |diff| {err:.2e} vs float64 on {r} rows (tol "
                f"{tol:.2e}); {sec * 1e3:.4f} ms, {gbs / 1e9:.1f} GB/s "
                f"lower-bound bytes ({label})")


def _pressure_dataset(s: Sizes):
    from coala_gnn.coloring import generate_color_metadata
    from coala_gnn.graph.datasets import synthetic_graph
    ds = synthetic_graph(num_nodes=s.p_nodes, avg_degree=15,
                         feature_dim=s.p_dim, num_classes=16, seed=0)
    return ds, generate_color_metadata(ds.graph, ds.train_idx)


def _mesh_trainer(ds, meta, store, mesh, mode, group_size, s: Sizes, tx):
    import jax.numpy as jnp

    from coala_gnn.cache import feature_cache as fc
    from coala_gnn.models import make_model
    from coala_gnn.parallel.sharded_cache import ShardedFeatureCache
    from coala_gnn.parallel.sharded_resident import ShardedResidentTrainer

    n_dev = mesh.devices.size
    shards = {"sharded": n_dev, "isolated": 1,
              "node_local": group_size}[mode]
    cfg = fc.make_config(cache_mb=s.p_cache_mb, dim=s.p_dim,
                         num_colors=meta.num_colors, num_shards=shards,
                         dtype=jnp.float32)
    cache = ShardedFeatureCache(cfg=cfg, mesh=mesh, mode=mode,
                                group_size=group_size)
    fanouts = [int(f) for f in s.p_fanout.split(",")]
    model = make_model("sage", hidden=s.hidden, num_classes=ds.num_classes,
                       num_layers=len(fanouts))
    return ShardedResidentTrainer(
        graph=ds.graph, host_fetch=store.fetch, labels=ds.labels,
        cache=cache, model=model, tx=tx, fanouts=fanouts,
        batch_size=s.batch, colors=meta.color)


def _check_exchange_rows(tag, rt, ds, meta, store, n_req=4096, seed=1):
    """Rows the cache exchange serves (f32 lines) equal the host rows."""
    n_dev = rt.mesh.devices.size
    ids = np.random.default_rng(seed).integers(
        0, ds.graph.num_nodes, (n_dev, n_req)).astype(np.int32)
    rt.cache.stats()
    got = rt.cache._read_local(rt.cache.fetch(
        ids, np.full(n_dev, n_req, np.int32), store.fetch,
        colors=meta.color))
    st = rt.cache.stats()
    equal = np.array_equal(got, ds.features[ids])
    log(f"[{tag}] exchange rows vs host rows over {n_dev}x{n_req} ids "
        f"({st['hits']} served by the caches): "
        f"{'exact' if equal else 'MISMATCH'}")
    if not equal or not st["hits"]:
        raise AssertionError(f"[{tag}] exchange row check failed")


def _check_dp_step(ds, meta, store, mesh, s: Sizes):
    """One data-parallel step on the mesh equals the same per-device blocks
    stepped on one card (mean of per-device gradients), at "highest"
    precision. SGD keeps the update linear in the gradient (Adam's first
    step is +-lr wherever a gradient is nonzero, turning rounding-level
    differences into sign flips); the remaining difference is the order of
    the cross-device mean, hence rtol 1e-5 / atol 1e-6."""
    import jax
    import optax

    tx = optax.sgd(0.1)
    rt = _mesh_trainer(ds, meta, store, mesh, "sharded", 0, s, tx)
    n_dev, B = mesh.devices.size, s.batch
    grid = np.random.default_rng(2).choice(
        ds.train_idx, n_dev * B, replace=False).reshape(n_dev, B)
    k1, k2 = jax.random.split(jax.random.key(3))
    with jax.default_matmul_precision("highest"):
        blocks, feats, y = rt.resolve(rt.begin(grid, k1))
        params = rt.model.init(
            jax.random.key(0), jax.tree.map(lambda a: np.asarray(a)[0],
                                            blocks), np.asarray(feats)[0])
        p_mesh, _, loss_mesh, _ = rt.train_step(params, tx.init(params), k2,
                                                (blocks, feats, y))
        dev0 = jax.devices()[0]
        blocks_h, feats_h, y_h = jax.tree.map(np.asarray, (blocks, feats, y))

        @jax.jit
        def local(p, d_blocks, d_x, d_y, d):
            def lf(p):
                logits = rt.model.apply(
                    p, d_blocks, d_x, train=True,
                    rngs={"dropout": jax.random.fold_in(k2, d)})[:B]
                return optax.softmax_cross_entropy_with_integer_labels(
                    logits, d_y).mean()
            return jax.value_and_grad(lf)(p)

        p0 = jax.device_put(params, dev0)
        outs = [local(p0, jax.device_put(jax.tree.map(lambda a: a[d],
                                                      blocks_h), dev0),
                      jax.device_put(feats_h[d], dev0),
                      jax.device_put(y_h[d], dev0), d)
                for d in range(n_dev)]
        loss_one = float(np.mean([float(l) for l, _ in outs]))
        grads = jax.tree.map(lambda *g: sum(g) / n_dev,
                             *[g for _, g in outs])
        p_one = optax.apply_updates(p0, tx.update(grads, tx.init(p0))[0])
    diffs = [float(np.abs(np.asarray(a) - np.asarray(b)).max())
             for a, b in zip(jax.tree.leaves(p_mesh), jax.tree.leaves(p_one))]
    ok_p = all(np.allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                           atol=1e-6)
               for a, b in zip(jax.tree.leaves(p_mesh),
                               jax.tree.leaves(p_one)))
    ok_l = abs(float(loss_mesh) - loss_one) <= 1e-5 * abs(loss_one)
    log(f"[four/dp-step] loss mesh {float(loss_mesh):.7f} vs one card "
        f"{loss_one:.7f}; updated params max |diff| {max(diffs):.3e} "
        f"(rtol 1e-5, atol 1e-6): {'match' if ok_p and ok_l else 'DIFFER'}")
    if not (ok_p and ok_l):
        raise AssertionError("[four/dp-step] mesh step != one-card step")


def phase_four(s: Sizes, devices, counter, label):
    import jax
    import optax

    from coala_gnn.cache.host_tier import HostFeatureStore
    from coala_gnn.distribution import DistributionScheduler, SeedDistributor
    from coala_gnn.parallel.mesh import make_mesh

    mesh = make_mesh(devices[:4])
    t0 = time.perf_counter()
    ds, meta = _pressure_dataset(s)
    store = HostFeatureStore(ds.features)
    log(f"[four] graph {ds.graph.num_nodes} nodes / {ds.graph.num_edges} "
        f"edges, dim {ds.feature_dim}, {meta.num_colors} colors "
        f"(set-up {time.perf_counter() - t0:.1f} s)")
    K, B = s.window, s.batch
    for mode, group in (("sharded", 0), ("isolated", 0), ("node_local", 2)):
        tag = f"four/{mode}" + (f" groups of {group}" if group else "")
        rt = _mesh_trainer(ds, meta, store, mesh, mode, group, s,
                           optax.adam(s.lr))
        dist = SeedDistributor(ds.train_idx, batch_size=B, local_size=4,
                               num_parts=1, mode="node_color",
                               color=meta.color, topk_colors=meta.topk,
                               affinity=meta.score, shuffle_seed=0)
        sched = DistributionScheduler(dist, part_id=0, local_rank=0,
                                      meta_fn=rt.cache.local_color_meta,
                                      refresh_counter=K)

        def grids(m):
            return np.stack([np.stack(
                [sched.run_domain().reshape(4, B).astype(np.int32)
                 for _ in range(K)], axis=1) for _ in range(m)])

        key = jax.random.key(0)
        resolved = rt.resolve(rt.begin(grids(1)[0][:, 0], key))
        params = rt.model.init(
            jax.random.key(1), jax.tree.map(lambda a: np.asarray(a)[0],
                                            resolved[0]),
            np.asarray(resolved[1])[0])
        opt = rt.tx.init(params)
        t0 = time.perf_counter()
        params, opt, losses, _ = rt.train_windows(
            params, opt, grids(s.four_warm_windows), jax.random.key(2))
        jax.block_until_ready(losses)
        setup_s = time.perf_counter() - t0
        rt.stats()
        t0 = time.perf_counter()
        params, opt, losses, edges = rt.train_windows(
            params, opt, grids(s.four_windows), jax.random.key(3))
        jax.block_until_ready(losses)
        dt = time.perf_counter() - t0
        st = rt.stats()
        losses = np.asarray(losses)
        if not np.isfinite(losses).all():
            raise AssertionError(f"[{tag}] non-finite losses")
        steps = s.four_windows * K
        n, secs = counter.since(t0)
        log(f"[{tag}] set-up windows {setup_s:.2f} s; {steps} steps in "
            f"{dt:.3f} s: {1e3 * dt / steps:.3f} ms/step, "
            f"{float(np.asarray(edges).sum()) / dt:,.0f} edges/s, aggregate "
            f"hit ratio {st['hit_ratio']:.4f}; {n} compiles inside took "
            f"{secs:.3f} s (smoke figure, {label})")
        _check_exchange_rows(tag, rt, ds, meta, store)
        del rt
        gc.collect()
    _check_dp_step(ds, meta, store, mesh, s)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-GPU mesh phase")
    args = p.parse_args(argv)
    need = 4 if args.four else 1
    counter = CompileCounter()
    devs = phase_device("gpu", need)
    label = card()
    log(f"[device] card: {label}")
    if args.four:
        phase_four(FULL, devs, counter, label)
    else:
        phase_native()
        for m in ("sage", "gat"):
            run = phase_coverage(m, FULL, "gpu", counter, label)
            phase_reference(m, run)
            del run
            gc.collect()
        phase_pressure(FULL, "gpu", counter, label)
        phase_aggregate(FULL, label)
    import jax
    d = jax.devices()
    log(f"card: {card()}")
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}), flush=True)


if __name__ == "__main__":
    main()
