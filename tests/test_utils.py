import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

from coala_gnn.utils.timers import PhaseTimers
from coala_gnn.utils import checkpoint as ckpt
from coala_gnn.parallel.multihost import make_meta_exchange_fn, topology


def test_phase_timers():
    t = PhaseTimers()
    with t.time("sample"):
        pass
    t.add("fetch", 0.5)
    s = t.summary()
    assert s["sample"]["count"] == 1
    assert s["fetch"]["total_s"] == 0.5
    assert "fetch" in t.report()
    t.reset()
    assert not t.summary()


def test_checkpoint_roundtrip(tmp_path):
    params = {"w": jnp.arange(6.0).reshape(2, 3), "b": jnp.zeros(3)}
    tx = optax.adam(1e-3)
    opt_state = tx.init(params)
    ckpt.save(str(tmp_path), params, opt_state, step=7)
    assert ckpt.latest_step(str(tmp_path)) == 7

    like = {"params": jax.tree.map(np.zeros_like, params),
            "opt_state": jax.tree.map(np.zeros_like, opt_state),
            "step": 0}
    restored = ckpt.restore(str(tmp_path), like)
    assert restored is not None
    p2, o2, step = restored
    assert step == 7
    np.testing.assert_allclose(np.asarray(p2["w"]), np.asarray(params["w"]))


def test_checkpoint_restore_feeds_mesh_step(tmp_path):
    """Restored arrays land committed to ONE device; a DP shard_map step
    over the mesh must still accept them after the trainer-side
    re-replication (the --resume path in examples/train.py). Regression:
    passing the restored tree straight into the sharded step raised
    'incompatible devices'."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from coala_gnn.parallel.mesh import make_mesh, DATA_AXIS

    mesh = make_mesh()
    n_dev = mesh.devices.size
    params = {"w": jnp.arange(8.0).reshape(2, 4)}
    tx = optax.adam(1e-3)
    ckpt.save(str(tmp_path), params, tx.init(params), step=3)
    like = {"params": jax.tree.map(np.zeros_like, params),
            "opt_state": jax.tree.map(np.zeros_like, tx.init(params)),
            "step": 0}
    p2, o2, step = ckpt.restore(str(tmp_path), like)
    rep = NamedSharding(mesh, P())
    p2, o2 = jax.tree.map(lambda a: jax.device_put(np.asarray(a), rep),
                          (p2, o2))

    @jax.jit
    def step_fn(params, x):
        def local(params, x):
            return jax.lax.pmean((x[0] @ params["w"].T).sum(), DATA_AXIS)
        from jax import shard_map
        pspec = jax.tree.map(lambda _: P(), params)
        return shard_map(local, mesh=mesh, in_specs=(pspec, P(DATA_AXIS)),
                         out_specs=P())(params, x)

    x = jax.device_put(np.ones((n_dev, 3, 4), np.float32),
                       NamedSharding(mesh, P(DATA_AXIS)))
    out = step_fn(p2, x)
    assert np.isfinite(float(out))


def test_meta_exchange_single_process():
    n_hosts, host, local = topology()
    assert n_hosts == 1 and host == 0 and local == 8
    fn = make_meta_exchange_fn(num_colors=4)
    local_meta = np.arange(5, dtype=np.int32)
    out = fn(local_meta)
    assert out.shape == (1, 5)
    np.testing.assert_array_equal(out[0], local_meta)


def test_local_color_meta_matches_global():
    from coala_gnn.cache import feature_cache as fc
    from coala_gnn.cache.host_tier import HostFeatureStore
    from coala_gnn.parallel.mesh import make_mesh
    from coala_gnn.parallel.sharded_cache import ShardedFeatureCache

    mesh = make_mesh()
    n_dev = mesh.devices.size
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(1000, 16)).astype(np.float32)
    colors = rng.integers(1, 5, size=1000).astype(np.int64)
    store = HostFeatureStore(feats)
    cfg = fc.CacheConfig(num_sets=8, ways=fc.WAYS, dim=16, cache_dim=128,
                         num_colors=4, num_shards=n_dev)
    cache = ShardedFeatureCache(cfg=cfg, mesh=mesh, mode="sharded")
    ids = np.tile(np.arange(64, dtype=np.int32), (n_dev, 1))
    nv = np.full(n_dev, 64, np.int32)
    cache.fetch(ids, nv, store.fetch, colors=colors)
    # single process: local == global
    np.testing.assert_array_equal(cache.local_color_meta(), cache.color_meta())


@pytest.fixture
def restore_cache_config():
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_jaxconfig_cache_dir_from_env(tmp_path, monkeypatch,
                                      restore_cache_config):
    from coala_gnn.utils import jaxconfig

    want = str(tmp_path / "jcache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    jaxconfig.setup("cpu")
    assert jax.config.jax_compilation_cache_dir == want
    assert (tmp_path / "jcache").is_dir()


def test_jaxconfig_cache_dir_default_in_checkout(monkeypatch,
                                                 restore_cache_config):
    import os

    from coala_gnn.utils import jaxconfig

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jaxconfig.setup("cpu")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert jax.config.jax_compilation_cache_dir == os.path.join(repo,
                                                                ".jax_cache")


def test_jaxconfig_refuses_platform_mismatch(restore_cache_config):
    """The tests run on the CPU: asking for the GPU must raise, never fall
    back to the CPU."""
    from coala_gnn.utils import jaxconfig

    with pytest.raises(RuntimeError, match="requested platform 'gpu'"):
        jaxconfig.setup("gpu")


def test_roofline_published_peaks_h100():
    from coala_gnn.utils.roofline import bound, published_peaks

    bf16 = published_peaks("NVIDIA H100 80GB HBM3", model_bytes=2)
    f32 = published_peaks("NVIDIA H100 80GB HBM3", model_bytes=4)
    assert bf16["stream_gbps"] == bf16["rand_gbps"] == 3350.0
    assert bf16["mm_tflops"] == 989.0 and f32["mm_tflops"] == 495.0
    # 3.35 GB of streaming bytes at 3.35 TB/s bounds the step at 1 ms
    b = bound({"rand_bytes": 0, "stream_bytes": 3_350_000_000, "flops": 0},
              bf16)
    assert b["binding"] == "stream" and b["t_bound_ms"] == 1.0


def test_roofline_unknown_device_is_an_error():
    from coala_gnn.utils.roofline import published_peaks

    with pytest.raises(KeyError, match="no published peaks"):
        published_peaks("Some Other Accelerator")
