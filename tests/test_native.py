"""The native library must BUILD and expose every symbol — a silent build
failure would flip all native/oracle cross-checks into oracle-vs-oracle
no-ops (the _native() helper deliberately falls back quietly in
production)."""

import ctypes

import pytest


def test_native_lib_builds_and_exports():
    from coala_gnn.native import lib

    l = lib.get()   # raises CalledProcessError on a compile failure
    for sym in ("cg_sample_layer", "cg_sample_layer_typed",
                "cg_color_graph", "cg_color_graph_seeded",
                "cg_color_affinity", "cg_distribute_affinity",
                "cg_gather_rows_f32", "cg_gather_rows_u16"):
        assert hasattr(l, sym), f"missing native symbol {sym}"


def test_sampler_actually_uses_native(small_dataset):
    from coala_gnn.sampling.neighbor import NeighborSampler

    s = NeighborSampler(small_dataset.graph, [3], 8, seed=0)
    assert s._native is not None, "native sampler silently unavailable"


def test_encode_bf16_matches_mldtypes():
    """cg_encode_bf16 is bitwise RNE — identical to ml_dtypes astype."""
    import ml_dtypes
    import numpy as np

    from coala_gnn.native import lib

    rng = np.random.default_rng(0)
    x = rng.normal(0, 3, (257, 130)).astype(np.float32)
    # include RNE tie cases and specials
    x[0, :4] = [0.0, -0.0, np.float32(1.0039062),  # 0x3F808000: tie
                np.float32(3.389531e38)]
    got = lib.encode_bf16(x)
    assert got is not None
    want = x.astype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))


def test_gather_rows_bf16_fused():
    """Fused gather+encode == gather then encode; sentinel ids zero."""
    import ml_dtypes
    import numpy as np

    from coala_gnn.native import lib

    l = lib.get()
    rng = np.random.default_rng(1)
    feats = rng.normal(0, 2, (500, 64)).astype(np.float32)
    ids = rng.integers(0, 500, 333).astype(np.int64)
    ids[::7] = -1
    got = lib.gather_rows_bf16(l, feats, ids)
    want = feats[np.maximum(ids, 0)].astype(ml_dtypes.bfloat16)
    want[ids < 0] = 0
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))


def test_gather_quantize_rows_fused():
    """Fused gather+int8 quantize == quantize_rows_native on gathered rows
    AND the jitted cache-line format; sentinel ids -> zero rows, scale 1."""
    import numpy as np

    from coala_gnn.cache.feature_cache import quantize_rows
    from coala_gnn.native import lib

    l = lib.get()
    rng = np.random.default_rng(2)
    feats = rng.normal(0, 5, (400, 96)).astype(np.float32)
    feats[3] = 0.0                               # all-zero row -> scale 1
    ids = rng.integers(0, 400, 211).astype(np.int64)
    ids[5] = 3
    ids[::9] = -1
    q, scale = lib.gather_quantize_rows(l, feats, ids)
    qn, sn = lib.quantize_rows_native(feats[np.maximum(ids, 0)])
    qn[ids < 0] = 0
    sn[ids < 0] = 1.0
    np.testing.assert_array_equal(q, qn)
    np.testing.assert_array_equal(scale, sn)
    # and against the jnp cache-line format on the non-sentinel rows
    qj, sj = quantize_rows(feats[np.maximum(ids, 0)])
    sel = ids >= 0
    np.testing.assert_array_equal(q[sel], np.asarray(qj)[sel])
    np.testing.assert_allclose(scale[sel], np.asarray(sj)[sel], rtol=1e-6)


def test_native_rebuilds_when_source_changes(tmp_path):
    """The library is keyed by the source (and flags and CPU): an edited
    source builds a new library beside the old one, an unchanged one is
    reused, and a library keyed for other sources is never picked."""
    import shutil

    from coala_gnn.native import lib

    src = tmp_path / "coala_native.cpp"
    shutil.copy(lib._SRC, src)
    build = str(tmp_path / "build")
    so1, built1 = lib.build(str(src), build)
    assert built1 and ctypes.CDLL(so1).cg_sample_layer
    assert lib.build(str(src), build) == (so1, False)

    with open(src, "a") as f:
        f.write("\n// edited\n")
    so2, built2 = lib.build(str(src), build)
    assert built2 and so2 != so1
    assert ctypes.CDLL(so2).cg_gather_rows_f32


def test_native_key_follows_the_cpu_flags(monkeypatch):
    """A host that reports no CPU model still keys its library by the
    feature flags ``-march=native`` compiles for."""
    from coala_gnn.native import lib

    paths = set()
    for flags in ("fpu sse2 avx2", "fpu sse2 avx2 avx512f"):
        monkeypatch.setattr(
            lib, "_cpuinfo", lambda key, f=flags: f if key == "flags" else "")
        paths.add(lib.library_path())
    assert len(paths) == 2
