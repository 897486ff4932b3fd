"""bench.py must stay runnable: the driver executes it at round end.
Exercises run_resident end-to-end on a tiny CPU config (both line
formats) and checks the JSON contract fields."""

import numpy as np

import bench
from coala_gnn.graph.datasets import synthetic_graph


def _tiny(quantize):
    ds = synthetic_graph(num_nodes=3000, avg_degree=8, feature_dim=32,
                         num_classes=4, seed=0)
    return bench.run_resident(ds, B=32, fanouts=[4, 3], dim=32, hidden=32,
                              cache_mb=16, bf16=False, warmup=2, steps=4,
                              quantize=quantize)


def test_bench_run_resident_contract():
    res = _tiny(quantize=False)
    assert res["metric"] == "train_edges_per_s_per_chip"
    assert res["value"] > 0 and res["unit"] == "edges/s"
    assert 0.0 <= res["cache_hit_ratio"] <= 1.0
    assert res["config"]["cache_lines"] == "float32"
    # full prewarm at this size -> fused windows all hit
    assert res["cache_hit_ratio"] == 1.0


def test_bench_run_resident_quantized():
    res = _tiny(quantize=True)
    assert res["value"] > 0
    assert res["config"]["cache_lines"] == "int8"
    assert res["cache_hit_ratio"] == 1.0


def test_bench_run_resident_pressure_staged():
    """The capacity-pressure configuration bench.py runs on the chip:
    degree priorities + staged windows + int8 transport, capacity < nodes."""
    ds = synthetic_graph(num_nodes=3000, avg_degree=8, feature_dim=32,
                         num_classes=4, seed=0)
    res = bench.run_resident(ds, B=32, fanouts=[4, 3], dim=32, hidden=32,
                             cache_mb=1, bf16=False, warmup=2, steps=8,
                             prewarm_frac=1.0, tag="resident-pressure",
                             priorities="degree", stage_transport="int8",
                             window=4)
    assert res["value"] > 0
    assert res["config"]["stage_transport"] == "int8"
    assert res["config"]["priorities"] == "degree"
    # 1 MB at dim 32 = 2048 lines < 3000 nodes: genuine pressure — the
    # associative engine ran with partial coverage
    assert res["cache_hit_ratio"] < 1.0


def test_bench_run_host_cached_and_uncached():
    """run_host (the refactored host packed pipeline, r3): uncached
    (cache_mb=0, the self-baseline configuration) and cached runs both
    return the JSON contract; the cached run reports a hit ratio."""
    from coala_gnn.graph.datasets import synthetic_graph
    ds = synthetic_graph(num_nodes=400, avg_degree=6, feature_dim=32,
                         num_classes=4, seed=0)
    unc = bench.run_host(ds, B=32, fanouts=[4, 3], dim=32, hidden=32,
                         cache_mb=0, bf16=False, warmup=2, steps=4,
                         tag="t-uncached")
    assert unc["value"] > 0 and unc["cache_hit_ratio"] is None
    assert unc["config"]["cache_mb"] == 0
    cach = bench.run_host(ds, B=32, fanouts=[4, 3], dim=32, hidden=32,
                          cache_mb=4, bf16=False, warmup=2, steps=4,
                          tag="t-cached")
    assert cach["value"] > 0 and cach["cache_hit_ratio"] is not None


def test_bench_run_dim1024_block_structure():
    """The int8-overflow-scale pressure block: at a
    budget where int8 lines also under-cover, both staged variants report
    a ratio vs the SAME-CONFIG inline uncached reference."""
    res = bench.run_dim1024(warmup=4, steps=8, nodes=600, dim=128, B=32,
                            fanouts=(4, 3), hidden=32, window=4)
    assert res["uncached_edges_per_s"] > 0
    for k in ("staged_f32_lines", "staged_int8_lines"):
        blk = res[k]
        assert blk["value"] > 0
        assert blk["vs_uncached_same_config"] > 0
        assert 0 <= blk["cache_hit_ratio"] <= 1
    assert res["staged_int8_lines"]["cache_lines"] == "int8"
