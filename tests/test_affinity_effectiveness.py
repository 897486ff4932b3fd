"""End-to-end validation of the COALA hypothesis: affinity-aware seed
distribution beats striping on cache hit rate when neighborhoods are
community-local and caches are capacity-constrained (reference README.md:1-3;
the measurement of Distribution_compare_script.sh)."""

import sys

import numpy as np
import pytest


def test_node_color_beats_baseline_hit_ratio():
    sys.path.insert(0, "examples")
    import affinity_ab

    from coala_gnn.coloring import generate_color_metadata
    from coala_gnn.graph.datasets import clustered_graph

    ds = clustered_graph(num_nodes=8000, num_communities=32, avg_degree=8,
                         p_intra=0.95, feature_dim=32, seed=3)
    meta = generate_color_metadata(ds.graph, ds.train_idx, seed=3)
    assert meta.num_colors > 4

    kwargs = dict(ds=ds, meta=meta, parts=2, B=64, fanouts=[4, 4],
                  cache_mb=1, iters=40, refresh=8, seed=3)
    base = affinity_ab.run_mode("baseline", **kwargs)
    node = affinity_ab.run_mode("node_color", **kwargs)

    # the affinity mechanism must produce a real, repeatable gain
    assert node["aggregate"] > base["aggregate"] + 0.02, (
        f"affinity gain too small: {node['aggregate']} vs {base['aggregate']}")
