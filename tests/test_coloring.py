import numpy as np
import pytest

from coala_gnn.coloring import (
    ColorMetadata,
    color_affinity,
    color_graph,
    generate_color_metadata,
    load_color_metadata,
    save_color_metadata,
)
from coala_gnn.coloring.coloring import color_graph_from_seeds


def test_coloring_invariants(small_dataset):
    ds = small_dataset
    nc, color, hop = color_graph(ds.graph, ds.train_idx, max_hop=10,
                                 base_rate=0.02, seed=0)
    assert nc > 0
    assert color.max() <= nc and color.min() >= 0
    # colored nodes have hop >= 1; uncolored have hop 0
    assert (hop[color > 0] >= 1).all()
    assert (hop[color == 0] == 0).all()
    # with a connected-ish graph and hop 10, most nodes get colored
    assert (color > 0).mean() > 0.5


def test_coloring_python_native_structural_agreement(small_dataset):
    """Native and Python paths use different RNGs so exact colors differ, but
    both must satisfy the same structural invariants on identical input."""
    ds = small_dataset
    for use_native in (True, False):
        nc, color, hop = color_graph(ds.graph, ds.train_idx, max_hop=3,
                                     base_rate=0.02, seed=1,
                                     use_native=use_native)
        assert nc > 0
        assert (hop[color > 0] >= 1).all()
        assert hop.max() <= 4  # max_hop + 1 (flush)


def test_coloring_native_exactly_matches_python_given_seeds(small_dataset):
    """With the RNG seed-pick injected, native BFS coloring and the Python
    oracle must agree EXACTLY — colors, hops, and color count (the
    RNG draw was the only divergence between the two paths)."""
    ds = small_dataset
    rng = np.random.default_rng(7)
    picks = rng.choice(ds.train_idx, size=12, replace=False).astype(np.int64)
    for max_hop in (2, 10):
        nc_n, col_n, hop_n = color_graph_from_seeds(
            ds.graph, ds.train_idx, picks, max_hop=max_hop, use_native=True)
        nc_p, col_p, hop_p = color_graph_from_seeds(
            ds.graph, ds.train_idx, picks, max_hop=max_hop, use_native=False)
        assert nc_n == nc_p == len(picks)
        np.testing.assert_array_equal(col_n, col_p)
        np.testing.assert_array_equal(hop_n, hop_p)
        # every pick ends up colored (possibly adopted by a neighboring
        # pick's color via the hop-0 train pre-step)
        assert (col_n[picks] > 0).all()


def test_affinity_native_matches_numpy(small_dataset):
    """Same coloring in -> native affinity must equal the NumPy oracle."""
    ds = small_dataset
    nc, color, hop = color_graph(ds.graph, ds.train_idx, max_hop=10,
                                 base_rate=0.02, seed=0)
    tk_n, sc_n = color_affinity(ds.graph, color, hop, nc, topk=5, use_native=True)
    tk_p, sc_p = color_affinity(ds.graph, color, hop, nc, topk=5, use_native=False)
    np.testing.assert_array_equal(tk_n, tk_p)
    np.testing.assert_allclose(sc_n, sc_p, rtol=1e-10, atol=1e-12)


def test_affinity_scores_normalized_and_sorted(small_dataset):
    ds = small_dataset
    meta = generate_color_metadata(ds.graph, ds.train_idx, base_rate=0.02,
                                   topk=10, seed=0)
    assert meta.topk.shape == (meta.num_colors, 10)
    assert (meta.score >= 0).all()
    assert (meta.score <= 1.0 + 1e-9).all()  # normalized by neighbor count
    # scores are descending within each row (over nonzero slots)
    for c in range(meta.num_colors):
        s = meta.score[c][meta.topk[c] != 0]
        assert (np.diff(s) <= 1e-12).all()
    # a color never lists itself as its own neighbor
    for c in range(meta.num_colors):
        assert (meta.topk[c] != c + 1).all()


def test_metadata_roundtrip(tmp_path, small_dataset):
    ds = small_dataset
    meta = generate_color_metadata(ds.graph, ds.train_idx, base_rate=0.02, seed=0)
    save_color_metadata(meta, str(tmp_path))
    m2 = load_color_metadata(str(tmp_path))
    np.testing.assert_array_equal(meta.color, m2.color)
    np.testing.assert_array_equal(meta.topk, m2.topk)
    np.testing.assert_allclose(meta.score, m2.score)
    np.testing.assert_array_equal(meta.hop, m2.hop)


def test_reference_flat_score_artifact(tmp_path, small_dataset):
    """The reference saves score.npy as 1-D f64 (generate_color_data.py:67);
    loader must reshape it against topk.npy."""
    ds = small_dataset
    meta = generate_color_metadata(ds.graph, ds.train_idx, base_rate=0.02, seed=0)
    save_color_metadata(meta, str(tmp_path))
    flat = meta.score.reshape(-1)
    np.save(tmp_path / "score.npy", flat)
    m2 = load_color_metadata(str(tmp_path))
    assert m2.score.shape == meta.score.shape
