import numpy as np
import pytest

from coala_gnn.graph.csc import CSCGraph, coo_to_csc, load_csc, save_csc
from coala_gnn.graph.datasets import range_splits, synthetic_graph


def test_coo_to_csc_roundtrip():
    src = np.array([0, 1, 2, 0, 3, 1])
    dst = np.array([1, 2, 0, 2, 1, 0])
    g = coo_to_csc(src, dst, 4)
    assert g.num_nodes == 4
    assert g.num_edges == 6
    # in-neighbors of node 0: edges (2->0), (1->0)
    assert sorted(g.in_neighbors(0).tolist()) == [1, 2]
    assert sorted(g.in_neighbors(1).tolist()) == [0, 3]
    assert sorted(g.in_neighbors(2).tolist()) == [0, 1]
    assert g.in_neighbors(3).size == 0
    assert g.in_degrees().tolist() == [2, 2, 2, 0]


def test_csc_validates():
    with pytest.raises(ValueError):
        CSCGraph(indptr=np.array([0, 1, 5]), indices=np.array([0, 1]))


def test_save_load_roundtrip(tmp_path):
    src = np.random.default_rng(0).integers(0, 50, 200)
    dst = np.random.default_rng(1).integers(0, 50, 200)
    g = coo_to_csc(src, dst, 50)
    save_csc(g, str(tmp_path))
    g2 = load_csc(str(tmp_path))
    np.testing.assert_array_equal(g.indptr, g2.indptr)
    np.testing.assert_array_equal(g.indices, g2.indices)
    np.testing.assert_array_equal(g.edge_ids, g2.edge_ids)


def test_reverse():
    src = np.array([0, 1, 2])
    dst = np.array([1, 2, 0])
    g = coo_to_csc(src, dst, 3)
    r = g.reverse()
    # reversed graph: in-neighbors of v are out-neighbors in g
    assert r.in_neighbors(0).tolist() == [2]
    assert r.in_neighbors(1).tolist() == [0]
    assert r.in_neighbors(2).tolist() == [1]


def test_range_splits():
    tr, va, te = range_splits(100)
    assert len(tr) == 60 and len(va) == 20 and len(te) == 20
    assert tr[0] == 0 and te[-1] == 99


def test_synthetic_dataset():
    ds = synthetic_graph(num_nodes=500, avg_degree=8, feature_dim=16,
                         num_classes=4, seed=0)
    assert ds.graph.num_nodes == 500
    assert ds.features.shape == (500, 16)
    assert ds.labels.shape == (500,)
    assert ds.labels.max() < 4
    assert len(ds.train_idx) + len(ds.val_idx) + len(ds.test_idx) == 500
    # splits are disjoint
    all_idx = np.concatenate([ds.train_idx, ds.val_idx, ds.test_idx])
    assert len(np.unique(all_idx)) == 500
