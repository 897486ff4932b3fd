"""Heterogeneous data path end-to-end.

The reference ships hetero IGB/OGB loaders (reference:
examples/dataloader.py:534-841) feeding its RGCN/RSAGE/RGAT models; this
exercises our flattened-relation equivalents offline: typed-edge CSC
artifacts (save_csc/load_csc round trip, create_csc_graph CLI), the
IGB-hetero directory loader, and RGCN training from on-disk artifacts
through examples/train.py.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))

from make_igb_fixture import write_igb_hetero_fixture  # noqa: E402


@pytest.fixture(scope="module")
def hetero_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("igb_hetero"))
    write_igb_hetero_fixture(root, num_paper=2000, dim=24, avg_degree=8,
                             seed=5)
    return root


def test_coo_to_csc_threads_edge_types():
    """edge_types ride the same dst-grouping permutation as indices."""
    from coala_gnn.graph.csc import coo_to_csc

    rng = np.random.default_rng(0)
    n, e = 50, 400
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    ets = rng.integers(0, 5, e).astype(np.int32)
    g = coo_to_csc(src, dst, n, edge_types=ets)
    assert g.num_edge_types == 5
    # for every dst, the (src, type) multiset must survive
    for v in (0, 7, 23, 49):
        lo, hi = g.indptr[v], g.indptr[v + 1]
        got = sorted(zip(g.indices[lo:hi].tolist(),
                         g.edge_types[lo:hi].tolist()))
        want = sorted(zip(src[dst == v].tolist(), ets[dst == v].tolist()))
        assert got == want


def test_save_csc_writes_edge_types_roundtrip(tmp_path):
    """save_csc now persists csc_edge_types.npy — the artifact load_csc
    reads (previously the CLI could never produce a hetero dir)."""
    from coala_gnn.graph.csc import coo_to_csc, load_csc, save_csc

    rng = np.random.default_rng(1)
    src = rng.integers(0, 30, 200)
    dst = rng.integers(0, 30, 200)
    ets = rng.integers(0, 3, 200).astype(np.int32)
    g = coo_to_csc(src, dst, 30, edge_types=ets)
    save_csc(g, str(tmp_path))
    assert os.path.exists(os.path.join(str(tmp_path), "csc_edge_types.npy"))
    g2 = load_csc(str(tmp_path))
    assert g2.num_edge_types == 3
    np.testing.assert_array_equal(np.asarray(g2.edge_types),
                                  np.asarray(g.edge_types))
    np.testing.assert_array_equal(np.asarray(g2.indices),
                                  np.asarray(g.indices))


def test_create_csc_graph_cli_typed_edges(tmp_path):
    """Several --edge_index files -> one flattened typed CSC dir;
    --symmetrize mints reversed relation ids num_rels + r."""
    import create_csc_graph

    rng = np.random.default_rng(2)
    f1, f2 = str(tmp_path / "cites.npy"), str(tmp_path / "writes.npy")
    np.save(f1, rng.integers(0, 40, (60, 2)).astype(np.int64))
    np.save(f2, rng.integers(0, 40, (30, 2)).astype(np.int64))
    out = str(tmp_path / "csc")
    create_csc_graph.main(["--edge_index", f1, f2, "--num_nodes", "40",
                           "--out", out, "--symmetrize"])
    from coala_gnn.graph.csc import load_csc
    g = load_csc(out)
    assert g.num_edges == 2 * (60 + 30)
    assert g.num_edge_types == 4
    counts = np.bincount(np.asarray(g.edge_types), minlength=4)
    np.testing.assert_array_equal(counts, [60, 30, 60, 30])


def test_load_igb_hetero_flattens_reference_layout(hetero_root):
    from coala_gnn.graph.datasets import load_igb_hetero

    ds = load_igb_hetero(hetero_root, dataset_size="tiny", num_classes=19)
    n_paper, n_author = 2000, 1000
    n_inst, n_fos = 100, 200
    assert ds.graph.num_nodes == n_paper + n_author + n_inst + n_fos
    assert ds.graph.num_edge_types == 8          # 4 relations + reverses
    assert ds.features.shape == (ds.graph.num_nodes, 24)
    # paper sits at offset 0: labels/splits index unchanged local ids
    assert ds.labels[:n_paper].min() >= 0
    assert (ds.labels[n_paper:] == -1).all()
    assert ds.train_idx.max() < n_paper
    assert len(ds.train_idx) == int(n_paper * 0.6)
    # paper features land verbatim at rows [0, n_paper)
    base = os.path.join(hetero_root, "tiny", "processed")
    paper_feat = np.load(os.path.join(base, "paper", "node_feat.npy"))
    np.testing.assert_allclose(ds.features[:n_paper], paper_feat)
    # relation 1 (paper -written_by-> author): dst rows are author-global
    et = np.asarray(ds.graph.edge_types)
    deg = np.diff(ds.graph.indptr)
    dst_all = np.repeat(np.arange(ds.graph.num_nodes), deg)
    r1_dst = dst_all[et == 1]
    assert r1_dst.size == 2 * n_paper
    assert r1_dst.min() >= n_paper and r1_dst.max() < n_paper + n_author
    # its reverse (rel 5) points back into paper rows
    r5_dst = dst_all[et == 5]
    assert r5_dst.max() < n_paper


def test_load_ogb_mag_hetero_layout(tmp_path):
    """OGB-MAG layout: [2, E] edge_index orientation, paper-only features,
    negative-label clamp (reference dataloader.py:747-841)."""
    from coala_gnn.graph.datasets import load_ogb_mag_hetero

    rng = np.random.default_rng(3)
    base = os.path.join(str(tmp_path), "processed")
    n_paper, n_author, n_inst = 300, 150, 20
    for d, (ns, nd) in {
        "paper___cites___paper": (n_paper, n_paper),
        "author___writes___paper": (n_author, n_paper),
        "author___affiliated_with___institution": (n_author, n_inst),
    }.items():
        os.makedirs(os.path.join(base, d), exist_ok=True)
        e = np.stack([rng.integers(0, ns, 100), rng.integers(0, nd, 100)])
        # pin the maxima so inferred counts are exact
        e[0, 0], e[1, 0] = ns - 1, nd - 1
        np.save(os.path.join(base, d, "edge_index.npy"), e.astype(np.int64))
    os.makedirs(os.path.join(base, "paper"), exist_ok=True)
    np.save(os.path.join(base, "paper", "node_feat.npy"),
            rng.normal(size=(n_paper, 16)).astype(np.float32))
    labels = rng.integers(-1, 10, n_paper).astype(np.int64)
    np.save(os.path.join(base, "paper", "node_label.npy"), labels)

    ds = load_ogb_mag_hetero(str(tmp_path), num_classes=10)
    assert ds.graph.num_nodes == n_paper + n_author + n_inst
    assert ds.graph.num_edge_types == 6
    assert ds.labels[:n_paper].min() >= 0       # clamp applied
    # author/institute rows are zero features
    assert not ds.features[n_paper:].any()
    assert ds.features[:n_paper].any()


def test_rgcn_trains_from_hetero_artifacts(hetero_root, capsys):
    """RGCN trains from on-disk hetero
    artifacts through examples/train.py (real relation ids, not the
    synthetic --num_edge_types fallback)."""
    import train as train_cli

    train_cli.main([
        "--data", "igb-hetero", "--path", hetero_root, "--dataset_size",
        "tiny", "--num_classes", "19", "--model_type", "rgcn",
        "--batch_size", "64", "--fan_out", "5,5", "--hidden_channels", "32",
        "--epochs", "10", "--learning_rate", "0.01", "--eval",
        "--platform", "cpu",
    ])
    out = capsys.readouterr().out
    assert "8 edge types" in out          # loader relations, not synthetic
    acc_line = [l for l in out.splitlines() if "Test accuracy" in l][-1]
    acc = float(acc_line.split()[2])
    # paper subgraph is the learnable synthetic generator; hetero noise
    # relations dilute it, so the bar is modest but far above 1/19 chance
    assert acc > 0.35, out
