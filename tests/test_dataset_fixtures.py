"""Reference-format dataset loaders exercised end-to-end from an offline
fixture (load_igb_npy / load_preprocessed had never
touched real files; the env has no IGB/OGB data).

The fixture reproduces the reference's IGB raw .npy directory layout
(reference: examples/dataloader.py:18-124) and the csc_*.npy preprocessed
layout (create_csc_graph.py outputs) from a learnable synthetic graph, then
drives the loaders, the coloring-artifact interop, and the full trainer CLI.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))

from make_igb_fixture import write_igb_fixture  # noqa: E402


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("igb_fixture"))
    write_igb_fixture(root, num_nodes=3000, dim=24, avg_degree=8, seed=3,
                      csc=True)
    return root


def test_load_igb_npy_reads_reference_layout(fixture_root):
    from coala_gnn.graph.datasets import load_igb_npy, synthetic_graph

    ds = load_igb_npy(fixture_root, dataset_size="tiny", num_classes=19)
    ref = synthetic_graph(num_nodes=3000, avg_degree=8, feature_dim=24,
                          num_classes=19, seed=3)
    assert ds.graph.num_nodes == 3000
    assert ds.graph.num_edges == ref.graph.num_edges
    assert ds.features.shape == (3000, 24)
    assert ds.num_classes == 19
    np.testing.assert_array_equal(ds.labels, ref.labels)
    np.testing.assert_allclose(np.asarray(ds.features), ref.features)
    # per-dst in-neighbor sets survive the edge_index round trip
    for v in (0, 17, 1234, 2999):
        np.testing.assert_array_equal(
            np.sort(ds.graph.in_neighbors(v)),
            np.sort(ref.graph.in_neighbors(v)))


def test_load_preprocessed_reads_csc_layout(fixture_root):
    from coala_gnn.graph.datasets import load_preprocessed

    pre = os.path.join(fixture_root, "preprocessed")
    ds = load_preprocessed(pre, num_classes=19)
    assert ds.graph.num_nodes == 3000
    assert ds.features.shape == (3000, 24)
    assert ds.train_idx.size > 0         # train_idx.npy override picked up


def test_coloring_artifacts_interop_with_igb_fixture(fixture_root, tmp_path):
    """generate_colors CLI on the fixture -> artifacts load back and drive
    the affinity distributor (the offline preprocessing interop chain)."""
    from coala_gnn.coloring import (generate_color_metadata,
                                        load_color_metadata,
                                        save_color_metadata)
    from coala_gnn.distribution import SeedDistributor
    from coala_gnn.graph.datasets import load_igb_npy

    ds = load_igb_npy(fixture_root, dataset_size="tiny", num_classes=19)
    meta = generate_color_metadata(ds.graph, ds.train_idx, base_rate=0.02,
                                   seed=0)
    save_color_metadata(meta, str(tmp_path))
    m2 = load_color_metadata(str(tmp_path))
    dist = SeedDistributor(ds.train_idx, batch_size=16, local_size=2,
                           num_parts=1, mode="node_color", color=m2.color,
                           topk_colors=m2.topk, affinity=m2.score,
                           shuffle_seed=0)
    domain = dist.distribute(0, np.ones((1, m2.topk.shape[0] + 1), np.int32))
    assert domain.shape[1] == 32


def test_trainer_cli_end_to_end_from_igb_fixture(fixture_root, capsys):
    """Full CLI drive from the reference-format fixture: loader -> sampler
    -> trainer -> eval accuracy above threshold (synthetic features are
    cluster-separable, so a trained model must clear 0.5 easily)."""
    import train as train_cli

    train_cli.main([
        "--data", "igb", "--path", fixture_root, "--dataset_size", "tiny",
        "--num_classes", "19", "--batch_size", "64", "--fan_out", "5,5",
        "--hidden_channels", "32", "--epochs", "2", "--learning_rate",
        "0.01", "--eval", "--platform", "cpu",
    ])
    out = capsys.readouterr().out
    assert "igb-tiny: 3000 nodes" in out
    acc_line = [l for l in out.splitlines() if "Test accuracy" in l][-1]
    acc = float(acc_line.split()[2])
    assert acc > 0.5, out
