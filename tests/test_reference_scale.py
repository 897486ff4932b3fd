"""Reference-scale pipeline test.

Exercises examples/reference_scale.py end-to-end at miniature scale: the
on-disk generate leg (load_preprocessed layout: csc_*.npy + memmapped
features.npy + labels/splits + meta.json), the single-chip capacity-
pressure run leg (ResidentTrainer off the memmap, staged miss path,
phase timers, epoch projection), and the sharded-topology mesh leg
(8 virtual devices, E/n_dev edges per device — the papers100M-class
layout, reference: examples/ssd_gnn_dataloader.py:365-569,819).

The full 10M-node / dim-1024 / 41 GiB run is examples/reference_scale.py
--run (same code path, real scale); the `slow` marker variant here regenerates
a mid-size graph to keep CI honest about the memmap path without the
41 GiB write.
"""

import json
import os

import numpy as np
import pytest

from examples.reference_scale import generate, run_mesh, run_single


@pytest.fixture(scope="module")
def tiny_graph(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("refscale"))
    meta = generate(path, num_nodes=20_000, avg_degree=8, dim=32,
                    num_classes=7, community_size=256, p_intra=0.9, seed=3)
    return path, meta


def test_generate_layout(tiny_graph):
    path, meta = tiny_graph
    for name in ("csc_indptr.npy", "csc_indices.npy", "features.npy",
                 "labels.npy", "train_idx.npy", "val_idx.npy",
                 "test_idx.npy", "meta.json"):
        assert os.path.exists(os.path.join(path, name)), name
    indptr = np.load(os.path.join(path, "csc_indptr.npy"))
    indices = np.load(os.path.join(path, "csc_indices.npy"), mmap_mode="r")
    assert indptr.shape == (meta["num_nodes"] + 1,)
    assert indptr[-1] == meta["num_edges"] == indices.shape[0]
    feats = np.load(os.path.join(path, "features.npy"), mmap_mode="r")
    assert feats.shape == (meta["num_nodes"], meta["dim"])
    assert feats.dtype == np.float32
    # homophily: with p_intra=0.9 most edges stay inside the community
    dst = np.repeat(np.arange(meta["num_nodes"]), np.diff(indptr))
    same = (np.asarray(indices) // meta["community_size"]
            == dst // meta["community_size"])
    assert same.mean() > 0.8
    with open(os.path.join(path, "meta.json")) as f:
        assert json.load(f)["num_nodes"] == meta["num_nodes"]


def test_run_single_pressure(tiny_graph):
    path, meta = tiny_graph
    out = run_single(path, cache_mb=1, batch=128, fanout="5,5", hidden=32,
                     window=4, windows=3, warm_windows=1,
                     transport="int8")
    assert out["measured_steps"] == 12
    assert 0.0 < out["hit_ratio"] < 1.0       # genuinely under pressure
    assert out["edges_per_s"] > 0
    assert np.isfinite(out["loss_first_last"]).all()
    # epoch projection = dt/steps * steps_per_epoch; at 200 train seeds
    # that is 1 step/epoch of ~4 ms, which rounds to 0.0s — assert the
    # inputs instead of the rounded product
    assert out["steps_per_epoch"] >= 1 and out["measured_s"] > 0
    # the probe-bitmap d2h cost at scale:
    # (num_nodes+1) bytes
    assert out["probe_bitmap_mb"] == round((meta["num_nodes"] + 1) / 2**20,
                                           1)
    assert {"probe_wait", "host_gather", "stage_upload"} <= set(
        out["phase_timers"])


def test_run_mesh_sharded_topology(tiny_graph):
    path, _ = tiny_graph
    out = run_mesh(path, batch=64, fanout="5,5", hidden=32, cache_mb=8,
                   window=2, windows=2)
    assert out["devices"] == 8
    assert out["shard_topology"] is True
    assert out["steps"] == 4
    assert np.isfinite(out["loss_first_last"]).all()


@pytest.mark.slow
def test_reference_scale_midsize(tmp_path):
    """Mid-size leg (1M nodes): int64 offsets + memmap paging for real."""
    path = str(tmp_path / "mid")
    meta = generate(path, num_nodes=1_000_000, avg_degree=10, dim=64,
                    num_classes=19, community_size=2048, p_intra=0.9,
                    seed=0)
    out = run_single(path, cache_mb=16, batch=512, fanout="10,5",
                     hidden=64, window=8, windows=4, warm_windows=1,
                     transport="int8")
    assert out["hit_ratio"] < 1.0
    assert out["edges_per_s"] > 0
    assert meta["num_edges"] == 10_000_000
