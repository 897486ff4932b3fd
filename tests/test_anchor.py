"""examples/anchor.py — the turnkey real-data accuracy harness. No real dataset exists in this environment, so the tests prove
the harness itself: the gated no-data path gives an actionable exit, and
the FULL anchor flow (load artifacts -> train -> parse accuracy -> write
BASELINE.json published) runs end-to-end on a synthetic preprocessed-format
directory — the moment real data appears, only the input changes."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
ANCHOR = os.path.join(REPO, "examples", "anchor.py")


def _run(argv, timeout=600):
    return subprocess.run([sys.executable, ANCHOR] + argv,
                          capture_output=True, text=True, timeout=timeout,
                          cwd=REPO)


def test_anchor_no_data_is_actionable():
    out = _run(["--root", "/nonexistent/ogb"])
    assert out.returncode == 2, out.stderr
    assert "no dataset available" in out.stderr
    assert "anchor.py --data preprocessed" in out.stderr


def test_anchor_check_probe():
    out = _run(["--check", "--root", "/nonexistent/ogb"])
    assert out.returncode == 0
    assert "ogb package:" in out.stdout


def test_anchor_full_flow_on_preprocessed_dir(tmp_path):
    """End-to-end: synthetic dataset written in the preprocessed artifact
    layout (create_csc_graph.py outputs), anchored through the real
    trainer, accuracy recorded into a BASELINE.json copy."""
    from coala_gnn.graph.csc import save_csc
    from coala_gnn.graph.datasets import synthetic_graph

    ds = synthetic_graph(num_nodes=4000, avg_degree=8, feature_dim=32,
                         num_classes=4, seed=77)
    art = tmp_path / "arts"
    save_csc(ds.graph, str(art))
    np.save(art / "features.npy", ds.features)
    np.save(art / "labels.npy", ds.labels)
    np.save(art / "train_idx.npy", ds.train_idx)
    np.save(art / "val_idx.npy", ds.val_idx)
    np.save(art / "test_idx.npy", ds.test_idx)

    bj = tmp_path / "BASELINE.json"
    bj.write_text(json.dumps({"published": {}}))

    out = _run(["--data", "preprocessed", "--path", str(art),
                "--num_classes", "4", "--epochs", "8",
                "--batch_size", "64", "--hidden_channels", "32",
                "--learning_rate", "0.01",
                "--platform", "cpu", "--baseline_json", str(bj)])
    assert out.returncode == 0, out.stdout + out.stderr

    doc = json.loads(bj.read_text())
    pub = doc["published"]
    assert pub["real_anchor_dataset"] == "preprocessed"
    # synthetic homophilous graph: the trainer should be far above chance
    assert pub["real_anchor_accuracy"] > 0.5
    assert pub["real_anchor_config"]["fan_out"] == "5,5"
    assert "real_anchor_utc" in pub
