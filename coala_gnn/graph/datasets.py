"""Dataset containers and loaders.

Capability parity with the reference's dataset layer
(reference: examples/dataloader.py + examples/ssd_gnn_dataloader.py):
  - IGB-style raw .npy directory layout (node_feat.npy / node_label_*.npy /
    paper__cites__paper/edge_index.npy)  [dataloader.py:18-124]
  - OGB node-property datasets via the ogb package when installed
    [dataloader.py:423-485]
  - 60/20/20 index-range train/val/test splits  [dataloader.py:181-196]
  - synthetic graphs for testing (the reference has none; our test pyramid
    needs them — SURVEY.md §4)

All loaders return a uniform ``Dataset``: CSC graph + features + labels +
split index arrays, everything host-resident NumPy.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np

from coala_gnn.graph.csc import CSCGraph, coo_to_csc, load_csc


@dataclasses.dataclass
class Dataset:
    graph: CSCGraph
    features: np.ndarray          # [num_nodes, dim] float32 (may be mmap)
    labels: np.ndarray            # [num_nodes] int32
    train_idx: np.ndarray         # int64 node ids
    val_idx: np.ndarray
    test_idx: np.ndarray
    num_classes: int
    name: str = "dataset"

    @property
    def feature_dim(self) -> int:
        return int(self.features.shape[1])


def range_splits(num_nodes: int,
                 fractions: Tuple[float, float] = (0.6, 0.2)
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Contiguous 60/20/20 index-range splits.

    Parity with reference examples/dataloader.py:181-196, which marks
    [0, 0.6N) train, [0.6N, 0.8N) val, rest test.
    """
    n_train = int(num_nodes * fractions[0])
    n_val = int(num_nodes * fractions[1])
    ids = np.arange(num_nodes, dtype=np.int64)
    return ids[:n_train], ids[n_train:n_train + n_val], ids[n_train + n_val:]


def synthetic_graph(num_nodes: int = 10_000,
                    avg_degree: int = 15,
                    feature_dim: int = 128,
                    num_classes: int = 16,
                    seed: int = 0,
                    power_law: bool = True) -> Dataset:
    """Random graph with community structure so GNNs can beat chance.

    Nodes get a latent class; edges prefer same-class endpoints (80%) and
    features are a noisy class embedding, so neighborhood aggregation is
    genuinely predictive — lets accuracy serve as the end-to-end oracle the
    way the reference uses test accuracy (SURVEY.md §4.2).
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=num_nodes).astype(np.int32)
    num_edges = num_nodes * avg_degree

    if power_law:
        # Heavy-tailed out-degree: exercises load-balancing paths.
        w = rng.pareto(1.5, size=num_nodes) + 1.0
        p = w / w.sum()
        src = rng.choice(num_nodes, size=num_edges, p=p).astype(np.int64)
    else:
        src = rng.integers(0, num_nodes, size=num_edges).astype(np.int64)

    # 80% homophilous edges: pick dst from same-class nodes.
    by_class = [np.flatnonzero(labels == c) for c in range(num_classes)]
    dst = rng.integers(0, num_nodes, size=num_edges).astype(np.int64)
    homo = rng.random(num_edges) < 0.8
    for c in range(num_classes):
        m = homo & (labels[src] == c)
        pool = by_class[c]
        if pool.size and m.any():
            dst[m] = rng.choice(pool, size=int(m.sum()))

    graph = coo_to_csc(src, dst, num_nodes)

    class_emb = rng.normal(0, 1, size=(num_classes, feature_dim)).astype(np.float32)
    features = class_emb[labels] + rng.normal(0, 1.0, size=(num_nodes, feature_dim)).astype(np.float32)

    perm = rng.permutation(num_nodes).astype(np.int64)
    n_tr, n_va = int(0.6 * num_nodes), int(0.2 * num_nodes)
    return Dataset(
        graph=graph,
        features=features,
        labels=labels,
        train_idx=perm[:n_tr],
        val_idx=perm[n_tr:n_tr + n_va],
        test_idx=perm[n_tr + n_va:],
        num_classes=num_classes,
        name=f"synthetic-{num_nodes}",
    )


def clustered_graph(num_nodes: int = 30_000,
                    num_communities: int = 64,
                    avg_degree: int = 10,
                    p_intra: float = 0.95,
                    feature_dim: int = 64,
                    num_classes: int = 16,
                    seed: int = 0) -> Dataset:
    """Strongly community-structured graph (stochastic block model flavor).

    The locality regime COALA targets: neighborhoods concentrate inside
    communities, so BFS colors track communities and affinity-aware seed
    distribution can specialize each host's cache (reference README.md:1-3).
    ``p_intra`` is the probability an edge stays inside its community."""
    rng = np.random.default_rng(seed)
    community = rng.integers(0, num_communities, size=num_nodes).astype(np.int32)
    members = [np.flatnonzero(community == c) for c in range(num_communities)]
    num_edges = num_nodes * avg_degree
    src = rng.integers(0, num_nodes, size=num_edges).astype(np.int64)
    dst = np.empty(num_edges, dtype=np.int64)
    intra = rng.random(num_edges) < p_intra
    dst[~intra] = rng.integers(0, num_nodes, size=int((~intra).sum()))
    for c in range(num_communities):
        m = intra & (community[src] == c)
        pool = members[c]
        if pool.size and m.any():
            dst[m] = rng.choice(pool, size=int(m.sum()))
    graph = coo_to_csc(src, dst, num_nodes)

    labels = (community % num_classes).astype(np.int32)
    class_emb = rng.normal(0, 1, size=(num_classes, feature_dim)).astype(np.float32)
    features = class_emb[labels] + rng.normal(
        0, 1.0, size=(num_nodes, feature_dim)).astype(np.float32)
    perm = rng.permutation(num_nodes).astype(np.int64)
    n_tr, n_va = int(0.6 * num_nodes), int(0.2 * num_nodes)
    return Dataset(graph=graph, features=features, labels=labels,
                   train_idx=perm[:n_tr], val_idx=perm[n_tr:n_tr + n_va],
                   test_idx=perm[n_tr + n_va:], num_classes=num_classes,
                   name=f"clustered-{num_nodes}x{num_communities}")


def load_ogbn_arxiv(root: str = "data/ogb") -> Dataset:
    """ogbn-arxiv via the ogb package (gated: raises if unavailable).

    Parity with reference examples/dataloader.py:423-485 (load_ogb), which
    symmetrizes the citation graph before training.
    """
    return _load_ogb("ogbn-arxiv", root)


def _load_ogb(name: str, root: str) -> Dataset:
    try:
        from ogb.nodeproppred import NodePropPredDataset  # type: ignore
    except ImportError as e:  # pragma: no cover - env-dependent
        raise RuntimeError(
            f"ogb package not installed; cannot load {name}. "
            "Use synthetic_graph() or an IGB/npy directory instead.") from e
    ds = NodePropPredDataset(name=name, root=root)
    split = ds.get_idx_split()
    g, labels = ds[0]
    num_nodes = g["num_nodes"]
    src, dst = g["edge_index"]
    # Symmetrize (reference dataloader.py:455-466 uses to_bidirected).
    src2 = np.concatenate([src, dst])
    dst2 = np.concatenate([dst, src])
    graph = coo_to_csc(src2, dst2, num_nodes)
    labels = np.nan_to_num(labels.reshape(-1), nan=-1).astype(np.int32)
    return Dataset(
        graph=graph,
        features=np.ascontiguousarray(g["node_feat"], dtype=np.float32),
        labels=labels,
        train_idx=np.asarray(split["train"], dtype=np.int64),
        val_idx=np.asarray(split["valid"], dtype=np.int64),
        test_idx=np.asarray(split["test"], dtype=np.int64),
        num_classes=int(labels.max()) + 1,
        name=name,
    )


def load_igb_npy(path: str, dataset_size: str = "tiny",
                 num_classes: int = 19, mmap: bool = True) -> Dataset:
    """IGB raw .npy directory layout.

    Parity with reference examples/dataloader.py:18-124 (IGB260M): expects
    ``<path>/<size>/processed/paper/node_feat.npy``, ``node_label_19.npy`` (or
    ``node_label_2K.npy``), ``paper__cites__paper/edge_index.npy``.
    """
    base = os.path.join(path, dataset_size, "processed")
    mode = "r" if mmap else None
    feat = np.load(os.path.join(base, "paper", "node_feat.npy"), mmap_mode=mode)
    label_file = "node_label_19.npy" if num_classes == 19 else "node_label_2K.npy"
    labels = np.load(os.path.join(base, "paper", label_file)).astype(np.int32).reshape(-1)
    edge_index = np.load(os.path.join(base, "paper__cites__paper", "edge_index.npy"),
                         mmap_mode=mode)
    num_nodes = feat.shape[0]
    graph = coo_to_csc(np.asarray(edge_index[:, 0]), np.asarray(edge_index[:, 1]), num_nodes)
    train_idx, val_idx, test_idx = range_splits(num_nodes)
    return Dataset(graph=graph, features=feat, labels=labels,
                   train_idx=train_idx, val_idx=val_idx, test_idx=test_idx,
                   num_classes=num_classes, name=f"igb-{dataset_size}")


def _flatten_hetero(edges, node_counts, predict_type: str,
                    feats_by_type, labels_predict: np.ndarray,
                    num_classes: int, add_reverse: bool,
                    name: str) -> Dataset:
    """Flatten a typed-node heterogeneous graph into one unified id space.

    Static-shape hetero form: ONE node-id domain (static shapes, one feature
    table, one cache) with a relation id per edge — replacing the
    reference's per-etype DGL heterograph (dataloader.py:561-567). The
    predict type sits at offset 0 so its local ids, labels, and splits
    carry over unchanged.

    edges        : list of (src_type, rel_name, dst_type, src_ids, dst_ids)
                   — rel id = list position; with ``add_reverse`` each
                   relation also gets a reversed twin with rel id
                   len(edges) + position (the reference never adds
                   reverses, so author/institute/fos features can never
                   reach paper through its in-edge sampler; we default the
                   fix ON and record it in ``name``)
    node_counts  : {type: count}
    feats_by_type: {type: [count, dim] array} — types may be absent
                   (zero features, e.g. OGB-MAG author/institute); present
                   types must share dim (true of IGB-hetero and required
                   by the reference's shared-input-dim RGCN,
                   examples/models.py:181-206)
    labels_predict: labels for the predict type's nodes; other nodes get -1
    """
    types = [predict_type] + [t for t in node_counts if t != predict_type]
    offsets = {}
    off = 0
    for t in types:
        offsets[t] = off
        off += int(node_counts[t])
    total_nodes = off

    dims = {int(f.shape[1]) for f in feats_by_type.values()}
    if len(dims) != 1:
        raise ValueError(f"hetero node-feature dims differ: {sorted(dims)}; "
                         "the flattened feature table needs one dim")
    dim = dims.pop()

    srcs, dsts, rels = [], [], []
    for rel_id, (st, _rn, dt, s, d) in enumerate(edges):
        s = np.asarray(s, np.int64) + offsets[st]
        d = np.asarray(d, np.int64) + offsets[dt]
        srcs.append(s)
        dsts.append(d)
        rels.append(np.full(len(s), rel_id, np.int32))
        if add_reverse:
            srcs.append(d)
            dsts.append(s)
            rels.append(np.full(len(s), len(edges) + rel_id, np.int32))
    graph = coo_to_csc(np.concatenate(srcs), np.concatenate(dsts),
                       total_nodes, edge_types=np.concatenate(rels))
    graph.num_edge_types = len(edges) * (2 if add_reverse else 1)

    features = np.zeros((total_nodes, dim), np.float32)
    for t, f in feats_by_type.items():
        features[offsets[t]:offsets[t] + int(node_counts[t])] = f

    labels = np.full(total_nodes, -1, np.int32)
    n_pred = int(node_counts[predict_type])
    labels[:n_pred] = np.asarray(labels_predict, np.int32).reshape(-1)[:n_pred]
    train_idx, val_idx, test_idx = range_splits(n_pred)
    return Dataset(graph=graph, features=features, labels=labels,
                   train_idx=train_idx, val_idx=val_idx, test_idx=test_idx,
                   num_classes=num_classes, name=name)


def load_igb_hetero(path: str, dataset_size: str = "tiny",
                    num_classes: int = 19, mmap: bool = True,
                    add_reverse: bool = True) -> Dataset:
    """IGB heterogeneous raw .npy directory layout, flattened.

    Parity with reference examples/dataloader.py:534-636
    (IGBHeteroDGLDataset): expects under ``<path>/<size>/processed/``
    the edge dirs ``paper__cites__paper``, ``paper__written_by__author``,
    ``author__affiliated_to__institute``, ``paper__topic__fos`` (each
    ``edge_index.npy`` [E, 2] = (src, dst) columns, dataloader.py:561-566)
    and per-type ``<type>/node_feat.npy`` + paper labels
    (``node_label_19.npy`` / ``node_label_2K.npy``). Splits: 60/20/20
    index ranges over paper nodes (dataloader.py:616-629)."""
    base = os.path.join(path, dataset_size, "processed")
    mode = "r" if mmap else None

    def _edges(d):
        e = np.load(os.path.join(base, d, "edge_index.npy"), mmap_mode=mode)
        return np.asarray(e[:, 0]), np.asarray(e[:, 1])

    feats = {t: np.load(os.path.join(base, t, "node_feat.npy"),
                        mmap_mode=mode)
             for t in ("paper", "author", "institute", "fos")}
    label_file = "node_label_19.npy" if num_classes == 19 else "node_label_2K.npy"
    labels = np.load(os.path.join(base, "paper", label_file))

    pp = _edges("paper__cites__paper")
    pa = _edges("paper__written_by__author")
    ai = _edges("author__affiliated_to__institute")
    pf = _edges("paper__topic__fos")
    edges = [("paper", "cites", "paper", *pp),
             ("paper", "written_by", "author", *pa),
             ("author", "affiliated_to", "institute", *ai),
             ("paper", "topic", "fos", *pf)]
    counts = {t: int(f.shape[0]) for t, f in feats.items()}
    return _flatten_hetero(edges, counts, "paper", feats, labels,
                           num_classes, add_reverse,
                           name=f"igb-hetero-{dataset_size}"
                                + ("+rev" if add_reverse else ""))


def load_ogb_mag_hetero(path: str, num_classes: int = 349,
                        mmap: bool = True,
                        add_reverse: bool = True) -> Dataset:
    """OGB-MAG heterogeneous directory layout, flattened.

    Parity with reference examples/dataloader.py:747-841
    (OGBHeteroDGLDatasetMassive): under ``<path>/processed/`` the edge dirs
    ``paper___cites___paper``, ``author___writes___paper``,
    ``author___affiliated_with___institution`` (``edge_index.npy`` [2, E] —
    note the transposed orientation vs IGB, dataloader.py:799-803), paper
    features/labels only (``paper/node_feat.npy``, ``node_label.npy``;
    negative labels clamp to 0, dataloader.py:781). author/institute get
    zero features (the reference attaches none either)."""
    base = os.path.join(path, "processed")
    mode = "r" if mmap else None

    def _edges(d):
        e = np.load(os.path.join(base, d, "edge_index.npy"), mmap_mode=mode)
        return np.asarray(e[0, :]), np.asarray(e[1, :])

    pp = _edges("paper___cites___paper")
    ap = _edges("author___writes___paper")
    ai = _edges("author___affiliated_with___institution")
    feat = np.load(os.path.join(base, "paper", "node_feat.npy"),
                   mmap_mode=mode)
    labels = np.asarray(
        np.load(os.path.join(base, "paper", "node_label.npy"),
                mmap_mode=mode)).reshape(-1).astype(np.int32)
    labels[labels < 0] = 0  # reference clamp, dataloader.py:781

    n_paper = int(feat.shape[0])
    n_author = int(max(ap[0].max(), ai[0].max())) + 1
    n_inst = int(ai[1].max()) + 1
    edges = [("paper", "cites", "paper", *pp),
             ("author", "writes", "paper", *ap),
             ("author", "affiliated_to", "institute", *ai)]
    counts = {"paper": n_paper, "author": n_author, "institute": n_inst}
    return _flatten_hetero(edges, counts, "paper", {"paper": feat}, labels,
                           num_classes, add_reverse,
                           name="ogb-mag-hetero"
                                + ("+rev" if add_reverse else ""))


def load_preprocessed(path: str, num_classes: int, mmap: bool = True,
                      name: str = "preprocessed") -> Dataset:
    """Load a directory of csc_*.npy + features.npy + labels.npy artifacts
    produced by our preprocessing CLI (tools equivalent of the reference's
    create_csc_graph.py outputs, examples/create_csc_graph.py:284-286)."""
    graph = load_csc(path, mmap=mmap)
    mode = "r" if mmap else None
    feat = np.load(os.path.join(path, "features.npy"), mmap_mode=mode)
    labels = np.load(os.path.join(path, "labels.npy")).astype(np.int32)
    train_idx, val_idx, test_idx = range_splits(graph.num_nodes)
    for split in ("train_idx", "val_idx", "test_idx"):
        p = os.path.join(path, f"{split}.npy")
        if os.path.exists(p):
            locals_map = {"train_idx": 0, "val_idx": 1, "test_idx": 2}
            arr = np.load(p).astype(np.int64)
            if locals_map[split] == 0:
                train_idx = arr
            elif locals_map[split] == 1:
                val_idx = arr
            else:
                test_idx = arr
    return Dataset(graph=graph, features=feat, labels=labels,
                   train_idx=train_idx, val_idx=val_idx, test_idx=test_idx,
                   num_classes=num_classes, name=name)


def load_dataset(name: str, **kwargs) -> Dataset:
    """Dispatch by name — mirrors the trainer's dataset switch
    (reference: examples/sbatch_ssd_gnn_train.py:270-289)."""
    if name.startswith("synthetic"):
        return synthetic_graph(**kwargs)
    if name.startswith("ogbn"):
        return _load_ogb(name, kwargs.get("root", "data/ogb"))
    if name in ("igb-hetero", "igbh"):
        return load_igb_hetero(**kwargs)
    if name in ("ogb-mag-hetero", "mag"):
        kwargs.pop("dataset_size", None)
        return load_ogb_mag_hetero(**kwargs)
    if name.startswith("igb"):
        return load_igb_npy(**kwargs)
    if name == "preprocessed":
        return load_preprocessed(kwargs["path"],
                                 num_classes=kwargs["num_classes"],
                                 mmap=kwargs.get("mmap", True))
    raise ValueError(f"unknown dataset {name!r}")
