from coala_gnn.graph.csc import CSCGraph, coo_to_csc, save_csc, load_csc
from coala_gnn.graph.datasets import (
    Dataset,
    synthetic_graph,
    load_ogbn_arxiv,
    load_dataset,
    range_splits,
)

__all__ = [
    "CSCGraph",
    "coo_to_csc",
    "save_csc",
    "load_csc",
    "Dataset",
    "synthetic_graph",
    "load_ogbn_arxiv",
    "load_dataset",
    "range_splits",
]
