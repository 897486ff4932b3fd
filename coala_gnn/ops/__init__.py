from coala_gnn.ops.aggregate import (
    padded_gather_sum,
    padded_mean,
    padded_gather_sum_dense,
)
from coala_gnn.ops.segment import spmm_coo, segment_softmax

__all__ = [
    "padded_gather_sum",
    "padded_mean",
    "padded_gather_sum_dense",
    "spmm_coo",
    "segment_softmax",
]
