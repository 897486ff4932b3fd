from coala_gnn.sampling.neighbor import (
    Block,
    SampledBatch,
    NeighborSampler,
    block_capacities,
    max_sample_size,
)

__all__ = [
    "Block",
    "SampledBatch",
    "NeighborSampler",
    "block_capacities",
    "max_sample_size",
]
