"""coala_gnn — distributed GNN training framework in JAX.

A from-scratch JAX/XLA re-imagining of COALA-GNN (color-based
affinity-aware caching and load-aware seed distribution for distributed
mini-batch GNN training on giant graphs). Reference behavior is documented in
SURVEY.md with file:line citations into the reference repo.

Subpackages
-----------
graph        CSC graph container, COO->CSC conversion, .npy artifact I/O
sampling     fanout neighbor sampling producing static-shape padded blocks
ops          neighborhood aggregation ops (segment-sum, gather-SpMM)
models       GraphSAGE / GCN / GAT (+ hetero R-variants) in plain JAX
cache        functional set-associative device feature cache + host RAM tier
coloring     BFS graph coloring + color-affinity metadata (offline)
distribution affinity-aware capacity-constrained seed distributor + scheduler
parallel     device mesh, shard_map sharded cache exchange, train steps
data         COALA-style training dataloader (scheduler + sampler + fetch)
native       C++ kernels for host-side hot loops (coloring, sampling, greedy)
utils        config, timers, stats
"""

__version__ = "0.1.0"

from coala_gnn.graph.csc import CSCGraph  # noqa: F401
