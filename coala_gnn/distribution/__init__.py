from coala_gnn.distribution.distributor import SeedDistributor, greedy_affinity_assign
from coala_gnn.distribution.scheduler import DistributionScheduler

__all__ = ["SeedDistributor", "greedy_affinity_assign", "DistributionScheduler"]
