"""HostBatch contract of CoalaDataLoader in both wire layouts.

Contiguous mode ships no adjacency/masks (they reconstruct on device from
sentinel ids — data/packing.pack_request_contig); the loader must not
spend prefetch-thread time stacking them, and its edge count must equal
what the mask-stacking path would have reported."""

import numpy as np

from coala_gnn.data.loader import CoalaDataLoader
from coala_gnn.distribution import DistributionScheduler, SeedDistributor
from coala_gnn.graph.datasets import synthetic_graph
from coala_gnn.sampling.neighbor import NeighborSampler


def _make_loader(ds, B, fanouts, contiguous, local_size=2):
    distributor = SeedDistributor(ds.train_idx, batch_size=B,
                                  local_size=local_size, num_parts=1,
                                  mode="baseline", shuffle_seed=3)
    scheduler = DistributionScheduler(distributor, part_id=0, local_rank=0)
    sampler = NeighborSampler(ds.graph, fanouts, B, seed=7,
                              contiguous=contiguous)
    return CoalaDataLoader(scheduler=scheduler, sampler=sampler,
                           labels=ds.labels, local_size=local_size,
                           prefetch=0)


def test_contiguous_batches_carry_edges_not_masks():
    ds = synthetic_graph(num_nodes=3000, avg_degree=8, feature_dim=16,
                         num_classes=4, seed=5)
    B, fanouts = 16, [4, 3]

    contig = _make_loader(ds, B, fanouts, contiguous=True)
    padded = _make_loader(ds, B, fanouts, contiguous=False)

    for hb_c, hb_p in zip(contig, padded):
        # contiguous wire: no adjacency, no masks, edge count carried
        assert hb_c.adjs is None and hb_c.masks is None
        assert hb_c.edges > 0
        # padded wire keeps masks for DeviceBlock construction, and its
        # edge field agrees with the stacked masks it still ships
        assert hb_p.masks is not None
        assert hb_p.edges == int(sum(m.sum() for m in hb_p.masks))
        # identical seeds (same distributor config) -> identical seed grid;
        # the two samplers draw different RNG streams per layout, so edge
        # counts only need to be plausible, not equal
        np.testing.assert_array_equal(hb_c.seeds, hb_p.seeds)
        from coala_gnn.sampling.neighbor import block_capacities
        caps = block_capacities(B, fanouts)
        cap = hb_c.seeds.shape[0] * sum(
            cd * f for (cd, _), f in zip(caps, fanouts))
        assert hb_c.edges <= cap
        break  # one batch suffices; the loop exists for the zip
