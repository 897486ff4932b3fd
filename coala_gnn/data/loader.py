"""Training data loader: distribution -> sampling -> cached feature fetch.

Capability parity with COALA_GNN_DataLoader
(reference: COALA-GNN-Setup/COALA_GNN/COALA_GNN_DataLoader.py:92-177): each
iteration runs the pipelined scheduler, samples blocks for every local
device, fetches features through the (sharded) cache, and yields
device-stacked arrays ready for the sharded train step. A background worker
prepares iteration i+1's host-side work (distribution, sampling, host-tier
gathers) while the device trains iteration i — the analogue of the
reference's thread pipeline (COALA_GNN_DataLoader.py:27-75), with JAX's async
dispatch hiding the device-side copies.

Epoch length drops the tail batch exactly like the reference
(COALA_GNN_DataLoader.py:141-151).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, List, NamedTuple, Optional

import numpy as np

from coala_gnn.distribution.scheduler import DistributionScheduler
from coala_gnn.sampling.neighbor import NeighborSampler, SampledBatch


class HostBatch(NamedTuple):
    """Device-stacked host-side batch (NumPy; leading axis = local device)."""
    adjs: Optional[List[np.ndarray]]  # per layer: int32 [n_dev, cap_dst,
                               # fanout]; None = contiguous slot-major layout
                               # (adjacency implicit, see sampling/neighbor
                               # ._sample_contiguous)
    masks: Optional[List[np.ndarray]]  # per layer: float32 [n_dev, cap_dst,
                               # fanout]; None in contiguous mode (the wire
                               # never ships them — masks reconstruct on
                               # device from sentinel ids, and stacking
                               # them would be pure prefetch-thread waste)
    input_ids: np.ndarray      # int64 [n_dev, cap_src0]
    num_input: np.ndarray      # int32 [n_dev]
    seeds: np.ndarray          # int64 [n_dev, batch]
    labels: np.ndarray         # int32 [n_dev, batch]
    sampled_nodes: int         # total valid sampled nodes (stats parity)
    rels: Optional[List[np.ndarray]] = None  # per layer int32 (hetero only)
    edges: int = 0             # total valid sampled edges, all devices +
                               # layers (bench accounting without masks)
    valid: Optional[np.ndarray] = None  # bool [n_dev, batch]: per-seed-slot
                               # validity from the distributor (False =
                               # wrapped drop_tail=False tail duplicate);
                               # feeds the masked train step (--mask_tail)


@dataclasses.dataclass
class CoalaDataLoader:
    """Iterates HostBatches for one host's local devices."""

    scheduler: DistributionScheduler
    sampler: NeighborSampler
    labels: np.ndarray           # [num_nodes] int
    local_size: int
    prefetch: int = 2            # background-prepared batches (0 = sync)

    def __post_init__(self):
        self.batch_size = self.sampler.batch_size
        self._steps = self.scheduler.d.num_iters

    def __len__(self) -> int:
        return self._steps

    def _make_batch(self) -> HostBatch:
        domain = self.scheduler.run_domain()
        dv = self.scheduler.domain_valid
        valid = (dv.reshape(self.local_size, self.batch_size).copy()
                 if dv is not None else None)
        per_dev: List[SampledBatch] = []
        for d in range(self.local_size):
            seeds = domain[d * self.batch_size:(d + 1) * self.batch_size]
            per_dev.append(self.sampler.sample(seeds))

        n_layers = len(per_dev[0].blocks)
        # contiguous slot-major sampler: adjacency is implicit (adj=None) —
        # HostBatch.adjs is None and consumers pack only ids+labels
        # (data/packing.pack_request_contig).
        contig = per_dev[0].blocks[0].adj is None
        adjs = None if contig else [
            np.stack([b.blocks[l].adj for b in per_dev])
            for l in range(n_layers)]
        masks = None if contig else [
            np.stack([b.blocks[l].mask for b in per_dev])
            for l in range(n_layers)]
        edges = int(sum(b.blocks[l].mask.sum()
                        for b in per_dev for l in range(n_layers)))
        rels = None
        if per_dev[0].blocks[0].rel is not None:
            rels = [np.stack([b.blocks[l].rel for b in per_dev])
                    for l in range(n_layers)]
        input_ids = np.stack([b.input_ids for b in per_dev])
        num_input = np.asarray([b.num_input for b in per_dev], np.int32)
        seeds = np.stack([b.seeds for b in per_dev])
        return HostBatch(
            adjs=adjs, masks=masks, input_ids=input_ids, num_input=num_input,
            seeds=seeds, labels=self.labels[seeds].astype(np.int32),
            sampled_nodes=int(num_input.sum()), rels=rels, edges=edges,
            valid=valid)

    def __iter__(self) -> Iterator[HostBatch]:
        if self.prefetch <= 0:
            for _ in range(self._steps):
                yield self._make_batch()
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            try:
                for _ in range(self._steps):
                    if stop.is_set():
                        return
                    q.put(self._make_batch())
            except BaseException as e:  # surface worker errors to consumer
                q.put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            for _ in range(self._steps):
                item = q.get()
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so the worker can exit if blocked on put
            while not q.empty():
                q.get_nowait()
            t.join(timeout=5)

    def reset(self, shuffle_seed: Optional[int] = None) -> None:
        self.scheduler.reset(shuffle_seed)
