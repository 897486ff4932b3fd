"""Pipelined distribution scheduler.

Capability parity with COALA_GNN_Node_Distribution_Scheduler
(reference: COALA-GNN-Setup/COALA_GNN/COALA_GNN_DataLoader.py:8-75):

  - the (expensive, global) seed distribution for iteration i+1 runs in a
    background thread while iteration i trains (:31-38, :64-68)
  - every ``refresh_counter`` iterations (default 8, :12) the local cache's
    color-occupancy counters are snapshotted and exchanged across parts in a
    second background thread (:46-59); the distributor consumes the freshest
    *completed* snapshot — double-buffered, never blocking the step
  - the returned seeds are this device's ``batch_size`` slice of its part's
    domain slice (:72-75)

Here threads overlap host-side work with device compute (JAX dispatch is
already async); the meta exchange hook abstracts single-host (identity) vs
multi-host (allgather over jax process group) operation.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

import numpy as np

from coala_gnn.distribution.distributor import SeedDistributor

DEFAULT_REFRESH_COUNTER = 8  # reference: COALA_GNN_DataLoader.py:12


class DistributionScheduler:
    def __init__(self, distributor: SeedDistributor, part_id: int,
                 local_rank: int,
                 meta_fn: Optional[Callable[[], np.ndarray]] = None,
                 meta_exchange_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                 refresh_counter: int = DEFAULT_REFRESH_COUNTER):
        """meta_fn() -> int32 [num_colors+1] local cache color counts.
        meta_exchange_fn(local) -> int32 [num_parts, num_colors+1] global."""
        self.d = distributor
        self.part_id = part_id
        self.local_rank = local_rank
        self.meta_fn = meta_fn
        self.meta_exchange_fn = meta_exchange_fn or (lambda m: m[None, :].repeat(distributor.num_parts, 0))
        self.refresh_counter = refresh_counter

        self._meta: Optional[np.ndarray] = None       # latest completed snapshot
        self._meta_pending: Optional[np.ndarray] = None
        self._meta_thread: Optional[threading.Thread] = None
        self._dist_thread: Optional[threading.Thread] = None
        self._next_domain: Optional[np.ndarray] = None
        self._next_valid: Optional[np.ndarray] = None
        #: bool [domain_batch] — per-slot validity of the last run_domain()
        #: output (False = wrapped tail duplicate; see
        #: SeedDistributor.distribute return_valid). All-true except the
        #: final drop_tail=False iteration of an epoch.
        self.domain_valid: Optional[np.ndarray] = None
        self._iter = 0

    def _distribute(self, it: int) -> None:
        out, valid = self.d.distribute(it, self._meta, return_valid=True)
        self._next_valid = valid[self.part_id]
        self._next_domain = out[self.part_id]

    def _exchange_meta(self, local: np.ndarray) -> None:
        self._meta_pending = self.meta_exchange_fn(local)

    def run(self) -> np.ndarray:
        """Seeds for this device for the next iteration (int64 [batch_size])."""
        return self.d.device_slice(self.run_domain(), self.local_rank)

    def run_domain(self) -> np.ndarray:
        """This part's full domain slice for the next iteration
        (int64 [domain_batch]) — used when one process drives all local
        devices (the single-process-per-host layout)."""
        it = self._iter
        if it >= self.d.num_iters:
            raise StopIteration

        # Join the distribution computed one iteration ahead (or compute now
        # on the first call).
        if self._dist_thread is not None:
            self._dist_thread.join()
            self._dist_thread = None
        if self._next_domain is None:
            self._distribute(it)
        domain = self._next_domain
        self.domain_valid = self._next_valid
        self._next_domain = self._next_valid = None

        # Cache-meta refresh cadence: flip in the finished snapshot, then
        # launch the next async exchange.
        if self.d.mode == "node_color" and self.meta_fn is not None \
                and it % self.refresh_counter == 0:
            if self._meta_thread is not None:
                self._meta_thread.join()
                self._meta = self._meta_pending
            local = np.ascontiguousarray(self.meta_fn(), dtype=np.int32)
            self._meta_thread = threading.Thread(
                target=self._exchange_meta, args=(local,), daemon=True)
            self._meta_thread.start()

        # Pipeline: distribute iteration it+1 in the background.
        if it + 1 < self.d.num_iters:
            self._dist_thread = threading.Thread(
                target=self._distribute, args=(it + 1,), daemon=True)
            self._dist_thread.start()

        self._iter += 1
        return domain

    def reset(self, shuffle_seed: Optional[int] = None) -> None:
        """New epoch: join stragglers, optionally reshuffle, restart pipeline
        (reference: Training_node_distributor.py:62-65)."""
        for t in (self._dist_thread, self._meta_thread):
            if t is not None:
                t.join()
        self._dist_thread = self._meta_thread = None
        self._next_domain = self._next_valid = None
        self._iter = 0
        if shuffle_seed is not None:
            self.d.reshuffle(shuffle_seed)
