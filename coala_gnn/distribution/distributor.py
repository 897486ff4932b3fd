"""Affinity-aware seed distribution.

Capability parity with the reference's Node_Distributor + native greedy
(reference: COALA-GNN-Setup/COALA_GNN/Training_node_distributor.py:5-65 and
COALA_GNN_Modules/node_distributor_pybind.cuh:150-222):

  - ``baseline`` mode: contiguous striping of the global batch across parts
    (Training_node_distributor.py:41-47)
  - ``node_color`` mode: greedy capacity-constrained argmax of
    score(seed, part) = sum_k cache_meta[part][topk_color[c][k]] * affinity[c][k]
    where c = color[seed]; uncolored seeds score 0; a full part scores -1;
    ties go to the lowest part index.

Every host computes the identical full global assignment from identical
inputs (determinism is the cross-host correctness contract — the reference
relies on the same property, node_distributor_pybind.cuh:166-221).

In this build a "part" is a host (jax process); each host then splits its
domain slice across its local devices by position, mirroring the reference's
domain_batch -> per-GPU batch split (COALA_GNN_DataLoader.py:72-75).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def greedy_affinity_assign(seeds: np.ndarray, color: np.ndarray,
                           topk_colors: np.ndarray, affinity: np.ndarray,
                           cache_meta: np.ndarray, capacity: int,
                           use_native: bool = True) -> np.ndarray:
    """Returns int32 [len(seeds)] part assignment.

    cache_meta: int32 [num_parts, num_colors + 1] — live per-part cache
    color-occupancy counters (1-based color index, slot 0 unused)."""
    num_parts = cache_meta.shape[0]
    if use_native:
        try:
            from coala_gnn.native import lib as native_lib
            lib = native_lib.get()
            return native_lib.distribute_affinity(
                lib, seeds, 0, len(seeds), num_parts, capacity,
                color, topk_colors, affinity, cache_meta)
        except Exception:
            pass
    return _greedy_py(seeds, color, topk_colors, affinity, cache_meta, capacity)


def _greedy_py(seeds, color, topk_colors, affinity, cache_meta, capacity):
    """Pure-Python oracle with identical semantics to cg_distribute_affinity."""
    num_parts = cache_meta.shape[0]
    # Precompute score(seed, part) vectorized; the greedy capacity loop stays
    # sequential (it must — assignment order affects feasibility).
    c = color[seeds]                                  # [S]
    valid = c != 0
    rows = np.where(valid, c - 1, 0)
    tk = topk_colors[rows]                            # [S, K]
    af = affinity[rows]                               # [S, K]
    counts = cache_meta[:, :].astype(np.float64)      # [P, C+1]
    per_slot = counts[:, tk]                          # [P, S, K]
    scores = np.einsum("psk,sk->sp", per_slot, np.where(tk != 0, af, 0.0))
    scores[~valid] = 0.0

    out = np.zeros(len(seeds), dtype=np.int32)
    bucket = np.zeros(num_parts, dtype=np.int64)
    for i in range(len(seeds)):
        s = scores[i].copy()
        s[bucket >= capacity] = -1.0
        best = int(np.argmax(s))  # argmax takes first max — same tie-break
        out[i] = best
        bucket[best] += 1
    return out


class SeedDistributor:
    """Global-shuffle seed stream + per-iteration distribution.

    Equivalent of Training_node_distributor.Node_Distributor: holds the
    shuffled global train-nid array; per iteration consumes
    ``global_batch = batch_size * local_size * num_parts`` seeds and returns
    each part's ``domain_batch = batch_size * local_size`` slice
    (Training_node_distributor.py:15-60)."""

    def __init__(self, train_ids: np.ndarray, batch_size: int,
                 local_size: int, num_parts: int,
                 mode: str = "baseline",
                 color: Optional[np.ndarray] = None,
                 topk_colors: Optional[np.ndarray] = None,
                 affinity: Optional[np.ndarray] = None,
                 shuffle_seed: int = 0,
                 use_native: bool = True,
                 drop_tail: bool = True):
        if mode not in ("baseline", "node_color"):
            raise ValueError(f"unknown distribution mode {mode!r}")
        if mode == "node_color" and (color is None or topk_colors is None
                                     or affinity is None):
            raise ValueError("node_color mode needs color/topk/affinity metadata")
        self.mode = mode
        self.batch_size = batch_size
        self.local_size = local_size
        self.num_parts = num_parts
        self.domain_batch = batch_size * local_size
        self.global_batch = self.domain_batch * num_parts
        self.color = color
        self.topk_colors = topk_colors
        self.affinity = affinity
        self.use_native = use_native
        rng = np.random.default_rng(shuffle_seed)
        self.items = np.asarray(train_ids, dtype=np.int64).copy()
        rng.shuffle(self.items)
        self.drop_tail = drop_tail
        if drop_tail or len(self.items) == 0:
            # Tail seeds that don't fill a global batch are dropped, like
            # the reference (COALA_GNN_DataLoader.py:141-151).
            self.num_iters = len(self.items) // self.global_batch
        else:
            # Exact-epoch mode: every seed is visited each epoch. Static
            # shapes forbid a ragged last batch, so the final window wraps
            # around to the epoch's (shuffled) start — the tail batch
            # re-trains a few early seeds instead of dropping up to
            # global_batch-1 seeds per epoch.
            self.num_iters = -(-len(self.items) // self.global_batch)

    @property
    def num_colors(self) -> int:
        return 0 if self.topk_colors is None else self.topk_colors.shape[0]

    def reshuffle(self, seed: int) -> None:
        np.random.default_rng(seed).shuffle(self.items)

    def distribute(self, it: int,
                   cache_meta: Optional[np.ndarray] = None,
                   return_valid: bool = False):
        """Part slices for iteration ``it``: int64 [num_parts, domain_batch].

        With ``return_valid=True`` also returns bool [num_parts,
        domain_batch] marking which slots carry real (non-wrapped) seeds —
        the validity rides THROUGH the node_color reordering (each window
        slot's real/wrapped flag follows its seed into the part slice), so
        unlike the positional ``valid_mask`` it is sound for every mode.
        All-true except the final drop_tail=False window."""
        if not 0 <= it < self.num_iters:
            raise IndexError(f"iteration {it} out of range [0, {self.num_iters})")
        window = self.items[it * self.global_batch:(it + 1) * self.global_batch]
        n_real = len(window)
        if n_real < self.global_batch:         # drop_tail=False final batch
            window = np.concatenate(           # cyclic wrap (np.resize
                [window, np.resize(self.items,  # repeats tiny datasets)
                                   self.global_batch - n_real)])
        real = np.arange(self.global_batch) < n_real
        if self.mode == "baseline" or cache_meta is None:
            # Contiguous striping: part j gets window[j*domain : (j+1)*domain].
            out = window.reshape(self.num_parts, self.domain_batch)
            if return_valid:
                return out, real.reshape(self.num_parts, self.domain_batch)
            return out
        assign = greedy_affinity_assign(
            window, self.color, self.topk_colors, self.affinity,
            cache_meta, capacity=self.domain_batch, use_native=self.use_native)
        out = np.empty((self.num_parts, self.domain_batch), dtype=np.int64)
        valid = np.zeros((self.num_parts, self.domain_batch), dtype=bool)
        for j in range(self.num_parts):
            sel = assign == j
            mine = window[sel]
            mv = real[sel]
            # Greedy capacity can underfill a part only if every other part
            # hit capacity first; pad by wrapping (keeps static shape).
            if len(mine) < self.domain_batch:
                pad = np.resize(mine if len(mine) else window, self.domain_batch - len(mine))
                mine = np.concatenate([mine, pad])   # pad slots stay invalid
            out[j] = mine[: self.domain_batch]
            valid[j, : min(len(mv), self.domain_batch)] = \
                mv[: self.domain_batch]
        if return_valid:
            return out, valid
        return out

    def valid_mask(self, it: int) -> np.ndarray:
        """bool [num_parts, domain_batch]: which slots of distribute(it)'s
        output are real (non-wrapped) seeds. Only meaningful with
        drop_tail=False, where the final window wrap-pads; earlier windows
        are all-valid. Positional masking is only sound in ``baseline``
        mode, whose striping preserves window order (a reordering mode like
        node_color scatters wrapped duplicates anywhere) — exact-tail eval
        must therefore use a baseline distributor, and this method refuses
        otherwise rather than miscount silently."""
        if self.mode != "baseline":
            raise ValueError(
                "valid_mask is positional and only sound for mode='baseline'"
                " (node_color reorders slots); run exact-tail eval with a "
                "baseline distributor")
        if not 0 <= it < self.num_iters:
            raise IndexError(f"iteration {it} out of range [0, {self.num_iters})")
        n_real = min(self.global_batch,
                     len(self.items) - it * self.global_batch)
        return (np.arange(self.global_batch) < n_real).reshape(
            self.num_parts, self.domain_batch)

    def device_slice(self, domain_seeds: np.ndarray, local_rank: int) -> np.ndarray:
        """This device's batch from its host's domain slice
        (COALA_GNN_DataLoader.py:72-75)."""
        return domain_seeds[local_rank * self.batch_size:(local_rank + 1) * self.batch_size]
