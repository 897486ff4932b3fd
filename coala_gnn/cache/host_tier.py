"""Host-RAM feature tier.

Replaces the reference's backing stores for cache misses — BaM GPU-initiated
NVMe reads (nvshmem_cache.h:278-323) and the host-UVA simulation path
(read_page_simulation, nvshmem_cache.h:324-332) — with a host-resident
(optionally memory-mapped) feature matrix served by the native parallel
gather. There is no device-initiated storage I/O here; the host gathers
miss rows and ships them with async device_put, overlapped with compute by
the double-buffered pipeline.
"""

from __future__ import annotations

import concurrent.futures
import threading
from typing import Optional

import numpy as np


class HostFeatureStore:
    def __init__(self, features: np.ndarray, use_native: bool = True):
        self.features = features
        self.dim = int(features.shape[1])
        self._lib = None
        if use_native and features.dtype == np.float32:
            try:
                from coala_gnn.native import lib as native_lib
                self._lib = native_lib.get()
                # the native gather needs a C-contiguous base (mmap is fine)
                self._native_ok = features.flags["C_CONTIGUOUS"]
            except Exception:
                self._native_ok = False
        else:
            self._native_ok = False
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="host-tier")

    def fetch(self, ids: np.ndarray, out: Optional[np.ndarray] = None
              ) -> np.ndarray:
        """out[i] = features[ids[i]] (float32); ids < 0 -> zero rows."""
        ids = np.asarray(ids, dtype=np.int64)
        if self._native_ok:
            from coala_gnn.native import lib as native_lib
            return native_lib.gather_rows(self._lib, self.features, ids,
                                          out=out)
        if out is None:
            out = np.zeros((ids.shape[0], self.dim), dtype=np.float32)
        else:
            out[:] = 0
        ok = ids >= 0
        out[ok] = np.asarray(self.features[ids[ok]], dtype=np.float32)
        return out

    def fetch_encoded(self, ids: np.ndarray, transport: str,
                      enc_out: Optional[np.ndarray] = None,
                      scale_out: Optional[np.ndarray] = None):
        """Fused gather + stage-transport encode straight off the feature
        matrix: each row is read ONCE (hot in L1/L2 while it encodes) and
        only the half/quarter-width encoding is ever materialized — the
        capacity-pressure miss path's replacement for gather-to-f32-scratch
        followed by a separate encode pass. Returns
        (encoded rows, scale or None), or None when the native fused path
        is unavailable (caller falls back to fetch + encode_stage_rows)."""
        if not self._native_ok:
            return None
        from coala_gnn.native import lib as native_lib
        ids = np.asarray(ids, dtype=np.int64)
        if transport == "float32":
            return self.fetch(ids, out=enc_out), None
        if transport == "bfloat16":
            return native_lib.gather_rows_bf16(self._lib, self.features, ids,
                                               out=enc_out), None
        if transport == "int8":
            return native_lib.gather_quantize_rows(
                self._lib, self.features, ids, q_out=enc_out,
                scale_out=scale_out)
        return None

    def fetch_async(self, ids: np.ndarray) -> "concurrent.futures.Future":
        """Prefetch: schedule the gather on a worker thread (the async
        device prefetch half lives in the data loader's double buffer)."""
        return self._pool.submit(self.fetch, np.array(ids, copy=True))
