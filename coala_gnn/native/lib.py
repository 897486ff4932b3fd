"""ctypes bindings + on-demand build for the native C++ kernels.

The shared library is compiled with g++ -O3 -march=native -fopenmp on the
machine that loads it, into ``build/<key>/libcoala_native.so`` (gitignored)
where ``key`` hashes the source, the compile command and the host CPU
model. A library built elsewhere (another CPU, other flags, an older
source) therefore never matches and is never loaded; a changed source
builds anew. (The reference ships a CMake + pybind11 CUDA build,
CMakeLists.txt:1-81; here the native surface is a small C ABI, so a
one-line compile is the whole build system.)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "coala_native.cpp")
_BUILD = os.path.join(_DIR, "build")
_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
          "-std=c++17")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_INFO: dict = {}

_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")


def _cpuinfo(key: str) -> str:
    """First ``key`` field of ``/proc/cpuinfo``, or "" where there is none."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.split(":", 1)[0].strip() == key:
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return ""


def host_cpu() -> str:
    """The CPU model string (``/proc/cpuinfo``), else ``platform``'s."""
    return (_cpuinfo("model name")
            or f"{platform.machine()} {platform.processor()}")


def library_path(src: str = _SRC, build_dir: str = _BUILD) -> str:
    """Where the library for this source, these flags and this CPU lives.
    The CPU enters as its model and its feature flags: some hosts report
    no model, and ``-march=native`` compiles for the flags."""
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(("g++",) + _FLAGS).encode())
    h.update(host_cpu().encode())
    h.update(_cpuinfo("flags").encode())
    return os.path.join(build_dir, h.hexdigest()[:16], "libcoala_native.so")


def build(src: str = _SRC, build_dir: str = _BUILD) -> Tuple[str, bool]:
    """Compile ``src`` unless its keyed library exists. Returns (path,
    built_now). Writes to a temporary name and renames, so concurrent
    builders (test workers) never load a half-written file."""
    so = library_path(src, build_dir)
    if os.path.exists(so):
        return so, False
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    subprocess.run(["g++", *_FLAGS, src, "-o", tmp], check=True,
                   capture_output=True, text=True)
    os.replace(tmp, so)
    return so, True


def build_info() -> dict:
    """How the loaded library came to be: path, source hash, CPU, and
    whether this process compiled it (after ``get``)."""
    return dict(_INFO)


def get() -> ctypes.CDLL:
    """Load (building if needed) and return the typed CDLL handle."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        so, built_now = build()
        lib = ctypes.CDLL(so)
        with open(_SRC, "rb") as f:
            _INFO.update(path=so, built_now=built_now, cpu=host_cpu(),
                         source_sha256=hashlib.sha256(f.read()).hexdigest())

        lib.cg_sample_layer.argtypes = [
            _i64p, ctypes.c_void_p, ctypes.c_int, _i64p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_uint64, _i64p, _f32p]
        lib.cg_sample_layer.restype = None

        lib.cg_sample_layer_typed.argtypes = [
            _i64p, ctypes.c_void_p, ctypes.c_int, _i32p, _i64p,
            ctypes.c_int64, ctypes.c_int, ctypes.c_uint64, _i64p, _f32p,
            _i32p]
        lib.cg_sample_layer_typed.restype = None

        lib.cg_color_graph.argtypes = [
            _i64p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
            _i64p, ctypes.c_int64, ctypes.c_int, ctypes.c_double,
            ctypes.c_uint64, _i64p, _i32p]
        lib.cg_color_graph.restype = ctypes.c_int64

        lib.cg_color_graph_seeded.argtypes = [
            _i64p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
            _i64p, ctypes.c_int64, _i64p, ctypes.c_int64, ctypes.c_int,
            _i64p, _i32p]
        lib.cg_color_graph_seeded.restype = ctypes.c_int64

        lib.cg_color_affinity.argtypes = [
            _i64p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
            _i64p, _i32p, ctypes.c_int64, ctypes.c_int, _i64p, _f64p]
        lib.cg_color_affinity.restype = None

        lib.cg_distribute_affinity.argtypes = [
            _i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int64, _i64p, _i64p, _f64p, ctypes.c_int,
            ctypes.c_int64, _i32p, _i32p]
        lib.cg_distribute_affinity.restype = None

        lib.cg_gather_rows_f32.argtypes = [
            _f32p, ctypes.c_int64, _i64p, ctypes.c_int64, _f32p]
        lib.cg_gather_rows_f32.restype = None

        lib.cg_quantize_rows.argtypes = [
            _f32p, ctypes.c_int64, ctypes.c_int64,
            np.ctypeslib.ndpointer(dtype=np.int8, flags="C_CONTIGUOUS"),
            _f32p]
        lib.cg_quantize_rows.restype = None

        _u16p = np.ctypeslib.ndpointer(dtype=np.uint16, flags="C_CONTIGUOUS")
        _i8p = np.ctypeslib.ndpointer(dtype=np.int8, flags="C_CONTIGUOUS")
        lib.cg_encode_bf16.argtypes = [_f32p, ctypes.c_int64, _u16p]
        lib.cg_encode_bf16.restype = None
        lib.cg_gather_rows_bf16.argtypes = [
            _f32p, ctypes.c_int64, _i64p, ctypes.c_int64, _u16p]
        lib.cg_gather_rows_bf16.restype = None
        lib.cg_gather_quantize_rows.argtypes = [
            _f32p, ctypes.c_int64, _i64p, ctypes.c_int64, _i8p, _f32p]
        lib.cg_gather_quantize_rows.restype = None

        _LIB = lib
        return lib


def _indices_arg(indices: np.ndarray) -> Tuple[ctypes.c_void_p, int]:
    if indices.dtype == np.int32:
        width = 4
    elif indices.dtype == np.int64:
        width = 8
    else:
        raise TypeError(f"indices dtype {indices.dtype} unsupported")
    return indices.ctypes.data_as(ctypes.c_void_p), width


def sample_layer(lib: ctypes.CDLL, graph, dst_ids: np.ndarray, fanout: int,
                 seed: int) -> Tuple[np.ndarray, np.ndarray]:
    dst_ids = np.ascontiguousarray(dst_ids, dtype=np.int64)
    n = dst_ids.shape[0]
    nbr = np.empty((n, fanout), dtype=np.int64)
    mask = np.empty((n, fanout), dtype=np.float32)
    idx_ptr, width = _indices_arg(graph.indices)
    lib.cg_sample_layer(graph.indptr, idx_ptr, width, dst_ids, n, fanout,
                        seed & (2**64 - 1), nbr, mask)
    return nbr, mask


def sample_layer_typed(lib: ctypes.CDLL, graph, dst_ids: np.ndarray,
                       fanout: int, seed: int
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """sample_layer + per-slot edge types (hetero graphs)."""
    dst_ids = np.ascontiguousarray(dst_ids, dtype=np.int64)
    et = np.ascontiguousarray(graph.edge_types, dtype=np.int32)
    n = dst_ids.shape[0]
    nbr = np.empty((n, fanout), dtype=np.int64)
    mask = np.empty((n, fanout), dtype=np.float32)
    rel = np.empty((n, fanout), dtype=np.int32)
    idx_ptr, width = _indices_arg(graph.indices)
    lib.cg_sample_layer_typed(graph.indptr, idx_ptr, width, et, dst_ids, n,
                              fanout, seed & (2**64 - 1), nbr, mask, rel)
    return nbr, mask, rel


def color_graph(lib: ctypes.CDLL, graph, train_ids: np.ndarray,
                max_hop: int = 10, base_rate: float = 0.005,
                seed: int = 0) -> Tuple[int, np.ndarray, np.ndarray]:
    """Returns (num_colors, color [N] int64, hop [N] int32)."""
    train_ids = np.ascontiguousarray(train_ids, dtype=np.int64)
    n = graph.num_nodes
    color = np.empty(n, dtype=np.int64)
    hop = np.empty(n, dtype=np.int32)
    idx_ptr, width = _indices_arg(graph.indices)
    num_colors = lib.cg_color_graph(graph.indptr, idx_ptr, width, n,
                                    train_ids, train_ids.shape[0], max_hop,
                                    base_rate, seed & (2**64 - 1), color, hop)
    return int(num_colors), color, hop


def color_graph_seeded(lib: ctypes.CDLL, graph, train_ids: np.ndarray,
                       seed_nodes: np.ndarray, max_hop: int = 10
                       ) -> Tuple[int, np.ndarray, np.ndarray]:
    """color_graph with the seed-node picks injected explicitly (seed i gets
    color i+1) — the exact-equality cross-check entry point."""
    train_ids = np.ascontiguousarray(train_ids, dtype=np.int64)
    seed_nodes = np.ascontiguousarray(seed_nodes, dtype=np.int64)
    n = graph.num_nodes
    color = np.empty(n, dtype=np.int64)
    hop = np.empty(n, dtype=np.int32)
    idx_ptr, width = _indices_arg(graph.indices)
    num_colors = lib.cg_color_graph_seeded(
        graph.indptr, idx_ptr, width, n, train_ids, train_ids.shape[0],
        seed_nodes, seed_nodes.shape[0], max_hop, color, hop)
    return int(num_colors), color, hop


def color_affinity(lib: ctypes.CDLL, graph, color: np.ndarray,
                   hop: np.ndarray, num_colors: int, topk: int = 10
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (topk [C, K] int64, score [C, K] float64)."""
    color = np.ascontiguousarray(color, dtype=np.int64)
    hop = np.ascontiguousarray(hop, dtype=np.int32)
    topk_out = np.zeros((num_colors, topk), dtype=np.int64)
    score_out = np.zeros((num_colors, topk), dtype=np.float64)
    idx_ptr, width = _indices_arg(graph.indices)
    lib.cg_color_affinity(graph.indptr, idx_ptr, width, graph.num_nodes,
                          color, hop, num_colors, topk, topk_out, score_out)
    return topk_out, score_out


def distribute_affinity(lib: ctypes.CDLL, item: np.ndarray, offset: int,
                        item_len: int, num_parts: int, capacity: int,
                        color: np.ndarray, topk_colors: np.ndarray,
                        affinity: np.ndarray, meta: np.ndarray) -> np.ndarray:
    """meta: int32 [num_parts, num_colors+1]; returns int32 [item_len]."""
    item = np.ascontiguousarray(item, dtype=np.int64)
    color = np.ascontiguousarray(color, dtype=np.int64)
    topk_colors = np.ascontiguousarray(topk_colors, dtype=np.int64)
    affinity = np.ascontiguousarray(affinity, dtype=np.float64)
    meta = np.ascontiguousarray(meta, dtype=np.int32)
    num_colors, topk = topk_colors.shape
    if meta.shape != (num_parts, num_colors + 1):
        raise ValueError(f"meta shape {meta.shape} != ({num_parts}, {num_colors + 1})")
    out = np.empty(item_len, dtype=np.int32)
    lib.cg_distribute_affinity(item, offset, item_len, num_parts, capacity,
                               color, topk_colors.reshape(-1),
                               affinity.reshape(-1), topk, num_colors,
                               meta.reshape(-1), out)
    return out


def quantize_rows_native(rows: np.ndarray):
    """Fused per-row symmetric int8 quantization (cg_quantize_rows).
    Returns (q int8 [n, dim], scale f32 [n]) or (None, None) when the
    native library is unavailable (caller falls back to numpy)."""
    try:
        lib = get()
    except Exception:
        return None, None
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    n, dim = rows.shape
    q = np.empty((n, dim), np.int8)
    scale = np.empty(n, np.float32)
    lib.cg_quantize_rows(rows, n, dim, q, scale)
    return q, scale


def gather_rows(lib: ctypes.CDLL, features: np.ndarray, ids: np.ndarray,
                out: Optional[np.ndarray] = None) -> np.ndarray:
    """Parallel out[i] = features[ids[i]]; ids < 0 -> zero rows."""
    if features.dtype != np.float32 or features.ndim != 2:
        raise TypeError("features must be float32 [n, dim]")
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    if out is None:
        out = np.empty((ids.shape[0], features.shape[1]), dtype=np.float32)
    lib.cg_gather_rows_f32(features, features.shape[1], ids, ids.shape[0], out)
    return out


def encode_bf16(rows: np.ndarray, out: Optional[np.ndarray] = None):
    """Parallel f32 -> bf16 round-to-nearest-even encode. Returns a
    bfloat16-viewed array, or (None) when the native library is missing
    (caller falls back to ml_dtypes astype)."""
    try:
        lib = get()
    except Exception:
        return None
    import ml_dtypes
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    if out is None:
        out = np.empty(rows.shape, np.uint16)
    lib.cg_encode_bf16(rows.reshape(-1), rows.size, out.reshape(-1))
    return out.view(ml_dtypes.bfloat16)


def gather_rows_bf16(lib: ctypes.CDLL, features: np.ndarray, ids: np.ndarray,
                     out: Optional[np.ndarray] = None) -> np.ndarray:
    """Fused parallel out[i] = bf16(features[ids[i]]); ids < 0 -> zero rows.
    ``out`` must be uint16 (the bf16 bit pattern); returns a bfloat16 view."""
    import ml_dtypes
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    if out is None:
        out = np.empty((ids.shape[0], features.shape[1]), np.uint16)
    lib.cg_gather_rows_bf16(features, features.shape[1], ids, ids.shape[0],
                            out)
    return out.view(ml_dtypes.bfloat16)


def gather_quantize_rows(lib: ctypes.CDLL, features: np.ndarray,
                         ids: np.ndarray,
                         q_out: Optional[np.ndarray] = None,
                         scale_out: Optional[np.ndarray] = None):
    """Fused parallel gather + per-row symmetric int8 quantize (identical
    math to quantize_rows_native). Returns (q int8 [n, dim], scale f32 [n])."""
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    n, dim = ids.shape[0], features.shape[1]
    if q_out is None:
        q_out = np.empty((n, dim), np.int8)
    if scale_out is None:
        scale_out = np.empty(n, np.float32)
    lib.cg_gather_quantize_rows(features, dim, ids, n, q_out, scale_out)
    return q_out, scale_out
