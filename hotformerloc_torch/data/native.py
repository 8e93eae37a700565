"""ctypes bindings for the native host point-ops library
(native/pointops.cpp), with numpy / torch fallbacks when it cannot be
built.

Own copy of hotformerloc_tpu/data/native.py. The library is compiled
from the repository's ``native/pointops.cpp`` with the flags of
``native/build.sh``, into ``hotformerloc_torch/build/`` (never into
``native/``, whose ``libpointops.so`` is tracked).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def library_path() -> str:
    return os.path.join(_repo_root(), "hotformerloc_torch", "build",
                        "libpointops.so")


def _build(path: str) -> None:
    """Compile native/pointops.cpp into ``path`` (native/build.sh's
    flags), through a temporary file renamed into place, so no other
    process loads a half-written library."""
    src = os.path.join(_repo_root(), "native", "pointops.cpp")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(path))
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC",
                        "-std=c++17", "-o", tmp, src], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_library(build_if_missing: bool = True) -> Optional[ctypes.CDLL]:
    """The library, built on first use; None when it cannot be built
    (no compiler), and then every function takes its fallback."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    path = library_path()
    if not os.path.exists(path) and build_if_missing:
        try:
            _build(path)
        except (OSError, subprocess.SubprocessError):
            return None
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    i64, i32, f32, f64 = (ctypes.c_int64, ctypes.c_int32,
                          ctypes.POINTER(ctypes.c_float),
                          ctypes.POINTER(ctypes.c_double))
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.morton_encode.argtypes = [f32, i64, i32, i32p]
    lib.argsort_i32.argtypes = [i32p, i64, i64p]
    lib.voxel_downsample.argtypes = [f32, i64, ctypes.c_float, f32, i64]
    lib.voxel_downsample.restype = i64
    lib.radius_search_2d.argtypes = [f32, i64, f32, i64, ctypes.c_float,
                                     i64p, i64p, i64p]
    lib.f64_to_f32.argtypes = [f64, i64, f32]
    _LIB = lib
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def morton_encode(points: np.ndarray, depth: int) -> np.ndarray:
    """(N, 3) float32 in [-1,1] -> (N,) int32 Morton keys."""
    lib = load_library()
    pts = np.ascontiguousarray(points, dtype=np.float32)
    n = len(pts)
    if lib is not None:
        out = np.empty(n, dtype=np.int32)
        lib.morton_encode(_fptr(pts), n, depth, _i32ptr(out))
        return out
    # fallback: the package's own Morton code on CPU tensors
    import torch

    from hotformerloc_torch.octree import morton
    g = morton.points_to_grid(torch.from_numpy(pts), depth)
    return morton.encode(g).numpy().astype(np.int32)


def voxel_downsample(points: np.ndarray, voxel: float) -> np.ndarray:
    """Mean-per-voxel downsample (processing_utils.py:89-151)."""
    lib = load_library()
    pts = np.ascontiguousarray(points, dtype=np.float32)
    n = len(pts)
    if lib is not None:
        out = np.empty((n, 3), dtype=np.float32)
        m = lib.voxel_downsample(_fptr(pts), n, voxel, _fptr(out), n)
        return out[:m].copy()
    # numpy fallback
    g = np.floor(pts / voxel).astype(np.int64)
    _, inv, cnt = np.unique(g, axis=0, return_inverse=True,
                            return_counts=True)
    sums = np.zeros((len(cnt), 3), dtype=np.float64)
    np.add.at(sums, inv, pts)
    return (sums / cnt[:, None]).astype(np.float32)


def radius_search_2d(points: np.ndarray, queries: np.ndarray,
                     radius: float) -> Tuple[np.ndarray, np.ndarray]:
    """All point indices within `radius` of each 2-D query.

    Returns (offsets (Q+1,), indices (total,)): neighbours of query q
    are indices[offsets[q]:offsets[q+1]] (unsorted).
    """
    lib = load_library()
    pts = np.ascontiguousarray(points, dtype=np.float32)
    qs = np.ascontiguousarray(queries, dtype=np.float32)
    n, nq = len(pts), len(qs)
    if lib is not None:
        counts = np.zeros(nq, dtype=np.int64)
        null64 = ctypes.cast(None, ctypes.POINTER(ctypes.c_int64))
        lib.radius_search_2d(_fptr(pts), n, _fptr(qs), nq, radius,
                             _i64ptr(counts), null64, null64)
        offsets = np.zeros(nq + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        out = np.empty(int(offsets[-1]), dtype=np.int64)
        counts2 = np.zeros(nq, dtype=np.int64)
        lib.radius_search_2d(_fptr(pts), n, _fptr(qs), nq, radius,
                             _i64ptr(counts2), _i64ptr(out),
                             _i64ptr(offsets))
        return offsets, out
    # numpy fallback: brute force in blocks
    offsets = np.zeros(nq + 1, dtype=np.int64)
    chunks = []
    for q in range(nq):
        d2 = np.sum((pts - qs[q]) ** 2, axis=1)
        idx = np.nonzero(d2 <= radius * radius)[0]
        chunks.append(idx.astype(np.int64))
        offsets[q + 1] = offsets[q] + len(idx)
    return offsets, (np.concatenate(chunks) if chunks
                     else np.empty(0, np.int64))
