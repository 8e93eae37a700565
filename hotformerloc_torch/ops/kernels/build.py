"""Build the CUDA sources with nvcc and load them with ctypes.

One shared library per source under hotformerloc_torch/csrc/, compiled
for sm_90a into hotformerloc_torch/build/ and keyed by a hash of the
source, so an edited source is rebuilt and an unchanged one is reused.
All sources compile in parallel, one nvcc process each. A missing nvcc
or a failed build raises: there is no fallback. Processes that start
together (the ranks of one data-parallel run) build one at a time under
a file lock on the build directory, so the first builds and the others
load its libraries.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("window_attn", "octree_conv", "gather", "constructs",
           "layer_norm")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# ptxas report (registers, shared memory, spills) of the last build,
# per source; empty for a library reused from an earlier build.
PTXAS_LOG: Dict[str, str] = {}


_nvcc_default = "/usr/local/cuda/bin/nvcc"


def _nvcc() -> str:
    path = shutil.which("nvcc") or _nvcc_default
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "hotformerloc_torch need the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every source that has no up-to-date library (in parallel)
    and load all of them. Returns {source name: CDLL}."""
    with _lock:
        missing = [n for n in SOURCES if n not in _libs]
        if not missing:
            return _libs
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / "build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)     # released at close
            _build(missing)
        return _libs


def _build(missing) -> None:
    """Compile the sources of ``missing`` that have no library, then
    load every one of them (under ``build_all``'s locks)."""
    stale = [n for n in missing if not _target(n).exists()]
    nvcc = _nvcc() if stale else None
    procs = {}
    for name in stale:
        out = _target(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        PTXAS_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    for name in missing:
        _libs[name] = ctypes.CDLL(str(_target(name)))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one source, building all sources first if
    needed."""
    return build_all()[name]


_bound: Dict[tuple, object] = {}


def bind(name: str, symbol: str, argtypes: list):
    """C entry point ``symbol`` of library ``name``, its ``argtypes`` set
    and its result a C int (cudaError_t), bound once per process."""
    key = (name, symbol)
    fn = _bound.get(key)
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _bound[key] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed with "
                           f"cudaError_t {err}")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


SMEM_OPTIN = 232448          # H100: opt-in dynamic shared memory per block


def smem_optin(device) -> int:
    """A block's opt-in dynamic shared memory on ``device``'s card."""
    import torch
    props = torch.cuda.get_device_properties(device)
    return getattr(props, "shared_memory_per_block_optin", SMEM_OPTIN)


DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}


def dtype_code(t) -> int:
    code = DTYPE_CODES.get(str(t.dtype))
    if code is None:
        raise TypeError(f"CUDA kernels take float32 or bfloat16, "
                        f"got {t.dtype}")
    return code
