"""K3 (depthwise) and K5 (full) stride-1 27-tap octree convolutions.

``octree_dwconv`` and ``octree_conv`` launch csrc/octree_conv.cu on CUDA
tensors and run the plain versions in ops/conv.py on CPU tensors. They
replace hotformerloc_tpu/ops/pallas/band_conv.py:_dw_fwd_kernel (entry
``banded_dwconv``) and :_conv_fwd_kernel (entry ``banded_conv``); the
direct gather needs no band tables and is exact for every table.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from hotformerloc_torch.ops import conv as plain
from hotformerloc_torch.ops import kernels
from hotformerloc_torch.ops.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int


def _check(x, neigh, name):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dim() != 3 or neigh.dim() != 3 or neigh.shape[:2] != x.shape[:2] \
            or neigh.shape[2] != 27:
        raise ValueError(f"{name}: want x (B, N, C) and neigh (B, N, 27), "
                         f"got {tuple(x.shape)} and {tuple(neigh.shape)}")
    if neigh.dtype != torch.int32:
        raise ValueError(f"{name}: neigh must be int32, got {neigh.dtype}")


def _ready(name, *ts):
    dev = ts[0].device
    for t in ts:
        if t is not None and (t.device != dev or not t.is_contiguous()):
            raise ValueError(f"{name}: inputs must be contiguous and on {dev}")


def octree_dwconv(x: torch.Tensor, neigh: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """out[b,n,c] = sum_k w[k,c] * x[b, neigh[b,n,k], c]; x: (B, N, C)
    float32/bfloat16, neigh: (B, N, 27) int32 (-1 = none), w: (27, C).
    Accumulates in fp32, returns x's dtype."""
    if x.device.type == "cpu":
        return plain.octree_dwconv(x, neigh, w)
    _check(x, neigh, "octree_dwconv")
    B, N, C = x.shape
    if w.shape != (27, C):
        raise ValueError(f"octree_dwconv: w must be (27, {C}), got "
                         f"{tuple(w.shape)}")
    code = build.dtype_code(x)
    w = w.to(x.dtype).contiguous()
    _ready("octree_dwconv", x, neigh, w)
    per16 = 16 // x.element_size()
    vec = int(C % per16 == 0 and x.data_ptr() % 16 == 0)
    out = torch.empty_like(x)
    fn = build.library("octree_conv").octree_dwconv_fwd
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), neigh.data_ptr(), w.data_ptr(), out.data_ptr(),
             B, N, C, code, vec, build.stream_ptr(x.device))
    build.check(err, "octree_dwconv_fwd")
    kernels.LAUNCHES["octree_dwconv"] += 1
    return out


def octree_conv(x: torch.Tensor, neigh: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[b,n,o] = sum_{k,c} w[k,c,o] * x[b, neigh[b,n,k], c] + b[o];
    x: (B, N, C) float32/bfloat16 (any C), neigh: (B, N, 27) int32,
    w: (27, C, O), b: (O,) or None. Accumulates in fp32."""
    if x.device.type == "cpu":
        return plain.octree_conv(x, neigh, w, b)
    _check(x, neigh, "octree_conv")
    B, N, C = x.shape
    if w.dim() != 3 or w.shape[:2] != (27, C):
        raise ValueError(f"octree_conv: w must be (27, {C}, O), got "
                         f"{tuple(w.shape)}")
    O = w.shape[2]
    if b is not None and b.shape != (O,):
        raise ValueError(f"octree_conv: bias must be ({O},)")
    code = build.dtype_code(x)
    w = w.to(x.dtype).contiguous()
    b = None if b is None else b.to(x.dtype).contiguous()
    _ready("octree_conv", x, neigh, w, b)
    out = torch.empty((B, N, O), dtype=x.dtype, device=x.device)
    fn = build.library("octree_conv").octree_conv_fwd
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), neigh.data_ptr(), w.data_ptr(),
             None if b is None else b.data_ptr(), out.data_ptr(),
             B, N, C, O, code, build.stream_ptr(x.device))
    build.check(err, "octree_conv_fwd")
    kernels.LAUNCHES["octree_conv"] += 1
    return out
