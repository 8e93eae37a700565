"""K3/K4 (depthwise) and K5/K6 (full) stride-1 27-tap octree
convolutions, forward and backward.

``octree_dwconv`` and ``octree_conv`` apply ``OctreeDwconvFn`` and
``OctreeConvFn``: on CUDA tensors their forwards launch K3/K5 and their
backwards K4/K6 (csrc/octree_conv.cu); on CPU tensors they run the plain
versions in ops/conv.py. They replace
hotformerloc_tpu/ops/pallas/band_conv.py:_dw_fwd_kernel/_dw_bwd_kernel
(entry ``banded_dwconv``) and :_conv_fwd_kernel/_conv_bwd_kernel (entry
``banded_conv``); the direct gather needs no band tables and is exact for
every table. The weights are cast to the activation dtype at use; their
gradients come back in fp32 (the parameters' dtype).
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
_SMS = 132                # H100 SXM
# The backward weight-gradient kernels are latency-bound gathers, so
# their grids aim at 8 blocks per SM (measured faster than 2 on the
# H100), splitting rows down to 64 per block.
_BLOCKS_PER_SM = 8
_MIN_ROWS = 64


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


def _vec(*ts) -> int:
    """1 when the 16-byte vector path applies to every tensor."""
    t0 = ts[0]
    per16 = 16 // t0.element_size()
    return int(t0.shape[-1] % per16 == 0
               and all(t.data_ptr() % 16 == 0 for t in ts))


def _parts(rows: int, blocks_per_part: int) -> int:
    """Row splits of a backward weight reduction: enough blocks for
    ``_BLOCKS_PER_SM`` per SM, each split at least ``_MIN_ROWS`` rows."""
    want = -(-_BLOCKS_PER_SM * _SMS // blocks_per_part)
    return max(1, min(want, -(-rows // _MIN_ROWS)))


def _dw_fwd(x, neigh, w):
    """K3 (w already in x's dtype)."""
    if x.device.type == "cpu":
        return plain.octree_dwconv(x, neigh, w)
    _check(x, neigh, "octree_dwconv")
    B, N, C = x.shape
    if w.shape != (27, C):
        raise ValueError(f"octree_dwconv: w must be (27, {C}), got "
                         f"{tuple(w.shape)}")
    code = build.dtype_code(x)
    _ready("octree_dwconv", x, neigh, w)
    out = torch.empty_like(x)
    fn = build.library("octree_conv").octree_dwconv_fwd
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), neigh.data_ptr(), w.data_ptr(), out.data_ptr(),
             B, N, C, code, _vec(x), build.stream_ptr(x.device))
    build.check(err, "octree_dwconv_fwd")
    kernels.LAUNCHES["octree_dwconv"] += 1
    return out


def octree_dwconv_bwd(x, neigh, w, dy, need_dx: bool = True):
    """K4 on CUDA tensors, ops/conv.octree_dwconv_bwd on CPU tensors.
    w: (27, C) in x's dtype; dy: (B, N, C) in x's dtype. Returns (dx or
    None, dw fp32 (27, C))."""
    if x.device.type == "cpu":
        return plain.octree_dwconv_bwd(x, neigh, w, dy, need_dx)
    _check(x, neigh, "octree_dwconv_bwd")
    B, N, C = x.shape
    if w.shape != (27, C) or dy.shape != x.shape or dy.dtype != x.dtype \
            or w.dtype != x.dtype:
        raise ValueError("octree_dwconv_bwd: want w (27, C) and dy like x")
    code = build.dtype_code(x)
    wf = w.flip(0).contiguous()
    _ready("octree_dwconv_bwd", x, neigh, wf, dy)
    dx = torch.empty_like(x) if need_dx else None
    ctiles = -(-C // 64)
    parts = _parts(B * N, ctiles)
    partial = torch.empty((parts, 27, C), dtype=torch.float32,
                          device=x.device)
    dw = torch.empty((27, C), dtype=torch.float32, device=x.device)
    fn = build.library("octree_conv").octree_dwconv_bwd
    fn.argtypes = [_P] * 7 + [_I] * 6 + [_P]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), neigh.data_ptr(), wf.data_ptr(), dy.data_ptr(),
             None if dx is None else dx.data_ptr(), partial.data_ptr(),
             dw.data_ptr(), B, N, C, parts, code, _vec(dy),
             build.stream_ptr(x.device))
    build.check(err, "octree_dwconv_bwd")
    kernels.LAUNCHES["octree_dwconv_bwd"] += 1
    return dx, dw


def _conv_fwd(x, neigh, w, b):
    """K5 (w, b already in x's dtype)."""
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


def octree_conv_bwd(x, neigh, w, dy, need_dx: bool = True):
    """K6 on CUDA tensors, ops/conv.octree_conv_bwd on CPU tensors.
    w: (27, C, O) in x's dtype; dy: (B, N, O) in x's dtype. Returns
    (dx or None, dw fp32 (27, C, O), db fp32 (O,)); db is a torch sum,
    as the JAX package computes it outside its kernel."""
    if x.device.type == "cpu":
        return plain.octree_conv_bwd(x, neigh, w, dy, need_dx)
    _check(x, neigh, "octree_conv_bwd")
    B, N, C = x.shape
    O = w.shape[-1]
    if w.shape != (27, C, O) or dy.shape != (B, N, O) \
            or dy.dtype != x.dtype or w.dtype != x.dtype:
        raise ValueError("octree_conv_bwd: want w (27, C, O) and dy "
                         "(B, N, O) in x's dtype")
    code = build.dtype_code(x)
    wft = w.flip(0).transpose(1, 2).contiguous()
    _ready("octree_conv_bwd", x, neigh, wft, dy)
    dx = torch.empty_like(x) if need_dx else None
    tiles = -(-C // 64) * -(-O // 64)
    parts = _parts(B * N, tiles * 27)
    partial = torch.empty((parts, 27, C, O), dtype=torch.float32,
                          device=x.device)
    dw = torch.empty((27, C, O), dtype=torch.float32, device=x.device)
    fn = build.library("octree_conv").octree_conv_bwd
    fn.argtypes = [_P] * 7 + [_I] * 6 + [_P]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), neigh.data_ptr(), wft.data_ptr(), dy.data_ptr(),
             None if dx is None else dx.data_ptr(), partial.data_ptr(),
             dw.data_ptr(), B, N, C, O, parts, code,
             build.stream_ptr(x.device))
    build.check(err, "octree_conv_bwd")
    kernels.LAUNCHES["octree_conv_bwd"] += 1
    return dx, dw, dy.float().sum((0, 1))


class OctreeDwconvFn(torch.autograd.Function):
    """K3 forward, K4 backward (plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, x, neigh, w):
        wc = w.to(x.dtype).contiguous()
        ctx.save_for_backward(x, neigh, wc)
        ctx.w_dtype = w.dtype
        return _dw_fwd(x, neigh, wc)

    @staticmethod
    def backward(ctx, dy):
        x, neigh, wc = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, dw = octree_dwconv_bwd(x, neigh, wc, dy.contiguous(), need[0])
        return dx, None, dw.to(ctx.w_dtype) if need[2] else None


class OctreeConvFn(torch.autograd.Function):
    """K5 forward, K6 backward (plain versions on CPU tensors). dx is not
    computed when x needs no gradient (the stem's input features)."""

    @staticmethod
    def forward(ctx, x, neigh, w, b):
        wc = w.to(x.dtype).contiguous()
        bc = None if b is None else b.to(x.dtype).contiguous()
        ctx.save_for_backward(x, neigh, wc)
        ctx.dtypes = (w.dtype, None if b is None else b.dtype)
        return _conv_fwd(x, neigh, wc, bc)

    @staticmethod
    def backward(ctx, dy):
        x, neigh, wc = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, dw, db = octree_conv_bwd(x, neigh, wc, dy.contiguous(), need[0])
        w_dt, b_dt = ctx.dtypes
        return (dx, None, dw.to(w_dt) if need[2] else None,
                db.to(b_dt) if need[3] else None)


def octree_dwconv(x: torch.Tensor, neigh: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """out[b,n,c] = sum_k w[k,c] * x[b, neigh[b,n,k], c]; x: (B, N, C)
    float32/bfloat16, neigh: (B, N, 27) int32 (-1 = none), w: (27, C)
    (cast to x's dtype). Accumulates in fp32, returns x's dtype.
    Differentiable in x and w."""
    return OctreeDwconvFn.apply(x, neigh, w)


def octree_conv(x: torch.Tensor, neigh: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[b,n,o] = sum_{k,c} w[k,c,o] * x[b, neigh[b,n,k], c] + b[o];
    x: (B, N, C) float32/bfloat16 (any C), neigh: (B, N, 27) int32,
    w: (27, C, O), b: (O,) or None (both cast to x's dtype). Accumulates
    in fp32. Differentiable in x, w and b."""
    return OctreeConvFn.apply(x, neigh, w, b)
