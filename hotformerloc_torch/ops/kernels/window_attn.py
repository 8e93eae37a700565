"""K1: windowed multi-head attention with fused RPE (forward).

``window_attention`` launches csrc/window_attn.cu on CUDA tensors and
runs ``window_attention_reference`` on CPU tensors. It replaces
hotformerloc_tpu/ops/pallas/window_attn.py:_fwd_kernel (entry
``fused_window_attention``); layouts are the JAX entry's.
"""
from __future__ import annotations

import ctypes

import torch

from hotformerloc_torch.ops import kernels
from hotformerloc_torch.ops.kernels import build
from hotformerloc_torch.ops.rpe import rpe_bias_reference
from hotformerloc_torch.ops.window import MASK_VALUE

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
             ctypes.c_float, _I, _P]


def window_attention_reference(q, k, v, xyz, mask, table, num_heads: int,
                               pos_bnd: int, use_rpe: bool = True):
    """Plain version: same function as the kernel, computed in fp32 and
    returned in q.dtype. Query rows with mask == 0 are exactly 0."""
    BW, T, C = q.shape
    H = num_heads
    hd = C // H
    qf, kf, vf = (t.float().reshape(BW, T, H, hd) for t in (q, k, v))
    logits = torch.einsum("wthd,wshd->whts", qf, kf) * hd ** -0.5
    if use_rpe:
        K = xyz.shape[2]
        G = T - K
        xyz_w = xyz.transpose(1, 2)[None]                   # (1, BW, K, 3)
        bias = rpe_bias_reference(table.float().t(), xyz_w, pos_bnd)[0]
        logits[:, :, G:, G:] = logits[:, :, G:, G:] + bias
    keep = mask > 0
    logits = logits + torch.where(keep, 0.0, MASK_VALUE)[:, None, None, :]
    attn = torch.softmax(logits, dim=-1)
    out = torch.einsum("whts,wshd->wthd", attn, vf).reshape(BW, T, C)
    out = out * keep[..., None]
    return out.to(q.dtype)


def window_attention(q, k, v, xyz, mask, table, num_heads: int,
                     pos_bnd: int, use_rpe: bool = True) -> torch.Tensor:
    """q, k, v: (BW, T, C) float32/bfloat16, contiguous; xyz: (BW, 3, K)
    int32 node coords with K = T - G (the G leading relay slots get no
    bias); mask: (BW, T) int32; table: (3*(2*pos_bnd+1), H) float32.
    Returns (BW, T, C) in q's dtype; rows with mask == 0 are 0."""
    if q.device.type == "cpu":
        return window_attention_reference(q, k, v, xyz, mask, table,
                                          num_heads, pos_bnd, use_rpe)
    if q.device.type != "cuda":
        raise ValueError(f"window_attention: unsupported device {q.device}")
    BW, T, C = q.shape
    H = num_heads
    K = xyz.shape[2]
    code = build.dtype_code(q)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape != (BW, T, C) or t.dtype != q.dtype:
            raise ValueError(f"window_attention: {name} is {t.dtype} "
                             f"{tuple(t.shape)}, want {q.dtype} {(BW, T, C)}")
    if T > 64 or C % H != 0 or K > T:
        raise ValueError(f"window_attention: unsupported T={T}, C={C}, "
                         f"H={H}, K={K} (T <= 64, H | C, K <= T)")
    if xyz.shape != (BW, 3, K) or xyz.dtype != torch.int32:
        raise ValueError("window_attention: xyz must be (BW, 3, K) int32")
    if mask.shape != (BW, T) or mask.dtype != torch.int32:
        raise ValueError("window_attention: mask must be (BW, T) int32")
    num = 2 * pos_bnd + 1
    if use_rpe and (table.shape != (3 * num, H)
                    or table.dtype != torch.float32):
        raise ValueError(f"window_attention: table must be ({3 * num}, {H}) "
                         "float32")
    args = (q, k, v, xyz, mask, table)
    for t in args:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("window_attention: inputs must be contiguous "
                             f"and on {q.device}")
    out = torch.empty_like(q)
    fn = build.library("window_attn").window_attn_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(*(t.data_ptr() for t in args), out.data_ptr(), BW, T, C, H, K,
             pos_bnd, int(bool(use_rpe)), float((C // H) ** -0.5), code,
             build.stream_ptr(q.device))
    build.check(err, "window_attn_fwd")
    kernels.LAUNCHES["window_attn"] += 1
    return out
