"""K1/K2: windowed multi-head attention with fused RPE, forward and
backward.

``window_attention`` applies ``WindowAttentionFn``: on CUDA tensors its
forward launches K1 and its backward K2 (csrc/window_attn.cu); on CPU
tensors they run the plain versions ``window_attention_reference`` and
``window_attention_bwd_reference``. They replace
hotformerloc_tpu/ops/pallas/window_attn.py:_fwd_kernel and _bwd_kernel
(entry ``fused_window_attention`` and its custom VJP); layouts are the
JAX entry's.
"""
from __future__ import annotations

import ctypes

import torch

from hotformerloc_torch.ops import kernels
from hotformerloc_torch.ops.kernels import build
from hotformerloc_torch.ops.rpe import rpe_bias_reference, rpe_index
from hotformerloc_torch.ops.window import MASK_VALUE

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_FWD_ARGTYPES = [_P] * 7 + [_I] * 7 + [_F, _I, _P]
_BWD_ARGTYPES = [_P] * 11 + [_I] * 8 + [_F, _I, _P]


def _attn_probs(q, k, xyz, mask, table, num_heads, pos_bnd, use_rpe):
    """fp32 (BW, H, T, T) softmax of the masked, biased logits, with the
    rows of invalid queries zeroed; and the (BW, T, H, hd) fp32 q, k."""
    BW, T, C = q.shape
    H = num_heads
    hd = C // H
    qf, kf = (t.float().reshape(BW, T, H, hd) for t in (q, k))
    logits = torch.einsum("wthd,wshd->whts", qf, kf) * hd ** -0.5
    if use_rpe:
        G = T - xyz.shape[2]
        xyz_w = xyz.transpose(1, 2)[None]                   # (1, BW, K, 3)
        bias = rpe_bias_reference(table.float().t(), xyz_w, pos_bnd)[0]
        logits[:, :, G:, G:] = logits[:, :, G:, G:] + bias
    keep = mask > 0
    logits = logits + torch.where(keep, 0.0, MASK_VALUE)[:, None, None, :]
    attn = torch.softmax(logits, dim=-1) * keep[:, None, :, None]
    return attn, qf, kf


def window_attention_reference(q, k, v, xyz, mask, table, num_heads: int,
                               pos_bnd: int, use_rpe: bool = True):
    """Plain version of K1: same function as the kernel, computed in fp32
    and returned in q.dtype. Query rows with mask == 0 are exactly 0."""
    BW, T, C = q.shape
    attn, _, _ = _attn_probs(q, k, xyz, mask, table, num_heads, pos_bnd,
                             use_rpe)
    vf = v.float().reshape(BW, T, num_heads, C // num_heads)
    out = torch.einsum("whts,wshd->wthd", attn, vf).reshape(BW, T, C)
    return out.to(q.dtype)


def window_attention_bwd_reference(q, k, v, xyz, mask, table, g,
                                   num_heads: int, pos_bnd: int,
                                   use_rpe: bool = True):
    """Plain version of K2: the explicit gradients of
    ``window_attention_reference`` with respect to q, k, v and the RPE
    table for the output cotangent g (BW, T, C). Returns (dq, dk, dv) in
    q.dtype and dtable (3*(2*pos_bnd+1), H) fp32 (zeros without RPE):

        dv = attn^T g,  dattn = g v^T,  dlog = attn * (dattn - rowsum(dattn * attn))
        dq = dlog k / sqrt(hd),  dk = dlog^T q / sqrt(hd)
        dtable[a*num + clip(x_a[t] - x_a[s]) + bnd, h] += dlog[h, t, s]
    over the (K, K) node block (the G leading relay slots carry no bias).
    """
    BW, T, C = q.shape
    H = num_heads
    hd = C // H
    attn, qf, kf = _attn_probs(q, k, xyz, mask, table, H, pos_bnd, use_rpe)
    vf = v.float().reshape(BW, T, H, hd)
    gf = g.float().reshape(BW, T, H, hd)
    dv = torch.einsum("whts,wthd->wshd", attn, gf)
    dattn = torch.einsum("wthd,wshd->whts", gf, vf)
    dlog = attn * (dattn - (dattn * attn).sum(-1, keepdim=True))
    scale = hd ** -0.5
    dq = torch.einsum("whts,wshd->wthd", dlog, kf) * scale
    dk = torch.einsum("whts,wthd->wshd", dlog, qf) * scale
    dtable = torch.zeros(table.shape, dtype=torch.float32, device=q.device)
    if use_rpe:
        G = T - xyz.shape[2]
        dl = dlog[:, :, G:, G:].permute(0, 2, 3, 1).reshape(-1, H)
        for idx in rpe_index(xyz.transpose(1, 2), pos_bnd):
            dtable.index_add_(0, idx.reshape(-1), dl)
    out = [t.reshape(BW, T, C).to(q.dtype) for t in (dq, dk, dv)]
    return (*out, dtable)


def _check(q, k, v, xyz, mask, table, num_heads, pos_bnd, use_rpe, what):
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    BW, T, C = q.shape
    H = num_heads
    K = xyz.shape[2]
    build.dtype_code(q)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape != (BW, T, C) or t.dtype != q.dtype:
            raise ValueError(f"{what}: {name} is {t.dtype} "
                             f"{tuple(t.shape)}, want {q.dtype} {(BW, T, C)}")
    if T > 64 or C % H != 0 or K > T:
        raise ValueError(f"{what}: unsupported T={T}, C={C}, "
                         f"H={H}, K={K} (T <= 64, H | C, K <= T)")
    if xyz.shape != (BW, 3, K) or xyz.dtype != torch.int32:
        raise ValueError(f"{what}: xyz must be (BW, 3, K) int32")
    if mask.shape != (BW, T) or mask.dtype != torch.int32:
        raise ValueError(f"{what}: mask must be (BW, T) int32")
    num = 2 * pos_bnd + 1
    if use_rpe and (table.shape != (3 * num, H)
                    or table.dtype != torch.float32):
        raise ValueError(f"{what}: table must be ({3 * num}, {H}) float32")
    for t in (q, k, v, xyz, mask, table):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous and on "
                             f"{q.device}")


def _fwd(q, k, v, xyz, mask, table, num_heads, pos_bnd, use_rpe):
    if q.device.type == "cpu":
        return window_attention_reference(q, k, v, xyz, mask, table,
                                          num_heads, pos_bnd, use_rpe)
    _check(q, k, v, xyz, mask, table, num_heads, pos_bnd, use_rpe,
           "window_attention")
    BW, T, C = q.shape
    out = torch.empty_like(q)
    fn = build.library("window_attn").window_attn_fwd
    fn.argtypes = _FWD_ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(*(t.data_ptr() for t in (q, k, v, xyz, mask, table)),
             out.data_ptr(), BW, T, C, num_heads, xyz.shape[2], pos_bnd,
             int(bool(use_rpe)), float((C // num_heads) ** -0.5),
             build.dtype_code(q), build.stream_ptr(q.device))
    build.check(err, "window_attn_fwd")
    kernels.LAUNCHES["window_attn"] += 1
    return out


def window_attention_bwd(q, k, v, xyz, mask, table, g, num_heads: int,
                         pos_bnd: int, use_rpe: bool = True,
                         need_dtable: bool = True):
    """K2 on CUDA tensors, ``window_attention_bwd_reference`` on CPU
    tensors. g: (BW, T, C) in q's dtype. Returns (dq, dk, dv, dtable)
    as the reference does; dtable is zeros when ``need_dtable`` is
    False or the RPE is off."""
    if q.device.type == "cpu":
        return window_attention_bwd_reference(q, k, v, xyz, mask, table, g,
                                              num_heads, pos_bnd, use_rpe)
    _check(q, k, v, xyz, mask, table, num_heads, pos_bnd, use_rpe,
           "window_attention_bwd")
    BW, T, C = q.shape
    if g.shape != q.shape or g.dtype != q.dtype or not g.is_contiguous() \
            or g.device != q.device:
        raise ValueError("window_attention_bwd: g must be a contiguous "
                         f"{q.dtype} {tuple(q.shape)} tensor on {q.device}")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dtable = torch.zeros(table.shape, dtype=torch.float32, device=q.device)
    fn = build.library("window_attn").window_attn_bwd
    fn.argtypes = _BWD_ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(*(t.data_ptr() for t in (q, k, v, xyz, mask, table, g, dq, dk,
                                      dv, dtable)),
             BW, T, C, num_heads, xyz.shape[2], pos_bnd, int(bool(use_rpe)),
             int(bool(use_rpe and need_dtable)),
             float((C // num_heads) ** -0.5), build.dtype_code(q),
             build.stream_ptr(q.device))
    build.check(err, "window_attn_bwd")
    kernels.LAUNCHES["window_attn_bwd"] += 1
    return dq, dk, dv, dtable


class WindowAttentionFn(torch.autograd.Function):
    """K1 forward, K2 backward (plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, xyz, mask, table, num_heads, pos_bnd,
                use_rpe):
        ctx.save_for_backward(q, k, v, xyz, mask, table)
        ctx.cfg = (num_heads, pos_bnd, use_rpe)
        return _fwd(q, k, v, xyz, mask, table, num_heads, pos_bnd, use_rpe)

    @staticmethod
    def backward(ctx, g):
        q, k, v, xyz, mask, table = ctx.saved_tensors
        num_heads, pos_bnd, use_rpe = ctx.cfg
        need = ctx.needs_input_grad
        dq, dk, dv, dtable = window_attention_bwd(
            q, k, v, xyz, mask, table, g.contiguous(), num_heads, pos_bnd,
            use_rpe, need_dtable=need[5])
        return (dq if need[0] else None, dk if need[1] else None,
                dv if need[2] else None, None, None,
                dtable.to(table.dtype) if need[5] else None,
                None, None, None)


def window_attention(q, k, v, xyz, mask, table, num_heads: int,
                     pos_bnd: int, use_rpe: bool = True) -> torch.Tensor:
    """q, k, v: (BW, T, C) float32/bfloat16, contiguous; xyz: (BW, 3, K)
    int32 node coords with K = T - G (the G leading relay slots get no
    bias); mask: (BW, T) int32; table: (3*(2*pos_bnd+1), H) float32.
    Returns (BW, T, C) in q's dtype; rows with mask == 0 are 0.
    Differentiable in q, k, v and table."""
    return WindowAttentionFn.apply(q, k, v, xyz, mask, table, num_heads,
                                   pos_bnd, use_rpe)
