"""K1/K2: windowed multi-head attention with fused RPE, forward and
backward.

``window_attention`` applies ``WindowAttentionFn``: on CUDA tensors its
forward launches K1 and its backward K2 (csrc/window_attn.cu); on CPU
tensors they run the plain versions ``window_attention_reference`` and
``window_attention_bwd_reference``. Both directions go through the
dispatcher as the ops ``hotformerloc::window_attn`` and
``hotformerloc::window_attn_bwd``, so that a selective activation
checkpoint policy (models/backbone.py ``run_block``) can keep K1's
output instead of running K1 again in the backward. They replace
hotformerloc_tpu/ops/pallas/window_attn.py:_fwd_kernel and _bwd_kernel
(entry ``fused_window_attention`` and its custom VJP); layouts are the
JAX entry's.

Each direction has two kernel bodies, and ``attn_body`` picks one from
the dtype and the shape alone: the tensor-core body ("tc": bf16, head
width a multiple of 16 up to 64, T <= 80, the window's tiles within
shared memory) or the CUDA-core body ("cc": fp32, the parity path, and
any other shape). Both take windows of up to ``MAX_T`` = 80 tokens: the
64 nodes and one relay slot of patch 64's H-OSA windows fit. q, k, v (and g) may be strided views, such as slices of
one qkv projection: the last dimension contiguous, the three with equal
strides.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from hotformerloc_torch.ops import kernels
from hotformerloc_torch.ops.kernels import build
from hotformerloc_torch.ops.rpe import rpe_bias_reference, rpe_index
from hotformerloc_torch.ops.window import MASK_VALUE

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_FWD_ARGTYPES = [_P] * 3 + [_L] * 2 + [_P] * 4 + [_I] * 7 + [_F, _I, _I, _P]
_BWD_ARGTYPES = ([_P] * 3 + [_L] * 2 + [_P] * 4 + [_L] * 2 + [_P] * 4
                 + [_I] * 8 + [_F, _I, _I, _P])

# Shared memory a block may use on the H100 (bytes), the longest window
# both bodies take, and the tensor-core bodies' layout constants
# (csrc/window_attn.cu: kSmemLimit, kMaxT, kPad, kBwdWarps).
SMEM_LIMIT = 232448
MAX_T = 80
_PAD, _BWD_WARPS = 8, 16


def tc_plan(T: int, C: int, H: int, pos_bnd: int, K: int | None = None):
    """The tensor-core bodies' plan at (T, C, H) with the RPE and its
    table gradient on, as csrc/window_attn.cu's launchers make it
    (window_attn_tc_plan): (heads per round of the backward, forward
    bytes, backward bytes) of shared memory. K (window nodes, T - G)
    defaults to T, the most it can be. The backward takes 4 key slabs of
    16 for T <= 64 and 5 above, a warp per (head, slab), and as many
    heads per round, up to 16 warps, as fit ``SMEM_LIMIT`` beside the
    window's four (T, C) tiles (1 when none does)."""
    K = T if K is None else K
    num = 2 * pos_bnd + 1
    R = 16 * -(-T // 16)
    fwd = 2 * 3 * T * (C + _PAD) + 4 * T + 4 * H * 3 * num + 4 * 3 * K

    def bwd(hpr):
        return (2 * (4 * T * (C + _PAD) + 2 * hpr * R * (R + _PAD))
                + 4 * T + 4 * 3 * K                # mask, coords
                + 4 * 2 * hpr * 3 * num            # table columns, histogram
                + 4 * hpr * T * (T | 1)            # fp32 dS
                + 4 * (9 * K + 6))                 # nodes sorted per axis
    hpr = min(_BWD_WARPS // (4 if T <= 64 else 5), H)
    while hpr > 1 and bwd(hpr) > SMEM_LIMIT:
        hpr -= 1
    return hpr, fwd, bwd(hpr)


def tc_smem(T: int, C: int, H: int, pos_bnd: int,
            K: int | None = None) -> int:
    """Shared-memory bytes of the larger of the tensor-core forward and
    backward (``tc_plan``)."""
    _, fwd, bwd = tc_plan(T, C, H, pos_bnd, K)
    return max(fwd, bwd)


def attn_body(dtype: torch.dtype, T: int, C: int, H: int, pos_bnd: int,
              K: int | None = None) -> str:
    """The kernel body K1 and K2 run for this dtype and shape: "tc" (the
    tensor-core bodies) for bf16 with hd = C / H a multiple of 16 up to
    64, T <= ``MAX_T`` and the tiles within ``SMEM_LIMIT``; else "cc"
    (the CUDA-core bodies)."""
    hd = C // H if H > 0 and C % H == 0 else 0
    if (dtype == torch.bfloat16 and hd > 0 and hd % 16 == 0 and hd <= 64
            and T <= MAX_T and tc_smem(T, C, H, pos_bnd, K) <= SMEM_LIMIT):
        return "tc"
    return "cc"


def launcher_tc_plan(T: int, C: int, H: int, pos_bnd: int,
                     K: int | None = None):
    """``tc_plan`` as csrc/window_attn.cu's launchers compute it
    (window_attn_tc_plan; builds the library): chip_smoke.py holds the
    two equal at the main path's shapes."""
    K = T if K is None else K
    fn = build.library("window_attn").window_attn_tc_plan
    fn.argtypes = [_I] * 7 + [ctypes.POINTER(_L)] * 2
    fn.restype = ctypes.c_int
    fwd, bwd = _L(), _L()
    hpr = fn(T, C, H, K, pos_bnd, 1, 1, ctypes.byref(fwd), ctypes.byref(bwd))
    return hpr, fwd.value, bwd.value


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


def _rounded(x, dtype):
    """x rounded to the compute dtype and back to fp32 (a no-op at fp32):
    where the JAX kernel casts an fp32 intermediate before a product."""
    return x.to(dtype).float()


def window_attention_reference(q, k, v, xyz, mask, table, num_heads: int,
                               pos_bnd: int, use_rpe: bool = True):
    """Plain version of K1: same function as the kernel, computed in fp32
    with the softmax rounded to q.dtype before attn . v (as _fwd_kernel
    rounds it), returned in q.dtype. Query rows with mask == 0 are
    exactly 0."""
    BW, T, C = q.shape
    attn, _, _ = _attn_probs(q, k, xyz, mask, table, num_heads, pos_bnd,
                             use_rpe)
    vf = v.float().reshape(BW, T, num_heads, C // num_heads)
    out = torch.einsum("whts,wshd->wthd", _rounded(attn, q.dtype),
                       vf).reshape(BW, T, C)
    return out.to(q.dtype)


def window_attention_bwd_reference(q, k, v, xyz, mask, table, g,
                                   num_heads: int, pos_bnd: int,
                                   use_rpe: bool = True):
    """Plain version of K2: the gradients of the attention with respect to
    q, k, v and the RPE table for the output cotangent g (BW, T, C), with
    _bwd_kernel's rounding points. Returns (dq, dk, dv) in q.dtype and
    dtable (3*(2*pos_bnd+1), H) fp32 (zeros without RPE):

        dv = rnd(attn)^T g,  dattn = g v^T,
        dlog = attn * (dattn - rowsum(dattn * attn))        (fp32)
        dq = rnd(dlog) k / sqrt(hd),  dk = rnd(dlog)^T q / sqrt(hd)
        dtable[a*num + clip(x_a[t] - x_a[s]) + bnd, h] += dlog[h, t, s]
    over the (K, K) node block (the G leading relay slots carry no bias),
    where rnd rounds to q.dtype (nothing at fp32). The table gradient is
    summed from the fp32 dlog.
    """
    BW, T, C = q.shape
    H = num_heads
    hd = C // H
    attn, qf, kf = _attn_probs(q, k, xyz, mask, table, H, pos_bnd, use_rpe)
    vf = v.float().reshape(BW, T, H, hd)
    gf = g.float().reshape(BW, T, H, hd)
    dv = torch.einsum("whts,wthd->wshd", _rounded(attn, q.dtype), gf)
    dattn = torch.einsum("wthd,wshd->whts", gf, vf)
    dlog = attn * (dattn - (dattn * attn).sum(-1, keepdim=True))
    scale = hd ** -0.5
    dl_c = _rounded(dlog, q.dtype)
    dq = torch.einsum("whts,wshd->wthd", dl_c, kf) * scale
    dk = torch.einsum("whts,wthd->wshd", dl_c, qf) * scale
    dtable = torch.zeros(table.shape, dtype=torch.float32, device=q.device)
    if use_rpe:
        G = T - xyz.shape[2]
        dl = dlog[:, :, G:, G:].permute(0, 2, 3, 1).reshape(-1, H)
        for idx in rpe_index(xyz.transpose(1, 2), pos_bnd):
            dtable.index_add_(0, idx.reshape(-1), dl)
    out = [t.reshape(BW, T, C).to(q.dtype) for t in (dq, dk, dv)]
    return (*out, dtable)


def _rows_ok(t, body) -> bool:
    """The kernels read a (BW, T, C) operand through two strides with the
    last dimension contiguous; the tensor-core bodies copy 16-byte rows,
    so their pointer and strides must be 16-byte aligned."""
    if t.stride(2) != 1 and t.shape[2] > 1:
        return False
    return body == "cc" or (t.data_ptr() % 16 == 0
                            and t.stride(0) % 8 == 0 and t.stride(1) % 8 == 0)


def _check(q, k, v, xyz, mask, table, num_heads, pos_bnd, use_rpe, what):
    """Validates the arguments of a launch and returns the body to run
    (the shapes first, then the device)."""
    BW, T, C = q.shape
    H = num_heads
    K = xyz.shape[2]
    build.dtype_code(q)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape != (BW, T, C) or t.dtype != q.dtype:
            raise ValueError(f"{what}: {name} is {t.dtype} "
                             f"{tuple(t.shape)}, want {q.dtype} {(BW, T, C)}")
    if T > MAX_T or C % H != 0 or K > T:
        raise ValueError(f"{what}: unsupported T={T}, C={C}, "
                         f"H={H}, K={K} (T <= {MAX_T}, H | C, K <= T)")
    if xyz.shape != (BW, 3, K) or xyz.dtype != torch.int32:
        raise ValueError(f"{what}: xyz must be (BW, 3, K) int32")
    if mask.shape != (BW, T) or mask.dtype != torch.int32:
        raise ValueError(f"{what}: mask must be (BW, T) int32")
    num = 2 * pos_bnd + 1
    if use_rpe and (table.shape != (3 * num, H)
                    or table.dtype != torch.float32):
        raise ValueError(f"{what}: table must be ({3 * num}, {H}) float32")
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    for t in (q, k, v, xyz, mask, table):
        if t.device != q.device:
            raise ValueError(f"{what}: inputs must be on {q.device}")
    for t in (xyz, mask, table):
        if not t.is_contiguous():
            raise ValueError(f"{what}: xyz, mask and table must be "
                             "contiguous")
    body = attn_body(q.dtype, T, C, H, pos_bnd, K)
    if k.stride() != q.stride() or v.stride() != q.stride() \
            or not all(_rows_ok(t, body) for t in (q, k, v)):
        raise ValueError(f"{what}: q, k, v need equal strides with the last "
                         "dimension contiguous (16-byte aligned rows for "
                         f"the tensor-core body), got {q.stride()}, "
                         f"{k.stride()}, {v.stride()}")
    return body


def _body(q, k, v, xyz, mask, table, num_heads, pos_bnd, use_rpe, what,
          body):
    """The body to launch: ``attn_body``'s choice, or "cc" on request."""
    if body not in (None, "cc"):
        raise ValueError(f"{what}: body must be None or 'cc', got {body!r}")
    chosen = _check(q, k, v, xyz, mask, table, num_heads, pos_bnd, use_rpe,
                    what)
    return body or chosen


def _fwd(q, k, v, xyz, mask, table, num_heads, pos_bnd, use_rpe):
    if q.device.type == "cpu":
        return window_attention_reference(q, k, v, xyz, mask, table,
                                          num_heads, pos_bnd, use_rpe)
    return launch_fwd(q, k, v, xyz, mask, table, num_heads, pos_bnd,
                      use_rpe)


def launch_fwd(q, k, v, xyz, mask, table, num_heads: int, pos_bnd: int,
               use_rpe: bool = True, body: str | None = None):
    """K1 on CUDA tensors, with the body ``attn_body`` picks (``body``
    None) or the CUDA-core body ("cc"; chip_smoke.py times both bodies on
    the same inputs)."""
    body = _body(q, k, v, xyz, mask, table, num_heads, pos_bnd, use_rpe,
                 "window_attention", body)
    BW, T, C = q.shape
    out = torch.empty((BW, T, C), dtype=q.dtype, device=q.device)
    fn = build.library("window_attn").window_attn_fwd
    fn.argtypes = _FWD_ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(0),
             q.stride(1), *(t.data_ptr() for t in (xyz, mask, table, out)),
             BW, T, C, num_heads, xyz.shape[2], pos_bnd, int(bool(use_rpe)),
             float((C // num_heads) ** -0.5), build.dtype_code(q),
             int(body == "tc"), build.stream_ptr(q.device))
    build.check(err, f"window_attn_fwd ({body})")
    kernels.LAUNCHES["window_attn"] += 1
    if body == "tc":
        kernels.LAUNCHES["window_attn_tc"] += 1
    return out


def window_attention_bwd(q, k, v, xyz, mask, table, g, num_heads: int,
                         pos_bnd: int, use_rpe: bool = True,
                         need_dtable: bool = True, body: str | None = None):
    """K2 on CUDA tensors, ``window_attention_bwd_reference`` on CPU
    tensors. g: (BW, T, C) in q's dtype, last dimension contiguous.
    Returns (dq, dk, dv, dtable) as the reference does; dtable is zeros
    when ``need_dtable`` is False or the RPE is off. ``body`` as for
    ``launch_fwd``."""
    if q.device.type == "cpu":
        return window_attention_bwd_reference(q, k, v, xyz, mask, table, g,
                                              num_heads, pos_bnd, use_rpe)
    body = _body(q, k, v, xyz, mask, table, num_heads, pos_bnd, use_rpe,
                 "window_attention_bwd", body)
    BW, T, C = q.shape
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device \
            or not _rows_ok(g, body):
        raise ValueError("window_attention_bwd: g must be a "
                         f"{q.dtype} {tuple(q.shape)} tensor on {q.device} "
                         "with the last dimension contiguous")
    dq, dk, dv = (torch.empty((BW, T, C), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    dtable = torch.zeros(table.shape, dtype=torch.float32, device=q.device)
    fn = build.library("window_attn").window_attn_bwd
    fn.argtypes = _BWD_ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(0),
             q.stride(1), *(t.data_ptr() for t in (xyz, mask, table, g)),
             g.stride(0), g.stride(1),
             *(t.data_ptr() for t in (dq, dk, dv, dtable)),
             BW, T, C, num_heads, xyz.shape[2], pos_bnd, int(bool(use_rpe)),
             int(bool(use_rpe and need_dtable)),
             float((C // num_heads) ** -0.5), build.dtype_code(q),
             int(body == "tc"), build.stream_ptr(q.device))
    build.check(err, f"window_attn_bwd ({body})")
    kernels.LAUNCHES["window_attn_bwd"] += 1
    if body == "tc":
        kernels.LAUNCHES["window_attn_bwd_tc"] += 1
    return dq, dk, dv, dtable


@torch.library.custom_op("hotformerloc::window_attn", mutates_args=())
def window_attn_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   xyz: torch.Tensor, mask: torch.Tensor,
                   table: torch.Tensor, num_heads: int, pos_bnd: int,
                   use_rpe: bool) -> torch.Tensor:
    """K1 as a dispatcher op: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    return _fwd(q, k, v, xyz, mask, table, num_heads, pos_bnd, use_rpe)


@torch.library.custom_op("hotformerloc::window_attn_bwd", mutates_args=())
def window_attn_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       xyz: torch.Tensor, mask: torch.Tensor,
                       table: torch.Tensor, g: torch.Tensor, num_heads: int,
                       pos_bnd: int, use_rpe: bool, need_dtable: bool
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """K2 as a dispatcher op (``window_attention_bwd``)."""
    return window_attention_bwd(q, k, v, xyz, mask, table, g, num_heads,
                                pos_bnd, use_rpe, need_dtable)


class WindowAttentionFn(torch.autograd.Function):
    """K1 forward, K2 backward (plain versions on CPU tensors), through
    the ops ``hotformerloc::window_attn`` and ``::window_attn_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, xyz, mask, table, num_heads, pos_bnd,
                use_rpe):
        kernels.check_device(q, "window_attention")
        ctx.save_for_backward(q, k, v, xyz, mask, table)
        ctx.cfg = (int(num_heads), int(pos_bnd), bool(use_rpe))
        return window_attn_op(q, k, v, xyz, mask, table, *ctx.cfg)

    @staticmethod
    def backward(ctx, g):
        q, k, v, xyz, mask, table = ctx.saved_tensors
        need = ctx.needs_input_grad
        dq, dk, dv, dtable = window_attn_bwd_op(
            q, k, v, xyz, mask, table, g.contiguous(), *ctx.cfg,
            bool(need[5]))
        return (dq if need[0] else None, dk if need[1] else None,
                dv if need[2] else None, None, None,
                dtable.to(table.dtype) if need[5] else None,
                None, None, None)


def window_attention(q, k, v, xyz, mask, table, num_heads: int,
                     pos_bnd: int, use_rpe: bool = True) -> torch.Tensor:
    """q, k, v: (BW, T, C) float32/bfloat16 with the last dimension
    contiguous and equal strides (e.g. slices of one qkv projection);
    xyz: (BW, 3, K) int32 node coords with K = T - G (the G leading relay
    slots get no bias); mask: (BW, T) int32; table: (3*(2*pos_bnd+1), H)
    float32. Returns a contiguous (BW, T, C) in q's dtype; rows with
    mask == 0 are 0. Differentiable in q, k, v and table."""
    return WindowAttentionFn.apply(q, k, v, xyz, mask, table, num_heads,
                                   pos_bnd, use_rpe)
