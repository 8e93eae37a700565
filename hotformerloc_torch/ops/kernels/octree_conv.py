"""K3/K4 (depthwise) and K5/K6 (full) stride-1 27-tap octree
convolutions, forward and backward.

``octree_dwconv`` and ``octree_conv`` apply ``OctreeDwconvFn`` and
``OctreeConvFn``: on CUDA tensors their forwards launch K3/K5 and their
backwards K4/K6 (csrc/octree_conv.cu); on CPU tensors they run the plain
versions in ops/conv.py. K3 and K4 go through the dispatcher as the
ops ``hotformerloc::octree_dwconv`` and ``hotformerloc::octree_dwconv_bwd``,
K5 and K6 as ``hotformerloc::octree_conv`` and
``hotformerloc::octree_conv_bwd``, so that a selective activation
checkpoint policy (models/backbone.py ``run_block``) can keep K3's
output, and an xCPE's K5 output, instead of running the kernel again in
the backward. They replace
hotformerloc_tpu/ops/pallas/band_conv.py:_dw_fwd_kernel/_dw_bwd_kernel
(entry ``banded_dwconv``) and :_conv_fwd_kernel/_conv_bwd_kernel (entry
``banded_conv``); the direct gather needs no band tables and is exact for
every table. The weights are cast to the activation dtype at use; their
gradients come back in fp32 (the parameters' dtype).

K5 and K6 have two bodies each, and ``conv_body`` picks one from the
dtype and the channel counts alone: the tensor-core bodies ("tc": bf16,
C and O multiples of 16) or the CUDA-core bodies ("cc": fp32, the parity
path, and any other shape, such as the stem's first conv with C = 3).
K4 has one body for every dtype. The backward weight gradients of K4 and
of K6's tensor-core body walk the level's tap lists
(``ops.plan.TapLists``); a caller without them gets them built here. The
plain versions ignore them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from hotformerloc_torch.ops import conv as plain
from hotformerloc_torch.ops import kernels
from hotformerloc_torch.ops.kernels import build
from hotformerloc_torch.ops.plan import TapLists, build_tap_lists

_P = ctypes.c_void_p
_I = ctypes.c_int
# argument types of the C entry points (csrc/octree_conv.cu)
_ARGTYPES = {
    "octree_dwconv_fwd": [_P] * 4 + [_I] * 6 + [_P],
    "octree_conv_fwd": [_P] * 5 + [_I] * 6 + [_P],
    "octree_dwconv_bwd": [_P] * 10 + [_I] * 7 + [_P],
    "octree_conv_bwd": [_P] * 10 + [_I] * 8 + [_P],
}
_protos: dict = {}
# The CUDA-core weight gradient of K6 is a latency-bound gather, so its
# grid aims at 8 blocks per SM (measured faster than 2 on the H100),
# splitting rows down to 64 per block. The tap-list reductions run 4
# blocks per SM (K4: 256 threads; K6's tensor-core body: 128 threads per
# tile, so 4 SMs' worth of workers share the tiles).
_BLOCKS_PER_SM = 8
_MIN_ROWS = 64
_WORKERS_PER_SM = 4


def _fn(name: str):
    """A C entry point of the loaded library, its prototype set once per
    library."""
    lib = build.library("octree_conv")
    fn = _protos.get((id(lib), name))
    if fn is None:
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _protos[(id(lib), name)] = fn
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sms(dev: torch.device) -> int:
    return _sm_count(dev.index if dev.index is not None
                     else torch.cuda.current_device())


def conv_body(dtype: torch.dtype, C: int, O: int) -> str:
    """The body K5 (and K6, whose dx is K5's function with C and O
    swapped) runs on CUDA tensors: "tc" (tensor cores) for bf16 with C
    and O multiples of 16, else "cc" (CUDA cores)."""
    if dtype == torch.bfloat16 and C > 0 and O > 0 and C % 16 == 0 \
            and O % 16 == 0:
        return "tc"
    return "cc"


def _check(x, neigh, name):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dim() != 3 or neigh.dim() != 3 or neigh.shape[:2] != x.shape[:2] \
            or neigh.shape[2] != 27:
        raise ValueError(f"{name}: want x (B, N, C) and neigh (B, N, 27), "
                         f"got {tuple(x.shape)} and {tuple(neigh.shape)}")
    if neigh.dtype != torch.int32:
        raise ValueError(f"{name}: neigh must be int32, got {neigh.dtype}")
    if x.shape[0] * x.shape[1] >= 2 ** 31:
        raise ValueError(f"{name}: {tuple(x.shape)} has too many rows for "
                         "int32 row indices")


def _ready(name, *ts):
    dev = ts[0].device
    for t in ts:
        if t is not None and (t.device != dev or not t.is_contiguous()):
            raise ValueError(f"{name}: inputs must be contiguous and on {dev}")


def _aligned(name, *ts):
    """The tensor-core bodies copy 16-byte row pieces."""
    if any(t is not None and t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name}: the tensor-core body needs 16-byte "
                         "aligned tensors")


def _vec(*ts) -> int:
    """1 when the 16-byte vector path applies to every tensor."""
    t0 = ts[0]
    per16 = 16 // t0.element_size()
    return int(t0.shape[-1] % per16 == 0
               and all(t.data_ptr() % 16 == 0 for t in ts))


def _parts(rows: int, blocks_per_part: int, sms: int) -> int:
    """Row splits of the CUDA-core weight reduction: enough blocks for
    ``_BLOCKS_PER_SM`` per SM, each split at least ``_MIN_ROWS`` rows."""
    want = -(-_BLOCKS_PER_SM * sms // blocks_per_part)
    return max(1, min(want, -(-rows // _MIN_ROWS)))


def _taps(taps: Optional[TapLists], neigh: torch.Tensor) -> TapLists:
    """The caller's tap lists of ``neigh``, or new ones."""
    if taps is None:
        return build_tap_lists(neigh)
    R = neigh.shape[0] * neigh.shape[1]
    for t, shape in ((taps.dst, (27, R)), (taps.src, (27, R)),
                     (taps.count, (27,))):
        if t.shape != shape or t.dtype != torch.int32 \
                or t.device != neigh.device or not t.is_contiguous():
            raise ValueError(f"tap lists do not match neigh "
                             f"{tuple(neigh.shape)}")
    return taps


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
    err = _fn("octree_dwconv_fwd")(
        x.data_ptr(), neigh.data_ptr(), w.data_ptr(), out.data_ptr(), B, N,
        C, code, _vec(x, w), _sms(x.device), build.stream_ptr(x.device))
    build.check(err, "octree_dwconv_fwd")
    kernels.LAUNCHES["octree_dwconv"] += 1
    return out


def octree_dwconv_bwd(x, neigh, w, dy, need_dx: bool = True,
                      taps: Optional[TapLists] = None):
    """K4 on CUDA tensors, ops/conv.octree_dwconv_bwd on CPU tensors.
    w: (27, C) in x's dtype; dy: (B, N, C) in x's dtype; taps: the tap
    lists of ``neigh`` (built here when None). Returns (dx or None, dw
    fp32 (27, C))."""
    if x.device.type == "cpu":
        return plain.octree_dwconv_bwd(x, neigh, w, dy, need_dx)
    _check(x, neigh, "octree_dwconv_bwd")
    B, N, C = x.shape
    if w.shape != (27, C) or dy.shape != x.shape or dy.dtype != x.dtype \
            or w.dtype != x.dtype:
        raise ValueError("octree_dwconv_bwd: want w (27, C) and dy like x")
    code = build.dtype_code(x)
    _ready("octree_dwconv_bwd", x, neigh, w, dy)
    tl = _taps(taps, neigh)
    dx = torch.empty_like(x) if need_dx else None
    sms = _sms(x.device)
    workers = _WORKERS_PER_SM * sms
    partial = torch.empty((workers + 27, C), dtype=torch.float32,
                          device=x.device)
    dw = torch.empty((27, C), dtype=torch.float32, device=x.device)
    err = _fn("octree_dwconv_bwd")(
        x.data_ptr(), neigh.data_ptr(), w.data_ptr(), dy.data_ptr(),
        None if dx is None else dx.data_ptr(), tl.dst.data_ptr(),
        tl.src.data_ptr(), tl.count.data_ptr(), partial.data_ptr(),
        dw.data_ptr(), B, N, C, workers, code, _vec(x, dy, w), sms,
        build.stream_ptr(x.device))
    build.check(err, "octree_dwconv_bwd")
    kernels.LAUNCHES["octree_dwconv_bwd"] += 1
    return dx, dw


def launch_conv(x, neigh, w, b, body: Optional[str] = None):
    """K5 on CUDA tensors (w, b already in x's dtype), with the body
    ``conv_body`` picks (``body`` None) or the CUDA-core body ("cc";
    chip_smoke.py times both bodies on the same inputs)."""
    _check(x, neigh, "octree_conv")
    B, N, C = x.shape
    if w.dim() != 3 or w.shape[:2] != (27, C):
        raise ValueError(f"octree_conv: w must be (27, {C}, O), got "
                         f"{tuple(w.shape)}")
    O = w.shape[2]
    if b is not None and b.shape != (O,):
        raise ValueError(f"octree_conv: bias must be ({O},)")
    if body not in (None, "cc"):
        raise ValueError(f"octree_conv: body must be None or 'cc', got "
                         f"{body!r}")
    body = body or conv_body(x.dtype, C, O)
    code = build.dtype_code(x)
    _ready("octree_conv", x, neigh, w, b)
    out = torch.empty((B, N, O), dtype=x.dtype, device=x.device)
    if body == "tc":
        _aligned("octree_conv", x, w, b, out)
    err = _fn("octree_conv_fwd")(
        x.data_ptr(), neigh.data_ptr(), w.data_ptr(),
        None if b is None else b.data_ptr(), out.data_ptr(), B, N, C, O,
        code, int(body == "tc"), build.stream_ptr(x.device))
    build.check(err, f"octree_conv_fwd ({body})")
    kernels.LAUNCHES["octree_conv"] += 1
    if body == "tc":
        kernels.LAUNCHES["octree_conv_tc"] += 1
    return out


def _conv_fwd(x, neigh, w, b):
    """K5 (w, b already in x's dtype)."""
    if x.device.type == "cpu":
        return plain.octree_conv(x, neigh, w, b)
    return launch_conv(x, neigh, w, b)


def octree_conv_bwd(x, neigh, w, dy, need_dx: bool = True,
                    taps: Optional[TapLists] = None,
                    body: Optional[str] = None):
    """K6 on CUDA tensors, ops/conv.octree_conv_bwd on CPU tensors.
    w: (27, C, O) in x's dtype; dy: (B, N, O) in x's dtype; taps: the tap
    lists of ``neigh`` for the tensor-core body (built here when None);
    ``body`` as for ``launch_conv``. Returns (dx or None, dw fp32
    (27, C, O), db fp32 (O,)); db is a torch sum, as the JAX package
    computes it outside its kernel."""
    if x.device.type == "cpu":
        return plain.octree_conv_bwd(x, neigh, w, dy, need_dx)
    _check(x, neigh, "octree_conv_bwd")
    B, N, C = x.shape
    O = w.shape[-1]
    if w.shape != (27, C, O) or dy.shape != (B, N, O) \
            or dy.dtype != x.dtype or w.dtype != x.dtype:
        raise ValueError("octree_conv_bwd: want w (27, C, O) and dy "
                         "(B, N, O) in x's dtype")
    if body not in (None, "cc"):
        raise ValueError(f"octree_conv_bwd: body must be None or 'cc', "
                         f"got {body!r}")
    body = body or conv_body(x.dtype, C, O)
    code = build.dtype_code(x)
    _ready("octree_conv_bwd", x, neigh, w, dy)
    dx = torch.empty_like(x) if need_dx else None
    sms = _sms(x.device)
    tiles = -(-C // 64) * -(-O // 64)
    if body == "tc":
        _aligned("octree_conv_bwd", x, w, dy, dx)
        tl = _taps(taps, neigh)
        tap_ptrs = (tl.dst.data_ptr(), tl.src.data_ptr(),
                    tl.count.data_ptr())
        parts = max(1, -(-_WORKERS_PER_SM * sms // tiles))
        partial = torch.empty((parts + 27, C, O), dtype=torch.float32,
                              device=x.device)
    else:
        tap_ptrs = (None, None, None)
        parts = _parts(B * N, tiles * 27, sms)
        partial = torch.empty((parts, 27, C, O), dtype=torch.float32,
                              device=x.device)
    dw = torch.empty((27, C, O), dtype=torch.float32, device=x.device)
    err = _fn("octree_conv_bwd")(
        x.data_ptr(), neigh.data_ptr(), w.data_ptr(), dy.data_ptr(),
        None if dx is None else dx.data_ptr(), *tap_ptrs,
        partial.data_ptr(), dw.data_ptr(), B, N, C, O, parts, code,
        int(body == "tc"), sms, build.stream_ptr(x.device))
    build.check(err, f"octree_conv_bwd ({body})")
    kernels.LAUNCHES["octree_conv_bwd"] += 1
    if body == "tc":
        kernels.LAUNCHES["octree_conv_bwd_tc"] += 1
    return dx, dw, dy.sum((0, 1), dtype=torch.float32)


@torch.library.custom_op("hotformerloc::octree_dwconv", mutates_args=())
def octree_dwconv_op(x: torch.Tensor, neigh: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    """K3 as a dispatcher op (w in x's dtype): the kernel on CUDA tensors,
    the plain version on CPU tensors."""
    return _dw_fwd(x, neigh, w)


@torch.library.custom_op("hotformerloc::octree_dwconv_bwd", mutates_args=())
def octree_dwconv_bwd_op(x: torch.Tensor, neigh: torch.Tensor,
                         w: torch.Tensor, dy: torch.Tensor, need_dx: bool,
                         tap_dst: Optional[torch.Tensor],
                         tap_src: Optional[torch.Tensor],
                         tap_count: Optional[torch.Tensor]
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 as a dispatcher op (``octree_dwconv_bwd``; the tap lists as
    three tensors, all None to build them here). dx is an empty tensor
    when ``need_dx`` is False."""
    taps = (None if tap_dst is None
            else TapLists(dst=tap_dst, src=tap_src, count=tap_count))
    dx, dw = octree_dwconv_bwd(x, neigh, w, dy, need_dx, taps)
    return (x.new_empty(0) if dx is None else dx), dw


class OctreeDwconvFn(torch.autograd.Function):
    """K3 forward, K4 backward (plain versions on CPU tensors), through
    the ops ``hotformerloc::octree_dwconv`` and ``::octree_dwconv_bwd``."""

    @staticmethod
    def forward(ctx, x, neigh, w, taps):
        kernels.check_device(x, "octree_dwconv")
        wc = w.to(x.dtype).contiguous()
        ctx.save_for_backward(x, neigh, wc)
        ctx.w_dtype = w.dtype
        ctx.taps = taps
        return octree_dwconv_op(x, neigh, wc)

    @staticmethod
    def backward(ctx, dy):
        x, neigh, wc = ctx.saved_tensors
        need = ctx.needs_input_grad
        tl = ctx.taps
        dx, dw = octree_dwconv_bwd_op(
            x, neigh, wc, dy.contiguous(), bool(need[0]),
            *((None,) * 3 if tl is None else (tl.dst, tl.src, tl.count)))
        return (dx if need[0] else None, None,
                dw.to(ctx.w_dtype) if need[2] else None, None)


@torch.library.custom_op("hotformerloc::octree_conv", mutates_args=())
def octree_conv_op(x: torch.Tensor, neigh: torch.Tensor, w: torch.Tensor,
                   b: Optional[torch.Tensor]) -> torch.Tensor:
    """K5 as a dispatcher op (w, b in x's dtype): the kernel on CUDA
    tensors, the plain version on CPU tensors."""
    return _conv_fwd(x, neigh, w, b)


@torch.library.custom_op("hotformerloc::octree_conv_bwd", mutates_args=())
def octree_conv_bwd_op(x: torch.Tensor, neigh: torch.Tensor,
                       w: torch.Tensor, dy: torch.Tensor, need_dx: bool,
                       tap_dst: Optional[torch.Tensor],
                       tap_src: Optional[torch.Tensor],
                       tap_count: Optional[torch.Tensor]
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6 as a dispatcher op (``octree_conv_bwd``; the tap lists as three
    tensors, all None to build them here). dx is an empty tensor when
    ``need_dx`` is False."""
    taps = (None if tap_dst is None
            else TapLists(dst=tap_dst, src=tap_src, count=tap_count))
    dx, dw, db = octree_conv_bwd(x, neigh, w, dy, need_dx, taps)
    return (x.new_empty(0) if dx is None else dx), dw, db


class OctreeConvFn(torch.autograd.Function):
    """K5 forward, K6 backward (plain versions on CPU tensors), through
    the ops ``hotformerloc::octree_conv`` and ``::octree_conv_bwd``. dx is
    not computed when x needs no gradient (the stem's input features)."""

    @staticmethod
    def forward(ctx, x, neigh, w, b, taps):
        kernels.check_device(x, "octree_conv")
        wc = w.to(x.dtype).contiguous()
        bc = None if b is None else b.to(x.dtype).contiguous()
        ctx.save_for_backward(x, neigh, wc)
        ctx.dtypes = (w.dtype, None if b is None else b.dtype)
        ctx.taps = taps
        return octree_conv_op(x, neigh, wc, bc)

    @staticmethod
    def backward(ctx, dy):
        x, neigh, wc = ctx.saved_tensors
        need = ctx.needs_input_grad
        tl = ctx.taps
        dx, dw, db = octree_conv_bwd_op(
            x, neigh, wc, dy.contiguous(), bool(need[0]),
            *((None,) * 3 if tl is None else (tl.dst, tl.src, tl.count)))
        w_dt, b_dt = ctx.dtypes
        return (dx if need[0] else None, None,
                dw.to(w_dt) if need[2] else None,
                db.to(b_dt) if need[3] else None, None)


def octree_dwconv(x: torch.Tensor, neigh: torch.Tensor, w: torch.Tensor,
                  taps: Optional[TapLists] = None) -> torch.Tensor:
    """out[b,n,c] = sum_k w[k,c] * x[b, neigh[b,n,k], c]; x: (B, N, C)
    float32/bfloat16, neigh: (B, N, 27) int32 (-1 = none), w: (27, C)
    (cast to x's dtype), taps: ``neigh``'s tap lists for the backward
    (optional). Accumulates in fp32, returns x's dtype. Differentiable in
    x and w."""
    return OctreeDwconvFn.apply(x, neigh, w, taps)


def octree_conv(x: torch.Tensor, neigh: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None,
                taps: Optional[TapLists] = None) -> torch.Tensor:
    """out[b,n,o] = sum_{k,c} w[k,c,o] * x[b, neigh[b,n,k], c] + b[o];
    x: (B, N, C) float32/bfloat16 (any C), neigh: (B, N, 27) int32,
    w: (27, C, O), b: (O,) or None (both cast to x's dtype), taps:
    ``neigh``'s tap lists for the backward (optional). Accumulates in
    fp32. Differentiable in x, w and b."""
    return OctreeConvFn.apply(x, neigh, w, b, taps)
