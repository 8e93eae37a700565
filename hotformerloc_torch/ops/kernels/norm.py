"""LayerNorm over the last axis: ``layer_norm_rows_kernel``
(csrc/layer_norm.cu), behind every LayerNorm of the model
(models/layers.py ``LayerNorm``).

``layer_norm`` launches the kernel on CUDA tensors and runs the plain
version ``layer_norm_reference`` (aten's ``native_layer_norm``) on CPU
tensors. Where autograd records, it applies ``LayerNormFn``, whose
forward goes through the dispatcher as the op
``hotformerloc::layer_norm`` (so that a selective activation checkpoint
policy, models/backbone.py ``run_block``, sees it) and whose backward is
aten's own ``native_layer_norm_backward``, fed the forward's mean and
rstd, so gradients keep aten's numerics. Serving calls launch directly,
without the op's host cost. The kernel replaces no TPU kernel (the
JAX package's LayerNorm is flax's, fused by XLA); see the source's note
for why it was added.

The launch plan (``layer_norm_plan``) is a pure function of the shape,
the dtype and the pointers' alignment: the lanes of a row and the
vectors of a lane follow from C, so one kernel adapts to rows of 16 bytes
to 4 KB. A width the kernel does not take raises on every device, so the
CPU runs refuse what the card would.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from hotformerloc_torch.ops import kernels
from hotformerloc_torch.ops.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_ARGTYPES = [_P] * 6 + [_L, _I, _F] + [_I] * 7 + [_L, _P]

# csrc/layer_norm.cu: kThreads, kMaxPerLane, kBlocksPerSM (blocks an SM
# of the persistent grid)
THREADS = 256
MAX_PER_LANE = 8
BLOCKS_PER_SM = 3
MAX_ROWS = 2 ** 30


class LayerNormPlan(NamedTuple):
    """vec: values a lane loads at once (a 16-byte vector, or 1); lanes:
    lanes of a row; per_lane: vectors a lane; unroll: row groups a warp
    loads before reducing; wide: 64-bit offsets; threads, blocks: the
    grid."""
    vec: int
    lanes: int
    per_lane: int
    unroll: int
    wide: bool
    threads: int
    blocks: int


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def max_width(elem_bytes: int, aligned: bool = True) -> int:
    """The widest row the kernel takes: 32 lanes of ``MAX_PER_LANE``
    units (16-byte vectors where ``aligned``, else single values)."""
    return 32 * MAX_PER_LANE * (16 // elem_bytes if aligned else 1)


@functools.lru_cache(maxsize=64)
def width_taken(C: int, elem_bytes: int) -> bool:
    """Whether the kernel takes rows of C values: a multiple of a 16-byte
    vector up to ``max_width``, else single values up to 32 lanes of
    ``MAX_PER_LANE``."""
    return 1 <= C <= max_width(elem_bytes, C % (16 // elem_bytes) == 0)


def check_width(C: int, elem_bytes: int) -> None:
    """Raise for a row width the kernel does not take."""
    if not width_taken(C, elem_bytes):
        raise ValueError(
            f"layer_norm: width {C} not taken ({elem_bytes}-byte values: "
            f"a multiple of {16 // elem_bytes} up to "
            f"{max_width(elem_bytes)}, else up to "
            f"{max_width(elem_bytes, False)})")


@functools.lru_cache(maxsize=512)
def layer_norm_plan(M: int, C: int, elem_bytes: int, aligned: bool = True,
                    sms: int = 132) -> LayerNormPlan:
    """The kernel's plan for M rows of C values of ``elem_bytes`` bytes:
    16-byte vectors where C is a multiple of one and ``aligned`` (every
    pointer on 16 bytes), else single values; L lanes a row, the least
    power of two that holds its units, up to 32; above 32 units, the
    least power of two of units a lane; U = 4 / per_lane row groups
    (32 / L rows each) a warp loads at once (1 from 4 units a lane); a
    persistent grid of ``BLOCKS_PER_SM`` blocks of 8 warps on each of
    ``sms`` SMs, fewer where the rows need fewer."""
    check_width(C, elem_bytes)
    if not 1 <= M < MAX_ROWS:
        raise ValueError(f"layer_norm: {M} rows (1 to {MAX_ROWS - 1})")
    full = 16 // elem_bytes
    vec = full if aligned and C % full == 0 else 1
    units = C // vec
    lanes = min(32, _pow2_at_least(units))
    per_lane = _pow2_at_least(-(-units // 32))
    if per_lane > MAX_PER_LANE:
        raise ValueError(f"layer_norm: width {C} not taken off 16-byte "
                         "alignment (at most "
                         f"{max_width(elem_bytes, False)})")
    unroll = max(1, 4 // per_lane)
    groups = -(-M // (32 // lanes))
    warps = -(-groups // unroll)
    blocks = min(-(-warps // (THREADS // 32)), sms * BLOCKS_PER_SM)
    return LayerNormPlan(vec, lanes, per_lane, unroll, M * C >= 2 ** 31,
                         THREADS, blocks)


@functools.lru_cache(maxsize=16)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def layer_norm_reference(x, weight, bias, eps: float):
    """Plain version: aten's native_layer_norm over the last axis, (y,
    mean, rstd) with mean and rstd shaped x.shape[:-1] + (1,)."""
    return torch.native_layer_norm(x, (x.shape[-1],), weight, bias, eps)


def _check(x, weight, bias) -> None:
    """The width first (every device), then the device and the operands
    of a launch."""
    C = x.shape[-1] if x.dim() else 0
    check_width(C, x.element_size())
    kernels.check_device(x, "layer_norm")
    for name, t in (("weight", weight), ("bias", bias)):
        if t is None or t.shape != (C,) or t.dtype != x.dtype \
                or t.device != x.device:
            raise ValueError(f"layer_norm: {name} must be a {x.dtype} "
                             f"({C},) tensor on {x.device}")


# Private symbol, present in PyTorch 2.11 (the H100 machine's): the raw
# current stream, 0.14 µs a call on that machine's host against 7.8 µs
# for build.stream_ptr's Stream object. A serving forward of the shipped
# configurations calls the wrapper 134 times, on a host that paces the
# card.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def launch(x, weight, bias, eps: float, stats: bool = False):
    """The kernel on CUDA tensors (checked by ``_check``): (y, mean,
    rstd) as the reference gives them, mean and rstd fp32, or None when
    ``stats`` is False."""
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: unsupported device {x.device}")
    code = build.dtype_code(x)
    x = x.contiguous()
    weight, bias = weight.contiguous(), bias.contiguous()
    C = x.shape[-1]
    M = x.numel() // C
    y = torch.empty_like(x)
    mean = rstd = None
    if stats:
        mean, rstd = (torch.empty((*x.shape[:-1], 1), dtype=torch.float32,
                                  device=x.device) for _ in range(2))
    if M == 0:
        return y, mean, rstd
    aligned = (x.data_ptr() | weight.data_ptr() | bias.data_ptr()
               | y.data_ptr()) % 16 == 0
    p = layer_norm_plan(M, C, x.element_size(), aligned, _sms(x.device))
    fn = build.bind("layer_norm", "layer_norm_fwd", _ARGTYPES)
    err = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
             mean.data_ptr() if stats else None,
             rstd.data_ptr() if stats else None, M, C, float(eps), code,
             p.vec, p.lanes, p.per_lane, p.unroll, int(p.wide), p.threads,
             p.blocks, _raw_stream(x.device.index))
    build.check(err, "layer_norm_fwd")
    kernels.LAUNCHES["layer_norm"] += 1
    return y, mean, rstd


def _op_cpu(x, weight, bias, eps):
    return layer_norm_reference(x, weight, bias, eps)


def _op_cuda(x, weight, bias, eps):
    return launch(x, weight, bias, eps, True)


# The forward with its statistics as a dispatcher op: the kernel on CUDA
# tensors, the plain version on CPU tensors. Defined on a Library and not
# by torch.library.custom_op, whose Python wrappers (an autograd kernel,
# output alias checks) cost a training call (forward and backward) about
# twice the host time of aten's: 506 against 235 µs on an H100 machine's
# host, whose train step waits on the host (NVIDIA H100 80GB HBM3).
_LIB = torch.library.Library("hotformerloc", "FRAGMENT")
_LIB.define("layer_norm(Tensor x, Tensor weight, Tensor bias, float eps)"
            " -> (Tensor, Tensor, Tensor)")
_LIB.impl("layer_norm", _op_cpu, "CPU")
_LIB.impl("layer_norm", _op_cuda, "CUDA")
layer_norm_op = torch.ops.hotformerloc.layer_norm.default


class LayerNormFn(torch.autograd.Function):
    """The kernel forward (plain version on CPU tensors) through the op
    ``hotformerloc::layer_norm``; aten's native_layer_norm_backward on
    the forward's mean and rstd."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        y, mean, rstd = layer_norm_op(x, weight, bias, float(eps))
        ctx.save_for_backward(x, weight, bias, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, bias, mean, rstd = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, dw, db = torch.ops.aten.native_layer_norm_backward.default(
            g.contiguous(), x, (x.shape[-1],), mean, rstd, weight, bias,
            [need[0], need[1], need[2]])
        return dx, dw, db, None


def layer_norm(x, weight, bias, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm of x (..., C) over its last axis with weight and bias
    (C,) in x's dtype (fp32 or bf16 on the card): fp32 statistics, the
    output in x's dtype. Differentiable in x, weight and bias, through
    the op (which the checkpoint policy sees). Without a gradient to
    record (serving) the kernel launches directly and writes no
    statistics: on an H100 machine the op's dispatch cost 14-31 µs of
    host time a call, against 12.4 µs for aten's whole F.layer_norm, and
    the host paces the Oxford forward."""
    _check(x, weight, bias)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return LayerNormFn.apply(x, weight, bias, eps)
    if x.device.type == "cpu":
        return layer_norm_reference(x, weight, bias, eps)[0]
    return launch(x, weight, bias, eps)[0]
