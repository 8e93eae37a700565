"""Row gathers of the on-chip probe tools (csrc/gather.cu).

``take_rows`` replaces the TPU probe kernels that gather rows in a
kernel: hotformerloc_tpu/tools/gather_bench.py:k_take (T1) and
mosaic_probe.py:k_take, k_jtake, k_rowloop, k_tiled (T4). All compute
``out = x[clamp(idx, 0)]`` along the row axis and differ only in TPU
layout. A missing tap (-1) reads row 0, as k_take does; the flat
``ops/conv._gather_rows`` zeroes it instead. ``take_plan`` is its launch
plan: 16-byte vectors per lane and threads per block.

``dwconv_resident`` replaces gather_bench.py:k_dw (T2): the depthwise
octree conv of K3 with x resident in on-chip memory, here the shared
memory of a thread-block cluster (``resident_plan`` picks the cluster
size, channel slice and rows per block). Its plain version is
``ops/conv.octree_dwconv``.

On CUDA tensors the wrappers launch the kernels; on CPU tensors they run
the plain versions beside them. Forward only: the probes have no
backward.
"""
from __future__ import annotations

import ctypes

import torch

from hotformerloc_torch.ops import conv as plain
from hotformerloc_torch.ops import kernels
from hotformerloc_torch.ops.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
K_TAPS = 27
# dwconv_resident's cluster sizes, the default first: 16 blocks (a
# non-portable cluster) hold a sample's 256 bf16 channels, 8 (the
# portable limit) half of them
RESIDENT_CLUSTERS = (16, 8)
MAX_CLUSTER = 16
SMS = 132                     # H100 SXM streaming multiprocessors
TAKE_PER_LANE = (1, 2, 4, 8)  # take_rows' vectors a lane (its instances)
# warps of a block in the probe kernels' plans: on the H100 fewer, larger
# blocks launched faster than more, smaller ones that reach every SM
BLOCK_WARPS = 4

def take_rows_reference(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of ``take_rows``."""
    batched = x.dim() == 3
    xb = x if batched else x[None]
    ib = (idx if batched else idx[None]).long().clamp(0, xb.shape[1] - 1)
    B, TN = ib.shape
    out = torch.gather(xb, 1, ib[..., None].expand(B, TN, xb.shape[2]))
    return out if batched else out[0]


def take_plan(rows: int, vecs: int) -> dict:
    """``take_rows``' launch plan for ``rows`` output rows of ``vecs``
    16-byte vectors: {"per_lane": vectors a lane copies, "threads",
    "blocks"}. Each warp copies 32 * per_lane consecutive vectors of the
    flat output, in blocks of ``BLOCK_WARPS`` warps. per_lane is the most
    of ``TAKE_PER_LANE`` that still gives each of the ``SMS`` SMs a block
    (the least where none does), and small enough that a warp's span
    touches at most 32 rows (32 per_lane < 31 vecs + 2), whose indices
    its lanes read in one load."""
    if rows < 1 or vecs < 1:
        raise ValueError(f"take_rows: no plan for {rows} rows of {vecs} "
                         f"vectors")
    total = rows * vecs
    fits = [u for u in TAKE_PER_LANE if 32 * u < 31 * vecs + 2]
    per_lane = max((u for u in fits
                    if -(-total // (32 * u)) >= BLOCK_WARPS * SMS),
                   default=fits[0])
    warps = -(-total // (32 * per_lane))
    return {"per_lane": per_lane, "threads": 32 * BLOCK_WARPS,
            "blocks": -(-warps // BLOCK_WARPS)}


def _check_device(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, t, :] = x[b, clamp(idx[b, t], 0, Nx - 1), :].

    x: (B, Nx, C) or (Nx, C), float32 or bfloat16, contiguous, with rows
    of whole 16-byte vectors (C a multiple of 4 fp32 / 8 bf16); idx:
    (B, TN) or (TN,) int32, contiguous or a view with one stride between
    consecutive indices (such as ``neigh[..., 0]`` of a (B, N, 27)
    table). Returns (B, TN, C) or (TN, C) in x's dtype."""
    if x.device.type == "cpu":
        return take_rows_reference(x, idx)
    _check_device(x, "take_rows")
    batched = x.dim() == 3
    if x.dim() not in (2, 3) or idx.dim() != x.dim() - 1 \
            or (batched and idx.shape[0] != x.shape[0]):
        raise ValueError(f"take_rows: want x (B, Nx, C) with idx (B, TN), "
                         f"or x (Nx, C) with idx (TN,); got "
                         f"{tuple(x.shape)} and {tuple(idx.shape)}")
    build.dtype_code(x)
    if idx.dtype != torch.int32 or idx.device != x.device:
        raise ValueError("take_rows: idx must be int32 on x's device")
    xb = x if batched else x[None]
    ib = idx if batched else idx[None]
    B, Nx, C = xb.shape
    TN = ib.shape[1]
    row_bytes = C * x.element_size()
    if row_bytes % 16 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"take_rows: x must be contiguous and 16-byte "
                         f"aligned with rows of whole 16-byte vectors; got "
                         f"C={C} {x.dtype}")
    istride = ib.stride(1) if TN > 1 else 1
    if B > 1 and ib.stride(0) != TN * istride:
        raise ValueError("take_rows: idx rows must be evenly strided")
    out = torch.empty((B, TN, C), dtype=x.dtype, device=x.device)
    plan = take_plan(B * TN, row_bytes // 16)
    fn = build.bind("gather", "take_rows",
                    [_P] * 3 + [_I] * 7 + [_L, _P])
    err = fn(x.data_ptr(), ib.data_ptr(), out.data_ptr(), B, Nx, TN,
             row_bytes // 16, istride, plan["per_lane"], plan["threads"],
             plan["blocks"], build.stream_ptr(x.device))
    build.check(err, "take_rows")
    kernels.LAUNCHES["take_rows"] += 1
    return out if batched else out[0]


def resident_plan(N: int, C: int, elem_size: int,
                  smem: int = build.SMEM_OPTIN, cluster=None) -> dict:
    """``dwconv_resident``'s plan for x (B, N, C) of ``elem_size``-byte
    elements: {"cluster": blocks per cluster, "slice": channels a cluster
    holds, "rows": rows per block, "smem": a block's shared-memory bytes,
    "clusters_per_sample"}. Tries ``cluster`` if given, else
    ``RESIDENT_CLUSTERS`` in order, and takes the first size with a
    channel slice (the widest dividing C in whole 16-byte vectors) whose
    rows of x, weights, valid-tap lists and mbarrier fit ``smem`` bytes
    (the card's opt-in shared memory per block). Rows per block are a
    multiple of 4. Raises when none fits."""
    for cs in ((cluster,) if cluster else RESIDENT_CLUSTERS):
        if not 1 <= cs <= MAX_CLUSTER or N < 1:
            raise ValueError(f"dwconv_resident: cluster of {cs} blocks "
                             f"(1 to {MAX_CLUSTER}) over N={N} rows")
        rows = -(-N // cs) + 3 & ~3
        for S in range(C, 0, -1):
            need = (rows * S * elem_size + K_TAPS * S * elem_size
                    + 4 * (K_TAPS + 1) * rows + 8)
            if C % S == 0 and S * elem_size % 16 == 0 and need <= smem:
                return {"cluster": cs, "slice": S, "rows": rows,
                        "smem": need, "clusters_per_sample": C // S}
    raise ValueError(f"dwconv_resident: no cluster plan of N={N} rows "
                     f"and C={C} channels fits {smem} bytes of shared "
                     f"memory per block")


def resident_active_clusters(plan: dict, N: int, C: int, dtype,
                             device) -> int:
    """cudaOccupancyMaxActiveClusters of ``plan`` on ``device``'s card:
    how many of its clusters run at once."""
    count = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = build.bind("gather", "dwconv_resident_active_clusters",
                         [_I] * 6 + [ctypes.POINTER(ctypes.c_int)])(
            N, C, plan["cluster"], plan["slice"], plan["rows"],
            build.DTYPE_CODES[str(dtype)], ctypes.byref(count))
    build.check(err, "dwconv_resident_active_clusters")
    return count.value


def dwconv_resident(x: torch.Tensor, neigh: torch.Tensor,
                    w: torch.Tensor, cluster=None) -> torch.Tensor:
    """out[b,n,c] = sum_k w[k,c] * x[b, neigh[b,n,k], c], missing tap (-1)
    = 0, fp32 accumulation; x: (B, N, C) float32/bfloat16, neigh:
    (B, N, 27) int32, w: (27, C) (cast to x's dtype). The same function
    as ``ops/conv.octree_dwconv``, its plain version. ``cluster`` sets the
    blocks per cluster (``resident_plan``; by default the first of
    ``RESIDENT_CLUSTERS`` that fits)."""
    if x.device.type == "cpu":
        return plain.octree_dwconv(x, neigh, w.to(x.dtype))
    _check_device(x, "dwconv_resident")
    if x.dim() != 3 or neigh.shape != (*x.shape[:2], K_TAPS) \
            or neigh.dtype != torch.int32:
        raise ValueError(f"dwconv_resident: want x (B, N, C) and neigh "
                         f"(B, N, 27) int32, got {tuple(x.shape)} and "
                         f"{tuple(neigh.shape)} {neigh.dtype}")
    B, N, C = x.shape
    if w.shape != (K_TAPS, C):
        raise ValueError(f"dwconv_resident: w must be (27, {C}), got "
                         f"{tuple(w.shape)}")
    code = build.dtype_code(x)
    wc = w.to(x.dtype).contiguous()
    for t in (x, neigh, wc):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("dwconv_resident: inputs must be contiguous "
                             f"and on {x.device}")
    if x.data_ptr() % 16 or wc.data_ptr() % 16:
        raise ValueError("dwconv_resident: x and w must be 16-byte aligned")
    plan = resident_plan(N, C, x.element_size(), build.smem_optin(x.device),
                         cluster)
    out = torch.empty_like(x)
    err = build.bind("gather", "dwconv_resident",
                     [_P] * 4 + [_I] * 7 + [_P])(
        x.data_ptr(), neigh.data_ptr(), wc.data_ptr(), out.data_ptr(), B, N,
        C, plan["cluster"], plan["slice"], plan["rows"], code,
        build.stream_ptr(x.device))
    build.check(err, "dwconv_resident")
    kernels.LAUNCHES["dwconv_resident"] += 1
    return out
