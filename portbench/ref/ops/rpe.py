# Frozen copy of hotformerloc_torch/ops/rpe.py at commit
# 17534d0, for portbench's plain reference: every CUDA kernel call is
# replaced by its plain formulation, data parallelism is dropped.
"""Relative-position bias by direct table lookup.

Counterpart of hotformerloc_tpu/ops/rpe.py: ``rpe_bias_reference`` per
axis indexes a (3*(2*bnd+1), H) table with the clipped coordinate
difference of every (query, key) pair of a window and sums the axes;
``rpe_bias`` is the same function with JAX's scatter-free table
gradient (three products with per-axis coordinate one-hots), which the
einsum route of the window attention differentiates. Autograd's own
adjoint of the lookup is an index_put with accumulation over B·W·K·K
indices into a table of a few hundred rows; with it, a bf16 train step
whose attention trained with dropout (chip_smoke.py's ablations variant
B, 4 x 8) took 32.0 s on an H100 80GB HBM3 at 700 W, and 1.6 s with
this adjoint.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rpe_index(xyz_w: torch.Tensor, bnd: int):
    """xyz_w: (..., K, 3) int window node coords. Yields, per axis a, the
    (..., K, K) table row a*num + clip(x_a[t] - x_a[s], +-bnd) + bnd of
    every (query t, key s) pair."""
    num = 2 * bnd + 1
    xyz_w = xyz_w.long()
    for a in range(3):
        rel = xyz_w[..., :, None, a] - xyz_w[..., None, :, a]
        yield torch.clamp(rel, -bnd, bnd) + bnd + a * num


def rpe_bias_reference(tab_t: torch.Tensor, xyz_w: torch.Tensor,
                       bnd: int) -> torch.Tensor:
    """tab_t: (H, 3*(2*bnd+1)) transposed table; xyz_w: (B, W, K, 3) int
    window node coords. Returns (B, W, H, K, K) in tab_t.dtype."""
    bias = None
    for ia in rpe_index(xyz_w, bnd):
        ba = tab_t[:, ia]                                # (H, B, W, K, K)
        bias = ba if bias is None else bias + ba
    return bias.permute(1, 2, 0, 3, 4)


class RpeBiasFn(torch.autograd.Function):
    """``rpe_bias_reference`` with hotformerloc_tpu/ops/rpe.py's custom
    VJP: for each axis a, with U_a[b,w,k,p] = 1{x_a[b,w,k] = p} over the
    coordinate range P and FOLD[p,q,j] = 1{clip(p - q, +-bnd) + bnd = j},

        dtable_a[j, h] = sum_{p,q} FOLD[p,q,j] (U_a^T dbias U_a)[h,p,q],

    products in fp32, no scatter."""

    @staticmethod
    def forward(ctx, tab_t, xyz_w, bnd, coord_range):
        ctx.save_for_backward(xyz_w)
        ctx.bnd, ctx.P, ctx.tab_dtype = bnd, coord_range, tab_t.dtype
        return rpe_bias_reference(tab_t, xyz_w, bnd)

    @staticmethod
    def backward(ctx, dbias):
        (xyz_w,) = ctx.saved_tensors
        bnd, P = ctx.bnd, ctx.P
        num = 2 * bnd + 1
        p = torch.arange(P, device=dbias.device)
        fold = F.one_hot(torch.clamp(p[:, None] - p[None, :], -bnd, bnd)
                         + bnd, num).float()                  # (P, P, num)
        g = dbias.float()
        parts = []
        for a in range(3):
            u = F.one_hot(xyz_w[..., a].long(), P).float()   # (B, W, K, P)
            c1 = torch.einsum("bwhts,bwsq->bwhtq", g, u)
            m = torch.einsum("bwtp,bwhtq->hpq", u, c1)
            parts.append(torch.einsum("hpq,pqj->hj", m, fold))
        return torch.cat(parts, 1).to(ctx.tab_dtype), None, None, None


def rpe_bias(tab_t: torch.Tensor, xyz_w: torch.Tensor, bnd: int,
             coord_range: int) -> torch.Tensor:
    """``rpe_bias_reference`` whose table gradient is three products per
    axis instead of a scatter; ``coord_range`` (2^depth) must bound the
    coordinates."""
    return RpeBiasFn.apply(tab_t, xyz_w, bnd, coord_range)
