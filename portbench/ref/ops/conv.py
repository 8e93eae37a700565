# Frozen copy of hotformerloc_torch/ops/conv.py at commit
# 17534d0, for portbench's plain reference: every CUDA kernel call is
# replaced by its plain formulation, data parallelism is dropped; the
# dense-grid CPE and the explicit conv gradients, which no reference path
# calls, are left out.
"""Octree convolutions in plain PyTorch.

``octree_conv`` gathers every tap and multiplies once; ``tap_conv`` and
``tap_dwconv`` (the reference's stride-1 convs) gather and multiply tap
by tap, with the explicit backward of the port's plain K4/K6 versions.
The down-conv has the JAX package's scatter-free backward
(``DownConvFn``: dx is a gather of dy's products, never a scatter), the
transposed conv likewise (``DeconvFn``). ``dense_voxel_index`` maps
raster voxels to nodes (the plan's dense-grid tables).
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from portbench.ref.ops.precision import product


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x: (B, N, C), idx: (B, ...) int with -1 for missing -> (B, ..., C),
    zero rows where idx < 0."""
    B, N, C = x.shape
    flat = idx.reshape(B, -1).long()
    g = torch.gather(x, 1, torch.clamp(flat, min=0)[..., None].expand(
        B, flat.shape[1], C))
    g = g * (flat >= 0)[..., None].to(x.dtype)
    return g.reshape(*idx.shape, C)


def octree_conv(x: torch.Tensor, neigh: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stride-1 octree conv: out[b,n,o] = sum_{k,c} w[k,c,o] *
    x[b, neigh[b,n,k], c] + b[o]. x: (B, N, C), neigh: (B, N, K),
    w: (K, C, O). Products accumulate in fp32."""
    assert neigh.shape[-1] == w.shape[0]
    g = product(_gather_rows(x, neigh))              # (B, N, K, C)
    B, N, K, C = g.shape
    out = (g.reshape(B * N, K * C).float()
           @ product(w).reshape(K * C, -1).float()).to(x.dtype)
    out = out.reshape(B, N, -1)
    if b is not None:
        out = out + b.to(x.dtype)
    return out


def _tap_index(neigh: torch.Tensor) -> torch.Tensor:
    """(K, B*N) rows of ``_padded``'s table for every tap of ``neigh``
    (B, N, K): neigh[b, n, k] + b (N + 1), or the sample's zero row N
    where it is -1."""
    B, N, K = neigh.shape
    base = (torch.arange(B, device=neigh.device) * (N + 1))[:, None, None]
    idx = torch.where(neigh >= 0, neigh.long(), N) + base
    return idx.permute(2, 0, 1).reshape(K, B * N)


def _padded(x: torch.Tensor) -> torch.Tensor:
    """(B (N + 1), C) fp32: each sample's rows, then a zero row."""
    B, N, C = x.shape
    return torch.cat([x.float(), x.new_zeros((B, 1, C), dtype=torch.float32)],
                     1).reshape(B * (N + 1), C)


class TapDwconvFn(torch.autograd.Function):
    """``octree_dwconv`` tap by tap, without the (B, N, K, C) gather:
    out = sum_k w[k] * x[neigh[..., k]] in fp32 (one row gather and one
    fused multiply-add a tap). Backward: dx by the stencil flip identity
    (``octree_dwconv_bwd``), dw[k] = sum over rows of x[neigh[..., k]]
    * dy, tap by tap. Saves x alone."""

    @staticmethod
    def forward(ctx, x, neigh, w):
        ctx.save_for_backward(x, neigh, w)
        return _tap_dwconv(x, neigh, w)

    @staticmethod
    def backward(ctx, dy):
        x, neigh, w = ctx.saved_tensors
        dx = (_tap_dwconv(dy, neigh, w.flip(0), grad=True)
              if ctx.needs_input_grad[0] else None)
        dw = None
        if ctx.needs_input_grad[2]:
            idx, xp = _tap_index(neigh), _padded(x)
            dyf = dy.float().reshape(-1, dy.shape[-1])
            dw = torch.stack([(xp.index_select(0, idx[k]) * dyf).sum(0)
                              for k in range(w.shape[0])]).to(w.dtype)
        return dx, None, dw


def _tap_dwconv(x, neigh, w, grad=False):
    """``grad``: x is an output gradient, which ``product`` leaves as it
    is (its rounding is of forward operands only)."""
    B, N, C = x.shape
    idx = _tap_index(neigh)
    xp, wq = _padded(x if grad else product(x)), product(w).float()
    out = torch.zeros((B * N, C), dtype=torch.float32, device=x.device)
    for k in range(w.shape[0]):
        out.addcmul_(xp.index_select(0, idx[k]), wq[k])
    return out.reshape(B, N, C).to(x.dtype)


def tap_dwconv(x: torch.Tensor, neigh: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """``octree_dwconv`` by ``TapDwconvFn``."""
    return TapDwconvFn.apply(x, neigh, w)


class TapConvFn(torch.autograd.Function):
    """``octree_conv`` tap by tap: out = sum_k x[neigh[..., k]] @ w[k]
    (+ b) in fp32. Backward: dx = the conv of dy with the flipped,
    transposed kernel (``octree_conv_bwd``), dw[k] = x[neigh[..., k]]^T
    dy, db = sum dy over every row. Saves x alone."""

    @staticmethod
    def forward(ctx, x, neigh, w, b):
        ctx.save_for_backward(x, neigh, w)
        ctx.has_b = b is not None
        out = _tap_conv(x, neigh, w)
        return out if b is None else out + b.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, neigh, w = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx = (_tap_conv(dy, neigh, w.flip(0).transpose(1, 2), grad=True)
              if need[0] else None)
        dw = db = None
        dyf = dy.float().reshape(-1, dy.shape[-1])
        if need[2]:
            idx, xp = _tap_index(neigh), _padded(x)
            dw = torch.stack([xp.index_select(0, idx[k]).t() @ dyf
                              for k in range(w.shape[0])]).to(w.dtype)
        if ctx.has_b and need[3]:
            db = dyf.sum(0)
        return dx, None, dw, db


def _tap_conv(x, neigh, w, grad=False):
    """``grad`` as for ``_tap_dwconv``."""
    B, N, _ = x.shape
    idx = _tap_index(neigh)
    xp, wq = _padded(x if grad else product(x)), product(w).float()
    out = torch.zeros((B * N, w.shape[-1]), dtype=torch.float32,
                      device=x.device)
    for k in range(w.shape[0]):
        out.addmm_(xp.index_select(0, idx[k]), wq[k])
    return out.reshape(B, N, -1).to(x.dtype)


def tap_conv(x: torch.Tensor, neigh: torch.Tensor, w: torch.Tensor,
             b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``octree_conv`` by ``TapConvFn``."""
    out = TapConvFn.apply(x, neigh, w, b)
    return out if b is None else out.to(x.dtype)


class DownConvFn(torch.autograd.Function):
    """The stride-2 conv with hotformerloc_tpu/ops/conv.py's custom VJP
    (``_down_core_bwd``): the forward is ``octree_conv`` over the children
    table; the backward reads the inverse tables instead of scattering.

        dx[b, c] = w[octant[b, c]]^T dy[b, parent[b, c]]   (0 where parent
                   is -1), as a gather of P = dy . w^T (B, N_parent * 8,
                   C) at parent * 8 + octant, fp32 products, x's dtype;
        dw[k] = sum_{b,p} x[b, children[b, p, k]] (x) dy[b, p] in fp32,
                   returned in w's dtype;
        db = sum_{b,p} dy[b, p] in fp32, returned in b's dtype.

    children[b, p, o] = c exactly when parent[b, c] = p and octant[b, c]
    = o, so the gather gives what autograd's scatter of the forward's
    gather would, without the scatter."""

    @staticmethod
    def forward(ctx, x, children, parent, octant, w, b):
        ctx.save_for_backward(x, children, parent, octant, w)
        ctx.b_dtype = None if b is None else b.dtype
        return octree_conv(x, children, w, b)

    @staticmethod
    def backward(ctx, dy):
        x, children, parent, octant, w = ctx.saved_tensors
        need = ctx.needs_input_grad
        B, Np, O = dy.shape
        K, C, _ = w.shape
        dyf = dy.reshape(B * Np, O).float()
        dx = dw = db = None
        if need[0]:
            prod = dyf @ w.float().permute(2, 0, 1).reshape(O, K * C)
            rows = torch.where(parent >= 0, parent * K + octant,
                               torch.full_like(parent, -1))
            dx = _gather_rows(prod.reshape(B, Np * K, C),
                              rows).to(x.dtype)
        if need[4]:
            dw = torch.empty((K, C, O), dtype=torch.float32,
                             device=x.device)
            for k in range(K):      # one octant at a time: no (.., 8, C)
                gk = _gather_rows(x, children[..., k]).reshape(B * Np, C)
                torch.mm(gk.float().t(), dyf, out=dw[k])
            dw = dw.to(w.dtype)
        if need[5]:
            db = dyf.sum(0).to(ctx.b_dtype)
        return dx, None, None, None, dw, db


def octree_down_conv(x: torch.Tensor, children: torch.Tensor,
                     w: torch.Tensor, b: Optional[torch.Tensor] = None,
                     parent: Optional[torch.Tensor] = None,
                     octant: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel-2 stride-2 conv: children (B, N_parent, 8), w (8, C, O).
    ``parent``/``octant`` ((B, N_child) each, ``OctreePlan.down_tables``)
    give the scatter-free backward (``DownConvFn``); without them autograd
    differentiates the gather (a scatter), which is fine without
    gradients."""
    if parent is None or octant is None:
        return octree_conv(x, children, w, b)
    return DownConvFn.apply(x, children, parent, octant, w, b)


def _deconv_fwd(x, parent, octant, w, b):
    """out[b, c] = w[octant[b, c]]^T x[b, parent[b, c]] (+ b); 0 before
    the bias where parent is -1. A gather of P = x . w (B, N_parent * 8,
    O), fp32 products, at parent * 8 + octant."""
    B, Np, C = x.shape
    K, _, O = w.shape
    prod = (x.reshape(B * Np, C).float()
            @ w.float().permute(1, 0, 2).reshape(C, K * O))
    rows = torch.where(parent >= 0, parent * K + octant,
                       torch.full_like(parent, -1))
    out = _gather_rows(prod.reshape(B, Np * K, O), rows).to(x.dtype)
    return out if b is None else out + b.to(x.dtype)


class DeconvFn(torch.autograd.Function):
    """The stride-2 transposed conv with hotformerloc_tpu/ops/conv.py's
    custom VJP (``_deconv_core_bwd``), scatter-free both ways:

        dx = the down-conv of dy over ``children`` with w's C and O
             swapped (x's dtype);
        dw[k] = sum_{b,p} x[b, p] (x) dy[b, children[b, p, k]] in fp32
             (children[b, p, k] = c exactly when parent[b, c] = p and
             octant[b, c] = k), in w's dtype;
        db = sum dy in fp32, in b's dtype."""

    @staticmethod
    def forward(ctx, x, parent, octant, children, w, b):
        ctx.save_for_backward(x, children, w)
        ctx.b_dtype = None if b is None else b.dtype
        return _deconv_fwd(x, parent, octant, w, b)

    @staticmethod
    def backward(ctx, dy):
        x, children, w = ctx.saved_tensors
        need = ctx.needs_input_grad
        B, Np, C = x.shape
        K, _, O = w.shape
        dx = dw = db = None
        if need[0]:
            dx = octree_conv(dy, children, w.transpose(1, 2)).to(x.dtype)
        if need[4]:
            xf = x.reshape(B * Np, C).float()
            dw = torch.empty((K, C, O), dtype=torch.float32,
                             device=x.device)
            for k in range(K):
                gk = _gather_rows(dy, children[..., k]).reshape(B * Np, O)
                torch.mm(xf.t(), gk.float(), out=dw[k])
            dw = dw.to(w.dtype)
        if need[5]:
            db = dy.float().sum((0, 1)).to(ctx.b_dtype)
        return dx, None, None, None, dw, db


def octree_deconv(x: torch.Tensor, parent: torch.Tensor,
                  octant: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None,
                  children: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel-2 stride-2 transposed conv (upsample), the adjoint of
    ``octree_down_conv``: x (B, N_parent, C), parent and octant (B,
    N_child) (parent -1 = padding), w (8, C, O). ``children`` (B,
    N_parent, 8) gives the scatter-free backward (``DeconvFn``); without
    it autograd differentiates the gather. Plain tensor code, as XLA
    computes it in the JAX package."""
    assert w.shape[0] == 8
    if children is None:
        return _deconv_fwd(x, parent, octant, w, b)
    return DeconvFn.apply(x, parent, octant, children, w, b)


# -- dense-grid depthwise conv (the JAX package's coarse-depth CPE) --------


@lru_cache(maxsize=None)
def _morton_of_raster(depth: int) -> np.ndarray:
    """Constant (V,) Morton key of every raster-ordered voxel."""
    D = 2 ** depth
    r = np.arange(D, dtype=np.int64)
    x, y, z = np.meshgrid(r, r, r, indexing="ij")

    def spread(v):
        out = np.zeros_like(v)
        for i in range(depth):
            out |= ((v >> i) & 1) << (3 * i)
        return out

    key = (spread(x) << 2) | (spread(y) << 1) | spread(z)
    return key.reshape(-1).astype(np.int32)


def dense_voxel_index(keys: torch.Tensor, counts: torch.Tensor,
                      depth: int) -> torch.Tensor:
    """(B, V) node index of every raster voxel, -1 where empty."""
    from portbench.ref.octree.neigh import lookup
    B = keys.shape[0]
    q = torch.as_tensor(_morton_of_raster(depth), device=keys.device)
    return lookup(keys, counts, q[None].expand(B, -1))
