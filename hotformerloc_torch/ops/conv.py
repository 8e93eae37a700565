"""Octree convolutions in plain PyTorch.

Counterparts of hotformerloc_tpu/ops/conv.py. ``octree_conv`` and
``octree_dwconv`` with their explicit gradients ``octree_conv_bwd`` and
``octree_dwconv_bwd`` are the plain versions of the CUDA kernels in
ops/kernels/octree_conv.py. The down-conv is plain tensor code, as XLA
computes it in the JAX package; given the inverse tables (``parent``,
``octant``) it has the JAX package's scatter-free backward
(``DownConvFn``: dx is a gather of dy's products, never a scatter);
the transposed conv ``octree_deconv`` likewise (``DeconvFn``).
``octree_dwconv_dense`` is the counterpart of the JAX package's
dense-grid CPE conv; the model does not call it (every CPE runs
``octree_dwconv``, the same function), and chip_smoke.py times its cuDNN
conv3d as K3's library yardstick.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


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
    g = _gather_rows(x, neigh)                       # (B, N, K, C)
    B, N, K, C = g.shape
    out = (g.reshape(B * N, K * C).float()
           @ w.reshape(K * C, -1).float()).to(x.dtype)
    out = out.reshape(B, N, -1)
    if b is not None:
        out = out + b.to(x.dtype)
    return out


def octree_dwconv(x: torch.Tensor, neigh: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """Depthwise octree conv: out[b,n,c] = sum_k w[k,c] *
    x[b, neigh[b,n,k], c]. x: (B, N, C), neigh: (B, N, K), w: (K, C)."""
    assert neigh.shape[-1] == w.shape[0]
    g = _gather_rows(x, neigh)                       # (B, N, K, C)
    return torch.einsum("bnkc,kc->bnc", g.float(), w.float()).to(x.dtype)


def octree_dwconv_bwd(x: torch.Tensor, neigh: torch.Tensor, w: torch.Tensor,
                      dy: torch.Tensor, need_dx: bool = True):
    """Gradients of ``octree_dwconv`` (the plain version of K4):
    dx = octree_dwconv(dy, neigh, w[::-1]) by the stencil flip identity
    neigh[m, k] = n <=> neigh[n, K-1-k] = m, which holds for the 27-tap
    tables because padding rows are all -1; dw[k, c] = sum_{b,n}
    x[b, neigh[b,n,k], c] * dy[b, n, c]. Returns (dx in x's dtype or
    None, dw fp32)."""
    dx = octree_dwconv(dy, neigh, w.flip(0)) if need_dx else None
    g = _gather_rows(x, neigh)                       # (B, N, K, C)
    dw = torch.einsum("bnkc,bnc->kc", g.float(), dy.float())
    return dx, dw


def octree_conv_bwd(x: torch.Tensor, neigh: torch.Tensor, w: torch.Tensor,
                    dy: torch.Tensor, need_dx: bool = True):
    """Gradients of ``octree_conv`` (the plain version of K6):
    dx = octree_conv(dy, neigh, flip-transpose(w)) with flip-transpose(w)
    = swap(w[::-1], 1, 2); dw[k, c, o] = sum_{b,n} x[b, neigh[b,n,k], c] *
    dy[b, n, o]; db = sum_{b,n} dy[b, n] over every row, padding rows
    included. Returns (dx in x's dtype or None, dw fp32, db fp32)."""
    dx = (octree_conv(dy, neigh, w.flip(0).transpose(1, 2), None)
          if need_dx else None)
    g = _gather_rows(x, neigh)                       # (B, N, K, C)
    dw = torch.einsum("bnkc,bno->kco", g.float(), dy.float())
    return dx, dw, dy.float().sum((0, 1))


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


def global_pool(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Masked mean over nodes: x (B, N, C), valid (B, N) -> (B, C)."""
    vf = valid.to(x.dtype)
    s = torch.einsum("bnc,bn->bc", x, vf)
    return s / torch.clamp(vf.sum(1), min=1.0)[:, None]


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
    from hotformerloc_torch.octree.neigh import lookup, on_device
    B = keys.shape[0]
    q = on_device(_morton_of_raster, keys.device, depth)
    return lookup(keys, counts, q[None].expand(B, -1))


class DepthwiseConv3d(torch.autograd.Function):
    """conv3d(x, wk, padding=1, groups=C) for x (B, C, D, D, D), wk
    (C, 1, 3, 3, 3): cuDNN's forward, and an explicit backward by the 27
    shifted products in fp32. Autograd's own backward goes through
    cuDNN's grouped 3-D weight-gradient engine, which launches one kernel
    per channel and made the dense-grid CPE most of the train step's
    device time on the H100 (hotformerloc_torch/tools/profile_step.py)."""

    @staticmethod
    def forward(ctx, x, wk):
        ctx.save_for_backward(x, wk)
        return F.conv3d(x, wk, padding=1, groups=x.shape[1])

    @staticmethod
    def backward(ctx, dout):
        x, wk = ctx.saved_tensors
        B, C, D = x.shape[:3]
        xp = F.pad(x.float(), (1,) * 6)
        gp = F.pad(dout.float(), (1,) * 6)
        g = dout.float()
        w = wk.reshape(C, 27).float()
        dx = torch.zeros_like(g) if ctx.needs_input_grad[0] else None
        dw = torch.empty((C, 27), dtype=torch.float32, device=x.device)
        # out[z] = sum_k w[k] xp[z + k]  =>  dx[i] = sum_k w[k] gp[i + 2 - k]
        for k in range(27):
            a, b, c = k // 9, (k // 3) % 3, k % 3
            dw[:, k] = (xp[:, :, a:a + D, b:b + D, c:c + D] * g).sum(
                (0, 2, 3, 4))
            if dx is not None:
                dx.add_(gp[:, :, 2 - a:2 - a + D, 2 - b:2 - b + D,
                           2 - c:2 - c + D] * w[:, k].view(1, C, 1, 1, 1))
        return (None if dx is None else dx.to(x.dtype),
                dw.view(C, 1, 3, 3, 3).to(wk.dtype)
                if ctx.needs_input_grad[1] else None)


def octree_dwconv_dense(x: torch.Tensor, xyz: torch.Tensor,
                        valid: torch.Tensor, w: torch.Tensor, depth: int,
                        vox_idx: torch.Tensor) -> torch.Tensor:
    """Depthwise octree conv through a dense (B, C, D, D, D) voxel grid,
    equal to ``octree_dwconv`` with the depth's neighbour table.
    w: (27, C) in raster tap order, which is the (3, 3, 3) kernel layout.
    fp32 inputs need ``torch.backends.cudnn.allow_tf32 = False`` on the
    card for full precision (the embed entry point sets it)."""
    B, N, C = x.shape
    D = 2 ** depth
    dense = _gather_rows(x, vox_idx)                 # (B, V, C)
    dense = dense.reshape(B, D, D, D, C).permute(0, 4, 1, 2, 3)
    wk = w.t().reshape(C, 1, 3, 3, 3).to(x.dtype)
    out = DepthwiseConv3d.apply(dense, wk)           # (B, C, D, D, D)
    out = out.permute(0, 2, 3, 4, 1).reshape(B, D ** 3, C)
    vid = (xyz[..., 0] * D + xyz[..., 1]) * D + xyz[..., 2]
    vid = torch.where(valid, vid, torch.full_like(vid, -1))
    return _gather_rows(out, vid)

