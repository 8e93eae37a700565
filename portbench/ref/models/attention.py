# Frozen copy of hotformerloc_torch/models/attention.py at commit
# 17534d0, for portbench's plain reference: every CUDA kernel call is
# replaced by its plain formulation, data parallelism is dropped.
"""Attention modules: windowed (H-OSA / OctFormer) attention, relay-token
attention (RTSA core) and attentional pooling.

Counterparts of hotformerloc_tpu/models/attention.py. Logits and softmax
are fp32 whatever the compute dtype. ``WindowAttention`` has two paths
over the same parameters: ``WindowAttentionFn`` (ops/kernels/
window_attn.py: the K1 CUDA kernel forward, K2 backward) and the plain
einsum formulation differentiated by autograd (``use_kernels = False``).
They differ only on query rows whose slot is invalid, which the kernel
zeroes and no consumer reads, so their gradients agree too.

Dropout (``attn_drop`` on the attention weights, ``proj_drop`` after the
output projection; 0.0 in every shipped config) is active in train mode
only. With attention dropout in training the JAX package leaves its
Pallas kernel for its XLA einsum formulation (hotformerloc_tpu/models/
attention.py ``can_fuse``), the one case where it does; ``WindowAttention``
does the same and runs its einsum formulation, the counterpart of JAX's
XLA path (not K1's plain version standing in for the kernel). In eval
mode, or with ``proj_drop`` alone, K1/K2 run.
"""
from __future__ import annotations

import torch
from torch import nn

from portbench.ref.models.layers import (Dropout, linear, param,
                                              rpe_pos_bnd)
from portbench.ref.ops.precision import product
from portbench.ref.ops.rpe import rpe_bias
from portbench.ref.ops.window import MASK_VALUE


def masked_softmax(logits: torch.Tensor, key_mask: torch.Tensor,
                   mask_batch_dims: int) -> torch.Tensor:
    """fp32 softmax over the last axis with a boolean key mask that
    broadcasts over the ``mask_batch_dims`` axes before the key axis."""
    add = torch.where(key_mask, 0.0, MASK_VALUE).to(torch.float32)
    for _ in range(mask_batch_dims):
        add = add.unsqueeze(-2)
    return torch.softmax(logits.float() + add, dim=-1)


class WindowAttention(nn.Module):
    """Windowed MHSA over (B, W, T, C) tokens with T = G + K: G relay
    slots (no RPE bias) then K window nodes."""

    def __init__(self, dim: int, num_heads: int, patch_size: int,
                 dilation: int = 1, rt_per_window: int = 0,
                 use_rpe: bool = True, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.rt_per_window = rt_per_window
        self.bnd = rpe_pos_bnd(patch_size, dilation)
        self.qkv = linear(dim, 3 * dim, device=device)
        self.rpe_table = (param((3 * (2 * self.bnd + 1), num_heads),
                                "trunc", 0.02, device=device)
                          if use_rpe else None)
        self.proj = linear(dim, dim, device=device)
        self.attn_drop = Dropout(attn_drop)
        self.proj_drop = Dropout(proj_drop)

    def forward(self, x, key_mask, xyz_w=None, coord_range=None):
        """x: (B, W, T, C); key_mask: (B, W, T) bool; xyz_w: (B, W, K, 3)
        int window node coords (None disables the RPE), all below
        ``coord_range`` (2^depth; the einsum route's table gradient
        needs it, as JAX's does)."""
        B, W, T, C = x.shape
        H = self.num_heads
        G = self.rt_per_window
        K = T - G
        hd = C // H
        use_rpe = self.rpe_table is not None and xyz_w is not None
        qkv = self.qkv(x)
        drop = self.attn_drop
        qkv = qkv.reshape(B, W, T, 3, H, hd)
        q, k, v = qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]
        logits = torch.einsum("bwthd,bwshd->bwhts", product(q).float(),
                              product(k).float()) * hd ** -0.5
        if use_rpe:
            bias = rpe_bias(self.rpe_table.t(), xyz_w, self.bnd,
                            coord_range).float()
            logits[..., G:, G:] = logits[..., G:, G:] + bias
        attn = drop(masked_softmax(logits, key_mask, 2))
        out = torch.einsum("bwhts,bwshd->bwthd",
                           product(attn.to(x.dtype)), product(v))
        out = out.reshape(B, W, T, C)
        return self.proj_drop(self.proj(out))


class TokenAttention(nn.Module):
    """Global masked MHSA over (B, M, C) tokens (the RTSA core)."""

    def __init__(self, dim: int, num_heads: int, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = linear(dim, 3 * dim, device=device)
        self.proj = linear(dim, dim, device=device)
        self.attn_drop = Dropout(attn_drop)
        self.proj_drop = Dropout(proj_drop)

    def forward(self, x, key_mask):
        B, M, C = x.shape
        H = self.num_heads
        hd = C // H
        qkv = self.qkv(x).reshape(B, M, 3, H, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        logits = torch.einsum("bthd,bshd->bhts", product(q).float(),
                              product(k).float()) * hd ** -0.5
        attn = self.attn_drop(masked_softmax(logits, key_mask, 2))
        out = torch.einsum("bhts,bshd->bthd", product(attn.to(x.dtype)),
                           product(v))
        return self.proj_drop(self.proj(out.reshape(B, M, C)))


class AdaptivePooling(nn.Module):
    """k learnable queries attend over the input tokens (SALSA pooling):
    (B, M, C) with a (B, M) key mask -> (B, k, C)."""

    def __init__(self, feature_dim: int, k_pooled_tokens: int, device=None):
        super().__init__()
        self.feature_dim = feature_dim
        self.query = param((k_pooled_tokens, feature_dim), "normal", 1.0,
                           device=device)

    def forward(self, x, key_mask):
        logits = torch.einsum("kc,bmc->bkm", product(self.query.float()),
                              product(x).float())
        attn = masked_softmax(logits * self.feature_dim ** -0.5, key_mask, 1)
        return torch.einsum("bkm,bmc->bkc", product(attn.to(x.dtype)),
                            product(x))
