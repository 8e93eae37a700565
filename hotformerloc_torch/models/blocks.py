"""Transformer blocks: OctFormer (local windows), H-OSA (windows with one
relay slot each) and RTSA (relay-token self-attention).

Counterparts of hotformerloc_tpu/models/blocks.py. Each residual
branch ends in a DropPath at the block's rate (blocks.py:64-195).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from hotformerloc_torch.models.attention import TokenAttention, WindowAttention
from hotformerloc_torch.models.layers import (CPE, DropPath, LayerScale, Mlp,
                                              layer_norm)
from hotformerloc_torch.ops import window as ow
from hotformerloc_torch.ops.plan import LevelCtx


class OctFormerBlock(nn.Module):
    """CPE -> window MHSA -> MLP, with dilated windows on odd blocks."""

    def __init__(self, dim: int, num_heads: int, patch_size: int,
                 dilation: int = 1, mlp_ratio: float = 4.0,
                 use_rpe: bool = True, layer_scale: Optional[float] = None,
                 drop_path: float = 0.0,
                 device=None):
        super().__init__()
        self.patch_size, self.dilation = patch_size, dilation
        self.use_rpe = use_rpe
        self.cpe = CPE(dim, device=device)
        self.norm1 = layer_norm(dim, device=device)
        self.attn = WindowAttention(dim, num_heads, patch_size, dilation, 0,
                                    use_rpe, device=device)
        self.ls1 = LayerScale(dim, layer_scale, device=device)
        self.norm2 = layer_norm(dim, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, device=device)
        self.ls2 = LayerScale(dim, layer_scale, device=device)
        self.drop1 = DropPath(drop_path)
        self.drop2 = DropPath(drop_path)

    def forward(self, x, ctx: LevelCtx):
        K, D = self.patch_size, self.dilation
        x = x + self.cpe(x, ctx)
        xw = ow.data_to_windows(x, K, D)
        key_mask = ow.window_key_mask(ctx.node_valid, K, D)
        xyz_w = ow.data_to_windows(ctx.xyz, K, D) if self.use_rpe else None
        xw = xw + self.drop1(self.ls1(self.attn(self.norm1(xw), key_mask,
                                                xyz_w)))
        xw = xw + self.drop2(self.ls2(self.mlp(self.norm2(xw))))
        return ow.windows_to_data(xw, K, D)


class HOTFormerBlock(nn.Module):
    """H-OSA block: CPE -> [relay slot | window nodes] MHSA -> MLP, then
    split the relay tokens back out. One relay token per window
    (rt_size 1), dilation 1."""

    def __init__(self, dim: int, num_heads: int, patch_size: int,
                 mlp_ratio: float = 4.0, use_rpe: bool = True,
                 layer_scale: Optional[float] = None,
                 drop_path: float = 0.0,
                 device=None):
        super().__init__()
        self.patch_size = patch_size
        self.use_rpe = use_rpe
        self.cpe = CPE(dim, device=device)
        self.norm1 = layer_norm(dim, device=device)
        self.attn = WindowAttention(dim, num_heads, patch_size, 1, 1,
                                    use_rpe, device=device)
        self.ls1 = LayerScale(dim, layer_scale, device=device)
        self.norm2 = layer_norm(dim, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, device=device)
        self.ls2 = LayerScale(dim, layer_scale, device=device)
        self.drop1 = DropPath(drop_path)
        self.drop2 = DropPath(drop_path)

    def forward(self, x, rt, ctx: LevelCtx):
        """x: (B, N, C) level nodes; rt: (B, W, C) relay tokens."""
        K = self.patch_size
        x = x + self.cpe(x, ctx)
        xw = ow.data_to_windows(x, K)                        # (B, W, K, C)
        node_mask_w = ow.window_key_mask(ctx.node_valid, K)  # (B, W, K)
        rt_valid = node_mask_w.any(dim=-1, keepdim=True)
        t = torch.cat([rt[:, :, None, :], xw], dim=2)        # (B, W, 1+K, C)
        key_mask = torch.cat([rt_valid, node_mask_w], dim=2)
        xyz_w = ow.data_to_windows(ctx.xyz, K) if self.use_rpe else None
        t = t + self.drop1(self.ls1(self.attn(self.norm1(t), key_mask,
                                              xyz_w)))
        t = t + self.drop2(self.ls2(self.mlp(self.norm2(t))))
        return ow.windows_to_data(t[:, :, 1:], K), t[:, :, 0]


class RelayTokenBlock(nn.Module):
    """RTSA: pre-LN masked attention + MLP over the combined multi-scale
    relay tokens (B, M, C)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 layer_scale: Optional[float] = None, drop_path: float = 0.0,
                 device=None):
        super().__init__()
        self.norm1 = layer_norm(dim, device=device)
        self.attn = TokenAttention(dim, num_heads, device=device)
        self.ls1 = LayerScale(dim, layer_scale, device=device)
        self.norm2 = layer_norm(dim, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, device=device)
        self.ls2 = LayerScale(dim, layer_scale, device=device)
        self.drop1 = DropPath(drop_path)
        self.drop2 = DropPath(drop_path)

    def forward(self, rt, rt_mask):
        rt = rt + self.drop1(self.ls1(self.attn(self.norm1(rt), rt_mask)))
        return rt + self.drop2(self.ls2(self.mlp(self.norm2(rt))))
