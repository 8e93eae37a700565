"""Transformer blocks: OctFormer (local windows), H-OSA (windows with G
relay slots each) and RTSA (relay-token self-attention).

Counterparts of hotformerloc_tpu/models/blocks.py. Each residual
branch ends in a DropPath at the block's rate (blocks.py:64-195).
``conv_norm`` and ``xcpe`` select the CPE's norm and conv; ``attn_drop``
and ``proj_drop`` the dropout of the attention and the MLP.

An OctFormer block is one ``hfl.block.osa`` span and counts the valid
nodes it sees (``hfl.block.valid``) against the slots it processes
(``hfl.block.slots``; ``count_block``); the callers of H-OSA and RTSA
blocks open their spans (backbone.py), around the projections too.
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
from hotformerloc_torch.utils import profiling

SPAN_OSA, SPAN_HOSA, SPAN_RTSA = ("hfl.block.osa", "hfl.block.hosa",
                                  "hfl.block.rtsa")


def count_block(valid: torch.Tensor, slots: torch.Tensor) -> None:
    """Count a block's valid tokens (``valid``: per-sample counts or a
    validity mask, summed when the counting scope is read) against its
    slots (``slots``: the mask of every slot it processes; only its
    size is counted)."""
    profiling.count("hfl.block.valid", valid)
    profiling.count("hfl.block.slots", slots.numel())


class _Block(nn.Module):
    """The parts every block has: norm1 -> attention -> LayerScale ->
    DropPath, then norm2 -> MLP -> LayerScale -> DropPath; ``cpe`` (None
    for RTSA) is registered first, which keeps the parameter order, and
    so the seeded initial weights, of the blocks before they shared this
    class."""

    def __init__(self, dim: int, cpe: Optional[nn.Module], attn: nn.Module,
                 mlp_ratio: float, layer_scale: Optional[float],
                 drop_path: float, proj_drop: float, device=None):
        super().__init__()
        if cpe is not None:
            self.cpe = cpe
        self.norm1 = layer_norm(dim, device=device)
        self.attn = attn
        self.ls1 = LayerScale(dim, layer_scale, device=device)
        self.norm2 = layer_norm(dim, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, proj_drop,
                       device=device)
        self.ls2 = LayerScale(dim, layer_scale, device=device)
        self.drop1 = DropPath(drop_path)
        self.drop2 = DropPath(drop_path)

    def residuals(self, t, *attn_args):
        t = t + self.drop1(self.ls1(self.attn(self.norm1(t), *attn_args)))
        return t + self.drop2(self.ls2(self.mlp(self.norm2(t))))


class OctFormerBlock(_Block):
    """CPE -> window MHSA -> MLP, with dilated windows on odd blocks."""

    def __init__(self, dim: int, num_heads: int, patch_size: int,
                 dilation: int = 1, mlp_ratio: float = 4.0,
                 use_rpe: bool = True, layer_scale: Optional[float] = None,
                 drop_path: float = 0.0, conv_norm: str = "layernorm",
                 xcpe: bool = False, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, device=None):
        super().__init__(dim, CPE(dim, conv_norm, xcpe, device=device),
                         WindowAttention(dim, num_heads, patch_size,
                                         dilation, 0, use_rpe, attn_drop,
                                         proj_drop, device=device),
                         mlp_ratio, layer_scale, drop_path, proj_drop,
                         device=device)
        self.patch_size, self.dilation = patch_size, dilation
        self.use_rpe = use_rpe

    def forward(self, x, ctx: LevelCtx):
        with profiling.annotate(SPAN_OSA):
            count_block(ctx.counts, ctx.node_valid)
            K, D = self.patch_size, self.dilation
            x = x + self.cpe(x, ctx)
            xw = ow.data_to_windows(x, K, D)
            key_mask = ow.window_key_mask(ctx.node_valid, K, D)
            xyz_w = (ow.data_to_windows(ctx.xyz, K, D) if self.use_rpe
                     else None)
            return ow.windows_to_data(self.residuals(xw, key_mask, xyz_w,
                                                     2 ** ctx.depth), K, D)


class HOTFormerBlock(_Block):
    """H-OSA block: CPE -> [G relay slots | window nodes] MHSA -> MLP,
    then split the relay tokens back out. Dilation 1. Relay token g of
    window w is row w·G + g of ``rt`` and summarises the window's g-th
    chunk of K/G nodes; its slot is valid iff that chunk has a valid
    node.

    The JAX block's relay-token propagation on a stage's last block
    (``last=True``, blocks.py:156-167) is not ported: no caller sets
    ``last``, and the stage propagates after its loop instead
    (backbone.py ``HOTFormerStage``)."""

    def __init__(self, dim: int, num_heads: int, patch_size: int,
                 mlp_ratio: float = 4.0, use_rpe: bool = True,
                 layer_scale: Optional[float] = None,
                 drop_path: float = 0.0, rt_per_window: int = 1,
                 conv_norm: str = "layernorm", xcpe: bool = False,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 device=None):
        super().__init__(dim, CPE(dim, conv_norm, xcpe, device=device),
                         WindowAttention(dim, num_heads, patch_size, 1,
                                         rt_per_window, use_rpe, attn_drop,
                                         proj_drop, device=device),
                         mlp_ratio, layer_scale, drop_path, proj_drop,
                         device=device)
        self.patch_size, self.rt_per_window = patch_size, rt_per_window
        self.use_rpe = use_rpe

    def forward(self, x, rt, ctx: LevelCtx):
        """x: (B, N, C) level nodes; rt: (B, W·G, C) relay tokens."""
        K, G = self.patch_size, self.rt_per_window
        x = x + self.cpe(x, ctx)
        xw = ow.data_to_windows(x, K)                        # (B, W, K, C)
        B, W = xw.shape[:2]
        node_mask_w = ow.window_key_mask(ctx.node_valid, K)  # (B, W, K)
        rt_valid = node_mask_w.reshape(B, W, G, K // G).any(-1)
        t = torch.cat([rt.reshape(B, W, G, -1), xw], dim=2)  # (B, W, G+K, C)
        key_mask = torch.cat([rt_valid, node_mask_w], dim=2)
        xyz_w = ow.data_to_windows(ctx.xyz, K) if self.use_rpe else None
        t = self.residuals(t, key_mask, xyz_w, 2 ** ctx.depth)
        return (ow.windows_to_data(t[:, :, G:], K),
                t[:, :, :G].reshape(B, W * G, -1))


class RelayTokenBlock(_Block):
    """RTSA: pre-LN masked attention + MLP over the combined multi-scale
    relay tokens (B, M, C)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 layer_scale: Optional[float] = None, drop_path: float = 0.0,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 device=None):
        super().__init__(dim, None, TokenAttention(dim, num_heads, attn_drop,
                                                   proj_drop, device=device),
                         mlp_ratio, layer_scale, drop_path, proj_drop,
                         device=device)

    def forward(self, rt, rt_mask):
        return self.residuals(rt, rt_mask)
