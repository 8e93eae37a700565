"""Descriptor head: per-level attentional pooling + MLP-mixer
(PyramidAttnPoolMixer, the head of every shipped config).

Counterpart of the mixer path of hotformerloc_tpu/models/pooling.py.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from hotformerloc_torch.models.attention import AdaptivePooling
from hotformerloc_torch.models.layers import layer_norm, linear


class FeatureMixerLayer(nn.Module):
    """Residual LayerNorm -> Linear -> GELU -> Linear over channels."""

    def __init__(self, dim: int, mlp_ratio: float = 1.0, device=None):
        super().__init__()
        self.norm1 = layer_norm(dim, device=device)
        self.fc1 = linear(dim, int(dim * mlp_ratio), device=device)
        self.fc2 = linear(int(dim * mlp_ratio), dim, device=device)

    def forward(self, x):
        return x + self.fc2(F.gelu(self.fc1(self.norm1(x))))


class Mixer(nn.Module):
    """mix_depth mixer layers, token projection k_in -> k_out, channel
    projection in_d -> out_d, flatten."""

    def __init__(self, k_in: int, k_out: int, in_d: int, out_d: int,
                 mix_depth: int = 4, mlp_ratio: float = 1.0, device=None):
        super().__init__()
        self.mix_depth = mix_depth
        for i in range(mix_depth):
            self.add_module(f"mix{i}", FeatureMixerLayer(in_d, mlp_ratio,
                                                         device=device))
        self.channel_proj = linear(k_in, k_out, device=device)
        self.row_proj = linear(in_d, out_d, device=device)

    def forward(self, x):
        for i in range(self.mix_depth):
            x = getattr(self, f"mix{i}")(x)
        x = self.channel_proj(x.transpose(1, 2)).transpose(1, 2)
        x = self.row_proj(x)
        return x.reshape(x.shape[0], -1)


class PyramidAttnPool(nn.Module):
    """Attention-pool each pyramid level to k_j tokens, concatenate, and
    aggregate with the mixer into an ``output_dim`` descriptor."""

    def __init__(self, feature_size: int, output_dim: int,
                 channels: Sequence[int], k_pooled_tokens: Sequence[int],
                 mix_depth: int = 4, mlp_ratio: float = 1.0, device=None):
        super().__init__()
        self.levels = len(channels)
        self.proj_levels = [j for j, c in enumerate(channels)
                            if c != feature_size]
        for j in range(self.levels):
            self.add_module(f"attpool{j}", AdaptivePooling(
                channels[j], k_pooled_tokens[j], device=device))
            if j in self.proj_levels:
                self.add_module(f"local_proj{j}", linear(
                    channels[j], feature_size, device=device))
        k_total = sum(k_pooled_tokens)
        k_out = k_total // 4
        out_d = output_dim // k_out
        if k_out * out_d != output_dim:
            raise ValueError(f"k_pooled_tokens {tuple(k_pooled_tokens)} "
                             f"incompatible with output_dim {output_dim}")
        self.mixer = Mixer(k_total, k_out, feature_size, out_d, mix_depth,
                           mlp_ratio, device=device)

    def forward(self, tokens_per_level, masks_per_level):
        pooled = []
        for j, (x, m) in enumerate(zip(tokens_per_level, masks_per_level)):
            t = getattr(self, f"attpool{j}")(x, m)
            if j in self.proj_levels:
                t = getattr(self, f"local_proj{j}")(t)
            pooled.append(t)
        return self.mixer(torch.cat(pooled, dim=1))
