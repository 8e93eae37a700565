# Frozen copy of hotformerloc_torch/models/pooling.py at commit
# 17534d0, for portbench's plain reference: every CUDA kernel call is
# replaced by its plain formulation, data parallelism is dropped.
"""Descriptor heads: per-level attentional pooling + MLP-mixer
(PyramidAttnPoolMixer, the head of every shipped config), the relay-token
attention pool (AttnPool), the GeM family (GeM, PyramidGeM with optional
context gating) and NetVLAD.

Counterpart of hotformerloc_tpu/models/pooling.py. The heads' BatchNorms
are flax ``nn.BatchNorm`` there, with flax's defaults (layers.py
``BatchNorm``: momentum 0.99, statistics over every row).
"""
from __future__ import annotations

from typing import Sequence

import math

import torch
import torch.nn.functional as F
from torch import nn

from portbench.ref.models.attention import AdaptivePooling
from portbench.ref.models.layers import (BatchNorm, Mlp, cast,
                                              layer_norm, linear, param)


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, N, C) mean over the rows ``mask`` (B, N) marks."""
    w = mask.to(x.dtype)
    s = torch.einsum("bnc,bn->bc", x, w)
    return s / torch.clamp(w.sum(1), min=1.0)[:, None]


class GeM(nn.Module):
    """Generalised-mean pooling over valid nodes: clamp(eps)^p -> masked
    mean -> ^(1/p), learnable p, in fp32."""

    def __init__(self, p_init: float = 3.0, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.p = param((1,), "const", p_init, device=device)

    def forward(self, x, mask):
        p = self.p.float()
        xf = torch.clamp(x.float(), min=self.eps) ** p
        return (masked_mean(xf, mask) ** (1.0 / p)).to(x.dtype)


class GatingContext(nn.Module):
    """NetVLAD's context gating: x * sigmoid(BN(x W)) (x W + b without
    the BatchNorm)."""

    def __init__(self, dim: int, add_batch_norm: bool = True, device=None):
        super().__init__()
        self.gating_weights = linear(dim, dim, bias=not add_batch_norm,
                                     device=device)
        self.gating_bn = (BatchNorm(dim, device=device) if add_batch_norm
                          else None)

    def forward(self, x):
        g = self.gating_weights(x)
        if self.gating_bn is not None:
            g = self.gating_bn(g)
        return x * torch.sigmoid(g)


class NetVLADLoupe(nn.Module):
    """NetVLAD aggregation: soft-assign the tokens (B, N, C) to K
    clusters (BatchNorm over the assignment logits of every row, padding
    included, as in the JAX package), mask, aggregate the residuals,
    normalise per cluster and overall, project to ``output_dim`` and
    gate. No model builds it."""

    def __init__(self, feature_size: int, cluster_size: int,
                 output_dim: int, gating: bool = True,
                 add_batch_norm: bool = True, device=None):
        super().__init__()
        C, K = feature_size, cluster_size
        std = 1.0 / math.sqrt(C)
        self.cluster_weights = param((C, K), "normal", std, device=device)
        if add_batch_norm:
            self.assign_bn = BatchNorm(K, device=device)
        else:
            self.cluster_biases = param((K,), "normal", std, device=device)
        self.add_batch_norm = add_batch_norm
        self.cluster_weights2 = param((1, C, K), "normal", std,
                                      device=device)
        self.hidden = linear(K * C, output_dim, device=device)
        self.gating = (GatingContext(output_dim, add_batch_norm,
                                     device=device) if gating else None)

    def forward(self, x, mask):
        B, N, C = x.shape
        a = torch.einsum("bnc,ck->bnk", x, cast(self.cluster_weights, x))
        a = (self.assign_bn(a) if self.add_batch_norm
             else a + cast(self.cluster_biases, a))
        a = torch.softmax(a, dim=-1) * mask[..., None].to(a.dtype)
        a_sum = a.sum(1, keepdim=True)                       # (B, 1, K)
        vlad = torch.einsum("bnk,bnc->bkc", a, x)
        vlad = vlad - (a_sum * cast(self.cluster_weights2, a)).transpose(1, 2)
        vlad = vlad / torch.clamp(vlad.norm(dim=-1, keepdim=True), min=1e-12)
        vlad = vlad.reshape(B, -1)
        vlad = vlad / torch.clamp(vlad.norm(dim=-1, keepdim=True), min=1e-12)
        out = self.hidden(vlad)
        return out if self.gating is None else self.gating(out)


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


def _aggregator(parent: nn.Module, aggregator: str, k_total: int,
                feature_size: int, output_dim: int, mix_depth: int,
                mlp_ratio: float, device) -> None:
    """Register the attention pools' aggregator on ``parent``: ``mixer``
    (the mixer), or for 'gem' the JAX module's unnamed LayerNorm, Mlp and
    GeM as ``norm1``, ``mlp`` and ``gem``."""
    if aggregator.lower() == "mixer":
        k_out = k_total // 4
        out_d = output_dim // k_out
        if k_out * out_d != output_dim:
            raise ValueError(f"k_pooled_tokens {k_total} incompatible with "
                             f"output_dim {output_dim}")
        parent.mixer = Mixer(k_total, k_out, feature_size, out_d, mix_depth,
                             mlp_ratio, device=device)
    elif aggregator.lower() == "gem":
        parent.norm1 = layer_norm(feature_size, device=device)
        parent.mlp = Mlp(feature_size, int(feature_size * mlp_ratio),
                         output_dim, device=device)
        parent.gem = GeM(device=device)
    else:
        raise ValueError(f"unknown aggregator {aggregator}")


def _aggregate(parent: nn.Module, t):
    """The mixer, or t + MLP(LN(t)) and GeM over the pooled tokens."""
    if hasattr(parent, "mixer"):
        return parent.mixer(t)
    t = t + parent.mlp(parent.norm1(t))
    return parent.gem(t, torch.ones(t.shape[:2], dtype=torch.bool,
                                    device=t.device))


class PyramidAttnPool(nn.Module):
    """Attention-pool each pyramid level to k_j tokens, concatenate, and
    aggregate with the mixer ('mixer') or GeM ('gem') into an
    ``output_dim`` descriptor."""

    def __init__(self, feature_size: int, output_dim: int,
                 channels: Sequence[int], k_pooled_tokens: Sequence[int],
                 aggregator: str = "mixer", mix_depth: int = 4,
                 mlp_ratio: float = 1.0, device=None):
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
        _aggregator(self, aggregator, sum(k_pooled_tokens), feature_size,
                    output_dim, mix_depth, mlp_ratio, device)

    def forward(self, tokens_per_level, masks_per_level):
        pooled = []
        for j, (x, m) in enumerate(zip(tokens_per_level, masks_per_level)):
            t = getattr(self, f"attpool{j}")(x, m)
            if j in self.proj_levels:
                t = getattr(self, f"local_proj{j}")(t)
            pooled.append(t)
        return _aggregate(self, torch.cat(pooled, dim=1))


class AttnPool(nn.Module):
    """Relay-token head: attention-pool the combined multi-scale relay
    tokens to k tokens, then the mixer ('mixer') or GeM ('gem')."""

    def __init__(self, feature_size: int, output_dim: int,
                 k_pooled_tokens: int, aggregator: str = "mixer",
                 mix_depth: int = 4, mlp_ratio: float = 1.0, device=None):
        super().__init__()
        self.attpool = AdaptivePooling(feature_size, k_pooled_tokens,
                                       device=device)
        _aggregator(self, aggregator, k_pooled_tokens, feature_size,
                    output_dim, mix_depth, mlp_ratio, device)

    def forward(self, rt, rt_mask):
        return _aggregate(self, self.attpool(rt, rt_mask))


class PyramidGeM(nn.Module):
    """Per-level GeM -> concat -> Linear (no bias) -> BatchNorm (->
    context gating)."""

    def __init__(self, output_dim: int, channels: Sequence[int],
                 gating: bool = False, device=None):
        super().__init__()
        self.levels = len(channels)
        for j in range(self.levels):
            self.add_module(f"gem{j}", GeM(device=device))
        self.linear = linear(sum(channels), output_dim, bias=False,
                             device=device)
        self.bn = BatchNorm(output_dim, device=device)
        self.gating = (GatingContext(output_dim, device=device) if gating
                       else None)

    def forward(self, tokens_per_level, masks_per_level):
        g = torch.cat([getattr(self, f"gem{j}")(x, m) for j, (x, m) in
                       enumerate(zip(tokens_per_level, masks_per_level))],
                      dim=-1)
        g = self.bn(self.linear(g))
        return g if self.gating is None else self.gating(g)
