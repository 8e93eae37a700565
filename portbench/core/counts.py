"""The benchmark's own work counts: valid nodes, valid taps and windows
per depth, worked out from the points by the reference's octree, and
the operations and bytes of a forward from the configuration's widths.

A count is the same whatever kernel does the work: it counts what the
model needs on valid nodes, not what a kernel touches at padded
capacity.

- Linear layers (qkv, proj, MLP, ADaPE, the mixer): 2·fin·fout per
  valid token.
- Window attention (K1): QK^T and PV, 4·T²·C per window that holds a
  valid node (T = window nodes + relay slots); the backward (K2) 10·T²·C
  (QK^T again, dV, dP, dQ, dK). Bytes: q, k, v and the output once in
  the forward (4·T·C), q, k, v, dO read and dq, dk, dv written in the
  backward (7·T·C), 2 bytes each (bf16), and the RPE table once a call.
- Relay-token attention (RTSA): 4·m²·C over the m valid relay tokens.
- Octree convs: 2·C·O per valid tap (27-tap convs), 2·C per valid tap
  (the CPE's depthwise conv), 2·C·O per valid child (stride-2 convs).
- Pooling: 4·k·C·n per level (logits and weighted sum over n valid
  nodes).

Norms, softmax, GELU and other elementwise work are not counted.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from portbench.ref.models.config import ADAPE_STATS, ModelConfig
from portbench.ref.models.hotformerloc import build_model_plan

BF16 = 2


@dataclasses.dataclass
class Level:
    """Per-sample counts at one depth (lists over samples)."""
    nodes: List[int]
    taps: List[int]                   # valid entries of valid rows' 27


def windows(n: int, patch: int, dilation: int = 1) -> int:
    """Windows holding at least one of the first ``n`` nodes
    (ops/window.py ``data_to_windows``: window w of each block of
    patch·dilation nodes holds every dilation-th node)."""
    block = patch * dilation
    full, rem = divmod(n, block)
    return full * dilation + min(dilation, rem)


def level_counts(cfg: ModelConfig, points: torch.Tensor,
                 chunk: int = 64) -> Dict[int, Level]:
    """{depth: Level} of ``points`` (S, P, 3) on their device, from the
    reference's octree and neighbour tables, ``chunk`` samples at a
    time."""
    out: Dict[int, Level] = {}
    pm = torch.ones(points.shape[:2], dtype=torch.bool, device=points.device)
    for i in range(0, points.shape[0], chunk):
        plan = build_model_plan(cfg, points[i:i + chunk], pm[i:i + chunk],
                                tap_lists=False)
        oc = plan.octree
        for d in range(oc.min_depth, oc.depth + 1):
            valid = oc.node_valid(d)
            nb = plan.neighs[oc.level(d)]
            taps = ((nb >= 0) & valid[..., None]).sum((1, 2))
            lev = out.setdefault(d, Level([], []))
            lev.nodes += valid.sum(1).tolist()
            lev.taps += taps.tolist()
    return out


def _check(cfg: ModelConfig) -> None:
    if (cfg.pooling != "PyramidAttnPoolMixer" or cfg.xcpe or cfg.disable_rt
            or cfg.octf_use_rt or cfg.rt_propagation
            or not cfg.downsample_input_embeddings):
        raise NotImplementedError("counts cover the shipped HOTFormerLoc "
                                  "models only")


def forward_counts(cfg: ModelConfig, lev: Dict[int, Level], s: int
                   ) -> Dict[str, float]:
    """Sample ``s``'s forward: {'flops': every counted product,
    'attn_flops', 'attn_bytes': the window attention (K1) calls alone,
    'attn_bwd_flops', 'attn_bwd_bytes': their backward (K2)}."""
    _check(cfg)
    n = {d: lev[d].nodes[s] for d in lev}
    taps = {d: lev[d].taps[s] for d in lev}
    f = 0.0
    att = {"attn_flops": 0.0, "attn_bytes": 0.0, "attn_bwd_flops": 0.0,
           "attn_bwd_bytes": 0.0}
    bnd = int(0.8 * cfg.patch_size * cfg.dilation ** 0.5)
    table = 3 * (2 * bnd + 1) * 4

    def window_attn(w, T, C, H):
        att["attn_flops"] += 4.0 * T * T * C * w
        att["attn_bytes"] += 4.0 * T * C * w * BF16 + table * H
        att["attn_bwd_flops"] += 10.0 * T * T * C * w
        att["attn_bwd_bytes"] += 7.0 * T * C * w * BF16 + 2 * table * H
        return 4.0 * T * T * C * w

    def block_linear(tokens, C, ratio):
        hidden = int(C * ratio)
        return 2.0 * tokens * (3 * C * C + C * C + 2 * C * hidden)

    # stem: num_down x [27-tap conv, stride-2 conv], then a 27-tap proj
    D = cfg.octree_depth
    dim = cfg.channels[0]
    chans = [int(dim * 2 ** i) for i in range(-cfg.stem_down, 1)]
    prev = cfg.in_channels if cfg.input_features == "P" else None
    if prev is None:
        raise NotImplementedError("counts take input feature 'P' only")
    for i in range(cfg.stem_down):
        f += 2.0 * prev * chans[i] * taps[D - i]
        f += 2.0 * chans[i] * chans[i + 1] * n[D - i]
        prev = chans[i + 1]
    d = cfg.transformer_depth
    f += 2.0 * prev * dim * taps[d]
    octf_ch, pyr_ch = cfg.stage_channels()
    octf_h, pyr_h = cfg.stage_heads()
    # OctFormer stage(s): CPE, window attention (dilation on odd blocks)
    for i in range(cfg.num_octf_levels):
        C, H = octf_ch[i], octf_h[i]
        for b in range(cfg.num_blocks[i]):
            dil = 1 if b % 2 == 0 else cfg.dilation
            w = windows(n[d], cfg.patch_size, dil)
            f += 2.0 * C * taps[d] + block_linear(n[d], C, cfg.mlp_ratio)
            f += window_attn(w, cfg.patch_size, C, H)
        f += 2.0 * C * cfg.channels[i + 1] * n[d]      # octf_down
        d -= 1
    # HOTFormer stage: pyramid downsamples, relay-token init, iterations
    depths = [d - j for j in range(cfg.num_pyramid_levels)]
    for j in range(len(depths) - 1):
        f += 2.0 * pyr_ch[j] * pyr_ch[j + 1] * n[depths[j]]
    G = cfg.rt_size
    chunk = cfg.patch_size // G
    rts = [windows(n[dj], chunk) for dj in depths]
    max_ch = max(pyr_ch)
    nstats = ADAPE_STATS[cfg.adape_mode]
    for j, dj in enumerate(depths):
        if nstats:
            f += 2.0 * rts[j] * (nstats * max_ch + max_ch * max_ch)
            if cfg.use_projections:
                f += 2.0 * rts[j] * max_ch * pyr_ch[j]
        if cfg.use_projections:
            f += 2.0 * rts[j] * pyr_ch[j] * max_ch
    m = sum(rts)
    T = cfg.patch_size + G
    for _ in range(cfg.num_blocks[-1]):
        f += block_linear(m, max_ch, cfg.mlp_ratio) + 4.0 * m * m * max_ch
        for j, dj in enumerate(depths):
            C, H = pyr_ch[j], pyr_h[j]
            w = windows(n[dj], cfg.patch_size)
            tokens = n[dj] + G * w
            if cfg.use_projections:
                f += 2.0 * 2 * rts[j] * max_ch * C
            f += 2.0 * C * taps[dj] + block_linear(tokens, C, cfg.mlp_ratio)
            f += window_attn(w, T, C, H)
    # PyramidAttnPool + mixer
    feat = cfg.feature_size
    for j, dj in enumerate(depths):
        f += 4.0 * cfg.k_pooled_tokens[j] * pyr_ch[j] * n[dj]
        if pyr_ch[j] != feat:
            f += 2.0 * cfg.k_pooled_tokens[j] * pyr_ch[j] * feat
    k = sum(cfg.k_pooled_tokens)
    k_out = k // 4
    out_d = cfg.output_dim // k_out
    f += 4 * (4.0 * feat * feat * k)                 # mix_depth 4, ratio 1
    f += 2.0 * k * k_out * feat + 2.0 * feat * out_d * k_out
    return dict(att, flops=f)


def batch_counts(cfg: ModelConfig, lev: Dict[int, Level],
                 samples: List[int]) -> Dict[str, float]:
    """``forward_counts`` summed over ``samples``."""
    tot: Dict[str, float] = {}
    for s in samples:
        for key, v in forward_counts(cfg, lev, s).items():
            tot[key] = tot.get(key, 0.0) + v
    return tot
