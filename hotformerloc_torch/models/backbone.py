"""HOTFormer backbone: conv stem, OctFormer stage, HOTFormer stage.

Counterpart of hotformerloc_tpu/models/backbone.py. The JAX package runs
the HOTFormer iterations under ``nn.scan`` with stacked parameters; here
they are a Python loop over an ``nn.ModuleList`` (``iters``), and
``convert.params_from_jax`` unstacks the parameters.

DropPath rates follow ``cfg.drop_path_rates()`` in the JAX package's
block order (backbone.py:369-396): the stem has none, then one rate per
OctFormer block, then one per HOTFormer iteration, shared by its RTSA
and its H-OSA blocks.

With ``cfg.grad_checkpoint`` each OctFormer block and each HOTFormer
iteration runs under ``torch.utils.checkpoint`` whenever autograd
records (the JAX package's ``nn.remat`` sites): the backward recomputes
the block from its inputs instead of keeping its activations, but for
what ``cfg.remat_policy`` keeps, as the JAX package's ``_remat`` does
(backbone.py:33-47): None keeps nothing; 'save_attn' keeps the output of
every window attention (K1, the op ``hotformerloc::window_attn``; JAX's
"attn_out" tag); 'save_hot' (the default) keeps those and the output of
every CPE conv (K3, ``hotformerloc::octree_dwconv``, before its
LayerNorm; JAX's "cpe_out"; an xCPE's full conv, K5,
``hotformerloc::octree_conv``, before its Linear), so the backward runs
none of these kernels again. Inside a checkpointed block the only full
octree convs are the xCPEs' (the stem runs outside, the down-convs are
plain code), so keeping ``octree_conv`` keeps the CPE's conv alone.
JAX's tag sits on the output of the xCPE's Linear, which follows the
conv; the port keeps the conv's own output, the one kernel output of
the xCPE.
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from hotformerloc_torch.models.blocks import (SPAN_HOSA, SPAN_RTSA,
                                              HOTFormerBlock, OctFormerBlock,
                                              RelayTokenBlock, count_block)
from hotformerloc_torch.models.config import ADAPE_STATS, ModelConfig
from hotformerloc_torch.models.attention import TokenAttention
from hotformerloc_torch.models.layers import (CPE, ADaPE, Downsample,
                                              DropPath, Dropout,
                                              OctreeConvNormRelu,
                                              OctreeDownConvNormRelu, cast,
                                              layer_norm, linear, param)
from hotformerloc_torch.ops import window as ow
from hotformerloc_torch.ops.plan import OctreePlan
from hotformerloc_torch.utils import profiling


# The kernel ops whose outputs each remat policy keeps.
REMAT_SAVED_OPS = {None: (), "save_attn": ("window_attn",),
                   "save_hot": ("window_attn", "octree_dwconv",
                                "octree_conv")}


def _keep_ops(names):
    """Selective-checkpoint policy: keep the outputs of the ops named,
    recompute every other op."""
    keep = {getattr(torch.ops.hotformerloc, n).default for n in names}

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in keep
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return policy


def run_block(cfg: ModelConfig, block: nn.Module, *args,
              span: Optional[str] = None):
    """``block(*args)``, under activation checkpointing when
    ``cfg.grad_checkpoint`` is set and autograd records, keeping the
    outputs ``cfg.remat_policy`` names (``REMAT_SAVED_OPS``). The DropPath
    masks and Dropout seeds set on the block now are handed to the
    recompute (the model clears them once its forward returns, before the
    backward runs), so the recompute equals the forward. Its running
    statistics are staged again, to the same values (layers.py
    ``RunningStats``). With ``span`` the call is that profiling span, and
    so is the recompute (for a block that opens no span of its own)."""
    def call(*args_):
        if span is None:
            return block(*args_)
        with profiling.annotate(span):
            return block(*args_)

    if not (cfg.grad_checkpoint and torch.is_grad_enabled()):
        return call(*args)
    sites = [(m, "mask" if isinstance(m, DropPath) else "seed")
             for m in block.modules() if isinstance(m, (DropPath, Dropout))]
    drawn = [getattr(m, a) for m, a in sites]

    def run(*args_):
        prev = [getattr(m, a) for m, a in sites]
        for (m, a), v in zip(sites, drawn):
            setattr(m, a, v)
        try:
            return call(*args_)
        finally:
            for (m, a), v in zip(sites, prev):
                setattr(m, a, v)

    saved = REMAT_SAVED_OPS[cfg.remat_policy]
    if not saved:
        return checkpoint(run, *args, use_reentrant=False)
    return checkpoint(run, *args, use_reentrant=False, context_fn=partial(
        create_selective_checkpoint_contexts, _keep_ops(saved)))


class PatchEmbed(nn.Module):
    """Conv stem. With ``downsample``: num_down x [27-tap conv -> stride-2
    conv] doubling the channels from dim/2^num_down, then a 27-tap
    projection to ``dim``. Without: num_down 27-tap convs to ``dim`` at
    the finest depth (JAX models/backbone.py:84-90)."""

    def __init__(self, cin: int, dim: int, num_down: int = 2,
                 downsample: bool = True, conv_norm: str = "layernorm",
                 device=None):
        super().__init__()
        self.num_down, self.downsample = num_down, downsample
        if not downsample:
            for i in range(num_down):
                self.add_module(f"conv{i}", OctreeConvNormRelu(
                    cin if i == 0 else dim, dim, conv_norm, device=device))
            return
        chans = [int(dim * 2**i) for i in range(-num_down, 1)]
        prev = cin
        for i in range(num_down):
            self.add_module(f"conv{i}", OctreeConvNormRelu(
                prev, chans[i], conv_norm, device=device))
            self.add_module(f"down{i}", OctreeDownConvNormRelu(
                chans[i], chans[i + 1], conv_norm, device=device))
            prev = chans[i + 1]
        self.proj = OctreeConvNormRelu(prev, dim, conv_norm, device=device)

    def forward(self, x, plan: OctreePlan):
        with profiling.annotate("hfl.stem"):
            return self._forward(x, plan)

    def _forward(self, x, plan: OctreePlan):
        oc = plan.octree
        d = oc.depth
        if not self.downsample:
            ctx = plan.level_ctx(d)
            for i in range(self.num_down):
                x = getattr(self, f"conv{i}")(x, ctx.neigh, ctx.node_valid,
                                              ctx.taps)
            return x
        for i in range(self.num_down):
            ctx = plan.level_ctx(d - i)
            x = getattr(self, f"conv{i}")(x, ctx.neigh, ctx.node_valid,
                                          ctx.taps)
            x = getattr(self, f"down{i}")(x, plan.down_tables(d - i),
                                          oc.node_valid(d - i - 1))
        ctx = plan.level_ctx(d - self.num_down)
        return self.proj(x, ctx.neigh, ctx.node_valid, ctx.taps)


def _block_kw(cfg: ModelConfig) -> dict:
    """The config's options every block takes."""
    return dict(conv_norm=cfg.conv_norm, xcpe=cfg.xcpe,
                attn_drop=cfg.attn_drop, proj_drop=cfg.proj_drop)


class OctFormerStage(nn.Module):
    """num_blocks OctFormer blocks at one depth, dilation 1 / D on even /
    odd blocks. With ``cfg.octf_use_rt`` (JAX models/backbone.py:122-150)
    the blocks are H-OSA blocks over relay tokens of this depth instead
    (G = ``rt_size`` per window, dilation off), each after a LayerNorm
    (``rt_ln{i}``) and a token attention (``rt_attn{i}``) over the
    stage's relay tokens, added back to them."""

    def __init__(self, cfg: ModelConfig, dim: int, num_heads: int,
                 drop_paths: Sequence[float], depth: int, device=None):
        super().__init__()
        self.cfg = cfg
        self.num_blocks = len(drop_paths)
        self.use_rt = cfg.octf_use_rt
        for i, dp in enumerate(drop_paths):
            if self.use_rt:
                self.add_module(f"rt_ln{i}", layer_norm(dim, device=device))
                self.add_module(f"rt_attn{i}", TokenAttention(
                    dim, num_heads, cfg.attn_drop, cfg.proj_drop,
                    device=device))
                block = HOTFormerBlock(
                    dim, num_heads, cfg.patch_size, cfg.mlp_ratio,
                    not cfg.disable_rpe, cfg.layer_scale, drop_path=dp,
                    rt_per_window=cfg.rt_size, device=device,
                    **_block_kw(cfg))
            else:
                block = OctFormerBlock(
                    dim, num_heads, cfg.patch_size,
                    1 if i % 2 == 0 else cfg.dilation, cfg.mlp_ratio,
                    not cfg.disable_rpe, cfg.layer_scale, drop_path=dp,
                    device=device, **_block_kw(cfg))
            self.add_module(f"block{i}", block)

    def forward(self, x, ctx):
        c = self.cfg
        if not self.use_rt:
            for i in range(self.num_blocks):
                x = run_block(c, getattr(self, f"block{i}"), x, ctx)
            return x
        chunk = c.patch_size // c.rt_size
        rt = ow.masked_window_mean(x, ctx.node_valid, chunk)
        wvalid = ow.window_valid(ctx.node_valid, chunk)
        for i in range(self.num_blocks):
            with profiling.annotate(SPAN_RTSA):
                count_block(wvalid, wvalid)
                h = getattr(self, f"rt_ln{i}")(rt)
                rt = rt + getattr(self, f"rt_attn{i}")(h, wvalid)
            count_block(ctx.counts, ctx.node_valid)
            x, rt = run_block(c, getattr(self, f"block{i}"), x, rt, ctx,
                              span=SPAN_HOSA)
        return x


class HOTFormerIteration(nn.Module):
    """One RTSA over all relay tokens, then one H-OSA block per pyramid
    level."""

    def __init__(self, cfg: ModelConfig, channels: Tuple[int, ...],
                 num_heads: Tuple[int, ...], depths: Tuple[int, ...],
                 drop_path: float = 0.0, device=None):
        super().__init__()
        self.use_proj = cfg.use_projections
        self.chunk = cfg.patch_size // cfg.rt_size
        max_ch = max(channels)
        self.rtsa = RelayTokenBlock(
            max_ch, num_heads[channels.index(max_ch)], cfg.mlp_ratio,
            cfg.layer_scale, drop_path, cfg.attn_drop, cfg.proj_drop,
            device=device)
        self.levels = len(channels)
        for j in range(self.levels):
            if self.use_proj:
                self.add_module(f"down_proj{j}", linear(
                    max_ch, channels[j], device=device))
            self.add_module(f"hosa{j}", HOTFormerBlock(
                channels[j], num_heads[j], cfg.patch_size, cfg.mlp_ratio,
                not cfg.disable_rpe, cfg.layer_scale, drop_path=drop_path,
                rt_per_window=cfg.rt_size, device=device, **_block_kw(cfg)))
            if self.use_proj:
                self.add_module(f"up_proj{j}", linear(
                    channels[j], max_ch, device=device))

    def forward(self, rt_comb, locals_, ctxs, rt_mask):
        with profiling.annotate(SPAN_RTSA):
            count_block(rt_mask, rt_mask)
            rt_comb = self.rtsa(rt_comb, rt_mask)
        parts, new_locals = [], []
        off = 0
        for j in range(self.levels):
            width = ctxs[j].node_valid.shape[1] // self.chunk
            rt_j = rt_comb[:, off:off + width]
            off += width
            with profiling.annotate(SPAN_HOSA):
                count_block(ctxs[j].counts, ctxs[j].node_valid)
                if self.use_proj:
                    rt_j = getattr(self, f"down_proj{j}")(rt_j)
                x_j, rt_j = getattr(self, f"hosa{j}")(locals_[j], rt_j,
                                                      ctxs[j])
                if self.use_proj:
                    rt_j = getattr(self, f"up_proj{j}")(rt_j)
            parts.append(rt_j)
            new_locals.append(x_j)
        return torch.cat(parts, dim=1), new_locals


class HOTFormerStage(nn.Module):
    """Pyramid init (downsample chain), relay-token init, then num_blocks
    iterations of [RTSA -> H-OSA].

    The relay-token init (JAX models/backbone.py:273-310) is the masked
    window mean plus ADaPE over the window statistics of
    ``cfg.adape_mode`` (3, 6 or 9 inputs); without ADaPE (mode None) it
    is the masked window mean of the level's features after a CPE: one
    ``rt_init_cpe`` shared by the levels (they have one width when there
    are no projections) or ``rt_init_cpe{j}`` per level with them. The
    CPE'd features feed only the relay tokens. It runs K3 forward and K4
    backward like every CPE, outside activation checkpointing as in the
    JAX package (not a remat site there). Each window holds G =
    ``rt_size`` relay tokens, one per chunk of K/G nodes.

    ``cfg.rt_propagation`` (JAX backbone.py:335-349): after the loop
    every level adds its relay tokens, projected (``prop_down_proj{j}``)
    when the levels' widths differ, repeated over their chunks, masked
    to valid nodes and scaled by ``rt_gamma_propagate{j}`` when
    ``rt_propagation_scale`` is set.

    ``cfg.disable_rt`` (JAX backbone.py:252-270): no relay tokens; per
    iteration i and level j a plain OctFormer block ``hosa_l{j}_b{i}``,
    dilation on odd iterations."""

    def __init__(self, cfg: ModelConfig, channels: Tuple[int, ...],
                 num_heads: Tuple[int, ...], drop_paths: Sequence[float],
                 depth: int, device=None):
        super().__init__()
        self.cfg = cfg
        self.channels = tuple(channels)
        self.depths = tuple(depth - j for j in range(len(channels)))
        self.num_blocks = len(drop_paths)
        L = len(channels)
        max_ch = max(channels)
        for j in range(L - 1):
            self.add_module(f"downsample{j}", Downsample(
                channels[j], channels[j + 1], cfg.conv_norm, device=device))
        if cfg.disable_rt:
            for i, dp in enumerate(drop_paths):
                for j in range(L):
                    self.add_module(f"hosa_l{j}_b{i}", OctFormerBlock(
                        channels[j], num_heads[j], cfg.patch_size,
                        1 if i % 2 == 0 else cfg.dilation, cfg.mlp_ratio,
                        not cfg.disable_rpe, cfg.layer_scale, drop_path=dp,
                        device=device, **_block_kw(cfg)))
            return
        self.use_adape = cfg.adape_mode is not None
        if self.use_adape:
            self.rt_adape = ADaPE(ADAPE_STATS[cfg.adape_mode], max_ch,
                                  device=device)
        elif not cfg.use_projections:
            self.rt_init_cpe = CPE(max_ch, cfg.conv_norm, cfg.xcpe,
                                   device=device)
        if cfg.use_projections:
            for j in range(L):
                if self.use_adape:
                    self.add_module(f"adape_proj{j}", linear(
                        max_ch, channels[j], device=device))
                else:
                    self.add_module(f"rt_init_cpe{j}", CPE(
                        channels[j], cfg.conv_norm, cfg.xcpe, device=device))
                self.add_module(f"init_up_proj{j}", linear(
                    channels[j], max_ch, device=device))
        self.iters = nn.ModuleList(
            HOTFormerIteration(cfg, self.channels, tuple(num_heads),
                               self.depths, dp, device=device)
            for dp in drop_paths)
        if cfg.rt_propagation:
            for j in range(L):
                if cfg.use_projections:
                    self.add_module(f"prop_down_proj{j}", linear(
                        max_ch, channels[j], device=device))
                if cfg.rt_propagation_scale is not None:
                    self.register_parameter(f"rt_gamma_propagate{j}", param(
                        (), "const", cfg.rt_propagation_scale,
                        device=device))

    def forward(self, x, plan: OctreePlan):
        """Returns ({depth: local features}, rt_comb, rt_mask); the last two
        are None with ``disable_rt``."""
        c = self.cfg
        oc = plan.octree
        ctxs = [plan.level_ctx(d) for d in self.depths]
        locals_ = [x]
        for j in range(len(self.depths) - 1):
            with profiling.annotate("hfl.down"):
                locals_.append(getattr(self, f"downsample{j}")(
                    locals_[j], plan.down_tables(self.depths[j]),
                    oc.node_valid(self.depths[j + 1])))
        if c.disable_rt:
            for i in range(self.num_blocks):
                for j, ctx in enumerate(ctxs):
                    locals_[j] = run_block(c, getattr(self, f"hosa_l{j}_b{i}"),
                                           locals_[j], ctx)
            return dict(zip(self.depths, locals_)), None, None
        with profiling.annotate("hfl.rt_init"):
            rt_comb, rt_mask, widths = self._init_relay_tokens(
                x, locals_, ctxs)
        for it in self.iters:
            rt_comb, locals_ = run_block(c, it, rt_comb, locals_, ctxs,
                                         rt_mask)
        if c.rt_propagation:
            with profiling.annotate("hfl.rt_propagate"):
                self._propagate(rt_comb, widths, locals_, ctxs)
        return dict(zip(self.depths, locals_)), rt_comb, rt_mask

    def _init_relay_tokens(self, x, locals_, ctxs):
        """(rt_comb, rt_mask, each level's width in relay tokens)."""
        c = self.cfg
        chunk = c.patch_size // c.rt_size
        rts = []
        for j, d in enumerate(self.depths):
            src = locals_[j]
            if not self.use_adape:
                cpe = (getattr(self, f"rt_init_cpe{j}")
                       if c.use_projections else self.rt_init_cpe)
                src = cpe(src, ctxs[j])
            rt = ow.masked_window_mean(src, ctxs[j].node_valid, chunk)
            if self.use_adape:
                stats = ow.window_stats(ctxs[j].xyz, ctxs[j].node_valid, d,
                                        chunk, c.adape_mode)
                pe = self.rt_adape(stats, x.dtype)
                if c.use_projections:
                    pe = getattr(self, f"adape_proj{j}")(pe)
                rt = rt + pe
            if c.use_projections:
                rt = getattr(self, f"init_up_proj{j}")(rt)
            rts.append(rt)
        rt_comb = torch.cat(rts, dim=1)
        rt_mask = torch.cat([ow.window_valid(ctx.node_valid, chunk)
                             for ctx in ctxs], dim=1)
        return rt_comb, rt_mask, [r.shape[1] for r in rts]

    def _propagate(self, rt_comb, widths, locals_, ctxs) -> None:
        """Add each level's relay tokens back to its nodes, in place in
        ``locals_``."""
        c = self.cfg
        chunk = c.patch_size // c.rt_size
        for j, rt_j in enumerate(torch.split(rt_comb, widths, dim=1)):
            if c.use_projections:
                rt_j = getattr(self, f"prop_down_proj{j}")(rt_j)
            up = rt_j.repeat_interleave(chunk, dim=1)
            up = torch.where(ctxs[j].node_valid[..., None], up, 0.0)
            if c.rt_propagation_scale is not None:
                up = up * cast(getattr(self, f"rt_gamma_propagate{j}"), up)
            locals_[j] = locals_[j] + up


class HOTFormerBase(nn.Module):
    """Stem -> OctFormer stage(s) -> HOTFormer stage."""

    def __init__(self, cfg: ModelConfig, in_channels: int, device=None):
        super().__init__()
        self.cfg = cfg
        octf_ch, pyr_ch = cfg.stage_channels()
        octf_h, pyr_h = cfg.stage_heads()
        self.patch_embed = PatchEmbed(in_channels, cfg.channels[0],
                                      cfg.stem_down,
                                      cfg.downsample_input_embeddings,
                                      cfg.conv_norm, device=device)
        rates = cfg.drop_path_rates()
        used = 0
        d = cfg.transformer_depth
        for i in range(cfg.num_octf_levels):
            nb = cfg.num_blocks[i]
            self.add_module(f"octf_stage{i}", OctFormerStage(
                cfg, octf_ch[i], octf_h[i], rates[used:used + nb], d,
                device=device))
            used += nb
            self.add_module(f"octf_down{i}", Downsample(
                cfg.channels[i], cfg.channels[i + 1], cfg.conv_norm,
                device=device))
            d -= 1
        self.hotf_stage = HOTFormerStage(
            cfg, pyr_ch, pyr_h, rates[used:used + cfg.num_blocks[-1]], d,
            device=device)

    def forward(self, feat, plan: OctreePlan):
        c = self.cfg
        feat = self.patch_embed(feat, plan)
        d = c.transformer_depth
        for i in range(c.num_octf_levels):
            feat = getattr(self, f"octf_stage{i}")(feat, plan.level_ctx(d))
            with profiling.annotate("hfl.down"):
                feat = getattr(self, f"octf_down{i}")(
                    feat, plan.down_tables(d), plan.octree.node_valid(d - 1))
            d -= 1
        return self.hotf_stage(feat, plan)
