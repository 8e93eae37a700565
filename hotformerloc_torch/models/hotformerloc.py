"""HOTFormerLoc: raw point clouds -> place-recognition descriptors.

Counterpart of hotformerloc_tpu/models/hotformerloc.py. The octree,
neighbour tables and window plan are built on the points' device inside
``forward`` unless the caller passes a ``plan`` built once (the train
step reuses one per microbatch in its two passes), so the caller ships
only (B, P, 3) points, a (B, P) mask and, for the 'N' input feature,
(B, P, 3) normals.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from hotformerloc_torch.models.backbone import HOTFormerBase
from hotformerloc_torch.models.config import ModelConfig, check_supported
from hotformerloc_torch.models.layers import (DropPath, Dropout,
                                              RunningStats, init_weights)
from hotformerloc_torch.models.pooling import (AttnPool, GeM,
                                               PyramidAttnPool, PyramidGeM)
from hotformerloc_torch.octree import morton
from hotformerloc_torch.octree.build import BatchedOctree, build_batched_octree
from hotformerloc_torch.ops.plan import OctreePlan, build_plan
from hotformerloc_torch.utils import profiling

FEATURE_CHANNELS = {"N": 3, "D": 1, "L": 3, "P": 3}


def feature_channels(feature_str: str) -> int:
    return sum(FEATURE_CHANNELS[f] for f in feature_str)


def input_features(octree: BatchedOctree, feature_str: str = "P"):
    """Per-leaf input features, (B, N_leaf, C) fp32, zero for padding
    leaves, in ocnn's N, D, L, P order whatever the string's order:
    'N' the mean per-point normal of the leaf (3), 'D' the norm of the
    displacement of the leaf's mean point from its octant centre in voxel
    units (1), 'L' that displacement (3), 'P' the mean point in the
    [-1, 1] frame (3)."""
    valid = octree.node_valid(octree.depth)[..., None]
    feats = []
    if "N" in feature_str:
        if octree.leaf_normal is None:
            raise ValueError("input feature 'N' needs per-point normals: "
                             "pass normals to build_batched_octree / "
                             "HOTFormerLoc.forward")
        feats.append(octree.leaf_normal)
    if "L" in feature_str or "D" in feature_str:
        centre = morton.grid_to_points(
            octree.xyz(octree.depth).to(torch.float32) + 0.5, octree.depth)
        disp = (octree.leaf_mean - centre) * 2.0 ** (octree.depth - 1)
        if "D" in feature_str:
            feats.append(disp.norm(dim=-1, keepdim=True))
        if "L" in feature_str:
            feats.append(disp)
    if "P" in feature_str:
        feats.append(octree.leaf_mean)
    if not feats:
        raise ValueError(f"no valid input features in {feature_str!r}")
    return torch.where(valid, torch.cat(feats, dim=-1), 0.0)


def build_model_plan(cfg: ModelConfig, points: torch.Tensor,
                     pmask: torch.Tensor, tap_lists: bool = True,
                     normals: Optional[torch.Tensor] = None) -> OctreePlan:
    """The octree and every gather table of one batch, for ``plan=``
    (``tap_lists`` as for ``build_plan``; ``normals`` (B, P, 3) for the
    'N' input feature). Every CPE runs the gather (K3/K4), so no level
    gets a dense voxel map and, with ``tap_lists``, every level gets tap
    lists."""
    if "N" in cfg.input_features and normals is None:
        raise ValueError("input feature 'N' requires a (B, P, 3) normals "
                         "argument")
    with profiling.annotate("hfl.octree"):
        octree = build_batched_octree(points, pmask, cfg.octree_depth,
                                      cfg.min_depth,
                                      cfg.resolve_capacities(),
                                      normals=normals)
    return build_plan(octree, tap_lists=tap_lists)


def _make_head(cfg: ModelConfig, device) -> nn.Module:
    """The descriptor head of ``cfg.pooling`` (JAX models/hotformerloc.py
    :92-129)."""
    _, pyr_ch = cfg.stage_channels()
    if cfg.pooling == "PyramidAttnPoolMixer":
        return PyramidAttnPool(cfg.feature_size, cfg.output_dim, pyr_ch,
                               cfg.k_pooled_tokens, "mixer", device=device)
    if cfg.pooling in ("AttnPoolMixer", "AttnPoolGeM"):
        k = (cfg.k_pooled_tokens if isinstance(cfg.k_pooled_tokens, int)
             else sum(cfg.k_pooled_tokens))
        return AttnPool(cfg.feature_size, cfg.output_dim, k,
                        "mixer" if cfg.pooling == "AttnPoolMixer" else "gem",
                        device=device)
    if cfg.pooling == "OctGeM":
        return GeM(device=device)
    return PyramidGeM(cfg.output_dim, pyr_ch,
                      gating=cfg.pooling.endswith("gc"), device=device)


class HOTFormerLoc(nn.Module):
    """points (B, P, 3) in [-1, 1] + pmask (B, P) -> {'global': (B, D)
    fp32 descriptors, 'octree_overflow': nodes dropped by capacity}.

    Built on ``device`` (the card unless the caller asks for the CPU)
    with the JAX package's initial distributions drawn from
    ``generator`` (seed 0 when None), in eval mode. ``dtype`` is the
    compute dtype (None: the parameters' dtype); parameters stay as
    they are and are cast at use. In train mode DropPath and dropout are
    active, the norms use batch statistics, and a forward stages the new
    running statistics (``commit_stats`` writes them; the train step
    does, once per step)."""

    def __init__(self, cfg: ModelConfig, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.dtype = dtype
        self.backbone = HOTFormerBase(
            cfg, feature_channels(cfg.input_features), device=device)
        self.pooling = _make_head(cfg, device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_weights(self, generator)
        self.eval()

    def set_use_kernels(self, flag: bool) -> None:
        """Route convs, window attention and LayerNorms through the CUDA
        kernels (True, the default) or the plain tensor code (False)."""
        for m in self.modules():
            if hasattr(m, "use_kernels"):
                m.use_kernels = flag

    def drop_path_sites(self) -> List[DropPath]:
        """Every DropPath of the model, in block order (two per block)."""
        return [m for m in self.modules() if isinstance(m, DropPath)]

    def dropout_sites(self) -> List[Dropout]:
        """Every Dropout of the model with a rate above 0."""
        return [m for m in self.modules()
                if isinstance(m, Dropout) and m.rate > 0]

    def stats_modules(self) -> List[RunningStats]:
        """Every module with running statistics, in module order."""
        return [m for m in self.modules() if isinstance(m, RunningStats)]

    def set_stats_group(self, group) -> None:
        """Sum the batch statistics of train-mode forwards over the ranks
        of ``group`` (data parallelism; None: this process's rows)."""
        for m in self.stats_modules():
            m.group = group

    def staged_stats(self) -> List[Optional[dict]]:
        """The running statistics the last train-mode forward staged, one
        entry per ``stats_modules`` module."""
        return [m.staged for m in self.stats_modules()]

    def commit_stats(self, staged: Optional[List[Optional[dict]]] = None
                     ) -> None:
        """Write ``staged`` (``staged_stats()`` when None) into the running
        buffers, and clear what is staged."""
        mods = self.stats_modules()
        for m, st in zip(mods, self.staged_stats() if staged is None
                         else staged):
            m.commit(st)
        for m in mods:
            m.staged = None

    def draw_drop_masks(self, batch: int,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
        """(n_sites, batch) fp32 DropPath masks: per site and sample
        1/keep with probability keep = 1 - rate, else 0 (all 1 at rate
        0), from ``generator`` (a CPU generator; the default one when
        None)."""
        keep = torch.tensor([1.0 - s.rate for s in self.drop_path_sites()])
        u = torch.rand((keep.numel(), batch), generator=generator)
        return (u < keep[:, None]).float() / torch.clamp(keep, min=1e-6)[
            :, None]

    def forward(self, points: torch.Tensor, pmask: torch.Tensor,
                plan: Optional[OctreePlan] = None,
                drop_masks: Optional[torch.Tensor] = None,
                dtype: Optional[torch.dtype] = None,
                normals: Optional[torch.Tensor] = None,
                dropout_seed: Optional[int] = None
                ) -> Dict[str, torch.Tensor]:
        """``plan``: a prebuilt ``build_model_plan`` of these points.
        ``drop_masks``: (n_sites, B) from ``draw_drop_masks``, used in
        train mode (drawn from the default generator when None) and
        ignored in eval mode. ``dtype`` overrides the compute dtype.
        ``normals``: (B, P, 3) per-point normals, needed for the 'N'
        input feature when no plan is given. ``dropout_seed``: the seed of
        the train-mode dropout masks (each site draws from its own
        generator, seeded from it; drawn from the default generator when
        None), so a forward with the same seed draws the same masks."""
        c = self.cfg
        dtype = dtype or self.dtype or next(self.parameters()).dtype
        if plan is None:         # tap lists only for a backward to read
            plan = build_model_plan(c, points, pmask,
                                    tap_lists=torch.is_grad_enabled(),
                                    normals=normals)
        octree = plan.octree
        sites = self.drop_path_sites() if self.training else []
        drops = self.dropout_sites() if self.training else []
        if sites:
            if drop_masks is None:
                drop_masks = self.draw_drop_masks(points.shape[0])
            for s, m in zip(sites, drop_masks.to(points.device)):
                s.mask = m if s.rate > 0 else None
        if drops:
            if dropout_seed is None:
                dropout_seed = int(torch.randint(2 ** 62, ()))
            seeds = torch.randint(2 ** 62, (len(drops),), generator=(
                torch.Generator().manual_seed(dropout_seed)))
            for s, seed in zip(drops, seeds.tolist()):
                s.seed = seed
        try:
            with profiling.annotate("hfl.features"):
                feat = input_features(octree, c.input_features).to(dtype)
            local_dict, rt_comb, rt_mask = self.backbone(feat, plan)
        finally:
            for s in sites:
                s.mask = None
            for s in drops:
                s.seed = None
        with profiling.annotate("hfl.pooling"):
            x = self._pool(local_dict, rt_comb, rt_mask, octree)
        return {"global": x, "octree_overflow": octree.overflow.sum()}

    def _pool(self, local_dict, rt_comb, rt_mask, octree) -> torch.Tensor:
        """The descriptor head, in fp32, normalised when the config says."""
        c = self.cfg
        pyr = c.pyramid_depths
        if c.pooling in ("AttnPoolMixer", "AttnPoolGeM"):
            x = self.pooling(rt_comb, rt_mask)
        elif c.pooling == "OctGeM":
            x = self.pooling(local_dict[max(pyr)], octree.node_valid(max(pyr)))
        else:
            x = self.pooling([local_dict[d] for d in pyr],
                             [octree.node_valid(d) for d in pyr])
        x = x.float()
        if c.normalize_embeddings:
            x = x / torch.clamp(x.norm(dim=1, keepdim=True), min=1e-12)
        return x


def param_count(model: nn.Module) -> int:
    """Number of parameter elements (the JAX package's ``param_count``
    over the flax params)."""
    return sum(p.numel() for p in model.parameters())
