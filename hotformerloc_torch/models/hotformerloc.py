"""HOTFormerLoc: raw point clouds -> place-recognition descriptors.

Counterpart of hotformerloc_tpu/models/hotformerloc.py. The octree,
neighbour tables and window plan are built on the points' device inside
``forward`` unless the caller passes a ``plan`` built once (the train
step reuses one per microbatch in its two passes), so the caller ships
only (B, P, 3) points and a (B, P) mask.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from hotformerloc_torch.models.backbone import HOTFormerBase
from hotformerloc_torch.models.config import ModelConfig, check_supported
from hotformerloc_torch.models.layers import DropPath, init_weights
from hotformerloc_torch.models.pooling import PyramidAttnPool
from hotformerloc_torch.octree.build import BatchedOctree, build_batched_octree
from hotformerloc_torch.ops.plan import OctreePlan, build_plan


def input_features(octree: BatchedOctree, feature_str: str = "P"):
    """'P' input feature: the mean point of each leaf in the [-1, 1]
    frame, zero for padding leaves. (B, N_leaf, 3) fp32."""
    if feature_str != "P":
        raise NotImplementedError(f"input_features={feature_str!r}")
    valid = octree.node_valid(octree.depth)[..., None]
    return torch.where(valid, octree.leaf_mean, 0.0)


def build_model_plan(cfg: ModelConfig, points: torch.Tensor,
                     pmask: torch.Tensor, tap_lists: bool = True
                     ) -> OctreePlan:
    """The octree and every gather table of one batch, for ``plan=``
    (``tap_lists`` as for ``build_plan``). Every CPE runs the gather
    (K3/K4), so no level gets a dense voxel map and, with ``tap_lists``,
    every level gets tap lists."""
    octree = build_batched_octree(points, pmask, cfg.octree_depth,
                                  cfg.min_depth, cfg.resolve_capacities())
    return build_plan(octree, tap_lists=tap_lists)


class HOTFormerLoc(nn.Module):
    """points (B, P, 3) in [-1, 1] + pmask (B, P) -> {'global': (B, D)
    fp32 descriptors, 'octree_overflow': nodes dropped by capacity,
    'band_overflow': 0}.

    Built on ``device`` (the card unless the caller asks for the CPU)
    with the JAX package's initial distributions drawn from
    ``generator`` (seed 0 when None), in eval mode. ``dtype`` is the
    compute dtype (None: the parameters' dtype); parameters stay as
    they are and are cast at use. In train mode DropPath is active.
    """

    def __init__(self, cfg: ModelConfig, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.dtype = dtype
        self.backbone = HOTFormerBase(cfg, 3, device=device)
        _, pyr_ch = cfg.stage_channels()
        self.pooling = PyramidAttnPool(cfg.feature_size, cfg.output_dim,
                                       pyr_ch, cfg.k_pooled_tokens,
                                       device=device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_weights(self, generator)
        self.eval()

    def set_use_kernels(self, flag: bool) -> None:
        """Route convs and window attention through the CUDA kernels
        (True, the default) or the plain tensor code (False)."""
        for m in self.modules():
            if hasattr(m, "use_kernels"):
                m.use_kernels = flag

    def drop_path_sites(self) -> List[DropPath]:
        """Every DropPath of the model, in block order (two per block)."""
        return [m for m in self.modules() if isinstance(m, DropPath)]

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
                dtype: Optional[torch.dtype] = None
                ) -> Dict[str, torch.Tensor]:
        """``plan``: a prebuilt ``build_model_plan`` of these points.
        ``drop_masks``: (n_sites, B) from ``draw_drop_masks``, used in
        train mode (drawn from the default generator when None) and
        ignored in eval mode. ``dtype`` overrides the compute dtype."""
        c = self.cfg
        dtype = dtype or self.dtype or self.pooling.mixer.row_proj.weight.dtype
        if plan is None:         # tap lists only for a backward to read
            plan = build_model_plan(c, points, pmask,
                                    tap_lists=torch.is_grad_enabled())
        octree = plan.octree
        sites = self.drop_path_sites() if self.training else []
        if sites:
            if drop_masks is None:
                drop_masks = self.draw_drop_masks(points.shape[0])
            for s, m in zip(sites, drop_masks.to(points.device)):
                s.mask = m if s.rate > 0 else None
        try:
            feat = input_features(octree, c.input_features).to(dtype)
            local_dict, _, _ = self.backbone(feat, plan)
        finally:
            for s in sites:
                s.mask = None
        toks = [local_dict[d] for d in c.pyramid_depths]
        masks = [octree.node_valid(d) for d in c.pyramid_depths]
        x = self.pooling(toks, masks).float()
        if c.normalize_embeddings:
            x = x / torch.clamp(x.norm(dim=1, keepdim=True), min=1e-12)
        return {"global": x,
                "octree_overflow": octree.overflow.sum(),
                "band_overflow": plan.band_overflow()}


def param_count(model: nn.Module) -> int:
    """Number of parameter elements (the JAX package's ``param_count``
    over the flax params)."""
    return sum(p.numel() for p in model.parameters())
