"""HOTFormerLoc: raw point clouds -> place-recognition descriptors.

Counterpart of hotformerloc_tpu/models/hotformerloc.py for serving: the
octree, neighbour tables and window plan are built on the points' device
inside ``forward``, so the caller ships only (B, P, 3) points and a
(B, P) mask.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from hotformerloc_torch.models.backbone import HOTFormerBase
from hotformerloc_torch.models.config import ModelConfig, check_supported
from hotformerloc_torch.models.layers import init_weights
from hotformerloc_torch.models.pooling import PyramidAttnPool
from hotformerloc_torch.octree.build import BatchedOctree, build_batched_octree
from hotformerloc_torch.ops.plan import build_plan


def input_features(octree: BatchedOctree, feature_str: str = "P"):
    """'P' input feature: the mean point of each leaf in the [-1, 1]
    frame, zero for padding leaves. (B, N_leaf, 3) fp32."""
    if feature_str != "P":
        raise NotImplementedError(f"input_features={feature_str!r}")
    valid = octree.node_valid(octree.depth)[..., None]
    return torch.where(valid, octree.leaf_mean, 0.0)


class HOTFormerLoc(nn.Module):
    """points (B, P, 3) in [-1, 1] + pmask (B, P) -> {'global': (B, D)
    fp32 descriptors, 'octree_overflow': nodes dropped by capacity,
    'band_overflow': 0}.

    Built on ``device`` (the card unless the caller asks for the CPU)
    with the JAX package's initial distributions drawn from
    ``generator`` (seed 0 when None). Inference only.
    """

    def __init__(self, cfg: ModelConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
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

    def forward(self, points: torch.Tensor,
                pmask: torch.Tensor) -> Dict[str, torch.Tensor]:
        c = self.cfg
        dtype = self.pooling.mixer.row_proj.weight.dtype
        octree = build_batched_octree(points, pmask, c.octree_depth,
                                      c.min_depth, c.resolve_capacities())
        plan = build_plan(octree, c.dense_depths())
        feat = input_features(octree, c.input_features).to(dtype)
        local_dict, _, _ = self.backbone(feat, plan)
        toks = [local_dict[d] for d in c.pyramid_depths]
        masks = [octree.node_valid(d) for d in c.pyramid_depths]
        x = self.pooling(toks, masks).float()
        if c.normalize_embeddings:
            x = x / torch.clamp(x.norm(dim=1, keepdim=True), min=1e-12)
        return {"global": x,
                "octree_overflow": octree.overflow.sum(),
                "band_overflow": plan.band_overflow()}
