"""Gather tables and per-level context for one forward pass.

Counterpart of hotformerloc_tpu/ops/plan.py without its band tables:
those only patch taps that escape a TPU VMEM band, and the CUDA kernels
here gather every tap directly, so ``band_overflow`` is 0 by
construction.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from hotformerloc_torch.octree.build import BatchedOctree
from hotformerloc_torch.octree.morton import SENTINEL
from hotformerloc_torch.octree.neigh import all_neigh_tables, child_table
from hotformerloc_torch.ops.conv import dense_voxel_index


@dataclasses.dataclass
class LevelCtx:
    """Per-depth context handed to transformer blocks."""
    depth: int
    node_valid: torch.Tensor                   # (B, N) bool
    xyz: torch.Tensor                          # (B, N, 3) int32
    neigh: torch.Tensor                        # (B, N, 27) int32
    keys: torch.Tensor                         # (B, N) sorted Morton keys
    counts: torch.Tensor                       # (B,)
    dense_idx: Optional[torch.Tensor] = None   # (B, 8^d) voxel -> node


@dataclasses.dataclass
class OctreePlan:
    """BatchedOctree plus every gather table the model consumes."""
    octree: BatchedOctree
    neighs: Tuple[torch.Tensor, ...]                  # per level (B, N_d, 27)
    childrens: Tuple[Optional[torch.Tensor], ...]     # per level (B, N_{d-1}, 8)
    dense_idxs: Tuple[Optional[torch.Tensor], ...] = ()

    def level_ctx(self, d: int) -> LevelCtx:
        lev = self.octree.level(d)
        didx = self.dense_idxs[lev] if self.dense_idxs else None
        return LevelCtx(depth=d, node_valid=self.octree.node_valid(d),
                        xyz=self.octree.xyz(d), neigh=self.neighs[lev],
                        keys=self.octree.key(d), counts=self.octree.count(d),
                        dense_idx=didx)

    def band_overflow(self) -> torch.Tensor:
        """Always 0: every tap is gathered directly."""
        return torch.zeros((), dtype=torch.int32,
                           device=self.octree.leaf_mean.device)

    def children(self, d: int) -> torch.Tensor:
        c = self.childrens[self.octree.level(d)]
        assert c is not None
        return c

    def down_tables(self, d: int):
        """(children, parent, octant) for a stride-2 conv into depth d-1."""
        key = self.octree.key(d)
        octant = torch.where(key < SENTINEL, key & 7,
                             torch.zeros_like(key)).to(torch.int32)
        return self.children(d), self.octree.parent(d), octant


def build_plan(octree: BatchedOctree,
               dense_depths: Tuple[int, ...] = ()) -> OctreePlan:
    """Child tables (one scatter each), then every neighbour table by the
    parent recurrence, then the voxel maps of the dense-grid CPE depths."""
    childrens = tuple(
        child_table(octree, d) if d > octree.min_depth else None
        for d in range(octree.min_depth, octree.depth + 1))
    neighs = all_neigh_tables(octree, childrens)
    dense_idxs = ()
    if dense_depths:
        dense_idxs = tuple(
            dense_voxel_index(octree.key(d), octree.count(d), d)
            if d in dense_depths else None
            for d in range(octree.min_depth, octree.depth + 1))
    return OctreePlan(octree=octree, neighs=neighs, childrens=childrens,
                      dense_idxs=dense_idxs)
