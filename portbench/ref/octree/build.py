# Frozen copy of hotformerloc_torch/octree/build.py at commit
# 17534d0, for portbench's plain reference: every CUDA kernel call is
# replaced by its plain formulation, data parallelism is dropped.
"""Batched, static-shape octree construction on device.

Every sample owns a fixed-capacity, Morton-sorted node array per depth
with a validity count, as in the JAX package (hotformerloc_tpu/octree/
build.py): keys, counts, parents and overflow are bit-identical to it.
The whole build is tensor ops (stable sort, head-flag cumsum, scatter),
so it runs on the card with the rest of the forward.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from portbench.ref.models.config import default_capacities
from portbench.ref.octree import morton
from portbench.ref.octree.morton import SENTINEL


@dataclasses.dataclass
class BatchedOctree:
    """Fixed-capacity batched octree.

    keys: per depth (B, cap_d) int32 Morton keys, ascending, SENTINEL tail.
    counts: per depth (B,) int32 valid node counts.
    parents: per depth (None at the coarsest) (B, cap_d) int32 parent index
      in the depth-1 arrays, -1 for padding.
    leaf_mean: (B, cap_leaf, 3) fp32 mean point per leaf (0 for padding).
    leaf_npts: (B, cap_leaf) fp32 raw points per leaf.
    overflow: (B,) int32 nodes dropped because a level exceeded its cap.
    leaf_normal: (B, cap_leaf, 3) fp32 mean per-point normal per leaf
      (0 for padding), when the build was given normals, else None.
    """
    depth: int
    min_depth: int
    caps: Tuple[int, ...]
    keys: Tuple[torch.Tensor, ...]
    counts: Tuple[torch.Tensor, ...]
    parents: Tuple[Optional[torch.Tensor], ...]
    leaf_mean: torch.Tensor
    leaf_npts: torch.Tensor
    overflow: torch.Tensor
    leaf_normal: Optional[torch.Tensor] = None

    def level(self, d: int) -> int:
        assert self.min_depth <= d <= self.depth, f"depth {d} out of range"
        return d - self.min_depth

    def cap(self, d: int) -> int:
        return self.caps[self.level(d)]

    def key(self, d: int) -> torch.Tensor:
        return self.keys[self.level(d)]

    def count(self, d: int) -> torch.Tensor:
        return self.counts[self.level(d)]

    def parent(self, d: int) -> torch.Tensor:
        p = self.parents[self.level(d)]
        assert p is not None, f"no parent map at depth {d}"
        return p

    def node_valid(self, d: int) -> torch.Tensor:
        """(B, cap_d) bool validity mask."""
        i = torch.arange(self.cap(d), device=self.leaf_mean.device)
        return i[None, :] < self.count(d)[:, None]

    def xyz(self, d: int) -> torch.Tensor:
        """(B, cap_d, 3) int32 voxel coords (0 for padding)."""
        k = self.key(d)
        return torch.where((k < SENTINEL)[..., None], morton.decode(k), 0)


def _unique_sorted(skeys: torch.Tensor, cap: int):
    """Segment per-row sorted keys (B, P) with SENTINEL tail into unique
    groups. Returns (unique_keys (B, cap), seg_id (B, P), count (B,),
    overflow (B,)); entries past ``cap`` or invalid get seg_id == cap."""
    B = skeys.shape[0]
    valid = skeys < SENTINEL
    head = torch.cat([valid[:, :1],
                      (skeys[:, 1:] != skeys[:, :-1]) & valid[:, 1:]], dim=1)
    seg_id = torch.cumsum(head.to(torch.int32), dim=1, dtype=torch.int32) - 1
    seg_id = torch.where(valid, torch.clamp(seg_id, max=cap),
                         torch.full_like(seg_id, cap))
    # Every write to a slot < cap carries the same key; slot `cap` collects
    # overflow and padding and is cut off.
    ukeys = torch.full((B, cap + 1), SENTINEL, dtype=torch.int32,
                       device=skeys.device)
    ukeys.scatter_(1, seg_id.long(), skeys)
    true_count = head.sum(dim=1, dtype=torch.int32)
    count = torch.clamp(true_count, max=cap)
    return ukeys[:, :cap], seg_id, count, true_count - count


def build_batched_octree(points: torch.Tensor, pmask: torch.Tensor,
                         depth: int, min_depth: int,
                         caps: Optional[Tuple[int, ...]] = None,
                         normals: Optional[torch.Tensor] = None
                         ) -> BatchedOctree:
    """Build a BatchedOctree from (B, P, 3) points in [-1, 1] with (B, P)
    validity, on the points' device. ``normals``: optional (B, P, 3)
    per-point normals, averaged per leaf into ``leaf_normal`` (the 'N'
    input feature)."""
    assert points.ndim == 3 and points.shape[-1] == 3
    B, P, _ = points.shape
    if caps is None:
        caps = default_capacities(P, depth, min_depth)
    nlev = depth - min_depth + 1
    assert len(caps) == nlev
    dev = points.device
    points = points.to(torch.float32)
    grid = morton.points_to_grid(points, depth)
    keys = torch.where(pmask.to(torch.bool), morton.encode(grid),
                       torch.full((), SENTINEL, dtype=torch.int32,
                                  device=dev))
    order = torch.argsort(keys, dim=1, stable=True)
    skeys = torch.gather(keys, 1, order)
    spts = torch.gather(points, 1, order[..., None].expand(B, P, 3))
    w = (skeys < SENTINEL).to(torch.float32)

    cap_leaf = caps[-1]
    leaf_keys, seg_id, leaf_count, ovf = _unique_sorted(skeys, cap_leaf)
    # Per-leaf point sums over a flat (B * (cap+1)) segment space.
    flat = (seg_id.long() + torch.arange(B, device=dev)[:, None]
            * (cap_leaf + 1)).reshape(-1)
    pt_sum = torch.zeros(B * (cap_leaf + 1), 3, device=dev)
    pt_sum.index_add_(0, flat, (spts * w[..., None]).reshape(-1, 3))
    pt_cnt = torch.zeros(B * (cap_leaf + 1), device=dev)
    pt_cnt.index_add_(0, flat, w.reshape(-1))
    pt_sum = pt_sum.reshape(B, cap_leaf + 1, 3)[:, :cap_leaf]
    pt_cnt = pt_cnt.reshape(B, cap_leaf + 1)[:, :cap_leaf]
    leaf_mean = pt_sum / torch.clamp(pt_cnt, min=1.0)[..., None]
    leaf_normal = None
    if normals is not None:
        snrm = torch.gather(normals.to(torch.float32), 1,
                            order[..., None].expand(B, P, 3))
        n_sum = torch.zeros(B * (cap_leaf + 1), 3, device=dev)
        n_sum.index_add_(0, flat, (snrm * w[..., None]).reshape(-1, 3))
        n_sum = n_sum.reshape(B, cap_leaf + 1, 3)[:, :cap_leaf]
        leaf_normal = n_sum / torch.clamp(pt_cnt, min=1.0)[..., None]

    keys_all = [None] * nlev
    counts_all = [None] * nlev
    parents_all = [None] * nlev
    keys_all[-1] = leaf_keys
    counts_all[-1] = leaf_count
    child_keys = leaf_keys
    for d in range(depth - 1, min_depth - 1, -1):
        lev = d - min_depth
        cvalid = child_keys < SENTINEL
        pkeys = torch.where(cvalid, child_keys >> 3,
                            torch.full_like(child_keys, SENTINEL))
        ukeys, seg_d, count_d, ovf_d = _unique_sorted(pkeys, caps[lev])
        ovf = ovf + ovf_d
        keys_all[lev] = ukeys
        counts_all[lev] = count_d
        parents_all[lev + 1] = torch.where(
            cvalid & (seg_d < caps[lev]), seg_d,
            torch.full_like(seg_d, -1)).to(torch.int32)
        child_keys = ukeys
    return BatchedOctree(depth=depth, min_depth=min_depth, caps=tuple(caps),
                         keys=tuple(keys_all), counts=tuple(counts_all),
                         parents=tuple(parents_all), leaf_mean=leaf_mean,
                         leaf_npts=pt_cnt, overflow=ovf,
                         leaf_normal=leaf_normal)
