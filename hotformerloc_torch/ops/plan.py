"""Gather tables and per-level context for one forward pass.

Counterpart of hotformerloc_tpu/ops/plan.py without its band tables:
those only patch taps that escape a TPU VMEM band, and the CUDA kernels
here gather every tap directly, so no tap ever overflows a band (the JAX
package's ``band_overflow`` has no counterpart). In their place each
level whose stride-1 convs run a kernel carries per-tap pair lists of
its neighbour table (``TapLists``), which the backward weight-gradient
kernels walk instead of the table; every conv at the level, forward and
backward, shares them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from hotformerloc_torch.octree.build import BatchedOctree
from hotformerloc_torch.octree.morton import SENTINEL
from hotformerloc_torch.octree.neigh import all_neigh_tables, child_table
from hotformerloc_torch.ops.conv import dense_voxel_index
from hotformerloc_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class TapLists:
    """The valid taps of a (B, N, 27) neighbour table, compacted per tap:
    for tap k, ``dst[k, p]`` and ``src[k, p]`` (p < ``count[k]``) are the
    global rows b*N + n and b*N + j of every neigh[b, n, k] = j >= 0, in
    row order. Fixed capacity B*N per tap; slots from ``count[k]`` on
    hold -1. The counts stay on the device: nothing is read back."""
    dst: torch.Tensor      # (27, B*N) int32
    src: torch.Tensor      # (27, B*N) int32
    count: torch.Tensor    # (27,) int32


def build_tap_lists(neigh: torch.Tensor) -> TapLists:
    """Per-tap pair lists of ``neigh`` (B, N, 27) int32, -1 = none, on its
    device, by mask, cumsum and one scatter per list into a buffer with
    one spare slot that takes the invalid taps. No device-to-host sync."""
    B, N, K = neigh.shape
    R = B * N
    dev = neigh.device
    nb = neigh.reshape(R, K).t()                          # (K, R)
    valid = nb >= 0
    count = valid.sum(1, dtype=torch.int32)
    rows = torch.arange(R, dtype=torch.int32, device=dev)
    slot = torch.where(valid, valid.cumsum(1) - 1
                       + torch.arange(K, device=dev)[:, None] * R, K * R)
    slot = slot.reshape(-1)
    src = (rows - rows % N) + nb                          # (K, R) int32
    lists = []
    for vals in (rows.expand(K, R), src):
        buf = torch.full((K * R + 1,), -1, dtype=torch.int32, device=dev)
        buf.scatter_(0, slot, vals.reshape(-1))
        lists.append(buf[:K * R].view(K, R))
    return TapLists(dst=lists[0], src=lists[1], count=count)


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
    taps: Optional[TapLists] = None            # levels with kernel convs


@dataclasses.dataclass
class OctreePlan:
    """BatchedOctree plus every gather table the model consumes."""
    octree: BatchedOctree
    neighs: Tuple[torch.Tensor, ...]                  # per level (B, N_d, 27)
    childrens: Tuple[Optional[torch.Tensor], ...]     # per level (B, N_{d-1}, 8)
    dense_idxs: Tuple[Optional[torch.Tensor], ...] = ()
    taps: Tuple[Optional[TapLists], ...] = ()         # per level

    def level_ctx(self, d: int) -> LevelCtx:
        lev = self.octree.level(d)
        didx = self.dense_idxs[lev] if self.dense_idxs else None
        return LevelCtx(depth=d, node_valid=self.octree.node_valid(d),
                        xyz=self.octree.xyz(d), neigh=self.neighs[lev],
                        keys=self.octree.key(d), counts=self.octree.count(d),
                        dense_idx=didx,
                        taps=self.taps[lev] if self.taps else None)

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


def build_plan(octree: BatchedOctree, dense_depths: Tuple[int, ...] = (),
               tap_lists: bool = True) -> OctreePlan:
    """Child tables (one scatter each), then every neighbour table by the
    parent recurrence, then the voxel maps of the dense-grid CPE depths
    and, with ``tap_lists``, the tap lists of every other level (their
    stride-1 convs run the octree-conv kernels, whose backward reads
    them; a forward without gradients needs none). One ``hfl.plan``
    span."""
    with profiling.annotate("hfl.plan"):
        return _build_plan(octree, dense_depths, tap_lists)


def _build_plan(octree, dense_depths, tap_lists) -> OctreePlan:
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
    taps = tuple(
        None if d in dense_depths or not tap_lists else build_tap_lists(nb)
        for d, nb in zip(range(octree.min_depth, octree.depth + 1), neighs))
    return OctreePlan(octree=octree, neighs=neighs, childrens=childrens,
                      dense_idxs=dense_idxs, taps=taps)
