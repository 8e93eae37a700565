"""Neighbour and child index tables.

Same tables, in the same tap order, as the JAX package (hotformerloc_tpu/
octree/neigh.py): -1 marks a missing neighbour. ``all_neigh_tables``
builds every level top-down from a dense lookup at the coarsest depth
and the parent recurrence (ocnn's construct_all_neigh); ``neigh_table``
is the direct sorted-key search it is tested against.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from hotformerloc_torch.octree import morton
from hotformerloc_torch.octree.build import BatchedOctree
from hotformerloc_torch.octree.morton import SENTINEL


@lru_cache(maxsize=None)
def kernel_offsets(kernel: str) -> np.ndarray:
    """Static (K, 3) offsets for a kernel spec, raster order with z
    fastest: '333' -> the 27-tap neighbourhood, '111' -> identity."""
    sizes = [int(c) for c in kernel]
    assert len(sizes) == 3
    ranges = []
    for s in sizes:
        assert s % 2 == 1, "stride-1 kernels must be odd-sized"
        h = s // 2
        ranges.append(np.arange(-h, h + 1))
    grid = np.stack(np.meshgrid(*ranges, indexing="ij"), axis=-1)
    return grid.reshape(-1, 3).astype(np.int32)


@lru_cache(maxsize=None)
def on_device(table, device: torch.device, *args) -> torch.Tensor:
    """The constant ``table(*args)`` (a cached numpy array) as a tensor on
    ``device``, copied there once: a host-to-device copy inside a forward
    waits on the card, which a CUDA graph's capture refuses."""
    return torch.as_tensor(table(*args), device=device)


def lookup(keys: torch.Tensor, counts: torch.Tensor,
           query: torch.Tensor) -> torch.Tensor:
    """Find query keys (B, M) in per-sample sorted keys (B, N) with valid
    counts (B,). Returns (B, M) int32 local indices, -1 where absent
    (SENTINEL queries are never found)."""
    N = keys.shape[1]
    idx = torch.searchsorted(keys.contiguous(), query.contiguous())
    safe = torch.clamp(idx, max=N - 1)
    hit = ((torch.gather(keys, 1, safe) == query) & (query < SENTINEL)
           & (idx < counts[:, None]))
    return torch.where(hit, idx, torch.full_like(idx, -1)).to(torch.int32)


def _tap_keys(keys: torch.Tensor, depth: int, kernel: str):
    """Morton keys of every node's K neighbours under ``kernel``'s
    offsets: (B, K, N) keys and an in-volume mask (False for padding
    nodes)."""
    valid = keys < SENTINEL
    safe = torch.where(valid, keys, torch.zeros_like(keys))
    offs = on_device(kernel_offsets, keys.device, kernel)
    lim = 2**depth
    B, N = keys.shape
    inside = valid[:, None, :].expand(B, offs.shape[0], N)
    nk = torch.zeros((B, offs.shape[0], N), dtype=torch.int32,
                     device=keys.device)
    for a in range(3):
        c = (morton.compact1by2(safe >> (2 - a))[:, None, :]
             + offs[None, :, a, None])
        inside = inside & (c >= 0) & (c < lim)
        nk = nk | (morton.part1by2(c) << (2 - a))
    return nk, inside


def neigh_table(octree: BatchedOctree, depth: int,
                kernel: str = "333") -> torch.Tensor:
    """(B, N_d, K) gather table for a stride-1 conv at ``depth`` by direct
    search over the sorted keys."""
    keys = octree.key(depth)
    B, N = keys.shape
    nk, inside = _tap_keys(keys, depth, kernel)
    q = torch.where(inside, nk, torch.full_like(nk, SENTINEL))
    tab = lookup(keys, octree.count(depth), q.reshape(B, -1))
    return tab.reshape(B, -1, N).transpose(1, 2).contiguous()


@lru_cache(maxsize=None)
def _parent_tap_tables() -> np.ndarray:
    """Static (2, 8, 27) tables: TAP[o, t] = parent-level tap holding the
    neighbour at offset t of a child in octant o; OCT[o, t] = that
    neighbour's octant within it."""
    offs = kernel_offsets("333")
    tap = np.zeros((8, 27), np.int32)
    oct_ = np.zeros((8, 27), np.int32)
    for o in range(8):
        bits = np.array([(o >> 2) & 1, (o >> 1) & 1, o & 1])
        for t in range(27):
            s = bits + offs[t]
            carry = s >> 1
            tap[o, t] = np.argmax(np.all(offs == carry, axis=1))
            b2 = s & 1
            oct_[o, t] = (b2[0] << 2) | (b2[1] << 1) | b2[2]
    return np.stack([tap, oct_])


def _dense_base_neigh(octree: BatchedOctree, depth: int) -> torch.Tensor:
    """Neighbour table at the coarsest depth through a dense inverse map
    key -> node index (8^depth slots per sample)."""
    keys = octree.key(depth)
    B, N = keys.shape
    size = (2**depth) ** 3
    dev = keys.device
    valid = keys < SENTINEL
    # slot `size` is the answer for out-of-volume queries and stays -1;
    # padding rows write to slot size+1, which is cut off.
    slot = torch.where(valid, keys, torch.full_like(keys, size + 1)).long()
    inv = torch.full((B, size + 2), -1, dtype=torch.int32, device=dev)
    ids = torch.arange(N, dtype=torch.int32, device=dev).expand(B, N)
    inv.scatter_(1, slot, ids)
    nk, inside = _tap_keys(keys, depth, "333")
    q = torch.where(inside, nk, torch.full_like(nk, size)).long()
    tab = torch.gather(inv, 1, q.reshape(B, -1)).reshape(B, 27, N)
    return tab.transpose(1, 2).contiguous()


def child_table(octree: BatchedOctree, depth: int) -> torch.Tensor:
    """(B, N_{depth-1}, 8) index of each parent's children at ``depth``
    (-1 where absent): the child->parent map inverted with one scatter."""
    ckeys = octree.key(depth)
    parent = octree.parent(depth)
    B, Nc = ckeys.shape
    Np = octree.cap(depth - 1)
    octant = torch.where(ckeys < SENTINEL, ckeys & 7, torch.zeros_like(ckeys))
    slot = torch.where(parent >= 0, parent * 8 + octant,
                       torch.full_like(parent, Np * 8)).long()
    flat = torch.full((B, Np * 8 + 1), -1, dtype=torch.int32,
                      device=ckeys.device)
    ids = torch.arange(Nc, dtype=torch.int32, device=ckeys.device)
    flat.scatter_(1, slot, ids.expand(B, Nc))
    return flat[:, :Np * 8].reshape(B, Np, 8)


def all_neigh_tables(octree: BatchedOctree,
                     childrens: Tuple[Optional[torch.Tensor], ...]
                     ) -> Tuple[torch.Tensor, ...]:
    """27-tap neighbour tables for every materialised depth, built
    top-down: a node's neighbour at offset t is a fixed child of its
    parent's neighbour at a fixed parent tap. ``childrens``: per level
    the (B, N_{d-1}, 8) child table (None at the coarsest)."""
    tap_tab, oct_tab = on_device(_parent_tap_tables,
                                 octree.leaf_mean.device).long()
    out = [_dense_base_neigh(octree, octree.min_depth)]
    for d in range(octree.min_depth + 1, octree.depth + 1):
        keys = octree.key(d)
        B, N = keys.shape
        parent = octree.parent(d).long()                 # (B, N)
        pneigh = out[-1]                                 # (B, Np, 27)
        children = childrens[octree.level(d)]            # (B, Np, 8)
        o = torch.where(keys < SENTINEL, keys & 7,
                        torch.zeros_like(keys)).long()
        tap = tap_tab[o]                                 # (B, N, 27)
        oct_ = oct_tab[o]
        prow = torch.clamp(parent, min=0)[..., None]     # (B, N, 1)
        pn = torch.gather(pneigh, 1, prow.expand(B, N, 27))
        pn = torch.gather(pn, 2, tap)
        pn = torch.where(parent[..., None] >= 0, pn, torch.full_like(pn, -1))
        Np = children.shape[1]
        cidx = torch.clamp(pn.long(), min=0) * 8 + oct_
        cn = torch.gather(children.reshape(B, Np * 8), 1,
                          cidx.reshape(B, -1)).reshape(B, N, 27)
        out.append(torch.where(pn >= 0, cn, torch.full_like(cn, -1)))
    return tuple(out)
