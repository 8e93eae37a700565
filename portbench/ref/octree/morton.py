# Frozen copy of hotformerloc_torch/octree/morton.py at commit
# 17534d0, for portbench's plain reference: every CUDA kernel call is
# replaced by its plain formulation, data parallelism is dropped.
"""Morton (z-order) keys: 3*depth-bit codes, x most significant within
each bit triple, stored as int32 (depth <= 10). Bit-identical to the JAX
package's keys (hotformerloc_tpu/octree/morton.py)."""
from __future__ import annotations

import torch

# Larger than every valid key (30 bits): marks padding so it sorts last.
SENTINEL = 2**30

_MAX_DEPTH = 10


def part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of ``x`` so bit i moves to bit 3*i."""
    x = x.to(torch.int32) & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def compact1by2(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`part1by2`: collect every third bit."""
    x = x.to(torch.int32) & 0x09249249
    x = (x | (x >> 2)) & 0x030C30C3
    x = (x | (x >> 4)) & 0x0300F00F
    x = (x | (x >> 8)) & 0x030000FF
    x = (x | (x >> 16)) & 0x000003FF
    return x


def encode(xyz: torch.Tensor) -> torch.Tensor:
    """Integer coords (..., 3) -> Morton keys (...,) int32."""
    return ((part1by2(xyz[..., 0]) << 2) | (part1by2(xyz[..., 1]) << 1)
            | part1by2(xyz[..., 2]))


def decode(key: torch.Tensor) -> torch.Tensor:
    """Morton keys (...,) -> integer coords (..., 3) int32."""
    return torch.stack([compact1by2(key >> 2), compact1by2(key >> 1),
                        compact1by2(key)], dim=-1)


def points_to_grid(points: torch.Tensor, depth: int) -> torch.Tensor:
    """Points in [-1, 1]^3 -> voxel coords floor((p+1) * 2^(depth-1))
    clamped into [0, 2^depth - 1], int32."""
    assert depth <= _MAX_DEPTH, f"depth {depth} exceeds int32 Morton range"
    u = torch.floor((points.to(torch.float32) + 1.0) * float(2 ** (depth - 1)))
    return torch.clamp(u, 0, 2**depth - 1).to(torch.int32)


def grid_to_points(xyz: torch.Tensor, depth: int) -> torch.Tensor:
    """Voxel coords at ``depth`` -> [-1, 1]: p = u * 2^(1-d) - 1."""
    return xyz.to(torch.float32) * float(2.0 ** (1 - depth)) - 1.0
