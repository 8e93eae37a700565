"""Relative-position bias by direct table lookup.

Counterpart of hotformerloc_tpu/ops/rpe.py:31 ``rpe_bias_reference``:
per axis, index a (3*(2*bnd+1), H) table with the clipped coordinate
difference of every (query, key) pair of a window and sum the axes.
"""
from __future__ import annotations

import torch


def rpe_index(xyz_w: torch.Tensor, bnd: int):
    """xyz_w: (..., K, 3) int window node coords. Yields, per axis a, the
    (..., K, K) table row a*num + clip(x_a[t] - x_a[s], +-bnd) + bnd of
    every (query t, key s) pair."""
    num = 2 * bnd + 1
    xyz_w = xyz_w.long()
    for a in range(3):
        rel = xyz_w[..., :, None, a] - xyz_w[..., None, :, a]
        yield torch.clamp(rel, -bnd, bnd) + bnd + a * num


def rpe_bias_reference(tab_t: torch.Tensor, xyz_w: torch.Tensor,
                       bnd: int) -> torch.Tensor:
    """tab_t: (H, 3*(2*bnd+1)) transposed table; xyz_w: (B, W, K, 3) int
    window node coords. Returns (B, W, H, K, K) in tab_t.dtype."""
    bias = None
    for ia in rpe_index(xyz_w, bnd):
        ba = tab_t[:, ia]                                # (H, B, W, K, K)
        bias = ba if bias is None else bias + ba
    return bias.permute(1, 2, 0, 3, 4)
