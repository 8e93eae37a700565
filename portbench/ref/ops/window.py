# Frozen copy of hotformerloc_torch/ops/window.py at commit
# 17534d0, for portbench's plain reference: every CUDA kernel call is
# replaced by its plain formulation, data parallelism is dropped.
"""Window partition, masks and window statistics.

Counterpart of hotformerloc_tpu/ops/window.py. Node arrays have a fixed
capacity that is a multiple of patch_size * dilation, so partition is a
reshape and windows never straddle two samples.
"""
from __future__ import annotations

import torch

from portbench.ref.octree import morton

# Additive logit penalty for masked attention slots (applied to fp32
# logits).
MASK_VALUE = -1e9


def data_to_windows(x: torch.Tensor, patch_size: int,
                    dilation: int = 1) -> torch.Tensor:
    """(B, N, ...) -> (B, W, K, ...); with dilation D, window w of each
    block of K*D nodes holds every D-th node."""
    B, N = x.shape[:2]
    K, D = patch_size, dilation
    tail = x.shape[2:]
    if D > 1:
        x = x.reshape(B, N // (K * D), K, D, *tail).transpose(2, 3)
    return x.reshape(B, N // K, K, *tail)


def windows_to_data(x: torch.Tensor, patch_size: int,
                    dilation: int = 1) -> torch.Tensor:
    """Inverse of :func:`data_to_windows`."""
    B, W, K = x.shape[:3]
    tail = x.shape[3:]
    D = dilation
    if D > 1:
        x = x.reshape(B, W // D, D, K, *tail).transpose(2, 3)
    return x.reshape(B, W * K, *tail)


def window_key_mask(node_valid: torch.Tensor, patch_size: int,
                    dilation: int = 1) -> torch.Tensor:
    """Node validity -> per-window key mask (B, W, K) bool."""
    return data_to_windows(node_valid, patch_size, dilation)


def window_valid(node_valid: torch.Tensor, patch_size: int,
                 dilation: int = 1) -> torch.Tensor:
    """(B, W) bool: the window holds at least one valid node."""
    return window_key_mask(node_valid, patch_size, dilation).any(dim=-1)


def window_stats(xyz: torch.Tensor, node_valid: torch.Tensor, depth: int,
                 patch_size: int, mode: str = "cov") -> torch.Tensor:
    """Per-window point statistics for ADaPE, (B, W, 3 / 6 / 9) for mode
    'pos' / 'var' / 'cov': the mean (x, y, z), then ('var') the unbiased
    variances [xx, yy, zz] or ('cov') the unbiased covariance entries
    [xx, xy, xz, yy, yz, zz]. Windows with < 2 valid nodes get zero
    (co)variance."""
    if mode not in ("pos", "var", "cov"):
        raise NotImplementedError(f"adape_mode={mode!r}")
    pts = morton.grid_to_points(xyz, depth)           # (B, N, 3)
    pw = data_to_windows(pts, patch_size)             # (B, W, K, 3)
    mw = data_to_windows(node_valid, patch_size).to(torch.float32)
    n = mw.sum(dim=-1)                                # (B, W)
    mean = ((pw * mw[..., None]).sum(dim=2)
            / torch.clamp(n, min=1.0)[..., None])
    if mode == "pos":
        return mean
    c = (pw - mean[:, :, None, :]) * mw[..., None]
    denom = torch.clamp(n - 1.0, min=1.0)[:, :, None, None]
    cov = torch.einsum("bwki,bwkj->bwij", c, c) / denom
    cov = torch.where((n >= 2)[:, :, None, None], cov, torch.zeros_like(cov))
    pairs = ((0, 0), (1, 1), (2, 2)) if mode == "var" else (
        (0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
    tri = torch.stack([cov[..., i, j] for i, j in pairs], -1)
    return torch.cat([mean, tri], dim=-1)


def masked_window_mean(x: torch.Tensor, node_valid: torch.Tensor,
                       patch_size: int) -> torch.Tensor:
    """Mean of the valid node features per window (the relay-token
    init); empty windows give 0."""
    xw = data_to_windows(x, patch_size)
    mw = data_to_windows(node_valid, patch_size).to(x.dtype)
    s = torch.einsum("bwkc,bwk->bwc", xw, mw)
    n = torch.clamp(mw.sum(dim=-1), min=1.0)
    return s / n[..., None]
