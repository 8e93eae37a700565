"""The traffic generator: pools of lidar-like surface clouds from the
seed, made once in set-up and served in turn.

``surface_cloud`` is a frozen copy of chip_smoke.py's ``surface_cloud``
(commit 17534d0): ``points`` points on 3-4 random planes through the
cube. A traffic file gives the parameters:

    {"points": 4096, "batch": 32, "pool": 8, "pairs": false}

``pairs``: each place appears twice with N(0, ``noise``) jitter, rows
2i and 2i + 1 (bench.py's training batch), which gives the positives
and negatives masks of the metric-learning loss.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def surface_cloud(rng, points=4096, normals=False):
    """``points`` points on 3-4 random planes through the cube (uniform in
    a 1.8-wide square about a centre in +-0.5, clipped to +-0.95),
    float32: its nodes have more valid taps than a uniform cloud's. With
    ``normals`` also each point's unit plane normal (exact; the same
    points either way)."""
    out = np.empty((points, 3), np.float32)
    nrm = np.empty((points, 3), np.float32)
    n_planes = int(rng.integers(3, 5))
    which = rng.integers(0, n_planes, points)
    for i in range(n_planes):
        basis, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        sel = which == i
        ab = rng.uniform(-0.9, 0.9, (int(sel.sum()), 2))
        out[sel] = rng.uniform(-0.5, 0.5, 3) + ab @ basis[:, :2].T
        nrm[sel] = basis[:, 2]
    out = np.clip(out, -0.95, 0.95)
    return (out, nrm) if normals else out


def make_pool(traffic: Dict, seed: int) -> Dict[str, np.ndarray]:
    """{'points': (pool, batch, points, 3) float32} and, for ``pairs``,
    '(positives|negatives)_mask' (batch, batch) bool, shared by every
    batch of the pool. The same seed gives the same pool."""
    rng = np.random.default_rng(int(seed))
    P, B, N = int(traffic["pool"]), int(traffic["batch"]), \
        int(traffic["points"])
    pairs = bool(traffic.get("pairs", False))
    places = B // 2 if pairs else B
    pts = np.stack([np.stack([surface_cloud(rng, N) for _ in range(places)])
                    for _ in range(P)])
    out = {}
    if pairs:
        pts = np.repeat(pts, 2, axis=1)
        pts += rng.normal(0.0, float(traffic["noise"]),
                          pts.shape).astype(np.float32)
        groups = np.repeat(np.arange(places), 2)
        same = groups[:, None] == groups[None]
        out["positives_mask"] = same & ~np.eye(B, dtype=bool)
        out["negatives_mask"] = ~same
    out["points"] = np.ascontiguousarray(pts, dtype=np.float32)
    return out
