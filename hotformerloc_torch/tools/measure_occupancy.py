"""Per-depth octree occupancy measurement -> tuned ``capacities``.

Counterpart of hotformerloc_tpu/tools/measure_occupancy.py. The default
capacity schedule pads every depth to the worst case min(P, 8^d)
(``models/config.py`` ``default_capacities``), so coarse pyramid levels
spend attention and MLP work on slots that are never occupied. This
tool measures the occupancy distribution over a corpus once, ships
static capacities at a high percentile + safety margin, and the rare
overflow shows in ``BatchedOctree.overflow``, which the train step
reports as ``stats["octree_overflow"]``.

Occupancy at depth d is the number of distinct Morton cells,
|unique(leaf_key >> 3*(depth-d))|. The counts come from the port's own
octree build (``octree/build.py``, on ``--device``, default the card;
the worst-case capacities never overflow), or with ``--device numpy``
from a vectorised numpy Morton encoder (this package's copy of the one
the JAX package golden-tests, bit-exact with ``octree/morton.py``;
tests/test_torch_tools.py holds the two routes and JAX's equal).

Usage:
    # real dataset (clouds go through the same train-time transform):
    python -m hotformerloc_torch.tools.measure_occupancy \
        --config configs/oxford.txt --model-config configs/oxford_model.txt \
        --num-clouds 2000 --out occupancy.json

    # no data on disk: distribution-free near-worst-case corpus
    # (uniform fill maximises distinct cells at every depth for a fixed
    # point budget; real clustered lidar sits strictly below it):
    python -m hotformerloc_torch.tools.measure_occupancy \
        --synthetic uniform --num-clouds 512 --out occupancy.json

Paste the suggested ``capacities = ...`` line into the [MODEL] section of
the dataset's *_model.txt (parsed by config/params.py) or pass
``capacities=`` to the ModelConfig.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


# -- numpy Morton (mirrors octree/morton.py, validated against it) ------

def _part1by2(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.int64) & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def encode_np(xyz: np.ndarray) -> np.ndarray:
    return (_part1by2(xyz[..., 0]) << 2) | (_part1by2(xyz[..., 1]) << 1) \
        | _part1by2(xyz[..., 2])


def points_to_grid_np(points: np.ndarray, depth: int) -> np.ndarray:
    scale = np.float32(2 ** (depth - 1))
    u = np.floor((points.astype(np.float32) + 1.0) * scale)
    return np.clip(u, 0, 2 ** depth - 1).astype(np.int64)


def occupancy_counts(points: np.ndarray, depth: int, min_depth: int,
                     mask: Optional[np.ndarray] = None) -> np.ndarray:
    """(P, 3) float cloud in [-1,1] -> per-depth distinct-cell counts,
    index 0 == min_depth (the layout of BatchedOctree.counts)."""
    if mask is not None:
        points = points[mask]
    keys = np.unique(encode_np(points_to_grid_np(points, depth)))
    out = np.empty(depth - min_depth + 1, dtype=np.int64)
    out[-1] = keys.size
    for d in range(depth - 1, min_depth - 1, -1):
        keys = np.unique(keys >> 3)
        out[d - min_depth] = keys.size
    return out


# -- capacity suggestion -------------------------------------------------

def suggest_capacities(counts: np.ndarray, cfg,
                       percentile: float = 99.9,
                       margin: float = 1.1) -> Tuple[int, ...]:
    """counts: (N, depths) per-cloud occupancy. Suggestion per depth =
    round_up(percentile * margin) under the same alignment rules as
    ModelConfig.resolve_capacities (block_num at transformer depths, 8
    at stem depths), never above the default worst-case cap."""
    from hotformerloc_torch.models.config import round_up
    worst = cfg.resolve_capacities()
    q = np.percentile(counts, percentile, axis=0)
    caps: List[int] = []
    for i, v in enumerate(q):
        d = cfg.min_depth + i
        mult = cfg.block_num if d <= cfg.transformer_depth else 8
        caps.append(min(round_up(max(int(v * margin), 1), mult), worst[i]))
    return tuple(caps)


def padded_fraction(counts: np.ndarray, caps: Sequence[int]) -> float:
    """Mean fraction of node slots that are padding under `caps`
    (clipped: overflowing clouds count as fully occupied)."""
    occ = np.minimum(counts, np.asarray(caps)[None, :]).sum(axis=1)
    return float(1.0 - occ.mean() / sum(caps))


def overflow_rate(counts: np.ndarray, caps: Sequence[int]) -> float:
    """Fraction of clouds that would drop >= 1 node under `caps`."""
    return float(np.mean((counts > np.asarray(caps)[None, :]).any(axis=1)))


# -- corpora -------------------------------------------------------------

def synthetic_corpus(kind: str, n: int, num_points: int,
                     seed: int = 0) -> List[np.ndarray]:
    """'uniform': i.i.d. uniform fill (distribution-free near-worst-case
    occupancy). 'surface': lidar-like 2.5D scene (ground plane + random
    vertical facades + scatter), matching how outdoor scans occupy a
    thin slab of the volume."""
    rng = np.random.default_rng(seed)
    clouds = []
    for _ in range(n):
        if kind == "uniform":
            c = rng.uniform(-0.9, 0.9, (num_points, 3))
        elif kind == "surface":
            n_g = num_points // 2
            n_w = num_points // 4
            ground = np.stack([rng.uniform(-1, 1, n_g),
                               rng.uniform(-1, 1, n_g),
                               rng.normal(-0.8, 0.02, n_g)], 1)
            walls = []
            for _ in range(6):
                cx, cy = rng.uniform(-0.8, 0.8, 2)
                ang = rng.uniform(0, np.pi)
                t = rng.uniform(-0.15, 0.15, n_w // 6)
                walls.append(np.stack(
                    [cx + t * np.cos(ang), cy + t * np.sin(ang),
                     rng.uniform(-0.8, rng.uniform(-0.4, 0.6),
                                 n_w // 6)], 1))
            rest = num_points - n_g - sum(len(w) for w in walls)
            scatter = np.stack([rng.uniform(-1, 1, rest),
                                rng.uniform(-1, 1, rest),
                                rng.uniform(-0.8, 0.2, rest)], 1)
            c = np.concatenate([ground] + walls + [scatter], 0)
            c += rng.normal(0, 0.005, c.shape)
        else:
            raise ValueError(f"unknown synthetic corpus kind: {kind}")
        clouds.append(np.clip(c, -1, 1).astype(np.float32))
    return clouds


def dataset_corpus(params, n: int, seed: int = 0) -> List[np.ndarray]:
    """Sample n clouds from the training pickle THROUGH the train-time
    augmentation (occupancy must be measured post-transform — rotations
    and jitter change cell occupancy)."""
    from hotformerloc_torch.data.augmentation import make_train_transform
    from hotformerloc_torch.data.loaders import get_pointcloud_loader
    from hotformerloc_torch.data.pipeline import TrainingDataset
    ds = TrainingDataset(
        params.dataset_folder, params.train_file,
        get_pointcloud_loader(params.dataset_name or ""),
        make_train_transform(params.aug_mode, params.normalize_points,
                             params.scale_factor, params.unit_sphere_norm,
                             params.zero_mean, params.random_rot_theta),
        None, params.model_params.coordinates)
    rng = np.random.default_rng(seed)
    labels = rng.choice(list(ds.queries.keys()),
                        size=min(n, len(ds.queries)), replace=False)
    return [ds.finalize_cloud(ds.load_cloud(int(l), rng)) for l in labels]


# -- counts from the port's octree ----------------------------------------

def octree_occupancy(clouds: Sequence[np.ndarray], cfg, device="cuda",
                     batch: int = 64) -> np.ndarray:
    """(N, depths) per-cloud occupancy from the port's octree build
    (``build_batched_octree`` at the worst-case capacities, which no
    cloud overflows) on ``device``, ``batch`` clouds at a time; index 0
    == min_depth. Each cloud is cut to its first num_points points."""
    import torch

    from hotformerloc_torch.data.pipeline import pack_clouds
    from hotformerloc_torch.models.config import default_capacities
    from hotformerloc_torch.octree.build import build_batched_octree
    P = cfg.num_points
    caps = default_capacities(P, cfg.octree_depth, cfg.min_depth)
    out = []
    for i in range(0, len(clouds), batch):
        pts, msk = pack_clouds([c[:P] for c in clouds[i:i + batch]], P)
        oc = build_batched_octree(torch.from_numpy(pts).to(device),
                                  torch.from_numpy(msk).to(device),
                                  cfg.octree_depth, cfg.min_depth, caps)
        if int(oc.overflow.sum()):
            raise AssertionError("worst-case capacities overflowed")
        out.append(torch.stack(
            [oc.count(d) for d in range(cfg.min_depth,
                                        cfg.octree_depth + 1)], 1).cpu())
    return torch.cat(out).numpy().astype(np.int64)


# -- CLI -----------------------------------------------------------------

def measure(clouds: Sequence[np.ndarray], cfg,
            percentile: float = 99.9, margin: float = 1.1,
            device: Optional[str] = None) -> Dict:
    """Occupancy statistics and the suggested capacities of ``clouds``;
    counts from the port's octree on ``device``, or from the numpy
    encoder when ``device`` is None."""
    if device is None:
        counts = np.stack([
            occupancy_counts(c[: cfg.num_points], cfg.octree_depth,
                             cfg.min_depth) for c in clouds])
    else:
        counts = octree_occupancy(clouds, cfg, device)
    worst = cfg.resolve_capacities()
    tuned = suggest_capacities(counts, cfg, percentile, margin)
    depths = list(range(cfg.min_depth, cfg.octree_depth + 1))
    per_depth = []
    for i, d in enumerate(depths):
        col = counts[:, i]
        per_depth.append({
            "depth": d, "mean": round(float(col.mean()), 1),
            "p50": int(np.percentile(col, 50)),
            "p99": int(np.percentile(col, 99)),
            "max": int(col.max()),
            "cap_default": worst[i], "cap_tuned": tuned[i]})
    return {
        "num_clouds": len(clouds),
        "percentile": percentile, "margin": margin,
        "per_depth": per_depth,
        "capacities": list(tuned),
        "padded_frac_default": round(padded_fraction(counts, worst), 4),
        "padded_frac_tuned": round(padded_fraction(counts, tuned), 4),
        "overflow_rate_tuned": overflow_rate(counts, tuned),
        "config_line": "capacities = " + ",".join(map(str, tuned)),
    }


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Measure and print (and with ``--out`` write) the result."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", help="training INI (for a real dataset)")
    ap.add_argument("--model-config", help="model INI")
    ap.add_argument("--synthetic", choices=["uniform", "surface"],
                    help="measure a synthetic corpus instead of a dataset")
    ap.add_argument("--num-clouds", type=int, default=512)
    ap.add_argument("--num-points", type=int, default=4096)
    ap.add_argument("--octree-depth", type=int, default=9)
    ap.add_argument("--percentile", type=float, default=99.9)
    ap.add_argument("--margin", type=float, default=1.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the octree build, or 'numpy' "
                         "for the numpy encoder")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.model_config:
        # geometry from the shipped model INI (patch_size/dilation set
        # the capacity alignment), clouds from the dataset or synthetic
        from hotformerloc_torch.config.params import parse_model_config
        cfg = parse_model_config(args.model_config,
                                 octree_depth=args.octree_depth,
                                 num_points=args.num_points).config
    else:
        from hotformerloc_torch.models.config import oxford_config
        cfg = oxford_config(num_points=args.num_points,
                            octree_depth=args.octree_depth)
    if args.synthetic:
        clouds = synthetic_corpus(args.synthetic, args.num_clouds,
                                  args.num_points, args.seed)
    else:
        from hotformerloc_torch.config.params import parse_train_config
        params = parse_train_config(args.config, args.model_config,
                                    num_points=args.num_points)
        cfg = params.model_params.config
        clouds = dataset_corpus(params, args.num_clouds, args.seed)

    res = measure(clouds, cfg, args.percentile, args.margin,
                  None if args.device == "numpy" else args.device)
    line = json.dumps(res, indent=2)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line)
    return res


if __name__ == "__main__":
    main()
