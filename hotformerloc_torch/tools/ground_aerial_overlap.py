"""Ground ↔ aerial submap overlap statistics for CS-Wild-Places.

Counterpart of hotformerloc_tpu/tools/ground_aerial_overlap.py; both
re-implement the reference's misc/compute_ground_aerial_overlap.py: for
each split, match every ground submap to its nearest aerial
(or airborne) submap by (x, y) pose, align the ground cloud into the
aerial frame via the relative SE(3) pose, and score the pair. The
reference leaves the actual metric as a TODO; here the chamfer
distance and an overlap ratio (fraction of aligned ground points with
an aerial point within a threshold) are implemented and averaged per
split. Runs on unnormalised postprocessed data.

Usage:
  python -m hotformerloc_torch.tools.ground_aerial_overlap \
      --postproc_path DIR --database_type aerial \
      [--positive_max_thresh 10] [--overlap_radius 0.5]
"""
from __future__ import annotations

import argparse
import csv
import os
from typing import Dict, List

import numpy as np

from hotformerloc_torch.data.loaders import CSWildPlacesPointCloudLoader
from hotformerloc_torch.tools.preprocess import quaternion_to_rot

CLOUD_SAVE_DIR = "clouds"
POSES_FILENAME = "poses.csv"


def load_poses(csv_path: str) -> List[Dict]:
    with open(csv_path, newline="") as f:
        return [dict(r) for r in csv.DictReader(f)]


def se3(row: Dict) -> np.ndarray:
    """Pose row -> 4x4 cloud-frame -> world transform."""
    m = np.eye(4)
    m[:3, :3] = quaternion_to_rot(np.array(
        [float(row["qx"]), float(row["qy"]), float(row["qz"]),
         float(row["qw"])]))
    m[:3, 3] = [float(row["x"]), float(row["y"]), float(row["z"])]
    return m


def relative_pose(m1: np.ndarray, m2: np.ndarray) -> np.ndarray:
    """frame1 -> frame2 transform from two frame->world poses."""
    return np.linalg.inv(m2) @ m1


def apply_transform(pc: np.ndarray, m: np.ndarray) -> np.ndarray:
    return pc @ m[:3, :3].T + m[:3, 3]


def nn_dists(a: np.ndarray, b: np.ndarray,
             chunk: int = 2048) -> np.ndarray:
    """Per-point distance from each row of `a` to its nearest row of
    `b` (brute force in chunks; avoids a KDTree dependency for clouds
    of ~10^3-10^4 points)."""
    try:
        from sklearn.neighbors import KDTree
        d, _ = KDTree(b).query(a, k=1)
        return d[:, 0]
    except ImportError:
        out = np.empty(len(a))
        for i in range(0, len(a), chunk):
            d2 = ((a[i:i + chunk, None, :] - b[None, :, :]) ** 2).sum(-1)
            out[i:i + chunk] = np.sqrt(d2.min(axis=1))
        return out


def pair_metrics(ground_aligned: np.ndarray, aerial: np.ndarray,
                 overlap_radius: float) -> Dict[str, float]:
    d_ga = nn_dists(ground_aligned, aerial)
    d_ag = nn_dists(aerial, ground_aligned)
    return {
        "chamfer": float(d_ga.mean() + d_ag.mean()),
        "overlap_ratio": float((d_ga <= overlap_radius).mean()),
    }


def process_split(split_path: str, database_type: str, loader,
                  positive_max_thresh: float,
                  overlap_radius: float) -> Dict[str, float]:
    runs = sorted(os.listdir(split_path))
    ground_runs = [r for r in runs if "ground" in r]
    air_runs = [r for r in runs if database_type in r]
    assert ground_runs and air_runs, (
        f"{split_path}: missing ground or {database_type} runs")
    assert len(air_runs) == 1, \
        f"expected one {database_type} run per split, got {air_runs}"
    air_path = os.path.join(split_path, air_runs[0])
    air_poses = load_poses(os.path.join(air_path, POSES_FILENAME))
    air_xy = np.array([[float(r["x"]), float(r["y"])] for r in air_poses])

    chamfers, overlaps, skipped = [], [], 0
    for ground_run in ground_runs:
        g_path = os.path.join(split_path, ground_run)
        g_poses = load_poses(os.path.join(g_path, POSES_FILENAME))
        for row in g_poses:
            xy = np.array([float(row["x"]), float(row["y"])])
            d = np.linalg.norm(air_xy - xy, axis=1)
            j = int(d.argmin())
            if d[j] > positive_max_thresh:
                skipped += 1
                continue
            g_pc = loader(os.path.join(
                g_path, CLOUD_SAVE_DIR, row["timestamp"] + ".pcd"))
            a_pc = loader(os.path.join(
                air_path, CLOUD_SAVE_DIR,
                air_poses[j]["timestamp"] + ".pcd"))
            tf = relative_pose(se3(row), se3(air_poses[j]))
            m = pair_metrics(apply_transform(g_pc[:, :3], tf),
                             a_pc[:, :3], overlap_radius)
            chamfers.append(m["chamfer"])
            overlaps.append(m["overlap_ratio"])
    return {"pairs": len(chamfers), "skipped": skipped,
            "mean_chamfer": float(np.mean(chamfers)) if chamfers else 0.0,
            "mean_overlap": float(np.mean(overlaps)) if overlaps else 0.0}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--postproc_path", required=True,
                    help="postprocessed (UNNORMALISED) data root")
    ap.add_argument("--database_type", choices=["aerial", "airborne"],
                    default="aerial")
    ap.add_argument("--positive_max_thresh", type=float, default=10.0,
                    help="max metres to accept a ground-aerial match")
    ap.add_argument("--overlap_radius", type=float, default=0.5,
                    help="NN radius (m) counted as overlapping")
    args = ap.parse_args()
    assert os.path.isdir(args.postproc_path), "Invalid path"

    loader = CSWildPlacesPointCloudLoader()
    splits = sorted(os.listdir(args.postproc_path))
    assert splits, "Invalid root dir, no splits found"
    for split in splits:
        stats = process_split(os.path.join(args.postproc_path, split),
                              args.database_type, loader,
                              args.positive_max_thresh,
                              args.overlap_radius)
        print(f"{split}: pairs={stats['pairs']} skipped={stats['skipped']} "
              f"mean_chamfer={stats['mean_chamfer']:.3f}m "
              f"mean_overlap={stats['mean_overlap']:.3f}")


if __name__ == "__main__":
    main()
