"""Visualise positive pairs of point clouds from a training pickle.

Counterpart of hotformerloc_tpu/tools/visualise_positives.py; both
re-implement the reference's misc/visualisation_positives.py: walk the
training tuples with a stride, pick a random positive per anchor (or,
with --ground_aerial, the first aerial positive of a ground anchor),
report the metric distance, and plot/save the two clouds side by side.

Usage:
  python -m hotformerloc_torch.tools.visualise_positives \
      --dataset_root DIR --training_tuples_path train.pickle \
      [--ground_aerial] [--out_dir figs/] [--skip 100]
"""
from __future__ import annotations

import argparse
import os
import pickle
import random

import numpy as np

from hotformerloc_torch.data.loaders import (CSWildPlacesPointCloudLoader,
                                             PNVPointCloudLoader)
from hotformerloc_torch.utils.seed import set_seed

BIN_LOADER = PNVPointCloudLoader()
PCD_LOADER = CSWildPlacesPointCloudLoader()


def load_pcl(path: str) -> np.ndarray:
    ext = os.path.splitext(path)[-1]
    if ext == ".bin":
        return BIN_LOADER.read_pc(path)
    if ext == ".pcd":
        return PCD_LOADER.read_pc(path)
    raise ValueError("Invalid point cloud type, must be .bin or .pcd")


def pick_positive(tuples, anchor, ground_aerial: bool):
    """(positive tuple | None) per the reference's selection rules."""
    if not ground_aerial:
        if len(anchor.positives) == 0:
            return None
        return tuples[random.choice(list(anchor.positives))]
    if "ground" not in anchor.rel_scan_filepath:
        return None
    for pid in anchor.positives:
        cand = tuples[pid]
        if "ground" not in cand.rel_scan_filepath:
            return cand
    return None


def plot_pair(anchor_pc, positive_pc, title: str, out_path=None):
    import matplotlib.pyplot as plt
    fig = plt.figure(figsize=(12, 6))
    fig.suptitle(title)
    for i, (pc, name) in enumerate([(anchor_pc, "anchor"),
                                    (positive_pc, "positive")]):
        ax = fig.add_subplot(1, 2, i + 1, projection="3d")
        ax.scatter(pc[:, 0], pc[:, 1], pc[:, 2], s=1)
        ax.set_title(name)
        ax.set_aspect("equal", adjustable="box")
    plt.tight_layout()
    if out_path:
        plt.savefig(out_path, dpi=120)
        plt.close(fig)
        print(f"saved {out_path}")
    else:
        plt.show()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset_root", required=True)
    ap.add_argument("--training_tuples_path", required=True)
    ap.add_argument("--ground_aerial", action="store_true",
                    help="only ground anchors with aerial positives")
    ap.add_argument("--skip", type=int, default=100,
                    help="visualise every skip-th tuple")
    ap.add_argument("--out_dir", default=None,
                    help="save PNGs here instead of showing windows")
    args = ap.parse_args()
    assert os.path.isdir(args.dataset_root), "Invalid directory"
    assert os.path.isfile(args.training_tuples_path), "Invalid path"
    set_seed()

    with open(args.training_tuples_path, "rb") as f:
        tuples = pickle.load(f)
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)

    keys = sorted(tuples.keys()) if isinstance(tuples, dict) \
        else range(len(tuples))
    for i in list(keys)[::args.skip]:
        anchor = tuples[i]
        pos = pick_positive(tuples, anchor, args.ground_aerial)
        if pos is None:
            continue
        dist = float(np.linalg.norm(np.abs(anchor.position - pos.position)))
        print(f"tuple {i}: positive distance {dist:.2f}m")
        a_pc = load_pcl(os.path.join(args.dataset_root,
                                     anchor.rel_scan_filepath))
        p_pc = load_pcl(os.path.join(args.dataset_root,
                                     pos.rel_scan_filepath))
        out = os.path.join(args.out_dir, f"pair_{i:06d}.png") \
            if args.out_dir else None
        plot_pair(a_pc, p_pc, f"pair {i} ({dist:.1f}m apart)", out)


if __name__ == "__main__":
    main()
