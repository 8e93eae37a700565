"""Repair broken timestamps in Wild-Places pose CSVs.

Counterpart of hotformerloc_tpu/tools/fix_broken_timestamps.py; both
re-implement the reference's datasets/WildPlaces/fix_broken_timestamps.py:
some `poses_aligned.csv` rows carry truncated/rounded timestamps that no
longer match the cloud filenames; row order does match the sorted cloud
listing, so the fix is to overwrite each row's timestamp with the
basename of the i-th sorted cloud file and write `<csv_savename>`.

Usage:
  python -m hotformerloc_torch.tools.fix_broken_timestamps --root DIR \
      [--csv_filename poses_aligned.csv] \
      [--csv_savename poses_aligned_fixed.csv] \
      [--cloud_folder Clouds_downsampled]
"""
from __future__ import annotations

import argparse
import csv
import os

FORESTS = ("Venman", "Karawatha")


def fix_run(run_path: str, csv_filename: str, csv_savename: str,
            cloud_folder: str) -> int:
    """Fix one run folder; returns the number of repaired rows."""
    csv_path = os.path.join(run_path, csv_filename)
    clouds_path = os.path.join(run_path, cloud_folder)
    if not (os.path.isfile(csv_path) and os.path.isdir(clouds_path)):
        return 0
    correct = [os.path.splitext(f)[0]
               for f in sorted(os.listdir(clouds_path))]
    with open(csv_path, newline="") as f:
        reader = csv.DictReader(f)
        fields = reader.fieldnames
        rows = list(reader)
    assert len(rows) == len(correct), (
        f"{run_path}: {len(rows)} pose rows vs {len(correct)} clouds")
    fixed = 0
    for i, row in enumerate(rows):
        if row["timestamp"] != correct[i]:
            row["timestamp"] = correct[i]
            fixed += 1
    out_path = os.path.join(run_path, csv_savename)
    with open(out_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fields)
        writer.writeheader()
        writer.writerows(rows)
    return fixed


def main():
    ap = argparse.ArgumentParser(
        description="Fix Wild-Places broken timestamps")
    ap.add_argument("--root", required=True, help="Dataset root folder")
    ap.add_argument("--csv_filename", default="poses_aligned.csv")
    ap.add_argument("--csv_savename", default="poses_aligned_fixed.csv")
    ap.add_argument("--cloud_folder", default="Clouds_downsampled")
    args = ap.parse_args()
    assert os.path.exists(args.root), f"Cannot access: {args.root}"

    for forest in FORESTS:
        base = os.path.join(args.root, forest)
        if not os.path.isdir(base):
            print(f"[skip] {base} not found")
            continue
        for run in sorted(os.listdir(base)):
            run_path = os.path.join(base, run)
            if not os.path.isdir(run_path):
                continue
            n = fix_run(run_path, args.csv_filename, args.csv_savename,
                        args.cloud_folder)
            print(f"{forest}/{run}: fixed {n} timestamps")
    print("Done")


if __name__ == "__main__":
    main()
