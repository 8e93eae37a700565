"""Wild-Places tuple generation: training tuples, evaluation sets, and
broken-timestamp repair.

Counterpart of hotformerloc_tpu/tools/wildplaces_tuples.py; both
re-implement the reference's datasets/WildPlaces/
generate_training_tuples.py, generate_test_sets.py, utils.py and
fix_broken_timestamps.py: polygon train/test splits with circular
buffer zones, KDTree radius queries over (easting, northing),
positives r=3 m / non-negatives r=50 m, eval ground truth r=3 m.

CLI:
  python -m hotformerloc_torch.tools.wildplaces_tuples train --root R
  python -m hotformerloc_torch.tools.wildplaces_tuples test-sets --root R
  python -m hotformerloc_torch.tools.wildplaces_tuples fix-timestamps --root R
"""
from __future__ import annotations

import argparse
import csv as csv_mod
import os
import pickle

import numpy as np

from hotformerloc_torch.data.tuples import TrainingTuple
from hotformerloc_torch.tools.geometry import (Polygon, make_circle,
                                               radius_query)

# Split geometry (WildPlaces/utils.py:6-39) — published dataset
# constants, not code.
POLY_VENMAN = [
    Polygon([(-468, -82), (-468, 44), (-314, 44), (-305, 12), (-192, 44),
             (-192, -82)]),
    Polygon([(-78, -171), (-78, -215), (-305, -215), (-305, -171)]),
    Polygon([(-62, 70), (95, 70), (142, 0), (140, -142), (-62, -142)]),
]
POLY_KARAWATHA = [
    Polygon([(-150, 8), (300, 8), (300, -210), (-150, -210)]),
    Polygon([(-215, 618), (-74, 618), (-74, 423), (-215, 423)]),
    Polygon([(-513, 300), (-513, 37), (-321, 37), (-321, 300)]),
]
EXCLUDE_VENMAN = [make_circle(-63, 40), make_circle(114, -143),
                  make_circle(-77, -205), make_circle(-310, -171),
                  make_circle(-433, -82), make_circle(-189, 12)]
EXCLUDE_KARAWATHA = [make_circle(-216, 606), make_circle(-98, 428),
                     make_circle(-316, 260), make_circle(-321, 63),
                     make_circle(-149, -22), make_circle(300, -134)]
# Karawatha easting offset so the two forests' maps don't overlap
# (generate_training_tuples.py:162)
_OFFSET = 10_000_000.0


def load_csv(csv_path: str, rel_cloud_path: str):
    """Rows of dicts with filename/easting/northing/pose from a
    poses CSV (WildPlaces/utils.py:41-52: easting=x, northing=y)."""
    rows = []
    with open(csv_path) as f:
        for row in csv_mod.DictReader(f):
            rows.append({
                "filename": rel_cloud_path + "/" + row["timestamp"]
                            + ".pcd",
                "timestamp": row["timestamp"],
                "easting": float(row["x"]), "northing": float(row["y"]),
                "pose": np.array([float(row[k]) for k in
                                  ("x", "y", "z", "qx", "qy", "qz",
                                   "qw")]),
            })
    return rows


def check_in_test_set(easting, northing, test_polygons, exclude_regions):
    """'test' | 'buffer' | 'train' (WildPlaces/utils.py:54-62)."""
    for poly in test_polygons:
        if poly.contains(easting, northing):
            return "test"
    for region in exclude_regions:
        if region.contains(easting, northing):
            return "buffer"
    return "train"


def construct_query_dict(rows, save_path: str, ind_nn_r: float,
                         ind_r_r: float):
    coords = np.array([[r["easting"], r["northing"]] for r in rows],
                      dtype=np.float64)
    ind_nn = radius_query(coords, coords, ind_nn_r)
    ind_r = radius_query(coords, coords, ind_r_r)
    queries = {}
    for i, row in enumerate(rows):
        ts = float(os.path.splitext(os.path.split(
            row["filename"])[1])[0])
        positives = ind_nn[i]
        positives = np.sort(positives[positives != i])
        queries[i] = TrainingTuple(
            id=i, timestamp=ts, rel_scan_filepath=row["filename"],
            positives=positives, non_negatives=np.sort(ind_r[i]),
            position=coords[i].copy())
    with open(save_path, "wb") as f:
        pickle.dump(queries, f, protocol=pickle.HIGHEST_PROTOCOL)
    print("Done", save_path, f"({len(queries)} queries)")


def _forest_rows(root, forest, csv_filename, cloud_folder, polys,
                 excludes, n_train_runs=2):
    base = os.path.join(root, forest)
    folders = sorted(os.listdir(base))[:n_train_runs]
    train, test, counts = [], [], {"train": 0, "test": 0, "buffer": 0}
    for folder in folders:
        rows = load_csv(os.path.join(base, folder, csv_filename),
                        os.path.join(forest, folder, cloud_folder))
        for row in rows:
            split = check_in_test_set(row["easting"], row["northing"],
                                      polys, excludes)
            counts[split] += 1
            if split == "test":
                test.append(row)
            elif split == "train":
                train.append(row)
    total = sum(counts.values())
    print(f"{forest}: train {counts['train']} "
          f"({counts['train'] / max(total, 1) * 100:.1f}%)  "
          f"test {counts['test']}  buffer {counts['buffer']}")
    return train, test


def generate_training_tuples(root, save_dir, csv_filename, cloud_folder,
                             pos_thresh=3.0, neg_thresh=50.0):
    tv, sv = _forest_rows(root, "Venman", csv_filename, cloud_folder,
                          POLY_VENMAN, EXCLUDE_VENMAN)
    tk, sk = _forest_rows(root, "Karawatha", csv_filename, cloud_folder,
                          POLY_KARAWATHA, EXCLUDE_KARAWATHA)
    for row in tk + sk:   # offset Karawatha easting
        row["easting"] += _OFFSET
    construct_query_dict(tv + tk,
                         os.path.join(save_dir,
                                      "training_wild-places.pickle"),
                         pos_thresh, neg_thresh)
    construct_query_dict(sv + sk,
                         os.path.join(save_dir,
                                      "testing_wild-places.pickle"),
                         pos_thresh, neg_thresh)


def construct_query_and_database_sets(root, forest, folders, cloud_folder,
                                      csv_filename, polys, output_name,
                                      save_dir, eval_thresh=3.0):
    """(generate_test_sets.py:21-80): per run, full database + in-test
    queries; ground truth = database hits within eval_thresh."""
    database_sets, test_sets = [], []
    for folder in folders:
        rows = load_csv(os.path.join(root, forest, folder, csv_filename),
                        os.path.join(forest, folder, cloud_folder))
        database, test = {}, {}
        for row in rows:
            rec = {"query": row["filename"], "northing": row["northing"],
                   "easting": row["easting"], "pose": row["pose"],
                   "timestamp": float(row["timestamp"])}
            if check_in_test_set(row["easting"], row["northing"], polys,
                                 []) == "test":
                test[len(test)] = dict(rec)
            database[len(database)] = dict(rec)
        database_sets.append(database)
        test_sets.append(test)
        single = os.path.join(save_dir,
                              os.path.basename(folder) + ".pickle")
        with open(single, "wb") as f:
            pickle.dump(database, f, protocol=pickle.HIGHEST_PROTOCOL)

    for i, database in enumerate(database_sets):
        coords = np.array([[v["easting"], v["northing"]]
                           for v in database.values()])
        for j, test in enumerate(test_sets):
            if i == j:
                continue
            q = np.array([[test[k]["easting"], test[k]["northing"]]
                          for k in range(len(test))]).reshape(-1, 2)
            if len(q) == 0:
                continue
            hits = radius_query(coords, q, eval_thresh)
            for k in range(len(test)):
                test[k][i] = hits[k].tolist()

    nq = sum(len(t) for t in test_sets)
    nd = sum(len(d) for d in database_sets)
    print(f"{output_name}: Query / Database Size {nq} / {nd}")
    for tag, obj in [("database", database_sets), ("query", test_sets)]:
        out = os.path.join(save_dir,
                           f"{output_name}_evaluation_{tag}.pickle")
        with open(out, "wb") as f:
            pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)
        print("Done", out)


def generate_test_sets(root, save_dir, csv_filename, cloud_folder,
                       eval_thresh=3.0):
    for forest, polys in [("Venman", POLY_VENMAN),
                          ("Karawatha", POLY_KARAWATHA)]:
        folders = sorted(os.listdir(os.path.join(root, forest)))
        construct_query_and_database_sets(root, forest, folders,
                                          cloud_folder, csv_filename,
                                          polys, forest, save_dir,
                                          eval_thresh)


def fix_broken_timestamps(root, csv_filename="poses_aligned.csv",
                          csv_savename="poses_aligned_fixed.csv",
                          cloud_folder="Clouds_downsampled"):
    """Row i's timestamp must equal the i-th sorted cloud filename;
    rewrite mismatches (fix_broken_timestamps.py:32-82)."""
    for forest in ("Venman", "Karawatha"):
        base = os.path.join(root, forest)
        for folder in sorted(os.listdir(base)):
            src = os.path.join(base, folder, csv_filename)
            clouds = sorted(os.listdir(
                os.path.join(base, folder, cloud_folder)))
            correct = [os.path.splitext(c)[0] for c in clouds]
            with open(src) as f:
                reader = csv_mod.DictReader(f)
                fields = reader.fieldnames
                rows = list(reader)
            fixed = 0
            for idx, row in enumerate(rows):
                if row["timestamp"] != correct[idx]:
                    row["timestamp"] = correct[idx]
                    fixed += 1
            dst = os.path.join(base, folder, csv_savename)
            with open(dst, "w", newline="") as f:
                w = csv_mod.DictWriter(f, fieldnames=fields)
                w.writeheader()
                w.writerows(rows)
            print(f"{forest}/{folder}: fixed {fixed}/{len(rows)} -> {dst}")


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("train", "test-sets", "fix-timestamps"):
        p = sub.add_parser(name)
        p.add_argument("--root", required=True)
        p.add_argument("--save_dir", default=None)
        p.add_argument("--csv_filename", default="poses_aligned_fixed.csv"
                       if name != "fix-timestamps" else "poses_aligned.csv")
        p.add_argument("--cloud_folder", default="Clouds_downsampled")
        if name == "train":
            p.add_argument("--pos_thresh", type=float, default=3.0)
            p.add_argument("--neg_thresh", type=float, default=50.0)
        if name == "test-sets":
            p.add_argument("--eval_thresh", type=float, default=3.0)
    args = ap.parse_args()
    assert os.path.exists(args.root), f"Cannot access: {args.root}"
    save_dir = args.save_dir or args.root
    os.makedirs(save_dir, exist_ok=True)
    if args.cmd == "train":
        generate_training_tuples(args.root, save_dir, args.csv_filename,
                                 args.cloud_folder, args.pos_thresh,
                                 args.neg_thresh)
    elif args.cmd == "test-sets":
        generate_test_sets(args.root, save_dir, args.csv_filename,
                           args.cloud_folder, args.eval_thresh)
    else:
        fix_broken_timestamps(args.root, args.csv_filename,
                              cloud_folder=args.cloud_folder)


if __name__ == "__main__":
    main()
