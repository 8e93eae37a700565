"""CS-Wild-Places train/test tuple generation.

Counterpart of hotformerloc_tpu/tools/cswildplaces_tuples.py; both
re-implement the reference's
datasets/CSWildPlaces/generate_train_test_tuples.py:63-480: per-forest
UTM test polygons, ground-query-seeded buffer zones (KDTree radius),
aerial submaps as the retrieval database, baseline (Karawatha+Venman)
vs refined (all forests) training splits, v1
(query/positives/negatives dict) and v2 (TrainingTuple) pickle formats,
ground/aerial positive filtering modes.

CLI:
  python -m hotformerloc_torch.tools.cswildplaces_tuples --root R \
      --save_dir S --pos_thresh 15 --neg_thresh 60 --buffer_thresh 30 \
      [--eval_thresh 30] [--refined] [--v2_only]
      [--query_requires_ground | --ground_aerial_positives_only]
"""
from __future__ import annotations

import argparse
import csv as csv_mod
import os
import pickle
from typing import Dict, List

import numpy as np

from hotformerloc_torch.data.tuples import TrainingTuple
from hotformerloc_torch.tools.geometry import Polygon, radius_query

CLOUD_DIR = "clouds/"
POSES_FILE = "poses.csv"
RANDOM_SEED = 42
VAL_SPLITS = ["Karawatha", "Venman"]
BASELINE_SPLITS = ["Karawatha", "Venman"]

# Test regions in UTM (generate_train_test_tuples.py:38-60) — published
# dataset constants, not code.
POLY_DICT = {
    "QCAT": [Polygon([(490500, 6955000), (490500, 6956000),
                      (491500, 6956000), (491500, 6955000)])],
    "Samford": [Polygon([(487000, 6969000), (487000, 6971000),
                         (489000, 6971000), (489000, 6969000)])],
    "Karawatha": [
        Polygon([(507018.60467, 6942659.3756), (507468.60473, 6942659.6724),
                 (507468.74853, 6942441.6724), (507018.74850, 6942441.3756)]),
        Polygon([(506953.20227, 6943269.3327), (507094.20227, 6943269.4257),
                 (507094.33093, 6943074.4257), (506953.33090, 6943074.3327)]),
        Polygon([(506655.41198, 6942951.1361), (506655.58551, 6942688.1361),
                 (506847.58554, 6942688.2628), (506847.41204, 6942951.2627)]),
    ],
    "Venman": [
        Polygon([(519331.85162354, 6943652.20440674),
                 (519331.19000244, 6943778.20266724),
                 (519485.18786621, 6943779.01129150),
                 (519494.35580444, 6943747.05899048),
                 (519607.18621826, 6943779.65188599),
                 (519607.84783936, 6943653.65362549)]),
        Polygon([(519722.31359863, 6943565.25347900),
                 (519722.54461670, 6943521.25408936),
                 (519495.54779053, 6943520.06213379),
                 (519495.31674194, 6943564.06152344)]),
        Polygon([(519737.04788208, 6943806.33413696),
                 (519894.04573059, 6943807.15850830),
                 (519941.41265869, 6943737.40628052),
                 (519940.15832520, 6943595.39773560),
                 (519738.16110229, 6943594.33709717)]),
    ],
}


def _read_poses(csv_path: str) -> List[Dict]:
    rows = []
    with open(csv_path) as f:
        for row in csv_mod.DictReader(f):
            rows.append({"timestamp": row["timestamp"],
                         "easting": float(row["x"]),
                         "northing": float(row["y"])})
    return rows


def check_in_test_set(easting, northing, test_polygons, run_type,
                      test_query_coords, buffer_thresh):
    """'test' (ground inside a test polygon) / 'buffer' (within
    buffer_thresh of any ground test query) / 'train'."""
    for poly in test_polygons:
        if poly.contains(easting, northing) and run_type == "ground":
            return "test"
    if test_query_coords is not None and len(test_query_coords):
        d2 = (test_query_coords[:, 0] - easting) ** 2 \
            + (test_query_coords[:, 1] - northing) ** 2
        if d2.min() <= buffer_thresh * buffer_thresh:
            return "buffer"
    return "train"


def construct_training_query_dict(entries, filename_base, pos_thresh,
                                  neg_thresh, test_set=False,
                                  v2_only=False,
                                  query_requires_ground=False,
                                  ground_aerial_positives_only=False):
    """entries: list of (rel_file, easting, northing). Produces v1 and
    v2 pickles (generate_train_test_tuples.py:92-186)."""
    rng = np.random.default_rng(RANDOM_SEED)
    coords = np.array([[e, n] for _, e, n in entries], dtype=np.float64)
    files = [f for f, _, _ in entries]
    ind_pos = radius_query(coords, coords, pos_thresh)
    ind_non_neg = radius_query(coords, coords, neg_thresh)
    ind_ground = np.array([i for i, f in enumerate(files)
                           if "ground" in f], dtype=np.int64)
    ind_aerial = np.array([i for i, f in enumerate(files)
                           if "aerial" in f], dtype=np.int64)
    all_idx = np.arange(len(entries))
    queries_v1, queries_v2 = {}, {}
    skipped, no_pos = 0, 0
    for i, (rel_file, easting, northing) in enumerate(entries):
        timestamp = os.path.splitext(os.path.split(rel_file)[1])[0]
        positives = np.setdiff1d(ind_pos[i], [i])
        negatives = np.setdiff1d(all_idx, ind_non_neg[i])
        non_negatives = np.sort(ind_non_neg[i])
        if (test_set and "aerial" in rel_file) or (
                query_requires_ground and "aerial" in rel_file
                and not any("ground" in files[p] for p in positives)):
            skipped += 1
            positives = np.array([])
            negatives = np.array([])
            non_negatives = np.array([])
        elif test_set and "ground" in rel_file:
            positives = np.setdiff1d(positives, ind_ground)
            negatives = np.setdiff1d(negatives, ind_ground)
            non_negatives = np.union1d(non_negatives, ind_ground)
        if ground_aerial_positives_only:
            own = ind_ground if "ground" in rel_file else ind_aerial
            positives = np.setdiff1d(positives, own)
            negatives = np.setdiff1d(negatives, own)
            non_negatives = np.union1d(non_negatives, own)
        rng.shuffle(negatives)
        if len(positives) == 0:
            no_pos += 1
        if not v2_only:
            queries_v1[i] = {"query": rel_file,
                             "positives": positives.tolist(),
                             "negatives": negatives.tolist()}
        queries_v2[i] = TrainingTuple(
            id=i, timestamp=timestamp, rel_scan_filepath=rel_file,
            positives=positives, non_negatives=non_negatives,
            position=np.array([easting, northing]))
    print(f"Queries with no positives: {no_pos}  skipped: {skipped}  "
          f"final: {len(queries_v2) - no_pos}/{len(queries_v2)}")
    if not v2_only:
        with open(filename_base + "v1.pickle", "wb") as f:
            pickle.dump(queries_v1, f, protocol=pickle.HIGHEST_PROTOCOL)
    with open(filename_base + "v2.pickle", "wb") as f:
        pickle.dump(queries_v2, f, protocol=pickle.HIGHEST_PROTOCOL)
    print("Done", filename_base + "{v1,v2}.pickle")


def generate(root, save_dir, splits, pos_thresh, neg_thresh,
             buffer_thresh, eval_thresh=30.0, refined=False,
             v2_only=False, query_requires_ground=False,
             ground_aerial_positives_only=False):
    os.makedirs(save_dir, exist_ok=True)
    if not splits:
        splits = [s for s in sorted(os.listdir(root))
                  if os.path.isdir(os.path.join(root, s))]
    train_baseline, train_refined, test_rows = [], [], []
    for split in splits:
        if split not in POLY_DICT:
            print(f"WARNING: split {split} unrecognised, skipping")
            continue
        folders = sorted(os.listdir(os.path.join(root, split)))
        for folder in folders:
            assert "ground" in folder or "aerial" in folder, \
                f'Invalid folder "{folder}"'
        # pass 1: ground test queries define the buffer zone
        tq = []
        for folder in (f for f in folders if "ground" in f):
            for row in _read_poses(os.path.join(root, split, folder,
                                                POSES_FILE)):
                if check_in_test_set(row["easting"], row["northing"],
                                     POLY_DICT[split], "ground", None,
                                     buffer_thresh) == "test":
                    tq.append([row["easting"], row["northing"]])
        tq = np.array(tq) if tq else None
        if tq is None:
            print(f"WARNING: no test queries for {split}; all train")
        # pass 2: sort all submaps; aerial rows form the database
        database_sets, test_sets = [], []
        counters = {"train": 0, "test": 0, "buffer": 0}
        for folder in folders:
            run_type = "aerial" if "aerial" in folder else "ground"
            database, test = {}, {}
            rel_dir = os.path.join(split, folder, CLOUD_DIR)
            for row in _read_poses(os.path.join(root, split, folder,
                                                POSES_FILE)):
                rel_file = os.path.join(rel_dir,
                                        row["timestamp"] + ".pcd")
                entry = (rel_file, row["easting"], row["northing"])
                rec = {"query": rel_file, "easting": row["easting"],
                       "northing": row["northing"]}
                sp = check_in_test_set(row["easting"], row["northing"],
                                       POLY_DICT[split], run_type, tq,
                                       buffer_thresh)
                counters[sp] += 1
                if sp == "test":
                    if split in VAL_SPLITS:
                        test_rows.append(entry)
                    test[len(test)] = dict(rec)
                elif sp == "train":
                    if split in BASELINE_SPLITS:
                        train_baseline.append(entry)
                    train_refined.append(entry)
                if run_type == "aerial":
                    if split in VAL_SPLITS:
                        test_rows.append(entry)
                    database[len(database)] = dict(rec)
            database_sets.append(database)
            test_sets.append(test)
        # eval ground truth: aerial database hits within eval_thresh
        for i, database in enumerate(database_sets):
            coords = np.array([[v["easting"], v["northing"]]
                               for v in database.values()]).reshape(-1, 2)
            for j, test in enumerate(test_sets):
                if i == j:
                    continue
                for k in range(len(test)):
                    if len(coords) == 0:
                        test[k][i] = []
                        continue
                    q = np.array([[test[k]["easting"],
                                   test[k]["northing"]]])
                    test[k][i] = radius_query(coords, q,
                                              eval_thresh)[0].tolist()
        base = os.path.join(save_dir, f"CSWildPlaces_{split}_evaluation")
        for tag, obj in [("database", database_sets),
                         ("query", test_sets)]:
            with open(f"{base}_{tag}.pickle", "wb") as f:
                pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)
        print(f"{split}: train {counters['train']} test "
              f"{counters['test']} buffer {counters['buffer']}; eval "
              f"queries {sum(len(t) for t in test_sets)} / db "
              f"{sum(len(d) for d in database_sets)}")

    if query_requires_ground:
        gp = "_ground-positives-required_"
    elif ground_aerial_positives_only:
        gp = "_ground-aerial-only_"
    else:
        gp = "_"
    kw = dict(pos_thresh=pos_thresh, neg_thresh=neg_thresh,
              v2_only=v2_only, query_requires_ground=query_requires_ground,
              ground_aerial_positives_only=ground_aerial_positives_only)
    construct_training_query_dict(
        train_baseline,
        os.path.join(save_dir, f"training_queries_CSWildPlaces_baseline{gp}"),
        **kw)
    if refined:
        construct_training_query_dict(
            train_refined,
            os.path.join(save_dir,
                         f"training_queries_CSWildPlaces_refined{gp}"),
            **kw)
    construct_training_query_dict(
        test_rows, os.path.join(save_dir, "test_queries_CSWildPlaces_"),
        test_set=True, **kw)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", required=True)
    ap.add_argument("--save_dir", default=None)
    ap.add_argument("--splits", nargs="+", default=[])
    ap.add_argument("--eval_thresh", type=float, default=15.0)
    ap.add_argument("--pos_thresh", type=float, required=True)
    ap.add_argument("--neg_thresh", type=float, required=True)
    ap.add_argument("--buffer_thresh", type=float, required=True)
    ap.add_argument("--query_requires_ground", action="store_true")
    ap.add_argument("--ground_aerial_positives_only", action="store_true")
    ap.add_argument("--refined", action="store_true")
    ap.add_argument("--v2_only", action="store_true")
    args = ap.parse_args()
    assert os.path.exists(args.root), f"Cannot access: {args.root}"
    generate(args.root, args.save_dir or args.root, args.splits,
             args.pos_thresh, args.neg_thresh, args.buffer_thresh,
             args.eval_thresh, args.refined, args.v2_only,
             args.query_requires_ground,
             args.ground_aerial_positives_only)


if __name__ == "__main__":
    main()
