"""CS-Campus3D pickle converter.

Counterpart of hotformerloc_tpu/tools/cscampus3d_convert.py; both
re-implement the reference's
datasets/CSCampus3D/save_queries_HOTFormerLoc_format.py:18-65:
repackages the upstream CS-Campus3D training pickle
(query/positives/negatives dicts) into TrainingTuple v2 format, and
eval query tuples into enumerated dicts.

CLI:
  python -m hotformerloc_torch.tools.cscampus3d_convert \
      --train_pickle training_queries_umd_4096.pickle \
      --query_pickle umd_evaluation_query.pickle
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from hotformerloc_torch.data.tuples import TrainingTuple


def convert_query_pickle(src: str, dst: str):
    with open(src, "rb") as f:
        query_tuple = pickle.load(f)
    fixed = [{k: v for k, v in enumerate(run)} for run in query_tuple]
    with open(dst, "wb") as f:
        pickle.dump(fixed, f, protocol=pickle.HIGHEST_PROTOCOL)
    print("Done", dst)


def convert_train_pickle(src: str, dst: str):
    with open(src, "rb") as f:
        train_tuple = pickle.load(f)
    id_range = np.arange(len(train_tuple))
    out = {}
    for qid, item in train_tuple.items():
        timestamp = int(os.path.splitext(
            os.path.split(item["query"])[1])[0])
        non_negatives = np.setdiff1d(id_range,
                                     np.array(item["negatives"]),
                                     assume_unique=True)
        out[qid] = TrainingTuple(
            id=qid, timestamp=timestamp,
            rel_scan_filepath=item["query"],
            positives=np.array(item["positives"]),
            non_negatives=non_negatives,
            position=np.array([item["northing"], item["easting"]]))
    with open(dst, "wb") as f:
        pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
    print("Done", dst)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--train_pickle", required=True)
    ap.add_argument("--query_pickle", required=True)
    args = ap.parse_args()
    convert_query_pickle(args.query_pickle,
                         args.query_pickle.replace(".pickle",
                                                   "_v2.pickle"))
    convert_train_pickle(args.train_pickle,
                         args.train_pickle.replace(".pickle",
                                                   "_v2.pickle"))


if __name__ == "__main__":
    main()
