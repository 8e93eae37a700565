"""Host batch-assembly throughput benchmark (loader only, no device).

Counterpart of hotformerloc_tpu/tools/loader_bench.py, on the port's
data pipeline (data/pipeline.py ``TrainingDataset`` and ``DataLoader``).
The single-thread loader is irrelevant while a step takes seconds but
becomes the bottleneck once the step approaches its roofline; the
reference parallelises with num_workers DataLoader processes (its
datasets/dataset_utils.py:164-170). This measures submaps/s of the full
host path — .bin read, float64→32, augmentation pipeline, clip, pack —
at num_points=4096 across worker counts, on a synthetic PNV-format
corpus it generates itself. A 256-cloud epoch is 4 batches of 64, fewer
than the larger worker counts, so each timed window runs whole epochs
until it holds at least 4 batches per worker of the largest count, and
it is timed ``REPEATS`` times: ``submaps_s`` is their median and
``runs`` lists them all.

Run: python -m hotformerloc_torch.tools.loader_bench [--root DIR]
Writes ``--out`` (docs/LOADER_BENCH_torch.json), with the host's CPU
count and nvidia-smi's name and power limit of the machine's card.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import tempfile
import time
from typing import Optional, Sequence

import numpy as np

from hotformerloc_torch.data.augmentation import (make_set_transform,
                                                  make_train_transform)
from hotformerloc_torch.data.loaders import get_pointcloud_loader
from hotformerloc_torch.data.pipeline import DataLoader, TrainingDataset
from hotformerloc_torch.data.sampler import BatchSampler
from hotformerloc_torch.data.tuples import TrainingTuple
from hotformerloc_torch.utils.profiling import smi_line

RESULTS_PATH = "docs/LOADER_BENCH_torch.json"
REPEATS = 3
BATCHES_PER_WORKER = 4


def make_corpus(root: str, n: int = 256, points: int = 4096) -> None:
    """n uniform clouds in PNV .bin format and their tuples (i paired
    with i ^ 1), as the JAX tool writes them."""
    os.makedirs(os.path.join(root, "clouds"), exist_ok=True)
    rng = np.random.default_rng(0)
    queries = {}
    for i in range(n):
        pc = rng.uniform(-1, 1, (points, 3))
        pc.astype(np.float64).tofile(
            os.path.join(root, "clouds", f"{i:05d}.bin"))
        queries[i] = TrainingTuple(
            i, i, f"clouds/{i:05d}.bin", np.array([i ^ 1]),
            np.sort(np.array([i, i ^ 1, (i + 2) % n])),
            np.array([float(i), 0.0]))
    with open(os.path.join(root, "tuples.pickle"), "wb") as f:
        pickle.dump(queries, f)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--num_points", type=int, default=4096)
    ap.add_argument("--workers", default="0,2,4,8,16")
    ap.add_argument("--mode", default="process", choices=["process", "thread"])
    ap.add_argument("--out", default=RESULTS_PATH)
    args = ap.parse_args(argv)

    root = args.root or tempfile.mkdtemp(prefix="loader_bench_")
    if not os.path.exists(os.path.join(root, "tuples.pickle")):
        print(f"generating corpus in {root} ...", flush=True)
        make_corpus(root, points=args.num_points)

    ds = TrainingDataset(
        root, "tuples.pickle", get_pointcloud_loader("Oxford"),
        make_train_transform(1, False, None, False, True, 5.0),
        make_set_transform(1, 5.0))
    workers = [int(x) for x in args.workers.split(",")]
    min_batches = BATCHES_PER_WORKER * max(1, *workers)
    out = {"batch": args.batch, "num_points": args.num_points,
           "mode": args.mode, "corpus": len(ds),
           "timed_batches_min": min_batches, "repeats": REPEATS,
           "host_cpus": os.cpu_count(), "nvidia_smi": smi_line()}
    base = None
    for w in workers:
        sampler = BatchSampler(ds.queries, args.batch)
        loader = DataLoader(ds, sampler, args.num_points, seed=1,
                            num_workers=w, worker_mode=args.mode)
        try:
            # warm the page cache (and start the pool) on the first
            # pass, then time whole epochs of at least min_batches
            for b in loader:
                pass
            runs = []
            for _ in range(REPEATS):
                t0 = time.perf_counter()
                n = nb = 0
                while nb < min_batches:
                    for b in loader:
                        n += b["points"].shape[0]
                        nb += 1
                    if not nb:
                        raise ValueError("an epoch holds no batch")
                runs.append(n / (time.perf_counter() - t0))
        finally:
            loader.close()
        rate = float(np.median(runs))
        out[f"workers_{w}"] = {"submaps_s": rate, "runs": runs,
                               "speedup": rate / base if base else 1.0}
        base = base or rate
        print(json.dumps({f"workers_{w}": out[f"workers_{w}"]}), flush=True)
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
