"""The readings that set each limit: the program's own (sound) runs, and
the reference put in the program's place, computed one precision step
below the configuration's bf16 (fp8 products, ``reference.precision``),
or with a fault planted (half of the batch left out, the mean taken over
the rest), each compared with the fp32 reference exactly as a run
compares the program, at the cell's own sizes and on the same inputs a
run makes from its seed.

    python3 portbench/control.py --workload <cell> --seeds a,b,c
        [--kinds program,fp8,half]

prints one JSON line a seed with the numbers of every kind: in train
cells the compared numbers and, beside them, the others that were tried
(``explore``). The benchmark's runs never call this; portbench/tests
runs it on the card.
"""
from __future__ import annotations

import gc
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.core import reference, train
from portbench.core.runner import Run
from portbench.core.spec import Cell, model_fields
from portbench.core.traffic import make_pool
from portbench.core.weights import make_weights


def serve_readings(cell: Cell, seed: int, kinds: List[str], device
                   ) -> Dict[str, Dict[str, float]]:
    """{kind: {'desc_max_abs': ...}}: the reference at ``kind`` against
    the fp32 reference on a sample of the pool's clouds drawn from the
    seed."""
    fields = model_fields(cell.config)
    weights = make_weights(fields, seed, device)
    pool = make_pool(cell.traffic, seed)["points"]
    flat = pool.reshape(-1, *pool.shape[2:])
    rng = np.random.default_rng([int(seed), 1])
    n = min(int(cell.workload["check"]["sample"]), flat.shape[0])
    rows = np.sort(rng.choice(flat.shape[0], size=n, replace=False))
    pts = torch.from_numpy(flat[rows]).to(device)
    chunk = int(cell.workload["check"]["chunk"])
    model = reference.build(fields, weights, device)
    ref, _ = reference.embed(model, pts, chunk, "fp32")
    out = {}
    for kind in kinds:
        got, ovf = reference.embed(model, pts, chunk, kind)
        out[kind] = {"desc_max_abs": float((got - ref).abs().max()),
                     "octree_overflow": float(ovf)}
    return out


def explore(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Numbers that were tried and that no cell compares (PERF.md gives
    their readings): the losses' gaps (the largest, the first step's),
    the gaps of first-gradient norms (worst leaf, 90th percentile,
    median, whole gradient), the same for the difference's norm, and the
    median leaf's gap of change norms."""
    gaps = [v for _, v, _ in reference.leaf_numbers(prog["grad"],
                                                    ref["grad"])]
    diffs = [v for _, v, _ in reference.leaf_numbers(
        prog["grad"], ref["grad"], diff=True)]
    dgaps = [v for _, v, _ in reference.leaf_numbers(
        prog["delta"], ref["delta"], reference.moved_leaves(ref))]

    def total(d):
        return sum(float(t.float().norm()) ** 2 for t in d.values()) ** 0.5
    rt = total(ref["grad"])
    losses = list(zip(prog["losses"], ref["losses"]))
    return {
        "loss_gap": max(abs(a - b) for a, b in losses),
        "first_loss_gap": abs(losses[0][0] - losses[0][1]),
        "grad_gap": gaps[0],
        "grad_gap_p90": float(np.percentile(gaps, 90)),
        "grad_gap_median": float(np.median(gaps)),
        "grad_gap_total": abs(total(prog["grad"]) - rt) / rt,
        "grad_diff_p90": float(np.percentile(diffs, 90)),
        "grad_diff_median": float(np.median(diffs)),
        "grad_diff_total": total({n: prog["grad"][n] - ref["grad"][n]
                                  for n in ref["grad"]}) / rt,
        "delta_gap_median": float(np.median(dgaps))}


def train_readings(cell: Cell, seed: int, kinds: List[str], device
                   ) -> Dict[str, Dict[str, float]]:
    """{kind: numbers}: the program's check steps ('program'), or the
    reference's at 'fp8' or with half of each batch left out ('half'),
    against the fp32 reference's, on the pool batches and step seeds a
    run uses."""
    r = Run(cell, seed, 0.0, False, device, time.perf_counter())
    rec = train.recipe(r)
    P = r.pool["points"].shape[0]
    pos = torch.from_numpy(r.pool["positives_mask"]).to(r.device)
    neg = torch.from_numpy(r.pool["negatives_mask"]).to(r.device)

    def batch(k: int):
        return {"points": torch.from_numpy(r.pool["points"][k % P]).to(
            r.device), "positives_mask": pos, "negatives_mask": neg}

    def timed(kind, fn):
        t0 = time.perf_counter()
        out = fn()
        gc.collect()
        if r.device.type == "cuda":
            torch.cuda.empty_cache()
            print(f"{kind}: {time.perf_counter() - t0:.1f} s, peak "
                  f"{torch.cuda.max_memory_allocated(r.device)} bytes",
                  file=sys.stderr)
        return out

    got = {}
    if "program" in kinds:
        got["program"] = timed("program", lambda: train.setup(r)["program"])
    base = timed("fp32", lambda: train.reference_side(r, rec, batch))
    for kind in kinds:
        if kind != "program":
            got[kind] = timed(kind, lambda: train.reference_side(
                r, rec, batch, prec="fp8" if kind == "fp8" else "fp32",
                half_batch=kind == "half"))
    return {kind: dict(reference.train_numbers(g, base)[0],
                       explore=explore(g, base)) for kind, g in got.items()}


def readings(cell: Cell, seed: int, kinds: List[str], device):
    fn = serve_readings if cell.entry == "serve" else train_readings
    return fn(cell, seed, kinds, device)
