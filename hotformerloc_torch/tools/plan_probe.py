"""Sub-stage timing of the octree plan's construction on the card.

Counterpart of hotformerloc_tpu/tools/plan_probe.py, on the port's
``ops/plan.py``: splits the plan's cost by level and by table kind for
one Oxford microbatch (8 uniform clouds of 4096 points):

  build            the octree alone (``build_batched_octree``)
  build+plan(full) the octree and ``build_plan`` with tap lists, as
                   ``build_model_plan`` runs it
  child_d<d>       the child table into depth d (one scatter)
  neigh_base_d<d>  the 27-tap table at the coarsest depth (dense inverse
                   map)
  neigh_rec        every other level's 27-tap table by the parent
                   recurrence (``all_neigh_tables``, given the child
                   tables; the port's route)
  neigh_d<d>       the same table by direct search (``neigh_table``; the
                   JAX tool's kind, for comparison, not on the path)
  taps_d<d>        the tap lists of depth d (``build_tap_lists``)

Times as bisect_step's (``utils/profiling.wall_and_device_ms``: host
wall clock between two synchronisations, CUDA events, kernel time under
torch.profiler; the host clock alone on the CPU). One JSON line each.

    python -m hotformerloc_torch.tools.plan_probe [--iters 5]
        [--device cpu --tiny] [--only child,taps]
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

KINDS = ("build", "plan", "child", "neigh_base", "neigh_rec", "neigh",
         "taps")


def run(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    """Time the table kinds ``--only`` names (default all); returns one
    dict per printed line."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny_test_config at 256 points (CPU checks)")
    ap.add_argument("--only", default=",".join(KINDS),
                    help=f"comma list of {', '.join(KINDS)}")
    args = ap.parse_args(argv)
    kinds = set(args.only.split(","))
    if kinds - set(KINDS):
        raise ValueError(f"unknown kinds {sorted(kinds - set(KINDS))}")

    from hotformerloc_torch.models.config import (oxford_config,
                                                  tiny_test_config)
    from hotformerloc_torch.octree.build import build_batched_octree
    from hotformerloc_torch.octree.neigh import (_dense_base_neigh,
                                                 all_neigh_tables,
                                                 child_table, neigh_table)
    from hotformerloc_torch.ops.plan import build_plan, build_tap_lists
    from hotformerloc_torch.utils.profiling import wall_and_device_ms

    dev = torch.device(args.device)
    cfg = (tiny_test_config(num_points=256) if args.tiny
           else oxford_config())
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.uniform(
        -0.9, 0.9, (args.batch, cfg.num_points, 3)).astype(
            np.float32)).to(dev)
    msk = torch.ones((args.batch, cfg.num_points), dtype=torch.bool,
                     device=dev)
    caps = cfg.resolve_capacities()
    lo, hi = cfg.min_depth, cfg.octree_depth

    def build():
        return build_batched_octree(pts, msk, hi, lo, caps)

    octree = build()
    plan = build_plan(octree)
    lines = []

    def report(stage, fn, **extra):
        line = {"stage": stage,
                **wall_and_device_ms(fn, iters=args.iters), **extra}
        lines.append(line)
        print(json.dumps(line), flush=True)

    if "build" in kinds:
        report("build", lambda: build().counts)
    if "plan" in kinds:
        report("build+plan(full)", lambda: build_plan(build()).neighs)
    if "child" in kinds:
        for d in range(lo + 1, hi + 1):
            report(f"child_d{d}", lambda d=d: child_table(octree, d),
                   cap=octree.cap(d))
    if "neigh_base" in kinds:
        report(f"neigh_base_d{lo}", lambda: _dense_base_neigh(octree, lo),
               cap=octree.cap(lo))
    if "neigh_rec" in kinds:
        report("neigh_rec", lambda: all_neigh_tables(octree,
                                                     plan.childrens))
    if "neigh" in kinds:
        for d in range(lo, hi + 1):
            report(f"neigh_d{d}", lambda d=d: neigh_table(octree, d),
                   cap=octree.cap(d))
    if "taps" in kinds:
        for d in range(lo, hi + 1):
            nb = plan.neighs[octree.level(d)]
            report(f"taps_d{d}", lambda nb=nb: build_tap_lists(nb).count,
                   cap=octree.cap(d))
    return lines


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
