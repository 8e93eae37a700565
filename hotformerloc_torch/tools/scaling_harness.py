"""Weak-scaling harness of the data-parallel train step: submaps/s at
world sizes 1..N with a fixed batch per rank.

Counterpart of hotformerloc_tpu/tools/scaling_harness.py. For each world
size w in 1, 2, 4, ... up to ``--max_world`` it starts w ranks under
torchrun (``dist.torchrun``: NCCL and a card each on the card, gloo on
the CPU). The step runs ``--accum`` global microbatches of w ·
``--per_rank_batch`` clouds, each rank holding per_rank_batch rows of
each (``dist.local_rows``) of a global batch of w · per_rank_batch ·
accum synthetic clouds (pairs of one uniform cloud; ``bench.py``'s
kind); every rank runs one warm-up step and times ``--iters`` more (host clock, ending in
``torch.cuda.synchronize``), and rank 0 writes the world's line: step
ms, submaps/s and the efficiency, submaps/s over w times the 1-rank
rate. One line per world size goes to stdout and ``<out>/scaling.jsonl``.
On the CPU the numbers only show that the path runs.

    python -m hotformerloc_torch.tools.scaling_harness --out OUT \\
        [--max_world 4] [--per_rank_batch 8] [--accum 1] [--tiny] \\
        [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from hotformerloc_torch.parallel import dist

TOOL = "hotformerloc_torch.tools.scaling_harness"
TIMEOUT = 1800                 # seconds one world size may take


def synthetic_rows(B: int, num_points: int, sl: np.ndarray
                   ) -> Dict[str, np.ndarray]:
    """Rows ``sl`` (global row indices) of a global batch of B clouds
    (B/2 uniform clouds, each twice; masks of the pairs)."""
    rng = np.random.default_rng(0)
    base = rng.uniform(-0.9, 0.9, (B // 2, num_points, 3)).astype(np.float32)
    groups = np.repeat(np.arange(B // 2), 2)
    same = groups[sl, None] == groups[None]
    return {"points": np.repeat(base, 2, axis=0)[sl],
            "pmask": np.ones((len(sl), num_points), bool),
            "positives_mask": same & (np.arange(B)[sl, None]
                                      != np.arange(B)[None]),
            "negatives_mask": ~same}


def bench_rank(args, group, device) -> Dict:
    """Time this rank's train steps; returns the world's line."""
    from hotformerloc_torch.evaluation.embed import compute_dtype
    from hotformerloc_torch.losses.losses import make_loss
    from hotformerloc_torch.models.config import (oxford_config,
                                                  tiny_test_config)
    from hotformerloc_torch.models.hotformerloc import HOTFormerLoc
    from hotformerloc_torch.training.optim import lr_schedule, make_optimizer
    from hotformerloc_torch.training.step import StepConfig, make_train_step

    device = torch.device(device)
    w, r = dist.world(group), dist.rank(group)
    cfg = (tiny_test_config(num_points=args.num_points) if args.tiny else
           oxford_config(num_points=args.num_points, grad_checkpoint=True))
    rows = args.per_rank_batch * args.accum
    B = rows * w
    model = HOTFormerLoc(cfg, device=device, dtype=compute_dtype(device),
                         generator=torch.Generator().manual_seed(0))
    dist.broadcast_module_(model, 0, group)
    opt = make_optimizer(model.parameters(), "adam",
                         lr_schedule(1e-3, 1, 10, scheduler="constant"))
    step = make_train_step(
        model, opt, make_loss("truncatedsmoothap", positives_per_query=1),
        StepConfig(accum_steps=args.accum), group)
    batch = {k: torch.from_numpy(v).to(device) for k, v in
             synthetic_rows(B, cfg.num_points, dist.local_rows(
                 B, args.accum, r, w)).items()}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    float(step(batch, 0)["loss"])
    sync()
    dist.barrier(group)
    t0 = time.perf_counter()
    for i in range(args.iters):
        loss = float(step(batch, 1 + i)["loss"])
    sync()
    dt = (time.perf_counter() - t0) / args.iters
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss} at world {w}")
    return {"world": w, "global_batch": B, "per_rank_batch": rows,
            "accum_steps": args.accum, "step_ms": dt * 1e3,
            "submaps_s": B / dt,
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "backend": None if group is None else
            torch.distributed.get_backend(group)}


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--max_world", type=int, default=None,
                    help="largest world (default: the cards, 2 on the CPU)")
    ap.add_argument("--per_rank_batch", type=int, default=8,
                    help="clouds per microbatch per rank")
    ap.add_argument("--accum", type=int, default=1,
                    help="microbatches per rank")
    ap.add_argument("--num_points", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny test config (checks the path on the CPU)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    """Start every world size in turn (or, as one of its ranks, run
    it). Returns the lines."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if "RANK" in os.environ:
        group, device = dist.init_from_env(args.device)
        try:
            line = bench_rank(args, group, device)
            if dist.rank(group) == 0:
                with open(os.path.join(
                        args.out, f"world{line['world']}.json"), "w") as f:
                    json.dump(line, f)
            dist.barrier(group)
        finally:
            dist.close(group)
        return [line]
    top = args.max_world or (torch.cuda.device_count()
                             if args.device != "cpu" else 2)
    lines = []
    open(os.path.join(args.out, "scaling.jsonl"), "w").close()
    w = 1
    while w <= top:
        dist.torchrun(["-m", TOOL, *argv], w,
                      log_dir=os.path.join(args.out, f"world{w}"),
                      timeout=TIMEOUT)
        with open(os.path.join(args.out, f"world{w}.json")) as f:
            line = json.load(f)
        line["efficiency"] = line["submaps_s"] / (lines[0]["submaps_s"] * w) \
            if lines else 1.0
        lines.append(line)
        print(json.dumps(line), flush=True)
        with open(os.path.join(args.out, "scaling.jsonl"), "a") as f:
            f.write(json.dumps(line) + "\n")
        w *= 2
    return lines


if __name__ == "__main__":
    main()
