"""Paired timing of the bf16 multistage train step of two checkouts on
one card: an A/B of a change against its parent.

Each checkout runs in a worker process of its own, with ``PYTHONPATH``
set to that checkout, so it imports that checkout's package and builds
that checkout's kernels. Both workers run chip_smoke.py's train-phase
step: ``oxford_config`` at full width, bf16 compute on fp32 parameters,
bench.py's 32 synthetic clouds of 4096 points (16 clouds, each twice
with N(0, 0.01) noise) as 4 microbatches of 8, TruncatedSmoothAP with 4
positives per query, Adam, the recompute check on. After ``--warmup``
steps each, the tool asks the workers for one timed step at a time
and alternates which goes first (A B, B A, A B, ...), so a drift of the
card or the host hits both sides alike. A step's time is the host clock
around ``step(...)``, ending in ``torch.cuda.synchronize``. The workers
stay loaded on the card side by side; only one steps at a time.

The result is one JSON line (also written to ``--out``): each side's
median, quartiles and times in ms, and the pairs in which B was faster.

    python -m hotformerloc_torch.tools.step_ab --a PARENT_DIR --b . \\
        --pairs 12 --out step_ab.json
    python -m hotformerloc_torch.tools.step_ab --a . --b . --tiny \\
        --device cpu --pairs 1 --warmup 1        # checks the path on the CPU
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

TAG = "STEP_AB "               # prefix of the workers' protocol lines


def worker(args) -> None:
    """Build the step, run the warm-up, then answer each 'step' line on
    stdin with one timed step's ms."""
    import torch

    from hotformerloc_torch.losses.losses import make_loss
    from hotformerloc_torch.models.config import (oxford_config,
                                                  tiny_test_config)
    from hotformerloc_torch.models.hotformerloc import HOTFormerLoc
    from hotformerloc_torch.training.optim import lr_schedule, make_optimizer
    from hotformerloc_torch.training.step import StepConfig, make_train_step

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = (tiny_test_config(num_points=256) if args.tiny
           else oxford_config())
    batch, accum = (8, 2) if args.tiny else (32, 4)
    rng = np.random.default_rng(0)
    base = rng.uniform(-0.9, 0.9, (batch // 2, cfg.num_points, 3))
    pts = np.repeat(base.astype(np.float32), 2, axis=0)
    pts += rng.normal(0, 0.01, pts.shape).astype(np.float32)
    groups = np.repeat(np.arange(batch // 2), 2)
    same = groups[:, None] == groups[None]
    data = {"points": torch.from_numpy(pts).to(dev),
            "pmask": torch.ones(pts.shape[:2], dtype=torch.bool,
                                device=dev),
            "positives_mask": torch.from_numpy(
                same & ~np.eye(batch, dtype=bool)).to(dev),
            "negatives_mask": torch.from_numpy(~same).to(dev)}
    model = HOTFormerLoc(cfg, device=dev, dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(0))
    opt = make_optimizer(model.parameters(), "adam", lr_schedule(
        5e-4, steps_per_epoch=100, epochs=150, warmup_epochs=5,
        milestones=[100]), weight_decay=1e-4)
    step = make_train_step(
        model, opt, make_loss("truncatedsmoothap", positives_per_query=4),
        StepConfig(accum_steps=accum, check_recompute=True))

    def timed(i):
        t0 = time.perf_counter()
        loss = float(step(data, i)["loss"])
        if cuda:
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if not np.isfinite(loss):
            raise RuntimeError(f"non-finite loss {loss} at step {i}")
        return ms

    for i in range(args.warmup):
        timed(i)
    print(TAG + "ready", flush=True)
    i = args.warmup
    for line in sys.stdin:
        if line.strip() != "step":
            break
        print(TAG + repr(timed(i)), flush=True)
        i += 1


def _reply(proc) -> str:
    """The worker's next protocol line (other output is skipped)."""
    for line in proc.stdout:
        if line.startswith(TAG):
            return line[len(TAG):].strip()
    raise RuntimeError(f"worker exited with {proc.wait()}")


def quartiles(xs: List[float]) -> List[float]:
    q = statistics.quantiles(xs, n=4) if len(xs) > 1 else xs * 3
    return [q[0], statistics.median(xs), q[2]]


def run(args) -> Dict:
    """Start a worker per checkout, time ``--pairs`` alternating pairs,
    stop both; returns the result."""
    me = os.path.abspath(__file__)
    sides = {"a": os.path.abspath(args.a), "b": os.path.abspath(args.b)}
    wargs = ["--worker", "--device", args.device, "--warmup",
             str(args.warmup)] + (["--tiny"] if args.tiny else [])
    procs = {}
    try:
        for k, root in sides.items():
            env = {**os.environ, "PYTHONPATH": os.pathsep.join(
                filter(None, [root, os.environ.get("PYTHONPATH")]))}
            # -P: the checkout's package, not this file's directory
            procs[k] = subprocess.Popen(
                [sys.executable, "-P", me, *wargs], cwd=root, env=env,
                text=True, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                bufsize=1)
        for p in procs.values():       # both built and warmed up
            if _reply(p) != "ready":
                raise RuntimeError("worker did not get ready")
        times = {"a": [], "b": []}
        for i in range(args.pairs):
            for k in ("ab" if i % 2 == 0 else "ba"):
                procs[k].stdin.write("step\n")
                procs[k].stdin.flush()
                times[k].append(float(_reply(procs[k])))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()
    return {"a": sides["a"], "b": sides["b"], "device": args.device,
            "config": "tiny_test_config" if args.tiny else "oxford_config",
            "pairs": args.pairs, "warmup": args.warmup,
            "median_ms": {k: statistics.median(v) for k, v in times.items()},
            "quartiles_ms": {k: quartiles(v) for k, v in times.items()},
            "b_faster_pairs": sum(b < a for a, b in zip(times["a"],
                                                        times["b"])),
            "times_ms": times}


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--a", default=".", help="checkout A (the parent)")
    ap.add_argument("--b", default=".", help="checkout B (the change)")
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--warmup", type=int, default=3,
                    help="untimed steps per worker first")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny test config, batch 8 (checks the path)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Optional[Dict]:
    args = parse_args(argv)
    if args.worker:
        worker(args)
        return None
    res = run(args)
    print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f)
    return res


if __name__ == "__main__":
    main()
