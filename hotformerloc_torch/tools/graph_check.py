"""The serving forward replayed as a CUDA graph, held against its eager
run on the card.

    python -m hotformerloc_torch.tools.graph_check [--device cuda|cpu]
        [--replays 20] [--out DIR]

For each served configuration (``oxford_config`` at batch 32 and
``cs_wild_places_config`` at batch 128, on surface clouds of 4096
points as the serve cells send; with ``--device cpu``,
``tiny_test_config`` at batch 2) it builds the bf16 serving call
``make_embed_fn`` twice on one seeded model: eager (``graphs=False``)
and graphed, and prints one JSON line:

  eager_launches        kernels of an eager forward under torch.profiler
                        (copies and fills left out, as the benchmark
                        counts them), one window a call on three batches;
                        ``graphed_launches`` the same of replays, whose
                        traced kernels are the graph's kernel nodes (the
                        profiler records each node of a replay as a
                        kernel). Each window opens with a marker kernel
                        and a synchronisation, which are left out, so the
                        forward's first launch is not the window's first
  eager_not_graphed     kernels, by name, of the first eager window that
                        the first replay window lacks; ``graphed_not_eager``
                        the other way. Every window of both sides must
                        hold the first eager window's kernels, by name
                        and number (``trace_faults``)
  capture_s             the capture alone, synchronised on both sides;
                        ``capture_call_s`` the whole capturing call
  replays_bit_equal     of ``--replays`` replays on distinct batches, how
                        many give the eager forward's ``global`` bit for
                        bit (must be all); ``max_abs_diff`` the largest
                        difference; ``eager_repeat_bit_equal`` whether
                        two eager runs of one batch agree
  outputs_distinct      every returned ``global`` still holds its own
                        batch's descriptors after the later calls, in its
                        own memory
  wall_ms               back to back, untraced: host clock per batch
                        between two synchronisations (``graphed_wall_ms``,
                        ``eager_wall_ms``)
  device_ms             the union of a traced window's device events
                        (median of the three windows, ``*_device_ms``),
                        and ``*_idle_share``, 1 - device / wall of the
                        same traced windows (median)

A failed check raises, after its line is printed, and the tool exits
non-zero. On the CPU a host replay (``HostReplay``: the forward run
again into the captured outputs) stands for the graph, so the lines
hold the checks and every device number is None. The tool writes a file
only under ``--out`` (graph_check.json).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from hotformerloc_torch.tools.gather_bench import device_name, parse_device
from hotformerloc_torch.tools.norm_bench import configs
from hotformerloc_torch.utils import profiling

# The marker kernel that opens a traced window (torch.cuda._sleep).
MARK = "spin_kernel"


def surface_cloud(rng, points=4096, normals=False):
    """``points`` points on 3-4 random planes through the cube (uniform in
    a 1.8-wide square about a centre in +-0.5, clipped to +-0.95),
    float32: its nodes have more valid taps than a uniform cloud's. With
    ``normals`` also each point's unit plane normal (exact; the same
    points either way)."""
    out = np.empty((points, 3), np.float32)
    nrm = np.empty((points, 3), np.float32)
    n_planes = int(rng.integers(3, 5))
    which = rng.integers(0, n_planes, points)
    for i in range(n_planes):
        basis, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        sel = which == i
        ab = rng.uniform(-0.9, 0.9, (int(sel.sum()), 2))
        out[sel] = rng.uniform(-0.5, 0.5, 3) + ab @ basis[:, :2].T
        nrm[sel] = basis[:, 2]
    out = np.clip(out, -0.95, 0.95)
    return (out, nrm) if normals else out


class HostReplay:
    """A capture on the CPU: runs ``run()`` once for its outputs, and each
    call runs it again into those same tensors, as a graph's replay
    overwrites its outputs."""

    def __init__(self, run, pool=None):
        self.run = run
        self.outputs = run()

    def __call__(self) -> Dict[str, torch.Tensor]:
        for k, v in self.run().items():
            self.outputs[k].copy_(v)
        return self.outputs


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _profiled(fn) -> tuple:
    """(kernel names, busy ms, wall ms) of one call ``fn()`` under
    torch.profiler: a Counter of its kernels (copies and fills left out),
    the union of its device events and the host clock from the call to
    its synchronisation. The window opens with a marker kernel and a
    synchronisation, both left out."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = sorted(d[:2] + (d[3],) for d in profiling.trace_records(prof)[0]
                 if d[4] != "gpu_user_annotation" and MARK not in d[3])
    kernels = Counter(n for _, _, n in dev
                      if not n.lower().startswith(("memcpy", "memset")))
    busy, end = 0, None
    for s, e, _ in dev:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return kernels, busy * 1e-6, wall


def trace_faults(eager: Sequence[Counter], graphed: Sequence[Counter]
                 ) -> List[str]:
    """Where a traced window's kernels (a Counter by name) differ from the
    first eager window's, by name or number, in either direction."""
    want = eager[0]
    faults = []
    for side, windows in (("eager", eager), ("graphed", graphed)):
        for i, got in enumerate(windows):
            lacks, adds = want - got, got - want
            if lacks or adds:
                faults.append(
                    f"{side} window {i}: {sum(got.values())} kernels against "
                    f"{sum(want.values())} eager, lacks {dict(lacks)}, "
                    f"adds {dict(adds)}")
    return faults


def _wall_ms(fn, calls: int, dev) -> float:
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(calls):
        fn(i)
    _sync(dev)
    return (time.perf_counter() - t0) * 1e3 / calls


def check(name: str, cfg, batch: int, dev: torch.device, replays: int,
          seed: int = 0, timed: int = 10) -> Dict:
    """The line of one configuration (see the module's docstring)."""
    from hotformerloc_torch.evaluation.embed import (CudaGraphReplay,
                                                     make_embed_fn)
    from hotformerloc_torch.models.hotformerloc import HOTFormerLoc

    cuda = dev.type == "cuda"
    rng = np.random.default_rng(seed)
    clouds = [torch.from_numpy(np.stack([
        surface_cloud(rng, cfg.num_points) for _ in range(batch)])).to(dev)
        for _ in range(replays + 2)]
    pmask = torch.ones(clouds[0].shape[:2], dtype=torch.bool, device=dev)
    model = HOTFormerLoc(cfg, device=dev,
                         generator=torch.Generator().manual_seed(seed))
    eager = make_embed_fn(model, torch.bfloat16, graphs=False)
    captured = []

    def capture(run, pool):
        _sync(dev)
        t0 = time.perf_counter()
        graph = (CudaGraphReplay if cuda else HostReplay)(run, pool)
        _sync(dev)
        captured.append(time.perf_counter() - t0)
        return graph

    graphed = make_embed_fn(model, torch.bfloat16, capture=capture)
    ref = [eager(c, pmask)["global"] for c in clouds]
    repeat = eager(clouds[0], pmask)["global"]
    line = {"config": name, "batch": batch, "points": cfg.num_points,
            "device": device_name(dev), "replays": replays,
            "eager_repeat_bit_equal": bool(torch.equal(repeat, ref[0]))}
    outs = [graphed(clouds[0], pmask)]
    if captured:
        raise AssertionError("the first call of a shape was captured")
    _sync(dev)
    t0 = time.perf_counter()
    outs.append(graphed(clouds[1], pmask))
    _sync(dev)
    line["capture_call_s"] = time.perf_counter() - t0
    if len(captured) != 1:
        raise AssertionError(f"{len(captured)} captures on a shape's "
                             "second call")
    line["capture_s"] = captured[0]
    outs += [graphed(c, pmask) for c in clouds[2:]]
    if len(captured) != 1:
        raise AssertionError("a replayed shape was captured again")
    diffs = [float((o["global"] - r).abs().max())
             for o, r in zip(outs[2:], ref[2:])]
    line["replays_bit_equal"] = sum(
        bool(torch.equal(o["global"], r)) for o, r in zip(outs[2:], ref[2:]))
    line["max_abs_diff"] = max(diffs)
    line["outputs_distinct"] = (
        len({o["global"].data_ptr() for o in outs}) == len(outs)
        and all(torch.equal(o["global"], r) for o, r in zip(outs, ref)))
    line.update(graphed_launches=None, eager_launches=None,
                graphed_not_eager=None, eager_not_graphed=None)
    for side, fn in (("graphed", graphed), ("eager", eager)):
        line[f"{side}_wall_ms"] = _wall_ms(
            lambda i: fn(clouds[i % len(clouds)], pmask), timed, dev)
        line[f"{side}_device_ms"] = line[f"{side}_idle_share"] = None
    faults = []
    if cuda:
        windows = {}
        for side, fn in (("graphed", graphed), ("eager", eager)):
            runs = [_profiled(lambda: fn(c, pmask)) for c in clouds[:3]]
            windows[side] = [n for n, _, _ in runs]
            line[f"{side}_launches"] = [sum(n.values()) for n, _, _ in runs]
            line[f"{side}_device_ms"] = float(np.median(
                [b for _, b, _ in runs]))
            line[f"{side}_idle_share"] = float(np.median(
                [1.0 - b / w for _, b, w in runs]))
        for a, b in (("graphed", "eager"), ("eager", "graphed")):
            line[f"{a}_not_{b}"] = {k[:100]: v for k, v in
                                    (windows[a][0] - windows[b][0]).items()}
        faults += trace_faults(windows["eager"], windows["graphed"])
        line["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    print(json.dumps(line), flush=True)
    if line["replays_bit_equal"] != replays:
        faults.append(f"{replays - line['replays_bit_equal']} replays off "
                      f"the eager forward (max abs {line['max_abs_diff']})")
    if not line["outputs_distinct"]:
        faults.append("a returned output was overwritten by a later call")
    if faults:
        raise AssertionError(f"{name}: " + "; ".join(faults))
    return line


def run(argv: Optional[list] = None) -> list:
    """The tool's work: prints its lines and returns them."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--replays", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = parse_device(args.device)
    lines = [{"head": device_name(dev), "nvidia_smi": profiling.smi_line()
              if dev.type == "cuda" else None, "torch": torch.__version__}]
    print(json.dumps(lines[0]), flush=True)
    for name, cfg, batch in configs(dev):
        lines.append(check(name, cfg, batch, dev, args.replays))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, "graph_check.json")
        with open(path, "w") as fh:
            json.dump(lines, fh, indent=1)
        print(f"wrote {path}", flush=True)
    return lines


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
