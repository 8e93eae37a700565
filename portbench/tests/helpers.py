"""Tiny cells for the CPU tests: the cells' workload files and limits
with ``tiny_test_config`` and small traffic. The train cell is parked
out of BENCHMARK.json (PERF.md, Open questions); ``PARKED`` holds the
entries it would have there."""
from __future__ import annotations

import copy
import dataclasses
import json
import time

from portbench.core import serve, train
from portbench.core.runner import Run
from portbench.core.spec import Cell, find_cell, load_benchmark

TRAIN = "oxford-train-2x128"
PARKED = {
    "workloads": [{"name": TRAIN, "config": "oxford",
                   "traffic": "surface-pairs-2x128", "chips": 1,
                   "why": "the shipped recipe: batches of 256 as 2 x 128 "
                   "under save_hot, Adam: backward kernels K2/K4/K6, "
                   "recompute and optimizer"}],
    "end_to_end": [{"name": "train_submaps_per_s", "unit": "submaps/s",
                    "better": "higher", "bound": 0.035,
                    "source": "host_clock", "workloads": [TRAIN]}],
    "per_layer": [
        {"name": f"{name}.train", "unit": unit, "better": better,
         "source": source, "layer": layer, "moves": "train_submaps_per_s",
         "workloads": [TRAIN]}
        for name, unit, better, source, layer in (
            ("launches_per_submap", "launches/submap", "lower",
             "device_trace", "entry"),
            ("mfu", "%", "higher", "device_trace", "model step"),
            ("attn_roofline", "%", "higher", "device_trace",
             "window attention"),
            ("conv_device_ms", "ms/submap", "lower", "device_trace",
             "octree convs"),
            ("plain_device_ms", "ms/submap", "lower", "device_trace",
             "plain layers"),
            ("idle_share", "%", "lower", "device_trace", "device"),
            ("peak_mem_gb", "GB", "lower", "program_counter", "device"))],
}


def bench_with_parked() -> dict:
    """BENCHMARK.json with the parked train cell's entries added."""
    bench = load_benchmark()
    for key, entries in PARKED.items():
        bench[key] = bench[key] + copy.deepcopy(entries)
    return bench


TINY_TRAFFIC = {
    "serve": {"points": 256, "batch": 4, "pool": 2, "rate": 50.0},
    "train": {"points": 256, "batch": 8, "microbatch": 4, "pool": 3,
              "pairs": True, "noise": 0.01},
}


def tiny_cell(name: str, **workload) -> Cell:
    """Cell ``name`` of BENCHMARK.json on tiny_test_config and tiny
    traffic, in fp32, with the cell's own limits."""
    from hotformerloc_torch.models.config import tiny_test_config
    cell = copy.deepcopy(find_cell(bench_with_parked(), name))
    cell.config["model"] = json.loads(json.dumps(dataclasses.asdict(
        tiny_test_config(num_points=256, grad_checkpoint=True))))
    cell.traffic = dict(TINY_TRAFFIC[cell.entry])
    cell.workload.update(dtype="float32", trace_batches=1, trace_steps=1)
    cell.workload["check"] = dict(cell.workload["check"], chunk=2,
                                  sample=6)
    cell.workload.update(workload)
    return cell


def tiny_mesa_cell() -> Cell:
    """The train cell with MESA 1.0 and the EMA teacher (the CS-Wild-Places
    recipe), its teacher's change held to a limit too."""
    cell = tiny_cell(TRAIN, recipe={"mesa": 1.0,
                                                   "use_ema": True})
    cell.workload["limits"] = dict(cell.workload["limits"], ema_gap=0.4)
    return cell


def run_cpu(cell: Cell, seed: int = 2 ** 31 + 101, seconds: float = 0.2,
            trace: bool = False, hooks=None) -> dict:
    r = Run(cell, seed, seconds, trace, "cpu", time.perf_counter(), hooks)
    return {"serve": serve.run, "train": train.run}[cell.entry](r)
