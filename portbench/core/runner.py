"""What every run shares: the inputs made from the seed, the set-up
clock, the metrics, the comparison's numbers and limits, and the result
line.

``Run`` takes the cell's files, the seed, the window's length and
whether to trace. The program side (serve.py, train.py) drives the
program's entry; ``hooks`` lets the benchmark's own tests plant a fault
under the timed path ("embed": the embed-function factory, "train_step":
a wrapper of the train step, "loss_fn": a wrapper of the loss).
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from portbench.core import trace as trace_mod
from portbench.core.spec import Cell, metric_reader, model_fields
from portbench.core.traffic import make_pool
from portbench.core.weights import load_weights, make_weights


class Run:
    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device, t_start: float, hooks: Optional[Dict] = None):
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.t_start = t_start
        self.hooks = hooks or {}
        self.fields = model_fields(cell.config)
        self.metrics: Dict[str, dict] = {}
        self.per: Dict[str, dict] = {}
        self.checks: Dict[str, dict] = {}
        self.attempted = self.failed = 0
        self.peak = 0
        self.summary: Optional[Dict] = None
        self.marks: Dict[str, float] = {}
        self.notes: list = []
        self.mark("imports")
        self.weights = make_weights(self.fields, self.seed, self.device)
        self.pool = make_pool(cell.traffic, self.seed)
        self.mark("inputs")

    # -- set-up ----------------------------------------------------------
    def load(self, model) -> None:
        load_weights(model, self.weights)

    def pinned(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(arr)
        return t.pin_memory() if self.device.type == "cuda" else t

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def end_setup(self) -> None:
        self.metric("setup_s", time.perf_counter() - self.t_start, "s")
        self.mark("setup")

    def ref_fields_cfg(self):
        from portbench.ref.models.config import ModelConfig
        return ModelConfig(**self.fields)

    def mark(self, name: str) -> None:
        """Seconds since the process started, at the end of a phase (on
        standard error at the end of the run)."""
        self.marks[name] = time.perf_counter() - self.t_start

    def note(self, line: str) -> None:
        """A line for standard error at the end of the run."""
        self.notes.append(line)

    # -- measurement -----------------------------------------------------
    def metric(self, name: str, value: float, unit: str) -> None:
        self.metrics[name] = {"value": float(value), "unit": unit}

    def profile(self, call: Callable[[int], None], n: int) -> Dict:
        """The traced sub-window's summary (trace.py); on the CPU, where
        there is no device trace, an empty one."""
        if self.device.type != "cuda":
            for i in range(n):
                call(i)
            return {"window_s": 0.0, "busy_s": 0.0, "kernels": 0,
                    "layer_s": {}, "class_s": {}, "breakdown": None}
        s = trace_mod.profile_calls(call, n)
        if s["device_events"] == 0:       # profiler returned no device events
            s = trace_mod.profile_calls(call, n)
        return s

    def read_peak(self) -> None:
        if self.device.type == "cuda":
            self.peak = int(torch.cuda.max_memory_allocated(self.device))

    def free(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def per_layer(self, summary: Dict) -> None:
        """Each per-layer metric of the cell from its reader; a reader
        that finds nothing to read returns None and the metric is left
        out."""
        summary["peak_mem_bytes"] = self.peak
        self.summary = summary
        if summary["busy_s"] <= 0:
            return
        for m in self.cell.per_layer:
            v = metric_reader(m["name"])(summary)
            if v is not None:
                self.per[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # -- the comparison --------------------------------------------------
    def compare(self, name: str, value: float) -> None:
        """Hold ``value`` to the cell's limit of ``name``; a number the
        cell sets no limit for is only reported (standard error)."""
        limits = self.cell.workload["limits"]
        if name not in limits:
            self.note(f"reading {name} {value!r} (not compared)")
            return
        self.checks[name] = {"value": float(value),
                             "limit": float(limits[name])}

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            np.isfinite(c["value"]) and c["value"] <= c["limit"]
            for c in self.checks.values())

    def result(self) -> Dict:
        want = ({m["name"] for m in self.cell.per_layer} if self.trace
                else {m["name"] for m in self.cell.end_to_end})
        metrics = self.per if self.trace else {
            k: v for k, v in self.metrics.items() if k in want}
        device = {"platform": "gpu" if self.device.type == "cuda"
                  else self.device.type,
                  "kind": (torch.cuda.get_device_name(self.device)
                           if self.device.type == "cuda" else "cpu"),
                  "count": self.cell.chips,
                  "memory_peak_bytes": self.peak}
        out = {"correct": self.correct, "attempted": int(self.attempted),
               "failed": int(self.failed), "metrics": metrics,
               "device": device}
        if self.trace and self.summary is not None:
            device["busy_s"] = self.summary["busy_s"]
            device["window_s"] = self.summary["window_s"]
            if self.summary.get("breakdown"):
                out["breakdown"] = self.summary["breakdown"]
        out["checks"] = self.checks
        return out
