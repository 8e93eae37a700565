"""The traced sub-window: torch.profiler over a few calls, reduced to a
summary that the per-layer metric readers read.

Only the kernel, copy and fill events of the device and the host's op
events are kept, in memory; nothing is written to disk. The summary:

- ``window_s``: host clock over the sub-window, between two
  synchronisations;
- ``busy_s``: the union of the device's event intervals;
- ``kernels``: device kernel launches (copies and fills left out);
- ``layer_s``: device seconds by layer of ``classes.json``
  (attention, conv, plain), and ``class_s`` by class;
- ``breakdown``: the ten device operations that took most time and the
  ten longest idle gaps, named by the innermost host op running at the
  gap's middle.
"""
from __future__ import annotations

import bisect
import json
import time
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import torch

_CLASSES = json.loads((Path(__file__).parent / "classes.json").read_text())


def classify(name: str) -> Tuple[str, str]:
    """(class, layer) of a CUDA kernel name, first match wins."""
    low = name.lower()
    for cls, layer, keys in _CLASSES["classes"]:
        if any(k.lower() in low for k in keys):
            return cls, layer
    return tuple(_CLASSES["other"])


def _ns(evt, what: str) -> int:
    f = getattr(evt, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(evt, f"{what}_us")() * 1000)


def _events(prof):
    """(device events [(start_ns, end_ns, name)], host op events)."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, "start")
        end = start + _ns(e, "duration")
        item = (start, end, e.name())
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append(item)
        else:
            host.append(item)
    dev.sort()
    host.sort()
    return dev, host


def _is_kernel(name: str) -> bool:
    low = name.lower()
    return not (low.startswith("memcpy") or low.startswith("memset"))


def _union(dev) -> Tuple[float, List[Tuple[int, int]]]:
    """(busy ns, idle gaps [(start, end)]) of sorted intervals."""
    busy, gaps = 0, []
    cur_s = cur_e = None
    for s, e, _ in dev:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


def _host_at(host, starts, t: int) -> str:
    """The innermost host event covering time t ("none" when none)."""
    i = bisect.bisect_right(starts, t)
    best = None
    for s, e, name in reversed(host[max(0, i - 4000):i]):
        if e >= t and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else "none"


def profile_calls(call: Callable[[int], None], n: int) -> Dict:
    """Run ``call(i)`` for i < n under torch.profiler (device and host
    activities) and return the summary; ``call`` leaves its work queued,
    the sub-window ends at a synchronisation."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            call(i)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    dev, host = _events(prof)
    busy_ns, gaps = _union(dev)
    class_s: Dict[str, float] = {}
    layer_s = {"attention": 0.0, "conv": 0.0, "plain": 0.0}
    by_name: Dict[str, float] = {}
    kernels = 0
    for s, e, name in dev:
        sec = (e - s) * 1e-9
        by_name[name] = by_name.get(name, 0.0) + sec
        if not _is_kernel(name):
            layer_s["plain"] += sec
            continue
        kernels += 1
        cls, layer = classify(name)
        class_s[cls] = class_s.get(cls, 0.0) + sec
        layer_s[layer] += sec
    starts = [h[0] for h in host]
    gaps.sort(key=lambda g: g[0] - g[1])
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": window_s, "busy_s": busy_ns * 1e-9, "kernels": kernels,
        "device_events": len(dev), "class_s": class_s, "layer_s": layer_s,
        "breakdown": {
            "device_ops": [[name[:120], sec] for name, sec in top_ops],
            "idle_gaps": [[_host_at(host, starts, (a + b) // 2)[:120],
                           (b - a) * 1e-9] for a, b in gaps[:10]]},
    }
