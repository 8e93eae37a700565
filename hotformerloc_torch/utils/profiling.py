"""Timing, tracing and model-introspection helpers.

Counterpart of hotformerloc_tpu/utils/profiling.py. A CUDA launch
returns before the card finishes, so ``block`` and ``fetch_sync``
synchronise the devices of the tensors they are given; ``time_fn`` times
CUDA work with CUDA events and CPU work with the host clock, and says
which clock it used; ``device_ms`` sums a call's kernel time under
``torch.profiler``, and ``bound_ms`` gives the least time an H100 could
take for a given work; ``trace`` and ``annotate`` wrap
``torch.profiler``; ``print_info`` counts parameters by module path;
``step_cost`` counts FLOPs with ``torch.utils.flop_counter``.
"""
from __future__ import annotations

import contextlib
import os
import statistics
import subprocess
import time
from typing import Callable, Dict, Iterator, Optional, Union

import torch


def _tensors(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def block(tree):
    """Wait until the work that produced every CUDA tensor in a nested
    dict/list/tuple has finished on its device. Returns ``tree``."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return tree


def fetch_sync(tree) -> None:
    """``block`` without the return value. (On the TPU this fetched one
    element, because a barrier there could return early; CUDA's
    synchronise is a true barrier.)"""
    block(tree)


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2,
            **kw) -> Dict[str, Union[float, str]]:
    """Time ``fn(*args, **kw)`` after ``warmup`` calls. When the warm-up
    results hold a CUDA tensor, each call is timed with CUDA events
    (``clock`` "cuda_events": device time of the call); otherwise with
    the host clock (``clock`` "host"). Returns median, mean and min in
    ms over ``iters`` calls."""
    cuda = False
    for _ in range(max(1, warmup)):
        out = fn(*args, **kw)
        cuda = any(t.is_cuda for t in _tensors(out))
        block(out)
    times = []
    for _ in range(iters):
        if cuda:
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn(*args, **kw)
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        else:
            t0 = time.perf_counter()
            fn(*args, **kw)
            times.append((time.perf_counter() - t0) * 1e3)
    return {"median_ms": statistics.median(times),
            "mean_ms": statistics.fmean(times), "min_ms": min(times),
            "iters": iters, "clock": "cuda_events" if cuda else "host"}


# NVIDIA H100 SXM, data sheet: HBM3 rate and dense peak operation rates
# (bf16 on tensor cores, fp32 on CUDA cores)
H100_BYTES_S = 3.35e12
H100_PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12}


def smi_line() -> Optional[str]:
    """nvidia-smi's name and power limit of the cards, or None
    (no card, no nvidia-smi)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple:
    """(ms, "bytes" or "operations"): the least time an H100 could take
    for work that moves ``nbytes`` and does ``flops`` operations of
    ``dtype`` ("fp32" or "bf16"), the larger of the two times."""
    tb, tf = nbytes / H100_BYTES_S, flops / H100_PEAK_FLOPS[dtype]
    return max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations"


def device_us(evt) -> float:
    """Self device time in µs of one ``key_averages()`` entry, under the
    attribute name of either profiler generation."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


# Windows ``device_ms`` profiled again because torch.profiler returned
# them without any device event; each made ``iters`` more calls of its
# function, which a run that counts kernel launches must allow for.
RETAKEN_WINDOWS = 0


def device_ms(fn: Callable, *args, iters: int = 10, **kw) -> float:
    """Device time of one call of ``fn`` on the card: the summed
    durations of the kernels, copies and fills it runs, as torch.profiler
    records them, per call over ``iters`` calls after one warm-up call.
    Unlike ``time_fn`` it leaves out the host's launch overhead and the
    gaps between kernels, which dominate a call of a few microseconds of
    device work. After many profiled windows in one process, torch.profiler
    has returned a window without any device event on the H100, so a
    window without device time is profiled again, up to three in all
    (counted in ``RETAKEN_WINDOWS``). Raises when none of them has device
    time."""
    from torch.profiler import ProfilerActivity, profile

    global RETAKEN_WINDOWS
    block(fn(*args, **kw))
    us = 0.0
    for attempt in range(3):
        if attempt:
            RETAKEN_WINDOWS += 1
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                out = fn(*args, **kw)
            block(out)
        us = sum(device_us(e) for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            break
    if us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return us / iters / 1e3


def wall_and_device_ms(fn: Callable, *args, iters: int = 5,
                       device_iters: int = 2, **kw) -> Dict:
    """Where one call of ``fn`` spends its time. After a warm-up call,
    ``iters`` calls run back to back between two card synchronisations:
    ``wall_ms`` is the host clock per call, ``event_ms`` the CUDA events'
    time per call on the current stream (first launch to last
    completion, idle gaps included). Then ``device_ms`` (``device_ms``
    over ``device_iters`` calls) sums the kernels' own time, so
    ``host_ms`` = wall_ms - device_ms is the time the card waited for the
    host, and ``idle_share`` = host_ms / wall_ms. When the warm-up
    result holds no CUDA tensor the call ran on the CPU: the host clock
    alone, and None for the device figures (``clock`` says which)."""
    out = fn(*args, **kw)
    cuda = any(t.is_cuda for t in _tensors(out))
    block(out)
    res = {"iters": iters, "clock": "cuda_events" if cuda else "host",
           "event_ms": None, "device_ms": None, "host_ms": None,
           "idle_share": None}
    if cuda:
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kw)
    if cuda:
        e.record()
        torch.cuda.synchronize()
    res["wall_ms"] = (time.perf_counter() - t0) * 1e3 / iters
    if cuda:
        res["event_ms"] = s.elapsed_time(e) / iters
        dev = device_ms(fn, *args, iters=device_iters, **kw)
        res.update(device_ms=dev, host_ms=res["wall_ms"] - dev,
                   idle_share=max(0.0, 1.0 - dev / res["wall_ms"]))
    return res


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with torch.profiler (CPU, and CUDA where there
    is a card) and write ``trace.json`` (Chrome trace format) and
    ``kernels.txt`` (key_averages) into ``logdir``.

    with trace("out/tr"): step(batch, 0)
    """
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "kernels.txt"), "w") as f:
        f.write(prof.key_averages().table(row_limit=60))
    print(f"[trace] written to {logdir}")


@contextlib.contextmanager
def annotate(name: str):
    """Named region inside an active trace (shows up on the timeline)."""
    with torch.profiler.record_function(name):
        yield


def step_cost(fn: Callable, *example_args) -> Dict[str, float]:
    """FLOPs of one call of ``fn(*example_args)``, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` over the aten operators
    it knows (matrix products, convolutions, attention). PyTorch counts
    no bytes, so unlike the JAX package's XLA cost analysis this gives
    no byte count; the hand-written kernels are not counted either."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*example_args)
    return {"flops": float(counter.get_total_flops())}


def _group_params(named, depth: int = 1) -> Dict[str, int]:
    """Parameter counts summed by the first ``depth`` components of the
    dotted module path, largest first."""
    groups: Dict[str, int] = {}
    for name, p in named:
        g = ".".join(name.split(".")[:depth]) if depth else "<root>"
        groups[g] = groups.get(g, 0) + p.numel()
    return dict(sorted(groups.items(), key=lambda kv: -kv[1]))


def print_info(model_name: str, model, depth: int = 1,
               step_fn: Optional[Callable] = None,
               example_args: tuple = ()) -> Dict:
    """Model summary: total and per-module parameter counts of an
    ``nn.Module`` (or a {name: tensor} dict), grouped by the first
    ``depth`` components of the parameter path, and the FLOPs of one
    ``step_fn(*example_args)`` when given."""
    named = (list(model.named_parameters()) if isinstance(
        model, torch.nn.Module) else list(model.items()))
    groups = _group_params(named, depth)
    total = sum(p.numel() for _, p in named)
    print(f"Model name: {model_name}")
    print(f"Total parameters: {total:,}")
    for g, n in groups.items():
        print(f"  {g:<40s} {n:>12,}  ({100.0 * n / max(total, 1):5.1f}%)")
    info = {"total_params": int(total), "groups": groups}
    if step_fn is not None:
        cost = step_cost(step_fn, *example_args)
        for k, v in cost.items():
            print(f"  {k}: {v:.3e}")
        info["cost"] = cost
    return info
