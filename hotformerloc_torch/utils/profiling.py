"""Timing, tracing and model-introspection helpers.

Counterpart of hotformerloc_tpu/utils/profiling.py. A CUDA launch
returns before the card finishes, so ``block`` and ``fetch_sync``
synchronise the devices of the tensors they are given; ``time_fn`` times
CUDA work with CUDA events and CPU work with the host clock, and says
which clock it used; ``device_ms`` sums a call's kernel time under
``torch.profiler``, and ``bound_ms`` gives the least time an H100 could
take for a given work; ``trace`` wraps ``torch.profiler``; ``annotate``
opens a named span of the program (one flag check when no profiler
runs) and ``span_summary`` attributes a trace's device time to the
innermost span that launched it; ``count`` adds to a counter of an open
``counting()`` scope (``counting_open`` says whether one is);
``print_info`` counts parameters by module path; ``step_cost`` counts
FLOPs with ``torch.utils.flop_counter``.
"""
from __future__ import annotations

import bisect
import contextlib
import os
import statistics
import subprocess
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple, Union

import torch
# Private symbols, present in PyTorch 2.11 (the H100 machine's) and 2.13:
# the op-scope RecordFunction and the profiler's enabled flag (annotate).
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler


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


def device_work(evt) -> bool:
    """Whether a ``key_averages()`` entry is work on the card (a kernel, a
    copy or a fill), and not the range kineto draws on a stream for a
    ``record_function`` (``gpu_user_annotation``): that range spans its
    kernels and the gaps between them, so counting it would count them
    twice."""
    return (evt.device_type == torch.autograd.DeviceType.CUDA
            and not evt.is_user_annotation)


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
                 if device_work(e))
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


_NO_SPAN = contextlib.nullcontext()
# Every span of the program is named ``hfl.<part>``.
SPAN_PREFIX = "hfl."


def annotate(name: str):
    """A named span of the program: ``with annotate("hfl.plan"): ...``.

    While torch.profiler runs, the span is a host range in its trace (a
    RecordFunction, on the clock of the device events), and every kernel
    launched inside it can be attributed to it (``span_summary``). The
    range is an op range, not a user annotation, so kineto draws no
    range for it on the device's streams: a trace's device events stay
    the kernels, copies and fills alone. It goes through no dispatcher
    op, so a selective-checkpoint policy never sees it. With no profiler
    running it costs one flag check and returns a shared no-op. Pass a
    name built once (a constant), not one formatted per call."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _RecordFunctionFast(name)


class Counts:
    """What one ``counting()`` scope collected: (name, value) in order.
    Values may be device tensors; they are summed only by ``totals``."""

    def __init__(self):
        self.entries: List[Tuple[str, object]] = []

    def totals(self) -> Dict[str, int]:
        """Each counter's sum over the scope (tensors summed over their
        elements; this synchronises with the device)."""
        out: Dict[str, int] = {}
        for name, v in self.entries:
            n = int(v.sum()) if isinstance(v, torch.Tensor) else int(v)
            out[name] = out.get(name, 0) + n
        return out


_COUNTS: Optional[Counts] = None


@contextlib.contextmanager
def counting():
    """Collect the program's ``count`` calls made inside the block:

        with counting() as c:
            embed(points, pmask)
        c.totals()      # {"hfl.block.valid": ..., "hfl.block.slots": ...}

    Nested scopes do not add up: the innermost one collects."""
    global _COUNTS
    prev, _COUNTS = _COUNTS, Counts()
    try:
        yield _COUNTS
    finally:
        _COUNTS = prev


def counting_open() -> bool:
    """Whether a ``counting()`` scope is open."""
    return _COUNTS is not None


def count(name: str, value) -> None:
    """Add ``value`` (a host number, or a tensor whose elements are
    summed when the scope is read) to counter ``name`` of the open
    ``counting()`` scope. Without a scope it returns at once; inside one
    it keeps a reference and launches nothing."""
    if _COUNTS is not None:
        _COUNTS.entries.append((name, value))


# -- attributing a trace's device time to the program's spans -----------

def _timeline(spans: List[Tuple[int, int, str]]):
    """Sorted boundaries of nested ranges [(start, end, name)] and the
    innermost name in force from each boundary on (None: no range). A
    range that ends after its enclosing one is cut at that end."""
    bounds: List[int] = []
    names: List[Optional[str]] = []
    stack: List[Tuple[int, str]] = []          # (end, name)

    def close(upto):
        while stack and stack[-1][0] <= upto:
            end, _ = stack.pop()
            bounds.append(end)
            names.append(stack[-1][1] if stack else None)

    for s, e, name in sorted(spans, key=lambda r: (r[0], -r[1])):
        close(s)
        if stack:
            e = min(e, stack[-1][0])
        stack.append((e, name))
        bounds.append(s)
        names.append(name)
    close(float("inf"))
    return bounds, names


def _at(line, t) -> Optional[str]:
    bounds, names = line
    i = bisect.bisect_right(bounds, t) - 1
    return names[i] if i >= 0 else None


def attribute(device, launches, spans, ops=()) -> Dict:
    """Device time of a trace by the innermost program span that launched
    it, from plain records:

    - ``device``: [(start_ns, end_ns, correlation, name, activity)], the
      device's events; ``activity`` is kineto's type ("kernel",
      "gpu_memcpy", "gpu_memset", "gpu_user_annotation", ...), and
      annotation ranges are left out;
    - ``launches``: {correlation: (thread, t_ns)}, the host call that
      launched each device event;
    - ``spans``: [(thread, start_ns, end_ns, name)], the program's spans;
    - ``ops``: [(start_ns, end_ns, name)], host ops, to name idle gaps.

    Returns ``span_s`` and ``span_kernels`` (device seconds and kernel
    launches by innermost span; an event without one is
    ``unattributed``), ``device_s`` (their sum), ``busy_s`` (the union of
    the events), ``idle_span_s`` (idle seconds by the innermost span open
    at each gap's middle, on any thread) and ``idle_gaps``: the ten
    longest gaps as [span > op, seconds]."""
    work = sorted(d for d in device if d[4] != "gpu_user_annotation")
    by_thread: Dict[int, list] = {}
    for th, s, e, name in spans:
        by_thread.setdefault(th, []).append((s, e, name))
    lines = {th: _timeline(v) for th, v in by_thread.items()}
    every = _timeline([(s, e, n) for _, s, e, n in spans])
    span_s: Dict[str, float] = {}
    span_kernels: Dict[str, int] = {}
    device_s = 0.0
    for s, e, corr, _, activity in work:
        th, t = launches.get(corr, (None, None))
        name = (_at(lines[th], t) if th in lines else None) or "unattributed"
        span_s[name] = span_s.get(name, 0.0) + (e - s) * 1e-9
        device_s += (e - s) * 1e-9
        if activity == "kernel":
            span_kernels[name] = span_kernels.get(name, 0) + 1
    busy, gaps, cur = 0, [], None
    for s, e, *_ in work:
        if cur is None:
            cur = [s, e]
        elif s > cur[1]:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    op_line = _timeline(list(ops))
    idle: Dict[str, float] = {}
    named = []
    for a, b in gaps:
        mid = (a + b) // 2
        span = _at(every, mid) or "none"
        idle[span] = idle.get(span, 0.0) + (b - a) * 1e-9
        named.append([f"{span} > {_at(op_line, mid) or 'none'}",
                      (b - a) * 1e-9])
    named.sort(key=lambda g: -g[1])
    return {"span_s": span_s, "span_kernels": span_kernels,
            "device_s": device_s, "busy_s": busy * 1e-9,
            "idle_span_s": idle, "idle_gaps": named[:10]}


def _device_kind(evt) -> str:
    """kineto's type of a device event, from its flag and name (not every
    PyTorch release gives the type itself)."""
    if evt.is_user_annotation():
        return "gpu_user_annotation"
    low = evt.name().lower()
    return ("gpu_memcpy" if low.startswith("memcpy") else
            "gpu_memset" if low.startswith("memset") else "kernel")


def trace_records(prof):
    """The records ``attribute`` reads, from a finished torch.profiler
    profile: each device event's launch is the CUDA runtime or driver
    call (a host event named ``cu*``) with its correlation id; spans
    are the host ranges whose name starts with ``SPAN_PREFIX``."""
    device, launches, spans, ops = [], {}, [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        rec = (s, s + e.duration_ns(), e.name())
        if e.device_type() == cuda:
            device.append(rec[:2] + (e.correlation_id(), e.name(),
                                     _device_kind(e)))
        elif e.name().startswith("cu"):
            launches.setdefault(e.correlation_id(), (e.start_thread_id(), s))
        elif e.name().startswith(SPAN_PREFIX):
            spans.append((e.start_thread_id(),) + rec)
        elif not e.is_user_annotation():
            ops.append(rec)
    return device, launches, spans, ops


def span_summary(prof) -> Dict:
    """``attribute`` over a finished torch.profiler profile (CUDA
    activity) of the program: where its device time went by span."""
    return attribute(*trace_records(prof))


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
