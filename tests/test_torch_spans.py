"""The program's spans and block counter (``utils/profiling.py``
``annotate``, ``count``, ``counting``, ``attribute``) on the CPU:

* a tiny ``make_embed_fn`` forward under torch.profiler records the span
  tree: ``hfl.embed`` the root, every other span inside it and apart
  from the others, each block span once per block of the config;
* with no profiler running ``annotate`` is a shared no-op and records
  nothing; with no counting scope ``count`` keeps nothing;
* the blocks' ``hfl.block.valid`` equals the octree's counts at their
  depths (and the benchmark's own ``level_counts``) plus the RTSA's
  valid relay tokens, against ``hfl.block.slots`` of padded capacity;
* the attribution of device events to spans, on synthetic event lists;
* a checkpointed ('save_hot') train step gives the same gradients with
  the profiler recording as without it;
* trace readers leave out the ranges kineto draws on a stream for a
  ``record_function``.
"""
import torch_threads  # noqa: F401  (first: one torch thread per worker)

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from hotformerloc_torch.evaluation.embed import make_embed_fn
from hotformerloc_torch.losses import losses as tl
from hotformerloc_torch.models import config as tcfg
from hotformerloc_torch.models.hotformerloc import (HOTFormerLoc,
                                                    build_model_plan)
from hotformerloc_torch.ops import window as ow
from hotformerloc_torch.training import optim as topt
from hotformerloc_torch.training.step import StepConfig, make_train_step
from hotformerloc_torch.utils import profiling

P = 256
CONFIGS = {
    "tiny": {},
    "rt_propagation": {"rt_propagation": True},
    "octf_use_rt": {"octf_use_rt": True},
}


def _clouds(B=2, seed=0):
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.uniform(-0.9, 0.9, (B, P, 3)).astype(
        np.float32))
    pmask = torch.ones(B, P, dtype=torch.bool)
    pmask[-1, 170:] = False
    return pts, pmask


def _embed(overrides):
    cfg = tcfg.tiny_test_config(num_points=P, **overrides)
    model = HOTFormerLoc(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(1))
    return cfg, make_embed_fn(model, torch.float32)


def _expected_spans(cfg):
    """How often each span opens in one forward of ``cfg``."""
    octf = sum(cfg.num_blocks[:cfg.num_octf_levels])
    iters, levels = cfg.num_blocks[-1], len(cfg.stage_channels()[1])
    rt = octf if cfg.octf_use_rt else 0
    want = {"hfl.embed": 1, "hfl.octree": 1, "hfl.plan": 1,
            "hfl.features": 1, "hfl.stem": 1, "hfl.rt_init": 1,
            "hfl.pooling": 1, "hfl.down": cfg.num_octf_levels + levels - 1,
            "hfl.block.osa": octf - rt, "hfl.block.rtsa": iters + rt,
            "hfl.block.hosa": iters * levels + rt}
    if cfg.rt_propagation:
        want["hfl.rt_propagate"] = 1
    return {k: v for k, v in want.items() if v}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_embed_records_the_span_tree(name):
    cfg, embed = _embed(CONFIGS[name])
    pts, pmask = _clouds()
    embed(pts, pmask)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        embed(pts, pmask)
    _, _, spans, _ = profiling.trace_records(prof)
    seen = {}
    for _, _, _, n in spans:
        seen[n] = seen.get(n, 0) + 1
    assert seen == _expected_spans(cfg)
    assert len({th for th, *_ in spans}) == 1
    root = next((s, e) for _, s, e, n in spans if n == "hfl.embed")
    rest = sorted((s, e, n) for _, s, e, n in spans if n != "hfl.embed")
    for s, e, n in rest:
        assert root[0] <= s <= e <= root[1], n
    for (s0, e0, n0), (s1, e1, n1) in zip(rest, rest[1:]):
        assert e0 <= s1, (n0, n1)                # no span inside another


def test_annotate_without_a_profiler_is_a_shared_noop(monkeypatch):
    a, b = profiling.annotate("hfl.a"), profiling.annotate("hfl.b")
    assert a is b
    with a:
        pass
    made = []
    real = profiling._RecordFunctionFast

    def record(name):
        made.append(name)
        return real(name)
    monkeypatch.setattr(profiling, "_RecordFunctionFast", record)
    cfg, embed = _embed({})
    pts, pmask = _clouds()
    embed(pts, pmask)
    assert made == []                 # no profiler: no RecordFunction
    # the profiler exists but waits and warms up: no span is made then,
    # and the step it records holds only its plain op
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=1, warmup=1, active=1)) as prof:
        embed(pts, pmask)
        prof.step()
        embed(pts, pmask)
        prof.step()
        torch.ones(8).sum()
        prof.step()
    assert made == []
    names = {e.name for e in prof.events()}
    assert "aten::sum" in names
    assert not [n for n in names if n.startswith("hfl.")]
    # inside a recording profiler the span is recorded
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.annotate("hfl.inside"):
            torch.ones(8).sum()
    assert "hfl.inside" in {e.name for e in prof.events()}


def test_count_without_a_scope_keeps_nothing():
    _, embed = _embed({})
    pts, pmask = _clouds()
    profiling.count("hfl.block.valid", torch.ones(3))
    embed(pts, pmask)
    assert profiling._COUNTS is None
    with profiling.counting() as outer:
        with profiling.counting() as inner:
            profiling.count("x", 2)
        profiling.count("x", torch.tensor([True, False, True]))
    assert inner.totals() == {"x": 2} and outer.totals() == {"x": 2}
    with profiling.counting() as empty:
        pass
    assert empty.totals() == {}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_block_counter_counts_valid_nodes_and_slots(name):
    from portbench.core.counts import level_counts
    from portbench.ref.models.config import ModelConfig as RefConfig

    cfg, embed = _embed(CONFIGS[name])
    pts, pmask = _clouds(B=3, seed=2)
    pmask[:] = True               # level_counts builds on whole clouds
    with profiling.counting() as c:
        embed(pts, pmask)
    got = c.totals()

    oc = build_model_plan(cfg, pts, pmask, tap_lists=False).octree
    octf_depths = [cfg.transformer_depth - i
                   for i in range(cfg.num_octf_levels)
                   for _ in range(cfg.num_blocks[i])]
    hotf = cfg.transformer_depth - cfg.num_octf_levels
    pyr = [hotf - j for j in range(len(cfg.stage_channels()[1]))]
    block_depths = octf_depths + pyr * cfg.num_blocks[-1]
    nodes = sum(int(oc.count(d).sum()) for d in block_depths)
    slots = sum(pts.shape[0] * oc.cap(d) for d in block_depths)
    chunk = cfg.patch_size // cfg.rt_size
    rt_mask = torch.cat([ow.window_valid(oc.node_valid(d), chunk)
                         for d in pyr], dim=1)
    relay = cfg.num_blocks[-1] * int(rt_mask.sum())
    relay_slots = cfg.num_blocks[-1] * rt_mask.numel()
    for d in (octf_depths if cfg.octf_use_rt else []):
        wvalid = ow.window_valid(oc.node_valid(d), chunk)
        relay += int(wvalid.sum())
        relay_slots += wvalid.numel()
    assert got == {"hfl.block.valid": nodes + relay,
                   "hfl.block.slots": slots + relay_slots}
    assert 0 < got["hfl.block.valid"] < got["hfl.block.slots"]

    ref_cfg = RefConfig(**dataclasses.asdict(cfg))
    lev = level_counts(ref_cfg, pts)
    assert nodes == sum(sum(lev[d].nodes) for d in block_depths)


# -- attribution on synthetic event lists ------------------------------------

# spans of thread 1: A [0, 100] holding B [10, 50] and C [60, 90]
SPANS = [(1, 0, 100, "hfl.a"), (1, 10, 50, "hfl.b"), (1, 60, 90, "hfl.c")]


def test_a_kernel_goes_to_its_innermost_span():
    device = [(200, 210, 1, "k1", "kernel"),      # launched inside B
              (220, 230, 2, "k2", "kernel"),      # inside A only
              (240, 250, 3, "k3", "kernel"),      # inside C
              (260, 280, 4, "copy", "gpu_memcpy")]
    launches = {1: (1, 20), 2: (1, 55), 3: (1, 70), 4: (1, 30)}
    r = profiling.attribute(device, launches, SPANS)
    assert r["span_kernels"] == {"hfl.b": 1, "hfl.a": 1, "hfl.c": 1}
    assert r["span_s"] == pytest.approx(
        {"hfl.b": 30e-9, "hfl.a": 10e-9, "hfl.c": 10e-9})
    assert r["device_s"] == pytest.approx(sum(r["span_s"].values()))


def test_a_kernel_launched_outside_every_span_is_unattributed():
    device = [(200, 210, 1, "k1", "kernel"), (210, 220, 2, "k2", "kernel"),
              (220, 230, 3, "k3", "kernel")]
    # after every span; on a thread without spans; no launch record
    launches = {1: (1, 150), 2: (7, 20)}
    r = profiling.attribute(device, launches, SPANS)
    assert r["span_kernels"] == {"unattributed": 3}
    assert r["span_s"] == pytest.approx({"unattributed": 30e-9})


def test_an_annotation_range_counts_as_neither_busy_time_nor_a_kernel():
    device = [(200, 210, 1, "k1", "kernel"), (300, 310, 2, "k2", "kernel"),
              (150, 400, 3, "hfl.a", "gpu_user_annotation")]
    launches = {1: (1, 20), 2: (1, 70)}
    r = profiling.attribute(device, launches, SPANS)
    assert r["span_kernels"] == {"hfl.b": 1, "hfl.c": 1}
    assert r["busy_s"] == pytest.approx(20e-9)
    assert r["device_s"] == pytest.approx(20e-9)


def test_idle_gaps_are_named_by_the_span_open_at_their_middle():
    device = [(0, 10, 1, "k1", "kernel"), (30, 40, 2, "k2", "kernel"),
              (35, 45, 3, "k3", "kernel"), (80, 84, 4, "k4", "kernel"),
              (130, 140, 5, "k5", "kernel")]
    ops = [(15, 25, "aten::lt"), (60, 75, "aten::cat")]
    r = profiling.attribute(device, {}, SPANS, ops)
    # gaps: (10, 30) mid 20 in B; (45, 80) mid 62 in C; (84, 130) mid 107
    assert r["busy_s"] == pytest.approx(39e-9)
    assert r["idle_span_s"] == pytest.approx(
        {"hfl.b": 20e-9, "hfl.c": 35e-9, "none": 46e-9})
    assert r["idle_gaps"] == [["none > none", pytest.approx(46e-9)],
                              ["hfl.c > aten::cat", pytest.approx(35e-9)],
                              ["hfl.b > aten::lt", pytest.approx(20e-9)]]


def test_a_range_past_its_enclosing_one_is_cut_at_its_end():
    line = profiling._timeline([(0, 10, "a"), (5, 20, "b"), (30, 40, "c")])
    assert [profiling._at(line, t) for t in (-1, 2, 7, 15, 35, 45)] == [
        None, "a", "b", None, "c", None]


# -- spans inside checkpointed blocks ----------------------------------------


def _train_step_grads(trace: bool, overrides):
    cfg = tcfg.tiny_test_config(num_points=P, grad_checkpoint=True,
                                remat_policy="save_hot", **overrides)
    model = HOTFormerLoc(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(4))
    opt = topt.make_optimizer(model.parameters(), "adam",
                              topt.lr_schedule(1e-3, 1, 100,
                                               scheduler="constant"))
    step = make_train_step(model, opt, tl.make_loss(
        "truncatedsmoothap", positives_per_query=1), StepConfig())
    pts, pmask = _clouds(B=4, seed=3)
    same = np.arange(4)[:, None] // 2 == np.arange(4)[None] // 2
    batch = {"points": pts, "pmask": pmask,
             "positives_mask": torch.from_numpy(same & ~np.eye(4, dtype=bool)),
             "negatives_mask": torch.from_numpy(~same)}
    if trace:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step(batch, 0)
        names = [e.name for e in prof.events()]
    else:
        step(batch, 0)
        names = []
    return {n: p.grad.clone() for n, p in model.named_parameters()}, \
        names, cfg


@pytest.mark.parametrize("name", ["tiny", "octf_use_rt"])
def test_spans_keep_a_checkpointed_step_exact(name):
    plain, _, _ = _train_step_grads(False, CONFIGS[name])
    traced, names, cfg = _train_step_grads(True, CONFIGS[name])
    assert set(plain) == set(traced)
    for n in plain:
        assert torch.equal(plain[n], traced[n]), n
    # the backward recomputes each checkpointed block inside its span; an
    # OctFormer stage's attention over its relay tokens is not checkpointed
    once = _expected_spans(cfg)
    octf_rt = sum(cfg.num_blocks[:cfg.num_octf_levels]) * cfg.octf_use_rt
    assert names.count("hfl.block.osa") == 2 * once.get("hfl.block.osa", 0)
    assert names.count("hfl.block.hosa") == 2 * once["hfl.block.hosa"]
    assert names.count("hfl.block.rtsa") == (2 * once["hfl.block.rtsa"]
                                             - octf_rt)


# -- trace readers --------------------------------------------------------------


def test_device_work_leaves_out_annotation_ranges():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    kernel = SimpleNamespace(device_type=cuda, is_user_annotation=False)
    annotation = SimpleNamespace(device_type=cuda, is_user_annotation=True)
    host = SimpleNamespace(device_type=cpu, is_user_annotation=False)
    assert [profiling.device_work(e) for e in
            (kernel, annotation, host)] == [True, False, False]
