"""The serving call's graph path (``evaluation/embed.py`` ``make_embed_fn``)
on the CPU, on the tiny model:

* on the CPU it stays eager and gives the model's own forward;
* a call shape is captured on its second call, never on its first, and
  replayed from then on (through an injected capture: the tool's
  ``HostReplay``, which overwrites its outputs on every replay as a CUDA
  graph does), each replay reading its own call's inputs;
* the returned tensors are copies: no two calls share one, and a later
  call leaves an earlier result as it was;
* an open ``profiling.counting()`` scope, and ``graphs=False``, run
  eagerly; at most ``MAX_GRAPHS`` graphs are held;
* the card check (``tools/graph_check.py``) runs its host logic, and
  fails on a traced window whose kernels differ from eager in either
  direction and on a replay that is off the eager forward.
"""
import torch_threads  # noqa: F401  (first: one torch thread per worker)

import json

import numpy as np
import pytest
import torch

from hotformerloc_torch.evaluation import embed as embed_mod
from hotformerloc_torch.evaluation.embed import make_embed_fn
from hotformerloc_torch.models import config as tcfg
from hotformerloc_torch.models.hotformerloc import HOTFormerLoc
from hotformerloc_torch.tools import graph_check
from hotformerloc_torch.utils import profiling

P = 256


@pytest.fixture(scope="module")
def model():
    return HOTFormerLoc(tcfg.tiny_test_config(num_points=P), device="cpu",
                        generator=torch.Generator().manual_seed(1))


def _clouds(B=2, seed=0):
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.uniform(-0.9, 0.9, (B, P, 3)).astype(
        np.float32))
    pmask = torch.ones(B, P, dtype=torch.bool)
    pmask[-1, 170:] = False
    return pts, pmask


def _forward(model, pts, pmask):
    with torch.inference_mode():
        return model(pts, pmask, dtype=torch.float32)["global"]


class Captures:
    """An injected capture step: ``HostReplay``, counting captures and
    replays."""

    def __init__(self):
        self.captured, self.replays = 0, 0

    def __call__(self, run, pool):
        self.captured += 1
        graph = graph_check.HostReplay(run, pool)

        def replay():
            self.replays += 1
            return graph()
        return replay


def test_cpu_path_is_eager_and_equals_the_forward(model, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CUDA graph was captured on the CPU")
    monkeypatch.setattr(embed_mod, "CudaGraphReplay", refuse)
    embed = make_embed_fn(model, torch.float32)
    for seed in range(3):
        pts, pmask = _clouds(seed=seed)
        out = embed(pts, pmask)
        assert set(out) == {"global", "octree_overflow"}
        assert torch.equal(out["global"], _forward(model, pts, pmask))


def test_a_shape_is_captured_on_its_second_call(model):
    cap = Captures()
    embed = make_embed_fn(model, torch.float32, capture=cap)
    batches = [_clouds(seed=s) for s in range(4)]
    for i, (pts, pmask) in enumerate(batches):
        out = embed(pts, pmask)
        assert cap.captured == (0 if i == 0 else 1)
        assert cap.replays == max(0, i)
        assert torch.equal(out["global"], _forward(model, pts, pmask))
    pts, pmask = _clouds(B=3, seed=9)           # another shape: eager first
    embed(pts, pmask)
    assert (cap.captured, cap.replays) == (1, 3)
    out = embed(pts, pmask)
    assert (cap.captured, cap.replays) == (2, 4)
    assert torch.equal(out["global"], _forward(model, pts, pmask))


def test_returned_tensors_are_not_aliased_across_calls(model):
    embed = make_embed_fn(model, torch.float32, capture=Captures())
    batches = [_clouds(seed=s) for s in range(4)]
    outs = [embed(*b) for b in batches]
    ptrs = {o[k].data_ptr() for o in outs for k in o}
    assert len(ptrs) == 2 * len(outs)
    for o, b in zip(outs, batches):
        assert torch.equal(o["global"], _forward(model, *b))


def test_an_open_counting_scope_runs_eagerly(model):
    cap = Captures()
    embed = make_embed_fn(model, torch.float32, capture=cap)
    pts, pmask = _clouds()
    embed(pts, pmask)
    embed(pts, pmask)
    assert (cap.captured, cap.replays) == (1, 1)
    with profiling.counting() as c:
        assert profiling.counting_open()
        out = embed(pts, pmask)
    assert not profiling.counting_open()
    assert (cap.captured, cap.replays) == (1, 1)
    assert c.totals()["hfl.block.slots"] > 0
    assert torch.equal(out["global"], _forward(model, pts, pmask))


def test_graphs_off_and_the_bound_on_held_graphs(model, monkeypatch):
    cap = Captures()
    embed = make_embed_fn(model, torch.float32, graphs=False, capture=cap)
    for _ in range(3):
        embed(*_clouds())
    assert cap.captured == 0
    monkeypatch.setattr(embed_mod, "MAX_GRAPHS", 1)
    embed = make_embed_fn(model, torch.float32, capture=cap)
    a, b = _clouds(B=2), _clouds(B=3)
    for batch in (a, a, b, b, a, a, b):
        embed(*batch)
    # a's graph went when b's came, so a ran eagerly once more before its
    # second capture; b's graph went then too
    assert cap.captured == 3


def test_graph_check_runs_on_cpu(tmp_path, capsys):
    lines = graph_check.run(["--device", "cpu", "--replays", "2",
                             "--out", str(tmp_path)])
    head, line = lines
    assert head["head"] == "cpu" and head["nvidia_smi"] is None
    assert line["replays_bit_equal"] == 2 and line["max_abs_diff"] == 0.0
    assert line["outputs_distinct"] and line["eager_repeat_bit_equal"]
    assert line["capture_s"] > 0 and line["capture_call_s"] > 0
    for k in ("graphed_launches", "eager_launches", "eager_not_graphed",
              "graphed_device_ms", "eager_idle_share"):
        assert line[k] is None, k
    assert json.loads((tmp_path / "graph_check.json").read_text()) == lines
    assert json.loads(capsys.readouterr().out.splitlines()[1]) == line


@pytest.mark.parametrize("eager,graphed,faulty", [
    ([{"a": 2, "b": 1}] * 3, [{"a": 2, "b": 1}] * 3, ()),
    ([{"a": 2, "b": 1}] * 3, [{"a": 2, "b": 1, "add": 1}] * 3,
     ("graphed window 0", "graphed window 1", "graphed window 2")),
    ([{"a": 2, "b": 1}] * 3, [{"a": 2, "b": 1}, {"a": 1, "b": 1},
                              {"a": 2, "b": 1}], ("graphed window 1",)),
    ([{"a": 2, "b": 1}, {"a": 2}, {"a": 2, "b": 1}], [{"a": 2, "b": 1}] * 3,
     ("eager window 1",)),
    ([{"a": 2, "b": 1}] * 3, [{"a": 2, "c": 1}, {"a": 2, "b": 1},
                              {"a": 2, "b": 1}], ("graphed window 0",)),
])
def test_graph_check_trace_faults_both_ways(eager, graphed, faulty):
    """A window that lacks a kernel of the first eager window, or holds
    one more, is a fault, on either side."""
    from collections import Counter
    faults = graph_check.trace_faults([Counter(w) for w in eager],
                                      [Counter(w) for w in graphed])
    assert [f.split(":")[0] for f in faults] == list(faulty)


def test_graph_check_fails_on_a_replay_off_the_eager_forward(monkeypatch):
    class Off(graph_check.HostReplay):
        def __call__(self):
            out = super().__call__()
            out["global"][0, 0] += 1e-6
            return out
    monkeypatch.setattr(graph_check, "HostReplay", Off)
    with pytest.raises(AssertionError, match="replays off the eager"):
        graph_check.run(["--device", "cpu", "--replays", "2"])
