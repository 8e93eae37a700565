"""A run end to end on the CPU at tiny sizes (the harness's look for a
card skipped): the last line's shape, ``correct`` on sound runs, and
``run.py`` refusing to run without a card."""
import json
import subprocess
import sys

import pytest

from helpers import TRAIN, run_cpu, tiny_cell, tiny_mesa_cell
from portbench.core import spec

ROOT = spec.ROOT


def check_shape(out, trace=False):
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert isinstance(out["correct"], bool)
    assert out["attempted"] > 0 and out["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        out["device"])
    for v in out["metrics"].values():
        assert set(v) == {"value", "unit"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


def test_serve_run_shape_and_correct():
    cell = tiny_cell("oxford-serve-b32")
    out = run_cpu(cell)
    check_shape(out)
    assert out["correct"]
    assert set(out["metrics"]) == {"setup_s", "serve_batch_p95_ms"}
    assert set(out["checks"]) == {"desc_max_abs", "octree_overflow"}


@pytest.mark.parametrize("mesa", [False, True])
def test_train_run_shape_and_correct(mesa):
    cell = tiny_mesa_cell() if mesa else tiny_cell(TRAIN)
    out = run_cpu(cell)
    check_shape(out)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"setup_s", "train_submaps_per_s"}
    assert set(out["checks"]) == set(cell.workload["limits"])
    # fp32 on both sides: the port's plain path and the reference agree
    # far inside the limits set for bf16
    assert all(c["value"] < c["limit"] / 10 for c in out["checks"].values())


@pytest.mark.parametrize("name", ["oxford-serve-b32", TRAIN])
def test_traced_run_reports_per_layer_metrics_only(name):
    out = run_cpu(tiny_cell(name), trace=True)
    check_shape(out)
    # no device trace on the CPU: every per-layer reader finds nothing
    assert out["metrics"] == {}


def test_readers_on_a_summary():
    s = {"entry": "serve", "submaps": 64, "kernels": 640, "window_s": 0.2,
         "busy_s": 0.15, "layer_s": {"attention": 0.02, "conv": 0.01,
                                     "plain": 0.12},
         "model_flops": 7.0e12, "attn_flops": 2.2e11, "attn_bytes": 9.3e9,
         "peak_mem_bytes": 3e9}
    read = {p.stem: spec.metric_reader(p.stem)(s)
            for p in (spec.BENCH_DIR / "metrics").glob("*.py")}
    assert read["launches_per_submap.serve"] == 10
    assert read["idle_share.serve"] == pytest.approx(25.0)
    assert read["conv_device_ms.serve"] == pytest.approx(10 / 64)
    assert read["plain_device_ms.serve"] == pytest.approx(120 / 64)
    assert read["mfu.serve"] == pytest.approx(100 * 7e12 / 0.2 / 989e12)
    assert read["attn_roofline.serve"] == pytest.approx(
        100 * (9.3e9 / 3.35e12) / 0.02)
    assert all(read[k] is None for k in read if k.endswith(".train"))


def test_run_py_refuses_without_a_card(tmp_path):
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"),
                        "--workload", "oxford-serve-b32", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300,
                       cwd=tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "needs 1 CUDA device" in p.stderr
