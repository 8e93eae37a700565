"""tools/step_ab on the CPU: two workers (here both this checkout) at
the tiny config, answering alternating timed steps."""
import torch_threads  # noqa: F401  (first: one torch thread per worker)

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_step_ab_times_alternating_pairs(tmp_path):
    out = tmp_path / "ab.json"
    p = subprocess.run(
        [sys.executable, "-m", "hotformerloc_torch.tools.step_ab", "--a",
         REPO, "--b", REPO, "--tiny", "--device", "cpu", "--pairs", "3",
         "--warmup", "1", "--out", str(out)],
        cwd=REPO, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert p.returncode == 0, p.stdout[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    with open(out) as f:
        assert json.load(f) == res
    assert res["config"] == "tiny_test_config" and res["pairs"] == 3
    for k in ("a", "b"):
        t = res["times_ms"][k]
        assert len(t) == 3 and np.isfinite(t).all() and min(t) > 0
        lo, med, hi = res["quartiles_ms"][k]
        assert lo <= med <= hi and med == res["median_ms"][k]
    assert 0 <= res["b_faster_pairs"] <= 3
