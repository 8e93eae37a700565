"""The convergence tool of hotformerloc_torch on the CPU, at a tiny size.

* ``tools/synthetic_benchmark.generate`` against the JAX package's, same
  seed (places_per_loc 2, num_points 256): clouds byte-equal, the train
  tuples field by field and the evaluation pickles equal, and the INI
  files equal but for the dataset folder.
* ``tools/convergence_run`` on the generated benchmark's own small
  model.txt / train.txt, two epochs through the port's ``Trainer`` on the
  CPU, evaluated after each: the summary has the JAX tool's keys, finite
  losses and one evaluation row per evaluated epoch, and ``summarize``
  of the run's log gives it again; a second run into the same log is
  summarised alone.
"""
import torch_threads  # noqa: F401  (first: one torch thread per worker)

import math
import os
import pickle

import numpy as np

from hotformerloc_tpu.tools import convergence_run as jcr
from hotformerloc_tpu.tools import synthetic_benchmark as jsb
from hotformerloc_torch.tools import convergence_run as tcr
from hotformerloc_torch.tools import synthetic_benchmark as tsb

JAX_SUMMARY_KEYS = {"config", "dataset", "epochs", "final_loss",
                    "best_avg_AR1", "eval_trajectory", "train_trajectory"}


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_generate_matches_jax(tmp_path):
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "torch")
    kw = dict(places_per_loc=2, num_points=256, seed=3)
    assert jsb.generate(dj, **kw) == tsb.generate(dt, **kw)
    clouds = sorted(os.listdir(os.path.join(dj, "clouds")))
    assert clouds == sorted(os.listdir(os.path.join(dt, "clouds")))
    assert len(clouds) == 2 * 4 * (jsb.TRAIN_VARIANTS + jsb.EVAL_RUNS)
    for c in clouds:
        with open(os.path.join(dj, "clouds", c), "rb") as a, \
                open(os.path.join(dt, "clouds", c), "rb") as b:
            assert a.read() == b.read(), c
    qj = _load(os.path.join(dj, "train_tuples.pickle"))
    qt = _load(os.path.join(dt, "train_tuples.pickle"))
    assert type(next(iter(qt.values()))).__module__ \
        == "hotformerloc_torch.data.tuples"
    assert list(qj) == list(qt)
    for i in qj:
        a, b = vars(qj[i]), vars(qt[i])
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{i} {k}")
    for loc in jsb.LOCATIONS:
        for part in ("database", "query"):
            name = f"{loc}_evaluation_{part}.pickle"
            assert _load(os.path.join(dj, name)) \
                == _load(os.path.join(dt, name)), name
    for ini in ("train.txt", "model.txt"):
        with open(os.path.join(dj, ini)) as a, \
                open(os.path.join(dt, ini)) as b:
            assert a.read().replace(dj, "DIR") \
                == b.read().replace(dt, "DIR"), ini


def test_tiny_convergence_run_on_cpu(tmp_path):
    out = str(tmp_path / "bench")
    argv = ["--device", "cpu", "--tiny", "--places_per_loc", "2",
            "--num_points", "256", "--epochs", "2", "--eval_freq", "1",
            "--out", out, "--weights_dir", str(tmp_path / "w"),
            "--json_out", str(tmp_path / "summary.json")]
    summary = tcr.run(argv)
    assert set(summary) >= JAX_SUMMARY_KEYS
    assert [r["epoch"] for r in summary["train_trajectory"]] == [1, 2]
    assert all(math.isfinite(r["loss"]) for r in summary["train_trajectory"])
    assert [r["epoch"] for r in summary["eval_trajectory"]] == [1, 2]
    assert 0.0 <= summary["best_avg_AR1"] <= 100.0
    assert summary["device"] == "cpu"
    log = tmp_path / "w" / "Oxford" / "ConvergenceRun_log.jsonl"
    again = tcr.summarize(str(log), tcr.parse_args(argv))
    assert again == {k: v for k, v in summary.items() if k != "device"}
    # a second run appends to the same log; its summary is its own
    second = tcr.run(argv[:argv.index("--epochs")] + [
        "--epochs", "1", "--eval_freq", "1"] + argv[
        argv.index("--out"):])
    assert [r["epoch"] for r in second["train_trajectory"]] == [1]
    assert len(log.read_text().splitlines()) == 6
    # the flagship model INI is the JAX tool's text (remat_policy left at
    # its default)
    args = tcr.parse_args(["--exact"])
    assert args.num_points == 4096 and args.batch_split_size == 8
    for exact in (True, False):
        assert tcr.model_cfg(exact) == jcr.model_cfg(exact)
    assert "remat_policy" not in tcr.model_cfg(True)
