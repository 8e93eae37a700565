"""Data parallelism of hotformerloc_torch (parallel/dist.py) on the CPU:
gloo, ranks started by torchrun (``dist.torchrun``; modelled on
tests/test_multihost.py), every run with a timeout.

1. tools/multihost_smoke at 2 ranks (global batch 8, DropPath 0.5,
   augmentations on) equals it at 1 process with the same accum_steps
   (each rank holds its half of every global microbatch, JAX's layout,
   so the shards reproduce the batch, the masks and the DropPath
   draws): the multistage step (accum 2) and the single pass (accum 1,
   its own rows spliced between the gathered ones); loss rtol 1e-6,
   every gradient |dg| <= 1e-4 |g| + 1e-7 (tensor norms), and both
   ranks' parameters bitwise equal after the step;
2. the 2-rank step at accum 4 (one row of each 2-row global microbatch
   per rank) with the JAX weights (params_from_jax) and DropPath 0
   equals the JAX single-device multistage step (accum 4) on the same
   global batch, at tests/test_torch_train.py's bar: loss rtol 1e-5,
   |dg| <= 1e-3 |g_jax| + 1e-8. JAX's gradients are read off an SGD step
   of rate 1e4: g = (p0 - p1) / 1e4;
3. retrieval_topk sharded over 2 ranks, D = 37, k = 25 (shard 19 < k),
   equals the one-process port and JAX's retrieval_topk, on one device
   and sharded over a 2-device mesh: indices exactly, distances 1e-5;
4. the train CLI at 2 ranks equals it at 1 process step by step (one
   step per epoch, 2 epochs, MESA and the sharded evaluation on): each
   epoch's logged stats, and each step's checkpoint (gradient moments
   at the gradient bar of 1, parameters), with only rank 0 logging;
5. pnv_evaluate at 2 ranks (retrieval sharded) writes, from rank 0
   only, the results line of 1 process;
6. tools/scaling_harness at 1 and 2 ranks;
7. without a group every helper is the identity; a failing rank raises.
"""
import torch_threads  # noqa: F401  (first: one torch thread per worker)

import json
import os
import pickle
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hotformerloc_tpu.evaluation import evaluate as je
from hotformerloc_tpu.losses import losses as jl
from hotformerloc_tpu.models import config as jcfg
from hotformerloc_tpu.models.hotformerloc import HOTFormerLoc as JModel
from hotformerloc_tpu.parallel.mesh import make_mesh
from hotformerloc_tpu.training.step import StepConfig as JStepConfig
from hotformerloc_tpu.training.step import init_train_state
from hotformerloc_tpu.training.step import make_train_step as j_train_step
from hotformerloc_torch.config import params as tparams
from hotformerloc_torch.convert import params_from_jax
from hotformerloc_torch.data.tuples import TrainingTuple
from hotformerloc_torch.evaluation.evaluate import retrieval_topk
from hotformerloc_torch.models import config as tcfg
from hotformerloc_torch.models.hotformerloc import HOTFormerLoc as TModel
from hotformerloc_torch.parallel import dist
from hotformerloc_torch.tools import multihost_smoke as mh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300                       # seconds per launched run
P = 256


def _env():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)               # conftest's 8-device flag
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    return env


def _launch(argv, n, log_dir, cwd=None):
    """``argv`` as n ranks under torchrun; returns each rank's output."""
    return dist.torchrun(argv, n, str(log_dir), timeout=TIMEOUT,
                         env=_env(), cwd=cwd)


def _run(argv):
    """``python *argv`` as one plain process; returns its output."""
    p = subprocess.run([sys.executable, *argv], env=_env(), text=True,
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       timeout=TIMEOUT)
    assert p.returncode == 0, p.stdout[-3000:]
    return p.stdout


def _tool(data, out, n, *extra):
    """multihost_smoke with --processes n (it starts the ranks itself);
    returns (results, tensors) per rank."""
    out = str(out)
    _run(["-m", mh.TOOL, "--data", data, "--processes", str(n),
          "--device", "cpu", "--out", out, "--tensors", *extra])
    res = [json.load(open(os.path.join(out, f"rank{r}.json")))
           for r in range(n)]
    ten = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=True)
           for r in range(n)]
    return res, ten


def _bar(got, want, a, b):
    """Names whose tensors break |got - want| <= a |want| + b (norms)."""
    assert set(got) == set(want)
    return [(n, float((got[n] - w).norm()), a * float(w.norm()) + b)
            for n, w in want.items()
            if not float((got[n] - w).norm()) <= a * float(w.norm()) + b]


@pytest.mark.parametrize("accum", [2, 1], ids=["multistage", "single_pass"])
def test_two_rank_step_equals_one_process(tmp_path, accum):
    data = str(tmp_path / "ds")
    mh.make_synthetic_dataset(data, n=16, points=P)
    common = ("--batch", "8", "--drop_path", "0.5", "--transforms")
    with ThreadPoolExecutor(2) as ex:
        two = ex.submit(_tool, data, tmp_path / "two", 2, "--accum",
                        str(accum), *common)
        one = ex.submit(_tool, data, tmp_path / "one", 1, "--accum",
                        str(accum), *common)
        (r2, t2), (r1, t1) = two.result(), one.result()
    assert [r["rows"] for r in r2] == [4, 4] and r1[0]["rows"] == 8
    assert r2[0]["backend"] == "gloo" and r1[0]["backend"] is None
    for r in r2:
        np.testing.assert_allclose(r["loss"], r1[0]["loss"], rtol=1e-6)
        np.testing.assert_allclose(r["grad_norm"], r1[0]["grad_norm"],
                                   rtol=1e-5)
    assert r2[0]["param_checksum"] == r2[1]["param_checksum"]
    for n, p in t2[0]["params"].items():
        assert torch.equal(p, t2[1]["params"][n]), n
    assert not _bar(t2[0]["grads"], t1[0]["grads"], 1e-4, 1e-7)


def test_two_rank_step_equals_jax_multistage_step(tmp_path):
    data = str(tmp_path / "ds")
    mh.make_synthetic_dataset(data, n=16, points=P)
    host = mh.load_batch(data, P, 8)
    batch = {k: jnp.asarray(v) for k, v in host.items()}
    cj = jcfg.tiny_test_config(drop_path=0.0, use_pallas_attn=False,
                               use_band_conv=False, num_points=P)
    jm = JModel(cj)
    lr = 1e4
    tx = optax.sgd(lr)
    state = init_train_state(jm, tx, jax.random.PRNGKey(1), batch)
    p0 = jax.tree_util.tree_map(np.array, state.params)
    tm = TModel(tcfg.tiny_test_config(drop_path=0.0, num_points=P),
                device="cpu")
    weights = str(tmp_path / "jax_weights.pt")
    torch.save(params_from_jax(p0, tm), weights)
    with ThreadPoolExecutor(1) as ex:
        two = ex.submit(_tool, data, tmp_path / "two", 2, "--accum", "4",
                        "--batch", "8", "--drop_path", "0", "--weights",
                        weights)
        step = j_train_step(jm, tx, jl.make_loss("truncatedsmoothap",
                                                 positives_per_query=1),
                            JStepConfig(accum_steps=4))
        state, stats = step(state, batch, jax.random.PRNGKey(0))
        p1 = jax.tree_util.tree_map(np.array, state.params)
        res, ten = two.result()
    gj = params_from_jax(jax.tree_util.tree_map(
        lambda a, b: (a - b) / lr, p0, p1), tm)
    for r in res:
        np.testing.assert_allclose(r["loss"], float(stats["loss"]),
                                   rtol=1e-5)
    bad = _bar(ten[0]["grads"], gj, 1e-3, 1e-8)
    assert not bad, bad[:5]


RETRIEVAL = """
import sys
import numpy as np
from hotformerloc_torch.evaluation.evaluate import retrieval_topk
from hotformerloc_torch.parallel import dist
group, device = dist.init_from_env("cpu")
x = np.load(sys.argv[1])
d, i = retrieval_topk(x["q"], x["db"], 25, device=device, group=group)
np.savez(f"{sys.argv[2]}/rank{dist.rank(group)}.npz", dist=d, idx=i)
dist.close(group)
"""


def test_sharded_retrieval_equals_single_device_and_jax(tmp_path):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((6, 16)).astype(np.float32)
    db = rng.standard_normal((37, 16)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    np.savez(tmp_path / "in.npz", q=q, db=db)
    (tmp_path / "retrieval.py").write_text(RETRIEVAL)
    _launch([str(tmp_path / "retrieval.py"), str(tmp_path / "in.npz"),
             str(tmp_path)], 2, tmp_path / "logs")
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    one = retrieval_topk(q, db, 25, device="cpu")
    jax_one = je.retrieval_topk(q, db, 25)
    jax_two = je.retrieval_topk(q, db, 25, mesh=make_mesh(jax.devices()[:2]))
    for g in got:
        assert g["idx"].shape == (6, 25)
        for d, i in (one, jax_one, jax_two):
            np.testing.assert_array_equal(g["idx"], i)
            np.testing.assert_allclose(g["dist"], d, atol=1e-5)
    np.testing.assert_array_equal(got[0]["dist"], got[1]["dist"])


def _write_trainer_env(root):
    """16 clouds (8 places x 2 passes), the four Oxford evaluation splits
    (2 runs of 3 places), and the train / model configs: batch 16 (one
    step per epoch) as microbatches of 4, 2 epochs, MESA from the start,
    evaluation and a checkpoint every epoch."""
    rng = np.random.default_rng(0)
    queries = {}
    for loc in range(8):
        base = rng.uniform(-0.9, 0.9, (P, 3))
        for k in range(2):
            i, sib = 2 * loc + k, 2 * loc + 1 - k
            rel = f"scan_{i:03d}.bin"
            (base + rng.normal(0, 0.01, base.shape)).tofile(root / rel)
            queries[i] = TrainingTuple(i, i, rel, np.array([sib]),
                                       np.array(sorted([i, sib])),
                                       np.array([float(loc), 0.0]))
    with open(root / "train.pickle", "wb") as f:
        pickle.dump(queries, f)
    for loc in ("oxford", "university", "residential", "business"):
        bases = rng.uniform(-0.9, 0.9, (3, P, 3))
        sets = {"database": [], "query": []}
        for run in range(2):
            db, qs = {}, {}
            for j in range(3):
                rel = f"{loc}_{run}_{j}.bin"
                (bases[j] + rng.normal(0, 0.01, (P, 3))).tofile(root / rel)
                db[j] = {"query": rel, "northing": 100.0 * j,
                         "easting": 0.0}
                qs[j] = {**db[j], 1 - run: [j]}
            sets["database"].append(db)
            sets["query"].append(qs)
        for kind, s in sets.items():
            with open(root / f"{loc}_evaluation_{kind}.pickle", "wb") as f:
                pickle.dump(s, f)
    train = root / "train.txt"
    train.write_text(f"""[DEFAULT]
dataset_folder = {root}

[TRAIN]
num_workers = 2
batch_size = 16
batch_split_size = 4
val_batch_size = 8
lr = 1e-3
epochs = 2
warmup_epochs = 1
scheduler_milestones = 2
aug_mode = 1
set_aug_mode = 1
octree_depth = 5
weight_decay = 1e-4
loss = TruncatedSmoothAP
tau1 = 0.01
positives_per_query = 1
similarity = cosine
dataset_name = Oxford
train_file = train.pickle
validation = False
mesa = 1.0
mesa_start_ratio = 0.0
eval_freq = 1
save_freq = 1
""")
    model = root / "model.txt"
    model.write_text("""[MODEL]
model = HOTFormerLoc-Test
channels = 16,32
num_blocks = 1,1
num_heads = 2,2
num_pyramid_levels = 2
num_octf_levels = 1
ct_size = 1
ADaPE_mode = cov
patch_size = 8
dilation = 2
input_features = P
downsample_input_embeddings = True
num_input_downsamples = 1
grad_checkpoint = True
conv_norm = layernorm
feature_size = 32
output_dim = 32
pooling = PyramidAttnPoolMixer
k_pooled_tokens = 12,4
coordinates = cartesian
normalize_embeddings = True
""")
    return str(train), str(model)


def test_two_rank_trainer_equals_one_process(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    train, model = _write_trainer_env(data)

    def run(n):
        w = tmp_path / f"w{n}"
        outs = _launch(["-m", "hotformerloc_torch.training.train",
                        "--config", train, "--model_config", model,
                        "--num_points", str(P), "--device", "cpu",
                        "--weights_dir", str(w), "--model_name", "t"], n,
                       tmp_path / f"logs{n}")
        return w / "Oxford", outs

    with ThreadPoolExecutor(2) as ex:
        jobs = [ex.submit(run, n) for n in (1, 2)]
        (w1, _), (w2, outs) = [j.result() for j in jobs]
    assert "epoch 1:" in outs[0] and "epoch 1:" not in outs[1]
    assert sorted(os.listdir(w1)) == sorted(os.listdir(w2))

    def log(w):
        with open(w / "t_log.jsonl") as f:
            return [json.loads(ln) for ln in f]

    l1, l2 = log(w1), log(w2)
    assert [r["phase"] for r in l2] == [r["phase"] for r in l1] == \
        ["train", "eval"] * 2
    for a, b in zip(l1, l2):
        assert set(a) == set(b)
        for k, v in a.items():
            if k in ("time", "loader_wait"):
                continue
            if a["phase"] == "train" and k not in ("epoch", "batches",
                                                    "batch_size", "phase"):
                np.testing.assert_allclose(b[k], v, rtol=1e-5, atol=1e-7,
                                           err_msg=k)
            else:
                assert b[k] == v, k
    assert [r["batches"] for r in l1 if r["phase"] == "train"] == [1, 1]
    for tag in ("e1", "e2"):                 # after step 1, after step 2
        c1, c2 = (torch.load(w / f"t_{tag}.ckpt", weights_only=True)
                  for w in (w1, w2))
        assert c1["step"] == c2["step"] == int(tag[1])
        names = list(c1["model"])
        m1 = {n: c1["optimizer"]["state"][i]["exp_avg"]
              for i, n in enumerate(names)}
        m2 = {n: c2["optimizer"]["state"][i]["exp_avg"]
              for i, n in enumerate(names)}
        assert not _bar(m2, m1, 1e-4, 1e-7)
        for n in names:
            torch.testing.assert_close(c2["model"][n], c1["model"][n],
                                       rtol=1e-5, atol=1e-6)


def test_two_rank_pnv_evaluate_equals_one_process(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    train, model = _write_trainer_env(data)
    cfg = tparams.parse_train_config(train, model, num_points=P)
    weights = str(tmp_path / "w.pt")
    torch.save(TModel(cfg.model_params.config, device="cpu").state_dict(),
               weights)

    def run(n):
        cwd = tmp_path / f"cwd{n}"       # where the results file goes
        cwd.mkdir()
        outs = _launch(["-m", "hotformerloc_torch.evaluation.pnv_evaluate",
                        "--config", train, "--model_config", model,
                        "--weights", weights, "--num_points", str(P),
                        "--device", "cpu"], n, tmp_path / f"logs{n}",
                       cwd=str(cwd))
        with open(cwd / "pnv_Oxford_results.txt") as f:
            return f.read().splitlines(), outs

    with ThreadPoolExecutor(2) as ex:
        jobs = [ex.submit(run, n) for n in (1, 2)]
        (one, _), (two, outs) = [j.result() for j in jobs]
    assert len(one) == 1 and two == one         # rank 0 wrote, once
    assert "Dataset: average" in outs[0] and "Dataset:" not in outs[1]


def test_scaling_harness_one_and_two_ranks(tmp_path):
    out = _run(["-m", "hotformerloc_torch.tools.scaling_harness",
                "--out", str(tmp_path), "--tiny", "--num_points", str(P),
                "--per_rank_batch", "4", "--iters", "1", "--device", "cpu",
                "--max_world", "2"])
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    with open(tmp_path / "scaling.jsonl") as f:
        assert [json.loads(ln) for ln in f] == lines
    assert [(r["world"], r["global_batch"], r["backend"]) for r in lines] \
        == [(1, 4, "gloo"), (2, 8, "gloo")]
    assert all(np.isfinite(r["step_ms"]) and r["step_ms"] > 0
               and r["device"] == "cpu" for r in lines)
    assert lines[0]["efficiency"] == 1.0


def test_helpers_without_a_group_are_the_identity(tmp_path):
    x = torch.arange(6.0).view(3, 2)
    assert dist.all_gather_rows(x) is x
    y = x.clone()
    dist.all_reduce_sum_([y])
    assert torch.equal(x, y)
    assert (dist.rank(), dist.world()) == (0, 1)
    assert dist.any_rank(True, "cpu") and not dist.any_rank(False, "cpu")
    m = torch.nn.Linear(2, 2)
    before = [p.clone() for p in m.parameters()]
    dist.broadcast_module_(m)
    assert all(torch.equal(a, b) for a, b in zip(before, m.parameters()))
    (tmp_path / "fail.py").write_text("import sys\nsys.exit(3)\n")
    with pytest.raises(RuntimeError) as e:
        _launch([str(tmp_path / "fail.py")], 2, tmp_path / "logs")
    assert re.search(r"exitcode\s*:\s*3", str(e.value)), str(e.value)
