"""The port's config parser, trainer, checkpoints, activation
checkpointing, qkv initialisers and preemption path, on the CPU.

* parse_train_config: the same dataclass fields as the JAX package's on
  every shipped configs/*.txt pair (and after an override);
* the tiny trainer (tests/test_trainer.py's configs, MESA on) runs 2
  epochs with evaluation, writes a checkpoint and a .meta.json per
  epoch, and a resumed trainer holds the same epoch, parameters,
  optimizer moments, update count, EMA teacher and sampler batch size;
* one epoch's stats and weights equal make_train_step driven by hand over
  the same loader batches and step seeds (exactly: same ops, same order);
* grad_checkpoint on and off: equal loss and gradients (exactly, fp32,
  DropPath 0.5, the multistage step), and the checkpointed blocks really
  ran again in the backward;
* apply_qkv_init: each mode's std and bound (from the weight's fans) on
  the qkv weights only, within 10% of the JAX function's std on the
  same layer (the flax kernel is the transpose) where JAX's kernel is
  2-D; the initial weights' std per parameter against JAX's;
* the preemption handler, maybe_requeue_exit and run_elastic.

The JAX trainer itself is not run: its CPU compile takes minutes.
"""
import torch_threads  # noqa: F401  (first: one torch thread per worker)

import dataclasses
import json
import math
import os
import pickle
import signal
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hotformerloc_tpu.config import params as jparams
from hotformerloc_tpu.models import config as jcfg
from hotformerloc_tpu.models.hotformerloc import HOTFormerLoc as JModel
from hotformerloc_tpu.training import step as jstep
from hotformerloc_torch.config import params as tparams
from hotformerloc_torch.convert import params_from_jax
from hotformerloc_torch.data.tuples import TrainingTuple
from hotformerloc_torch.losses.losses import make_loss
from hotformerloc_torch.models import config as tcfg
from hotformerloc_torch.models.backbone import HOTFormerIteration
from hotformerloc_torch.models.blocks import OctFormerBlock
from hotformerloc_torch.models.hotformerloc import HOTFormerLoc, param_count
from hotformerloc_torch.training import elastic
from hotformerloc_torch.training.optim import lr_schedule, make_optimizer
from hotformerloc_torch.training.step import (StepConfig, apply_qkv_init,
                                              make_train_step)
from hotformerloc_torch.training.trainer import (Trainer, load_checkpoint,
                                                 step_seed, to_device)

P = 256
SHIPPED = ("oxford", "wild-places", "cs-wild-places", "cs-campus3d")


@pytest.mark.parametrize("name", SHIPPED)
def test_parse_shipped_configs_equal_jax(name):
    args = (f"configs/{name}.txt", f"configs/{name}_model.txt")
    a = jparams.parse_train_config(*args)
    b = tparams.parse_train_config(*args)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    ov = {"lr": 1e-4, "patch_size": 32, "grad_checkpoint": False}
    a = jparams.update_params_from_dict(a, dict(ov))
    b = tparams.update_params_from_dict(b, dict(ov))
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert jparams.loss_kwargs(a) == tparams.loss_kwargs(b)
    assert b.model_params.config.grad_checkpoint is False


@pytest.fixture(scope="module")
def tiny_env(tmp_path_factory):
    """tests/test_trainer.py's dataset (6 locations x 2 passes of 256
    points) and configs, plus the four Oxford evaluation splits (2 runs
    of 3 places each) and MESA from the first epoch."""
    root = tmp_path_factory.mktemp("oxford_mini")
    rng = np.random.default_rng(0)
    queries = {}
    for loc in range(6):
        base = rng.uniform(-0.9, 0.9, (P, 3))
        for k in range(2):
            i = loc * 2 + k
            pc = base + rng.normal(0, 0.01, base.shape)
            rel = f"scan_{i:03d}.bin"
            pc.astype(np.float64).tofile(root / rel)
            sibling = loc * 2 + (1 - k)
            queries[i] = TrainingTuple(
                id=i, timestamp=i, rel_scan_filepath=rel,
                positives=np.array([sibling]),
                non_negatives=np.array(sorted([i, sibling])),
                position=np.array([float(loc), 0.0]))
    with open(root / "train.pickle", "wb") as f:
        pickle.dump(queries, f)
    for loc in ("oxford", "university", "residential", "business"):
        bases = rng.uniform(-0.9, 0.9, (3, P, 3))
        sets = {"database": [], "query": []}
        for run in range(2):
            db, q = {}, {}
            for j in range(3):
                rel = f"{loc}_{run}_{j}.bin"
                (bases[j] + rng.normal(0, 0.01, (P, 3))).tofile(root / rel)
                db[j] = {"query": rel, "northing": 100.0 * j,
                         "easting": 0.0}
                q[j] = {**db[j], 1 - run: [j]}
            sets["database"].append(db)
            sets["query"].append(q)
        for kind, s in sets.items():
            with open(root / f"{loc}_evaluation_{kind}.pickle", "wb") as f:
                pickle.dump(s, f)

    cfg_dir = tmp_path_factory.mktemp("cfg")
    train_cfg = cfg_dir / "train.txt"
    train_cfg.write_text(f"""[DEFAULT]
dataset_folder = {root}

[TRAIN]
num_workers = 2
batch_size = 8
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
    model_cfg = cfg_dir / "model.txt"
    model_cfg.write_text("""[MODEL]
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
    return str(train_cfg), str(model_cfg)


def _params(env, **over):
    p = tparams.parse_train_config(*env, num_points=P)
    for k, v in over.items():
        setattr(p, k, v)
    return p


def _log(trainer):
    with open(os.path.join(trainer.weights_dir,
                           trainer.model_name + "_log.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def _same_state(a: Trainer, b: Trainer):
    for (n, x), (m, y) in zip(a.model.state_dict().items(),
                              b.model.state_dict().items()):
        assert n == m and torch.equal(x, y), n
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sorted(sa["state"]) == sorted(sb["state"])
    for k in sa["state"]:
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa["state"][k][name], sb["state"][k][name])
            assert sa["state"][k][name].device == \
                sb["state"][k][name].device
    assert a.train_step.state.step == b.train_step.state.step
    for x, y in zip(a.train_step.state.ema_model.parameters(),
                    b.train_step.state.ema_model.parameters()):
        assert torch.equal(x, y)


def test_trainer_two_epochs_and_resume(tiny_env, tmp_path):
    p = _params(tiny_env)
    tr = Trainer(p, weights_dir=str(tmp_path), model_name="t",
                 device="cpu", seed=3)
    try:
        tr.train()
    finally:
        tr.close()
    assert tr.model.dtype == torch.float32 and tr.use_ema
    log = _log(tr)
    train = [r for r in log if r["phase"] == "train"]
    evals = [r for r in log if r["phase"] == "eval"]
    assert [r["epoch"] for r in train] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in train)
    assert all(r["batches"] == 2 for r in train)    # 8, then the flush 4
    assert [r["epoch"] for r in evals] == [1, 2]
    assert tr.train_step.state.step == 4
    for tag in ("e1", "e2", "latest", "final", "best"):
        path = tr.ckpt_path(tag)
        assert os.path.exists(path) and os.path.exists(path + ".meta.json")
    with open(tr.ckpt_path("e2") + ".meta.json") as f:
        assert json.load(f) == {"wandb_run_id": None,
                                "sampler_batch_size": 8}

    tr.train_sampler.batch_size = 6        # as a batch expansion leaves it
    tr.best_metric = 12.5
    path = tr.save("latest", 2)
    back = Trainer(_params(tiny_env), weights_dir=str(tmp_path / "b"),
                   model_name="t", device="cpu", seed=9)
    back.resume(path)
    back.close()
    assert back.start_epoch == 3 and back.best_metric == 12.5
    assert back.train_sampler.batch_size == 6
    _same_state(tr, back)
    assert len(back.optimizer.state_dict()["state"]) == len(
        list(back.model.parameters()))
    assert load_checkpoint(tr.ckpt_path("e1"), back.train_step)[0] == 1
    assert back.train_step.state.step == 2


def test_epoch_equals_step_by_hand(tiny_env, tmp_path):
    p = _params(tiny_env, epochs=1, eval_freq=0, mesa=0.0)
    tr = Trainer(p, weights_dir=str(tmp_path), model_name="a",
                 device="cpu", seed=5)
    hand = Trainer(p, weights_dir=str(tmp_path), model_name="b",
                   device="cpu", seed=5)
    try:
        tr.train()
        agg = {}
        for bi, batch in enumerate(hand.train_loader):
            stats = hand.train_step(to_device(batch, "cpu"),
                                    step_seed(5, 1, bi))
            for k, v in stats.items():
                agg.setdefault(k, []).append(float(v))
    finally:
        tr.close()
        hand.close()
    want = {k: float(np.mean(v)) for k, v in agg.items()}
    got = _log(tr)[0]
    assert set(want) <= set(got)
    for k, v in want.items():
        assert got[k] == v, k
    for x, y in zip(tr.model.parameters(), hand.model.parameters()):
        assert torch.equal(x, y)
    assert param_count(tr.model) == sum(
        p.numel() for p in hand.model.parameters())


def _batch(B, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-0.8, 0.8, (B // 2, P, 3)).astype(np.float32)
    pts = np.repeat(base, 2, 0) + rng.normal(0, 0.01, (B, P, 3)).astype(
        np.float32)
    g = np.repeat(np.arange(B // 2), 2)
    return {"points": torch.from_numpy(pts),
            "pmask": torch.ones(B, P, dtype=torch.bool),
            "positives_mask": torch.from_numpy(
                (g[:, None] == g[None]) & ~np.eye(B, dtype=bool)),
            "negatives_mask": torch.from_numpy(g[:, None] != g[None])}


def test_grad_checkpoint_equal_loss_and_gradients():
    batch = _batch(8)
    out = {}
    for gc in (False, True):
        cfg = tcfg.tiny_test_config(drop_path=0.5, num_points=P,
                                    grad_checkpoint=gc)
        m = HOTFormerLoc(cfg, device="cpu")
        calls = []
        for mod in m.modules():
            if isinstance(mod, (OctFormerBlock, HOTFormerIteration)):
                mod.register_forward_pre_hook(
                    lambda *a: calls.append(torch.is_grad_enabled()))
        opt = make_optimizer(m.parameters(), "adam",
                             lr_schedule(1e-3, 1, 10, scheduler="constant"))
        step = make_train_step(
            m, opt, make_loss("truncatedsmoothap", positives_per_query=1),
            StepConfig(accum_steps=2, check_recompute=True))
        stats = step(batch, 7)
        out[gc] = (stats, {n: q.grad.clone()
                           for n, q in m.named_parameters()}, calls)
    (s0, g0, c0), (s1, g1, c1) = out[False], out[True]
    assert float(s0["loss"]) == float(s1["loss"])
    assert float(s1["recompute_max_abs"]) == 0.0
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    # 4 blocks (2 OctFormer blocks, 2 iterations) x 2 microbatches: stage
    # 1 without grad, stage 3 with; checkpointing runs stage 3 again
    assert c0.count(False) == c1.count(False) == 8
    assert c0.count(True) == 8 and c1.count(True) == 16


QKV_MODES = ("trunc_normal,0.05", "xavier_uniform", "xavier_normal",
             "kaiming_uniform", "kaiming_normal")


def _want_std(mode, fan_in, fan_out):
    return {"trunc_normal,0.05": 0.05 * 0.8796,      # std of the samples
            "xavier_uniform": math.sqrt(4.0 / (fan_in + fan_out)),
            "xavier_normal": math.sqrt(4.0 / (fan_in + fan_out)),
            "kaiming_uniform": math.sqrt(2.0 / fan_in),
            "kaiming_normal": math.sqrt(2.0 / fan_in)}[mode]


WIDE = dict(channels=(64, 128), num_heads=(4, 8))     # more samples


@pytest.fixture(scope="module")
def jax_params():
    """Initial parameters of the JAX model at WIDE (init jitted: op by op
    it takes most of a minute on the CPU)."""
    cfg = jcfg.tiny_test_config(use_pallas_attn=False, use_band_conv=False,
                                **WIDE)
    pts = jnp.zeros((1, cfg.num_points, 3), jnp.float32)
    return jax.jit(JModel(cfg).init)(
        jax.random.PRNGKey(0), pts,
        jnp.ones((1, cfg.num_points), bool))["params"]


@pytest.fixture(scope="module")
def jax_qkv_kernels(jax_params):
    """The JAX model's qkv kernels, re-initialised per mode."""
    params = jax_params
    out = {}
    for mode in QKV_MODES:
        new = jstep.apply_qkv_init(params, jax.random.PRNGKey(1), mode)
        flat = jax.tree_util.tree_flatten_with_path(new)[0]
        out[mode] = {tuple(str(getattr(k, "key", k)) for k in path):
                     np.asarray(leaf) for path, leaf in flat
                     if any("qkv" in str(getattr(k, "key", k))
                            for k in path)
                     and str(getattr(path[-1], "key", "")) == "kernel"}
    return out


@pytest.mark.parametrize("mode", QKV_MODES)
def test_apply_qkv_init(mode, jax_qkv_kernels):
    cfg = tcfg.tiny_test_config(**WIDE)
    m = HOTFormerLoc(cfg, device="cpu")
    before = {n: q.detach().clone() for n, q in m.named_parameters()}
    apply_qkv_init(m, torch.Generator().manual_seed(0), mode)
    qkv = [n for n in before if "qkv" in n and n.endswith(".weight")]
    assert len(qkv) == 2 + 2 * 3          # OctFormer blocks, RTSA + H-OSA
    # flax kernels: (fan_in, fan_out), stacked (iters, fan_in, fan_out)
    # for the scanned HOTFormer iterations. There the JAX initialiser
    # reads the stack axis as a receptive field, so its fans are iters x
    # the layer's; the port (and torch.nn.init per Linear) use the
    # layer's own fans. So JAX is the yardstick for the 2-D kernels.
    jk = jax_qkv_kernels[mode].values()
    jstd = {k.shape[-2]: float(k.std()) for k in jk if k.ndim == 2}
    for k in jk:
        if k.ndim == 3 and not mode.startswith("trunc"):
            iters, fi, fo = k.shape
            assert abs(float(k.std()) / _want_std(mode, iters * fi,
                                                  iters * fo) - 1) < 0.1
    for n, q in m.named_parameters():
        q = q.detach()
        if n not in qkv:
            assert torch.equal(q, before[n]), n
            continue
        fan_out, fan_in = q.shape
        assert fan_out == 3 * fan_in
        want = _want_std(mode, fan_in, fan_out)
        std = float(q.std())
        assert abs(std / want - 1) < 0.1, (n, std, want)
        if "octf_stage" in n:
            assert abs(std / jstd[fan_in] - 1) < 0.1, (n, std, jstd[fan_in])
        if mode.endswith("uniform"):
            assert float(q.abs().max()) <= want * math.sqrt(3) + 1e-7
        if mode.startswith("trunc"):
            assert float(q.abs().max()) <= 2 * 0.05 + 1e-7


def test_initial_weights_match_jax_distributions(jax_params):
    """Each parameter of the port's initial weights has the std of the
    JAX package's initial parameter of the same name (within 10%, for
    tensors of 1000 elements or more; the constants exactly)."""
    m = HOTFormerLoc(tcfg.tiny_test_config(**WIDE), device="cpu")
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params),
                           m)
    checked = 0
    for n, q in m.state_dict().items():
        w = want[n]
        if float(w.std()) == 0.0 or w.numel() == 1:
            assert torch.equal(q, w), n
        elif w.numel() >= 1000:
            assert abs(float(q.std()) / float(w.std()) - 1) < 0.1, n
            checked += 1
    assert checked > 20


def test_qkv_init_default_and_invalid():
    m = HOTFormerLoc(tcfg.tiny_test_config(), device="cpu")
    before = [q.detach().clone() for q in m.parameters()]
    apply_qkv_init(m, torch.Generator().manual_seed(0), "torch_default")
    assert all(torch.equal(a, b) for a, b in zip(before, m.parameters()))
    with pytest.raises(ValueError):
        apply_qkv_init(m, torch.Generator(), "orthogonal")


def test_preemption_requeue(tiny_env, tmp_path):
    tr = Trainer(_params(tiny_env), weights_dir=str(tmp_path),
                 model_name="p", device="cpu", seed=1, dtype=torch.bfloat16)
    tr.close()
    assert tr.model.dtype == torch.bfloat16
    old = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGUSR1)}
    try:
        elastic.install_preemption_handler(tr)
        elastic.maybe_requeue_exit(tr, 1)           # no signal: no-op
        assert not tr.preempted
        elastic.inject_fault(sig=signal.SIGUSR1)
        assert tr.preempted
        with pytest.raises(SystemExit) as e:
            elastic.maybe_requeue_exit(tr, 4)
        assert e.value.code == elastic.REQUEUE_EXIT_CODE
    finally:
        for s, h in old.items():
            signal.signal(s, h)
    back = Trainer(_params(tiny_env), weights_dir=str(tmp_path / "b"),
                   model_name="p", device="cpu", seed=2)
    back.close()
    back.resume(tr.ckpt_path("latest"))
    assert back.start_epoch == 5
    _same_state(tr, back)
    # a child that asks to be requeued once, then runs to its end
    cmd = [sys.executable, "-c",
           "import sys; sys.exit(0 if '--resume_from' in sys.argv "
           f"else {elastic.REQUEUE_EXIT_CODE})"]
    assert elastic.run_elastic(cmd, max_requeues=2, ckpt_path="x") == 0
    assert elastic.run_elastic(cmd, max_requeues=0, ckpt_path="x") == \
        elastic.REQUEUE_EXIT_CODE


def test_cli_runs_the_parsers_default_norm_and_head(tiny_env, tmp_path):
    """A model config without conv_norm and pooling gets the parsers'
    defaults, batchnorm and OctGeM (the reference's ModelParams), and
    runs through the train and evaluate CLIs; the checkpoint carries the
    running statistics the steps moved."""
    from hotformerloc_torch.evaluation import pnv_evaluate
    from hotformerloc_torch.training import train as train_cli
    train_cfg, model_cfg = tiny_env
    text = "".join(ln for ln in open(model_cfg).read().splitlines(True)
                   if not ln.startswith(("conv_norm", "pooling")))
    model_cfg = tmp_path / "model.txt"
    model_cfg.write_text(text)
    common = ["--config", train_cfg, "--model_config", str(model_cfg),
              "--num_points", str(P), "--device", "cpu"]
    trainer = train_cli.main(common + ["--weights_dir", str(tmp_path / "w"),
                                       "--model_name", "t"])
    cfg = trainer.model.cfg
    assert (cfg.conv_norm, cfg.pooling) == ("batchnorm", "OctGeM")
    log = _log(trainer)
    assert all(np.isfinite(r["loss"]) for r in log if r["phase"] == "train")
    final = trainer.ckpt_path("final")
    trainer.close()
    state = torch.load(final, map_location="cpu", weights_only=False)
    state = state.get("model", state)
    means = [v for k, v in state.items() if k.endswith("norm.mean")]
    assert means and all(bool(v.abs().sum() > 0) for v in means)
    cwd = os.getcwd()
    os.chdir(tmp_path)                 # the evaluator writes its results
    try:
        stats = pnv_evaluate.main(common + ["--weights", final])
    finally:
        os.chdir(cwd)
    assert np.isfinite(float(stats["average"]["ave_recall"][0]))
