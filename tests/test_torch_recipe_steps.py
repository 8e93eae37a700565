"""Ten steps of the shipped training recipe, port against JAX, on the CPU.

The recipe is ``bench.py``'s: ``make_optimizer("adam", lr_schedule(...),
weight_decay=1e-4)`` (torch Adam's L2 decay, added to the gradient
before the moments, as the JAX optimiser chains ``add_decayed_weights``
before ``scale_by_adam``) driving ``make_train_step(...,
StepConfig(accum_steps=4))`` on ``truncatedsmoothap``. The schedule is
shrunk so that ten steps cross the warm-up (epochs 0 and 1) and a
milestone (epoch 4): learning rates 5e-7, 5e-7, 2.5e-4, 2.5e-4, then
5e-4 for four steps, then 5e-5.

Both packages start from the same random weights (``params_from_jax``)
on ``tiny_test_config`` at fp32 with DropPath 0 (their random streams
differ), and see the same numpy batch at every step (a fresh batch a
step, 4 microbatches of 2 pairs). JAX runs its XLA routes
(use_pallas_attn and use_band_conv off) once, in a module fixture; the
port runs without checkpointing and under 'save_hot', the shipped
remat_policy. Held:

* the loss at every step within rtol 2e-5;
* the parameters after step 10: at most 0.1% of the entries off by more
  than rtol 1e-4 / atol 1e-7, and per tensor |dp| within 1e-4 |p_jax|
  (norms). Adam divides each gradient entry by the root of its running
  square, so an entry whose gradient is fp32 noise takes an update of
  the full learning rate in either sign: such an entry may differ by up
  to 2 lr a step with everything else in agreement, so the fraction of
  entries, not the largest difference, is the measure (as
  tests/test_torch_step.py does for the multistage step). Measured on
  the CPU: losses within 4e-6, 0.0034% of the entries off, the worst
  tensor 1.2e-5 of its norm, alike without checkpointing and under
  'save_hot';
* the bar can fail: the port's run with one deliberate fault (the
  schedule read one step late; the weight decay applied decoupled, as
  AdamW does) must break it. Measured: the late schedule puts 98% of the
  entries off and the losses 1.5% apart from step 3; the decoupled decay
  25% of the entries, a tensor 1.8% of its norm.
"""
import torch_threads  # noqa: F401  (first: one torch thread per worker)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hotformerloc_tpu.losses import losses as jl
from hotformerloc_tpu.models import config as jcfg
from hotformerloc_tpu.models.hotformerloc import HOTFormerLoc as JModel
from hotformerloc_tpu.training import optim as jopt
from hotformerloc_tpu.training.step import StepConfig as JStepConfig
from hotformerloc_tpu.training.step import TrainState
from hotformerloc_tpu.training.step import make_train_step as jmake_step
from hotformerloc_torch.convert import params_from_jax
from hotformerloc_torch.losses import losses as tl
from hotformerloc_torch.models import config as tcfg
from hotformerloc_torch.models.hotformerloc import HOTFormerLoc as TModel
from hotformerloc_torch.training import optim as topt
from hotformerloc_torch.training.step import StepConfig, make_train_step
from test_torch_ablations import jax_variables
from test_torch_train import synthetic_batch

STEPS = 10
B, POINTS, ACCUM = 8, 128, 4
# bench.py's schedule at 2 steps an epoch over 10 epochs: warm-up over
# epochs 0-1, the milestone 2 epochs after it (epoch 4, step 8)
SCHEDULE = dict(base_lr=5e-4, steps_per_epoch=2, epochs=10,
                warmup_epochs=2, milestones=[2])
WEIGHT_DECAY = 1e-4
LOSS_RTOL = 2e-5
PARAM_RTOL, PARAM_ATOL, PARAM_MISMATCH = 1e-4, 1e-7, 1e-3
PARAM_NORM_RTOL = 1e-4


def _batches():
    return [synthetic_batch(np.random.default_rng(100 + i), B, POINTS)
            for i in range(STEPS)]


@pytest.fixture(scope="module")
def jax_run():
    """JAX's ten steps: (start params, start batch_stats, loss per step,
    params after the last step), as numpy trees."""
    cj = jcfg.tiny_test_config(use_pallas_attn=False, use_band_conv=False,
                               num_points=POINTS, drop_path=0.0)
    jm = JModel(cj)
    batches = _batches()
    b0 = {k: jnp.asarray(a) for k, a in batches[0].items()}
    v = jax_variables(jm, b0["points"][:1], b0["pmask"][:1], None, seed=3)
    params0 = jax.tree_util.tree_map(np.asarray, v["params"])
    stats0 = jax.tree_util.tree_map(np.asarray, v.get("batch_stats", {}))
    tx = jopt.make_optimizer("adam", jopt.lr_schedule(**SCHEDULE),
                             weight_decay=WEIGHT_DECAY)
    st = TrainState(step=jnp.zeros((), jnp.int32),
                    params=jax.tree_util.tree_map(jnp.asarray, params0),
                    opt_state=tx.init(v["params"]),
                    model_state={"batch_stats": v["batch_stats"]}
                    if "batch_stats" in v else {})
    step = jmake_step(jm, tx, jl.make_loss("truncatedsmoothap",
                                           positives_per_query=4),
                      JStepConfig(accum_steps=ACCUM))
    losses = []
    for i, b in enumerate(batches):
        st, stats = step(st, {k: jnp.asarray(a) for k, a in b.items()},
                         jax.random.PRNGKey(i))
        losses.append(float(stats["loss"]))
    return (params0, stats0 or None, np.array(losses),
            jax.tree_util.tree_map(np.asarray, st.params))


def _torch_run(jrun, remat="off", fault=None):
    """The port's ten steps from JAX's start: (model, loss per step).
    ``fault``: None, "schedule_late" (the step reads schedule(step + 1))
    or "decoupled_decay" (AdamW's decay in place of Adam's L2)."""
    params0, stats0, _, _ = jrun
    cfg = tcfg.tiny_test_config(num_points=POINTS, drop_path=0.0)
    if remat != "off":
        cfg = dataclasses.replace(cfg, grad_checkpoint=True,
                                  remat_policy=remat)
    m = TModel(cfg, device="cpu")
    m.load_state_dict(params_from_jax(params0, m, stats0))
    sched = topt.lr_schedule(**SCHEDULE)
    opt = topt.make_optimizer(
        m.parameters(), "adamw" if fault == "decoupled_decay" else "adam",
        sched, weight_decay=WEIGHT_DECAY)
    if fault == "schedule_late":
        opt.schedule = lambda s: sched(s + 1)
    step = make_train_step(m, opt, tl.make_loss("truncatedsmoothap",
                                                positives_per_query=4),
                           StepConfig(accum_steps=ACCUM))
    losses = []
    for i, b in enumerate(_batches()):
        stats = step({k: torch.from_numpy(a) for k, a in b.items()}, i)
        losses.append(float(stats["loss"]))
    return m, np.array(losses)


def _misses(jrun, m, losses):
    """What of the bar the port's run misses: a list of reasons (empty:
    it holds), with the measured numbers."""
    _, _, jlosses, jparams = jrun
    want = params_from_jax(jparams, m)
    out = []
    lrel = np.abs(losses - jlosses) / np.abs(jlosses)
    if not lrel.max() <= LOSS_RTOL:
        out.append(f"loss rel diff per step {np.round(lrel, 7).tolist()}")
    total = mismatched = 0
    for name, p in m.named_parameters():
        a, b = p.detach().numpy(), want[name].numpy()
        mismatched += int((~np.isclose(a, b, rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL)).sum())
        total += a.size
        d, lim = np.linalg.norm(a - b), PARAM_NORM_RTOL * np.linalg.norm(b)
        if not d <= lim:
            out.append(f"{name}: |dp| {d:.3g} > {lim:.3g}")
    if not mismatched <= PARAM_MISMATCH * total:
        out.append(f"{mismatched}/{total} parameter entries mismatched")
    return out


def test_schedule_crosses_warmup_and_milestone():
    lrs = [topt.lr_schedule(**SCHEDULE)(s) for s in range(STEPS)]
    np.testing.assert_allclose(lrs, [5e-7] * 2 + [2.5e-4] * 2 + [5e-4] * 4
                               + [5e-5] * 2, rtol=1e-12)
    jsched = jopt.lr_schedule(**SCHEDULE)
    np.testing.assert_allclose([float(jsched(s)) for s in range(STEPS)],
                               lrs, rtol=1e-6)


@pytest.mark.parametrize("remat", ["off", "save_hot"])
def test_recipe_steps_match_jax(jax_run, remat):
    m, losses = _torch_run(jax_run, remat)
    assert np.isfinite(losses).all()
    misses = _misses(jax_run, m, losses)
    assert not misses, misses[:6]


@pytest.mark.parametrize("fault", ["schedule_late", "decoupled_decay"])
def test_recipe_bar_catches_a_faulted_step(jax_run, fault):
    m, losses = _torch_run(jax_run, fault=fault)
    assert _misses(jax_run, m, losses), f"{fault} passed the bar"
