"""The train step of hotformerloc_torch on the CPU (moved whole out of
tests/test_torch_train.py, which holds the losses, optimisers and model
gradients against JAX):

* the multistage step (accum 4) against the single pass, to the bar of
  tests/test_train_step.py;
* the step's stats keys against the JAX step's;
* DropPath: per-sample masks scaled by 1/keep, rates in block order,
  equal stage-1 / stage-3 embeddings, and a loss that falls over 8
  steps; EMA + MESA and the eval step run.
"""
import torch_threads  # noqa: F401  (first: one torch thread per worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hotformerloc_tpu.losses import losses as jl
from hotformerloc_torch.losses import losses as tl
from hotformerloc_torch.models import config as tcfg
from hotformerloc_torch.models.hotformerloc import HOTFormerLoc as TModel
from hotformerloc_torch.models.layers import DropPath
from hotformerloc_torch.training import optim as topt
from hotformerloc_torch.training.step import (StepConfig, make_eval_step,
                                              make_train_step)
from test_torch_train import _loss_inputs, synthetic_batch, torch_batch


# -- the train step -----------------------------------------------------------


def _setup(drop_path, accum, seed=0, mesa=0.0, use_ema=False, B=8):
    cfg = tcfg.tiny_test_config(drop_path=drop_path, num_points=256)
    model = TModel(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(seed))
    opt = topt.make_optimizer(model.parameters(), "adam",
                              topt.lr_schedule(1e-3, 1, 100,
                                               scheduler="constant"),
                              weight_decay=1e-4)
    step = make_train_step(model, opt, tl.make_loss(
        "truncatedsmoothap", positives_per_query=1),
        StepConfig(accum_steps=accum, mesa=mesa, use_ema=use_ema,
                   ema_decay=0.5, check_recompute=accum > 1))
    batch = torch_batch(synthetic_batch(np.random.default_rng(0), B, 256))
    return model, step, batch


def test_multistage_matches_single_pass():
    """accum 4 against 1 at drop_path 0 (tests/test_train_step.py:74-95
    bar): loss rtol 1e-4; params after one step within rtol 5e-3 /
    atol 1e-5 with < 0.5% mismatched."""
    m1, s1, batch = _setup(0.0, 1)
    m4, s4, _ = _setup(0.0, 4)
    st1, st4 = s1(batch, 7), s4(batch, 7)
    np.testing.assert_allclose(float(st1["loss"]), float(st4["loss"]),
                               rtol=1e-4)
    assert set(st4) - {"recompute_max_abs"} == set(st1)
    total = mismatched = 0
    for a, b in zip(m1.parameters(), m4.parameters()):
        a, b = a.detach().numpy(), b.detach().numpy()
        mismatched += (~np.isclose(a, b, rtol=5e-3, atol=1e-5)).sum()
        total += a.size
        assert np.abs(a - b).max() < 5e-3
    assert mismatched / total < 0.005, f"{mismatched}/{total}"


def test_stats_keys_match_jax_step():
    e, pos, neg = _loss_inputs(1)
    _, jstats = jl.truncated_smoothap(jnp.asarray(e), jnp.asarray(pos),
                                      jnp.asarray(neg))
    for accum in (1, 4):
        _, step, batch = _setup(0.0, accum)
        stats = step(batch, 0)
        want = set(jstats) | {"octree_overflow", "grad_norm"}
        assert set(stats) - {"recompute_max_abs"} == want
        assert "band_overflow" not in stats
        assert all(torch.isfinite(v.float()).all() for v in stats.values())


def test_drop_path_masks_and_rates():
    cfg = tcfg.tiny_test_config(drop_path=0.5)
    model = TModel(cfg, device="cpu")
    sites = model.drop_path_sites()
    rates = cfg.drop_path_rates()
    nb0 = cfg.num_blocks[0]
    levels = cfg.num_pyramid_levels
    want = [r for r in rates[:nb0] for _ in range(2)]
    want += [r for r in rates[nb0:] for _ in range(2 * (1 + levels))]
    assert [s.rate for s in sites] == pytest.approx(want)
    masks = model.draw_drop_masks(4000, torch.Generator().manual_seed(0))
    for s, m in zip(sites, masks):
        keep = 1.0 - s.rate
        vals = np.unique(m.numpy())
        assert np.allclose(vals, 1.0) or np.allclose(vals, [0.0, 1.0 / keep])
        assert float((m > 0).float().mean()) == pytest.approx(keep, abs=0.03)
    dp = DropPath(0.5)
    x = torch.ones(3, 2, 5, 4)
    dp.mask = torch.tensor([0.0, 2.0, 2.0])
    y = dp(x)
    assert torch.equal(y[0], torch.zeros(2, 5, 4))
    assert torch.equal(y[1:], 2 * torch.ones(2, 2, 5, 4))
    dp.mask = None
    assert dp(x) is x


def test_drop_path_stages_agree_and_loss_falls():
    """drop_path 0.5: stage 3 recomputes exactly stage 1's embeddings
    (same masks from (seed, microbatch)), and 8 steps on one batch lower
    the loss; in eval mode the masks are off."""
    model, step, batch = _setup(0.5, 4)
    losses = []
    for i in range(8):
        stats = step(batch, i)
        assert float(stats["recompute_max_abs"]) == 0.0
        losses.append(float(stats["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    model.train()
    masks = model.draw_drop_masks(8, torch.Generator().manual_seed(1))
    a = model(batch["points"], batch["pmask"], drop_masks=masks)["global"]
    b = model(batch["points"], batch["pmask"], drop_masks=masks)["global"]
    assert torch.equal(a, b)
    model.eval()
    c = model(batch["points"], batch["pmask"], drop_masks=masks)["global"]
    assert not torch.allclose(a, c)


def test_ema_mesa_and_eval_step():
    model, step, batch = _setup(0.0, 4, mesa=0.1, use_ema=True)
    e0 = [p.clone() for p in step.state.ema_model.parameters()]
    stats = step(batch, 0)
    assert np.isfinite(float(stats["loss"]))
    e1 = list(step.state.ema_model.parameters())
    assert any(not torch.equal(a, b) for a, b in zip(e0, e1))
    assert step.state.step == 1
    ev = make_eval_step(model, tl.make_loss("truncatedsmoothap",
                                            positives_per_query=1))(batch)
    assert np.isfinite(float(ev["loss"])) and not model.training
