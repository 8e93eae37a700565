"""PowerNorm's row-order spread, port against JAX, on the CPU.

``chip_smoke.py``'s dp phase found the fp32 step of the PowerNorm model
at Oxford width 1.94 (rows reversed) and 4.17 (rows rolled) times
``GRAD_TOL`` away from the same step on the rows as loaded, and widened
its two-rank bar to twice that spread (``SPREAD_FACTOR``). Both orders
are the same step in exact arithmetic, so the spread is rounding; this
file asks whether JAX's step spreads as far on the same inputs, or
whether the port's backward (``models/layers.py`` ``PowerCoreFn``) adds
to it.

The batch is the first of ``tools/multihost_smoke``'s synthetic PNV
dataset, as its loader gives it (``load_batch``) and reordered by its
``reorder_micro`` within each microbatch ("reverse", "roll"); JAX gets
the same numpy arrays. Both packages start from the same random weights
(``params_from_jax``; PowerNorm in its warm-up with ``ema_gz`` 0, as
training keeps it), fp32, DropPath 0. The port's step is the tool's own
``run`` (the dp phase's), started from those weights; JAX's is
``make_train_step`` with an optimiser that keeps the step's gradients
as its state and moves nothing (``grads_kept``). Held, per row order:

* the port's step gradients against JAX's on the same order, each
  tensor within 1e-3 |g_jax| + 1e-8 (norms; the bar of ``jax.grad`` in
  tests/test_torch_train.py);
* the port's spread (``chip_smoke._grad_worst`` of the reordered step's
  gradients against the loaded order's, in units of ``GRAD_TOL``) at
  most max(1, 2 x JAX's spread on the same inputs).

``tiny_test_config`` runs in the tier-1 suite (batch 16 as 4
microbatches of 4). The same check at Oxford width (``oxford_config``
with the dp phase's flags, batch 8 as 2 microbatches of 4, depth cut to
2 OctFormer blocks and 2 HOTFormer iterations) is marked slow:
``python -m pytest tests/test_torch_powernorm_order.py -m slow -s``.
"""
import torch_threads  # noqa: F401  (first: one torch thread per worker)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from hotformerloc_tpu.losses import losses as jl
from hotformerloc_tpu.models import config as jcfg
from hotformerloc_tpu.models.hotformerloc import HOTFormerLoc as JModel
from hotformerloc_tpu.training.step import StepConfig as JStepConfig
from hotformerloc_tpu.training.step import TrainState
from hotformerloc_tpu.training.step import make_train_step as jmake_step
from hotformerloc_torch.convert import params_from_jax
from hotformerloc_torch.models.hotformerloc import HOTFormerLoc as TModel
from hotformerloc_torch.tools import multihost_smoke as mh
from test_torch_ablations import jax_variables

ORDERS = (None, *mh.REORDERS)          # as loaded, then reordered
JAX_GRAD_TOL = (1e-3, 1e-8)            # |dg| <= a |g_jax| + b, per tensor
SPREAD_FACTOR = 2.0
# config -> (global batch, microbatches, depth cut). Oxford keeps its
# widths, octree depth 9 and 4096 points (the stem, whose PowerNorm
# tensors spread most in the dp phase); 2 OctFormer blocks and 2 HOTFormer
# iterations keep the CPU run near 13 GB (12 minutes)
CASES = {"tiny": (16, 4, {}), "oxford": (8, 2, {"num_blocks": (2, 2)})}


def grads_kept():
    """An optax transformation whose updates are zero and whose state is
    the last gradients it was given: the step's gradients, read back from
    ``TrainState.opt_state``."""
    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, grads), grads
    return optax.GradientTransformation(init, update)


def _args(config, batch, accum, data, out, reorder=None, weights=None):
    argv = ["--data", data, "--config", config, "--batch", str(batch),
            "--accum", str(accum), "--conv_norm", "powernorm",
            "--drop_path", "0", "--dtype", "float32", "--device", "cpu",
            "--out", out]
    argv += ["--reorder", reorder] if reorder else []
    argv += ["--weights", weights] if weights else []
    return mh.parse_args(argv)


def spreads(config, tmp, monkeypatch):
    """Both packages' step gradients on every row order of ORDERS, by
    the port's parameter names, with the parameters ``_grad_worst``
    treats as 0 in exact arithmetic: ({order: port grads}, {order: JAX
    grads}, zero)."""
    batch, accum, cut = CASES[config]
    tool_config = mh.config_of
    monkeypatch.setattr(mh, "config_of", lambda a: dataclasses.replace(
        tool_config(a), **cut))
    data, out = str(tmp / "data"), str(tmp / "out")
    mh.make_synthetic_dataset(data, n=2 * batch, points=mh.POINTS[config])
    cfg = mh.config_of(_args(config, batch, accum, data, out))
    host = mh.load_batch(data, cfg.num_points, batch, accum=accum)
    over = dict(drop_path=0.0, conv_norm="powernorm",
                num_points=cfg.num_points, use_pallas_attn=False,
                use_band_conv=False, **cut)
    cj = (jcfg.tiny_test_config(**over) if config == "tiny"
          else jcfg.oxford_config(grad_checkpoint=False, **over))
    jm = JModel(cj)
    pts = jnp.asarray(host["points"][:1])
    v = jax_variables(jm, pts, jnp.asarray(host["pmask"][:1]), None, seed=5)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (np.zeros_like(a)
                         if str(getattr(path[-1], "key", "")) == "ema_gz"
                         else np.asarray(a)), v["batch_stats"])
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    model = TModel(cfg, device="cpu")
    wpath = str(tmp / "weights.pt")
    torch.save(params_from_jax(params, model, stats), wpath)
    zero = chip_smoke.bn_shift_params(model)

    tx = grads_kept()
    step = jmake_step(jm, tx, jl.make_loss("truncatedsmoothap",
                                           positives_per_query=1),
                      JStepConfig(accum_steps=accum))
    port, jax_ = {}, {}
    for how in ORDERS:
        h = mh.reorder_micro(host, accum, how) if how else host
        st = TrainState(step=jnp.zeros((), jnp.int32),
                        params=jax.tree_util.tree_map(jnp.asarray, params),
                        opt_state=tx.init(v["params"]),
                        model_state={"batch_stats": jax.tree_util.tree_map(
                            jnp.asarray, stats)})
        st, _ = step(st, {k: jnp.asarray(h[k]) for k in (
            "points", "pmask", "positives_mask", "negatives_mask")},
            jax.random.PRNGKey(1))
        jax_[how] = params_from_jax(
            jax.tree_util.tree_map(np.asarray, st.opt_state), model)
        _, ten = mh.run(_args(config, batch, accum, data, out, how, wpath),
                        None, "cpu")
        port[how] = ten["grads"]
    return port, jax_, zero


def check(port, jax_, zero):
    """The file's two bars; returns {order: (port's spread, JAX's
    spread, the port's three worst tensors)}, spreads in units of
    GRAD_TOL."""
    for how in ORDERS:
        bad = []
        for name, g in jax_[how].items():
            d = float((port[how][name] - g).norm())
            lim = JAX_GRAD_TOL[0] * float(g.norm()) + JAX_GRAD_TOL[1]
            if not d <= lim:
                bad.append((name, d, lim))
        assert not bad, (how, bad[:5])
    out = {}
    for how in mh.REORDERS:
        sp, fin, top = chip_smoke._grad_worst(port[how], port[None], zero)
        sj = chip_smoke._grad_worst(jax_[how], jax_[None], zero)[0]
        assert fin
        out[how] = (sp, sj, top)
        assert sp <= max(1.0, SPREAD_FACTOR * sj), (how, sp, sj, top)
    return out


def test_powernorm_step_and_row_order_spread_tiny(tmp_path, monkeypatch):
    check(*spreads("tiny", tmp_path, monkeypatch))


@pytest.mark.slow
def test_powernorm_step_and_row_order_spread_oxford(tmp_path, monkeypatch):
    out = check(*spreads("oxford", tmp_path, monkeypatch))
    print("spread in GRAD_TOL units {order: (port, JAX, port's worst)}:",
          out)
