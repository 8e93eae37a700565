"""Batch statistics under data parallelism (hotformerloc_torch), on the
CPU over gloo: the models with running statistics, one multistage step
of a global batch of 8 as 2 microbatches of 4.

For conv_norm 'batchnorm' with the PyramidOctGeMgc head (MaskedBatchNorm
after every conv, flax's BatchNorm in the head) and for 'powernorm'
(PowerNorm past its warm-up start, iteration 5), from JAX's random
variables (params_from_jax with batch_stats):

* two gloo ranks under torchrun, each holding 2 rows of each global
  microbatch (``dist.local_rows``, JAX's layout), against one process
  with the same accum_steps: every gradient |dg| <= 1e-4 |g| + 1e-7
  (chip_smoke.py's GRAD_TOL; tensor norms; a parameter that only shifts
  a MaskedBatchNorm's input has gradient 0 in exact arithmetic, so its
  values on both sides, rounding, must be within ZERO_GRAD_TOL of the
  whole gradient's norm, as in tests/test_torch_ablations.py), both ranks' running statistics within 1e-6
  of the process's, the ranks' bitwise equal to each other;
  With the PyramidOctGeMgc head this comparison runs its BatchNorm in
  the two-pass form (``BatchNorm.two_pass``, as chip_smoke.py does for
  kernel against plain): flax's E[x^2] - E[x]^2 amplifies the fp32
  order noise of the rank sums, and broke GRAD_TOL by up to 6.6 times
  here (gem0.p) with it;
* the ranks in flax's form against the JAX single-device multistage step on the same
  global batch (JAX's batch statistics are global over a mesh-sharded
  microbatch, so one device is the reference): gradients within
  1e-3 |g_jax| + 1e-8, running statistics within 1e-6. DropPath and
  dropout are off, so JAX's step draws nothing (it is deterministic);
  its gradients are read off an SGD step of rate 1e4, g = (p0 - p1) /
  1e4.

JAX's step is compiled once per norm. Helpers and the batch come from
tests/test_torch_norms.py.
"""
import torch_threads  # noqa: F401  (first: one torch thread per worker)

import importlib.util
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hotformerloc_tpu.losses import losses as jl
from hotformerloc_tpu.models import config as jcfg
from hotformerloc_tpu.models.hotformerloc import HOTFormerLoc as JModel
from hotformerloc_tpu.training.step import StepConfig as JStepConfig
from hotformerloc_tpu.training.step import TrainState
from hotformerloc_tpu.training.step import make_train_step as jmake_step
from hotformerloc_torch.convert import params_from_jax
from hotformerloc_torch.models import config as tcfg
from hotformerloc_torch.models.layers import BatchNorm
from hotformerloc_torch.models.hotformerloc import HOTFormerLoc as TModel
from hotformerloc_torch.parallel import dist
from chip_smoke import GRAD_TOL, ZERO_GRAD_TOL, bn_shift_params
from test_torch_ablations import jax_variables
from test_torch_dist import _env
from test_torch_norms import _np, _pair_batch

P = 128
B = 8
ACCUM = 2
LR = 1e4
VARIANTS = {"batchnorm": dict(conv_norm="batchnorm",
                              pooling="PyramidOctGeMgc"),
            "powernorm": dict(conv_norm="powernorm")}

# one train step of this rank's rows; argv: variant, weights, batch, out,
# accum_steps, two_pass (1: the heads' BatchNorm in its two-pass form)
WORKER = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from hotformerloc_torch.losses.losses import make_loss
from hotformerloc_torch.models.config import tiny_test_config
from hotformerloc_torch.models.hotformerloc import HOTFormerLoc
from hotformerloc_torch.parallel import dist
from hotformerloc_torch.training.step import StepConfig, make_train_step

VARIANTS = {"batchnorm": dict(conv_norm="batchnorm",
                              pooling="PyramidOctGeMgc"),
            "powernorm": dict(conv_norm="powernorm")}


def run(variant, weights, batch, out, accum, group, two_pass):
    from hotformerloc_torch.models.layers import BatchNorm
    cfg = tiny_test_config(num_points=%d, drop_path=0.0,
                           **VARIANTS[variant])
    m = HOTFormerLoc(cfg, device="cpu")
    for mod in m.modules():
        if isinstance(mod, BatchNorm):
            mod.two_pass = two_pass
    m.load_state_dict(torch.load(weights, weights_only=True))
    opt = torch.optim.SGD(m.parameters(), lr=0.0)
    opt.schedule = lambda step: 0.0
    step = make_train_step(m, opt, make_loss(
        "truncatedsmoothap", positives_per_query=1),
        StepConfig(accum_steps=accum), group)
    x = np.load(batch)
    rows = dist.local_rows(len(x["points"]), accum, dist.rank(group),
                           dist.world(group))
    step({k: torch.from_numpy(x[k][rows]) for k in x.files}, 0)
    torch.save({"grads": {n: p.grad for n, p in m.named_parameters()},
                "buffers": dict(m.named_buffers())},
               f"{out}/rank{dist.rank(group)}.pt")


if __name__ == "__main__":
    group, _ = dist.init_from_env("cpu")
    try:
        run(*sys.argv[1:5], int(sys.argv[5]), group, sys.argv[6] == "1")
    finally:
        dist.close(group)
""" % P


def _jax_step(over, batch):
    """JAX's multistage step (accum 2, SGD at LR) from jax_variables:
    (params, batch_stats) before, the gradients and batch_stats after."""
    cj = jcfg.tiny_test_config(use_pallas_attn=False, use_band_conv=False,
                               num_points=P, drop_path=0.0, **over)
    jm = JModel(cj)
    b = {k: jnp.asarray(a) for k, a in batch.items()}
    tx = optax.sgd(LR)
    v = jax_variables(jm, b["points"][:1], b["pmask"][:1], None)
    st = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                    opt_state=tx.init(v["params"]),
                    model_state={"batch_stats": v["batch_stats"]})
    p0, s0 = _np(st.params), _np(st.model_state["batch_stats"])
    step = jmake_step(jm, tx, jl.make_loss("truncatedsmoothap",
                                           positives_per_query=1),
                      JStepConfig(accum_steps=ACCUM))
    st, _ = step(st, b, jax.random.PRNGKey(0))
    grads = jax.tree_util.tree_map(lambda a, c: (a - c) / LR, p0,
                                   _np(st.params))
    return p0, s0, grads, _np(st.model_state["batch_stats"])


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def runs(request, tmp_path_factory):
    """(variant, JAX's gradients and statistics by the port's names, the
    two ranks' results in flax's BatchNorm form, the two ranks' and the
    one process's results in the two-pass form, the BN-shift
    parameters). Without a BatchNorm head both forms are one run."""
    variant = request.param
    tmp = tmp_path_factory.mktemp(variant)
    batch = _pair_batch(B=B, P=P)
    np.savez(tmp / "batch.npz", **batch)
    (tmp / "worker.py").write_text(WORKER)
    tm = TModel(tcfg.tiny_test_config(num_points=P, drop_path=0.0,
                                      **VARIANTS[variant]), device="cpu")
    # JAX's variables come first: the ranks start from them
    p0, s0, gj, sj = _jax_step(VARIANTS[variant], batch)
    weights = str(tmp / "weights.pt")
    torch.save(params_from_jax(p0, tm, s0), weights)
    args = [variant, weights, str(tmp / "batch.npz")]
    head = any(isinstance(m, BatchNorm) for m in tm.modules())
    forms = ("flax", "two_pass") if head else ("flax",)

    def two_ranks(form):
        out = tmp / form
        out.mkdir()
        dist.torchrun([str(tmp / "worker.py"), *args, str(out), str(ACCUM),
                       str(int(form == "two_pass"))], 2,
                      str(tmp / f"logs_{form}"), timeout=300, env=_env())
        return [torch.load(out / f"rank{r}.pt", weights_only=True)
                for r in range(2)]

    with ThreadPoolExecutor(len(forms)) as ex:
        jobs = {f: ex.submit(two_ranks, f) for f in forms}
        # one process, here, with the same accum_steps
        spec = importlib.util.spec_from_file_location("dp_worker",
                                                      tmp / "worker.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        (tmp / "one").mkdir()
        mod.run(*args, str(tmp / "one"), ACCUM, None, head)
        ranks = {f: j.result() for f, j in jobs.items()}
    one = torch.load(tmp / "one" / "rank0.pt", weights_only=True)
    want_g = params_from_jax(gj, tm)
    want_s = {k: v for k, v in params_from_jax(p0, tm, sj).items()
              if k in dict(tm.named_buffers())}
    return (variant, want_g, want_s, ranks["flax"], ranks[forms[-1]], one,
            bn_shift_params(tm))


def _bad(got, want, a, b, zero):
    """Tensors breaking |got - want| <= a |want| + b (norms). A parameter
    that only shifts a MaskedBatchNorm's input (``zero``) has gradient 0
    in exact arithmetic and both values are rounding: each must be
    within ZERO_GRAD_TOL of the whole gradient's norm instead."""
    assert set(got) == set(want)
    total = float(torch.sqrt(sum((w ** 2).sum() for w in want.values())))
    bad = []
    for n, w in want.items():
        if n in zero:
            d = max(float(got[n].norm()), float(w.norm()))
            lim = ZERO_GRAD_TOL * total
        else:
            d = float((got[n] - w).norm())
            lim = a * float(w.norm()) + b
        if not d <= lim:
            bad.append((n, d, lim))
    return bad


def test_two_ranks_equal_one_process(runs):
    variant, _, _, _, ranks, one, zero = runs
    for r, got in enumerate(ranks):
        bad = _bad(got["grads"], one["grads"], *GRAD_TOL, zero)
        assert not bad, (variant, r, bad[:5])
        assert set(got["buffers"]) == set(one["buffers"])
        for k, b in one["buffers"].items():
            torch.testing.assert_close(got["buffers"][k], b, rtol=0,
                                       atol=1e-6, msg=k)
            assert torch.equal(got["buffers"][k], ranks[0]["buffers"][k])
    assert any(k.endswith(("mean", "running_phi")) for k in one["buffers"])


def test_two_ranks_equal_jax_step(runs):
    variant, want_g, want_s, ranks, _, _, zero = runs
    for r, got in enumerate(ranks):
        bad = _bad(got["grads"], want_g, 1e-3, 1e-8, zero)
        assert not bad, (variant, r, bad[:5])
        assert set(want_s) == set(got["buffers"])
        for k, w in want_s.items():
            np.testing.assert_allclose(got["buffers"][k].numpy(),
                                       w.numpy(), rtol=0, atol=1e-6,
                                       err_msg=k)


def test_reductions_at_world_one_issue_no_collective(monkeypatch):
    """Without a group, or at world 1, both reductions return their input
    and call no collective; ``local_rows`` is JAX's (A, mb) layout."""
    calls = []
    monkeypatch.setattr(torch.distributed, "all_reduce",
                        lambda *a, **k: calls.append(a))
    x = torch.arange(4.0, requires_grad=True)
    assert dist.all_reduce_sum_diff(x) is x
    assert dist.all_reduce_sum(x) is x
    monkeypatch.setattr(dist, "world", lambda group=None: 1)
    assert dist.all_reduce_sum_diff(x, object()) is x
    assert dist.all_reduce_sum(x, object()) is x
    assert not calls
    np.testing.assert_array_equal(dist.local_rows(8, 2, 1, 2),
                                  [2, 3, 6, 7])
    np.testing.assert_array_equal(dist.local_rows(8, 1, 0, 2),
                                  [0, 1, 2, 3])
    with pytest.raises(ValueError):
        dist.local_rows(6, 2, 0, 2)
    assert os.environ.get("RANK") is None
