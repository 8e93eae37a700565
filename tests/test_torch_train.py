"""The training slice of hotformerloc_torch against the JAX package, on
the CPU (where the kernel Functions run their plain forward and backward):

* the four losses: value and gradient against JAX (rtol 1e-5, with an
  absolute floor of 1e-5 max |g| for entries near zero);
* lr_schedule and five Adam (L2 weight decay) / AdamW / LAMB steps
  against optax (rtol 1e-6; atol 1e-6 on the parameters, see the test),
  and three LAMB steps on the tiny model's parameters against optax.lamb,
  whose trust ratio spans the stacked HOTFormer iterations;
* tiny_test_config model gradients of truncated_smoothap against
  jax.grad, mapped by name through params_from_jax, with kernel routing
  on and off and under each remat policy: loss rtol 1e-5, each tensor
  |dg| <= 1e-3 |g_jax| + 1e-8.

The train step's own tests are in tests/test_torch_step.py.
"""
import torch_threads  # noqa: F401  (first: one torch thread per worker)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hotformerloc_tpu.losses import losses as jl
from hotformerloc_tpu.models import config as jcfg
from hotformerloc_tpu.models.hotformerloc import HOTFormerLoc as JModel
from hotformerloc_tpu.training import optim as jopt
from hotformerloc_torch.convert import params_from_jax
from hotformerloc_torch.losses import losses as tl
from hotformerloc_torch.models import config as tcfg
from hotformerloc_torch.models.hotformerloc import HOTFormerLoc as TModel
from hotformerloc_torch.training import optim as topt


def synthetic_batch(rng, B, P, k=2):
    """k-sample positive groups of jittered copies of a base cloud."""
    base = rng.uniform(-0.8, 0.8, size=(B // k, P, 3)).astype(np.float32)
    pts = np.repeat(base, k, axis=0)
    pts = pts + rng.normal(0, 0.01, size=pts.shape).astype(np.float32)
    groups = np.repeat(np.arange(B // k), k)
    return {"points": pts, "pmask": np.ones((B, P), bool),
            "positives_mask": (groups[:, None] == groups[None])
            & ~np.eye(B, dtype=bool),
            "negatives_mask": groups[:, None] != groups[None]}


def torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


# -- losses -----------------------------------------------------------------


def _loss_inputs(seed, B=12, D=16):
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((B, D)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    groups = rng.integers(0, 4, B)
    pos = (groups[:, None] == groups[None]) & ~np.eye(B, dtype=bool)
    neg = groups[:, None] != groups[None]
    neg[0, :] = False                   # a row without negatives
    return e, pos, neg


LOSSES = {
    "truncatedsmoothap": dict(positives_per_query=2),
    "batchhardtripletmarginloss": {},
    "batchhardcontrastiveloss": {},
}


@pytest.mark.parametrize("name", list(LOSSES))
def test_loss_value_and_grad_match_jax(name):
    e, pos, neg = _loss_inputs(len(name))
    jf = jl.make_loss(name, **LOSSES[name])
    tf = tl.make_loss(name, **LOSSES[name])
    (jv, jstats), jg = jax.value_and_grad(jf, has_aux=True)(
        jnp.asarray(e), jnp.asarray(pos), jnp.asarray(neg))
    et = torch.from_numpy(e).requires_grad_()
    tv, tstats = tf(et, torch.from_numpy(pos), torch.from_numpy(neg))
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    # entries near zero: both sides round the affinities before the
    # 1/tau1 = 100 gain of the sigmoid, so the floor scales with max |g|
    jg = np.asarray(jg)
    np.testing.assert_allclose(et.grad.numpy(), jg, rtol=1e-5,
                               atol=1e-5 * np.abs(jg).max())
    assert set(tstats) == set(jstats)
    for k in jstats:
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                   rtol=1e-5, err_msg=k)


def test_kd_loss_value_and_grad_match_jax():
    rng = np.random.default_rng(9)
    s, t = (rng.standard_normal((6, 16)).astype(np.float32) for _ in "st")
    jv, jg = jax.value_and_grad(jl.kd_loss)(jnp.asarray(s), jnp.asarray(t))
    st = torch.from_numpy(s).requires_grad_()
    tv = tl.kd_loss(st, torch.from_numpy(t))
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    jg = np.asarray(jg)
    np.testing.assert_allclose(st.grad.numpy(), jg, rtol=1e-5,
                               atol=1e-5 * np.abs(jg).max())


# -- optimiser and schedule ------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(base_lr=5e-4, steps_per_epoch=100, epochs=150, warmup_epochs=5,
         milestones=[100]),
    dict(base_lr=1.0, steps_per_epoch=1, epochs=100,
         scheduler="CosineAnnealingLR", min_lr=0.1, warmup_epochs=3),
    dict(base_lr=1.0, steps_per_epoch=2, epochs=10, scheduler="ExponentialLR",
         gamma=0.5)])
def test_lr_schedule_matches_jax(kw):
    js, ts = jopt.lr_schedule(**kw), topt.lr_schedule(**kw)
    for step in (0, 1, 99, 100, 250, 499, 500, 501, 10_499, 10_500, 10_501,
                 14_999):
        # atol: 0.5 ** 7000 underflows to 0 in JAX's fp32
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6,
                                   atol=1e-30, err_msg=str(step))


@pytest.mark.parametrize("name", ["adam", "adamw", "lamb"])
def test_optimizer_steps_match_optax(name):
    rng = np.random.default_rng(3)
    p0 = {"a": rng.standard_normal((5, 4)).astype(np.float32),
          "b": rng.standard_normal(7).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(5)]
    kw = dict(base_lr=1e-2, steps_per_epoch=1, epochs=10, warmup_epochs=2)
    tx = jopt.make_optimizer(name, jopt.lr_schedule(**kw), weight_decay=1e-4)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt = topt.make_optimizer(tp.values(), name, topt.lr_schedule(**kw),
                              weight_decay=1e-4)
    for i, g in enumerate(grads):
        up, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, up)
        for group in opt.param_groups:
            group["lr"] = opt.schedule(i)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    # atol: optax rounds the bias correction 1 - 0.999**t in fp32 (off
    # by 1.3e-5 at t = 1), torch in fp64, so the updates (summing to
    # ~3.5e-2 here) differ by up to ~2.5e-7
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6)




# -- model gradients against jax.grad ---------------------------------------


@pytest.fixture(scope="module")
def grad_pair():
    """Loss and parameter gradients of truncated_smoothap over the JAX
    tiny model (plain XLA paths, deterministic), and the port's model
    with the same weights."""
    cj = jcfg.tiny_test_config(drop_path=0.0, use_pallas_attn=False,
                               use_band_conv=False, num_points=256)
    b = synthetic_batch(np.random.default_rng(21), 4, 256)
    b["pmask"][3, 200:] = False
    jm = JModel(cj)
    args = [jnp.asarray(b[k]) for k in ("points", "pmask")]
    v = jm.init(jax.random.PRNGKey(1), *args)
    loss_fn = jl.make_loss("truncatedsmoothap", positives_per_query=1)

    def loss_of(params):
        out = jm.apply({"params": params}, *args)
        return loss_fn(out["global"], jnp.asarray(b["positives_mask"]),
                       jnp.asarray(b["negatives_mask"]))[0]

    jloss, jgrad = jax.jit(jax.value_and_grad(loss_of))(v["params"])
    np_tree = jax.tree_util.tree_map(np.asarray, v["params"])
    tm = TModel(tcfg.tiny_test_config(drop_path=0.0, num_points=256),
                device="cpu")
    tm.load_state_dict(params_from_jax(np_tree, tm))
    # params_from_jax maps any tree shaped like the params, here the
    # gradient tree, by name onto the port's parameters
    tgrad_ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrad),
                                tm)
    return tm, b, float(jloss), tgrad_ref, np_tree


# remat "off": no checkpointing; else grad_checkpoint with that policy.
# The ids of the first two cases are those of the test before the
# policies were added.
@pytest.mark.parametrize("use_kernels,remat", [
    (True, "off"), (False, "off"), (True, None), (True, "save_attn"),
    (True, "save_hot")], ids=["True", "False", "True-remat_None",
                              "True-save_attn", "True-save_hot"])
def test_model_grads_match_jax(grad_pair, use_kernels, remat):
    """With each remat policy too: the checkpointed model's gradients
    against jax.grad at the same bar (tests/test_torch_remat.py holds
    them bitwise against no checkpointing)."""
    tm, b, jloss, gref, _ = grad_pair
    if remat != "off":
        m = TModel(dataclasses.replace(tm.cfg, grad_checkpoint=True,
                                       remat_policy=remat), device="cpu")
        m.load_state_dict(tm.state_dict())
        tm = m
    tm.set_use_kernels(use_kernels)
    tm.train()
    tm.zero_grad(set_to_none=True)
    tb = torch_batch(b)
    out = tm(tb["points"], tb["pmask"])
    loss, _ = tl.truncated_smoothap(out["global"], tb["positives_mask"],
                                    tb["negatives_mask"],
                                    positives_per_query=1)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-5)
    assert set(gref) == {n for n, _ in tm.named_parameters()}
    bad = []
    for name, p in tm.named_parameters():
        d = float((p.grad - gref[name]).norm())
        lim = 1e-3 * float(gref[name].norm()) + 1e-8
        if not d <= lim:
            bad.append((name, d, lim))
    assert not bad, bad[:5]
    tm.eval()


def test_lamb_steps_match_optax_on_tiny_model(grad_pair):
    """Three LAMB steps on the tiny model's converted JAX parameters with
    the same random gradients (one scale per HOTFormer iteration) against
    optax.lamb: each tensor within 1e-6 + 1e-5 |p|. optax takes the trust
    ratio over a whole leaf, and the HOTFormer iterations' parameters are
    stacked in one leaf per name, so taking it per tensor must miss."""
    tm, _, _, _, np_tree = grad_pair
    kw = dict(base_lr=0.05, steps_per_epoch=1, epochs=10,
              scheduler="constant")
    rng = np.random.default_rng(17)

    def rand_grads(tree, path=()):
        if isinstance(tree, dict):
            return {k: rand_grads(v, path + (k,)) for k, v in tree.items()}
        g = rng.standard_normal(tree.shape).astype(np.float32)
        if path[:3] == ("backbone", "hotf_stage", "iter"):
            g *= np.arange(1, tree.shape[0] + 1, dtype=np.float32).reshape(
                (-1,) + (1,) * (tree.ndim - 1))
        return g

    grads = [rand_grads(np_tree) for _ in range(3)]
    tx = jopt.make_optimizer("lamb", jopt.lr_schedule(**kw),
                             weight_decay=1e-4)
    jp = jax.tree_util.tree_map(jnp.asarray, np_tree)
    st = tx.init(jp)
    for g in grads:
        up, st = tx.update(jax.tree_util.tree_map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, up)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tm)
    tgrads = [params_from_jax(g, tm) for g in grads]

    def run(named):
        m = TModel(tm.cfg, device="cpu")
        m.load_state_dict(tm.state_dict())
        opt = topt.make_optimizer(m.named_parameters() if named
                                  else m.parameters(), "lamb",
                                  topt.lr_schedule(**kw), weight_decay=1e-4)
        for i, g in enumerate(tgrads):
            for group in opt.param_groups:
                group["lr"] = opt.schedule(i)
            for n, p in m.named_parameters():
                p.grad = g[n].clone()
            opt.step()
        return {n: p.detach() for n, p in m.named_parameters()}

    def misses(got):
        return [n for n in want if not torch.allclose(
            got[n], want[n], rtol=1e-5, atol=1e-6)]

    assert not misses(run(True))
    per_tensor = misses(run(False))
    assert per_tensor and all(".iters." in n for n in per_tensor)
