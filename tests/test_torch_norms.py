"""The norms, the transposed conv, NetVLAD, the N/D/L input features,
the running-statistics rule of the train step and the converter's
batch_stats in hotformerloc_torch against the JAX package, on the CPU:

* MaskedBatchNorm and PowerNorm: forward, gradients (jax.vjp; PowerNorm's
  approximate custom backward, with a nonzero ema_gz) and the running
  state over 3 train steps, then eval mode, within 1e-5 (PowerNorm also
  past its warm-up);
* octree_deconv forward and VJP (its scatter-free backward) and
  OctreeDeconvNormRelu, and the deconv kernel's initial spread; the
  window attention's RPE bias with JAX's scatter-free table gradient;
  ``global_pool`` and ``masked_mean``;
* NetVLADLoupe (no model builds it) in eval and train mode, and the
  PyramidOctGeM(gc) head in train mode on 6 samples;
* the 'N', 'D' and 'L' input features, and 'N' as the per-octant mean of
  the point normals;
* the multistage step's running statistics after 3 steps against JAX's
  make_train_step (batchnorm: mean and var; powernorm: running_phi and
  iters), within 1e-6, with and without activation checkpointing under
  each remat_policy; single-pass and MESA rules; dropout's masks;
* params_from_jax with batch_stats: every parameter and buffer set once.

JAX runs its XLA routes (use_pallas_attn and use_band_conv off).
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
from hotformerloc_tpu.models import layers as jlayers
from hotformerloc_tpu.models import pooling as jpool
from hotformerloc_tpu.models.hotformerloc import HOTFormerLoc as JModel
from hotformerloc_tpu.models.hotformerloc import input_features as jfeat
from hotformerloc_tpu.octree import morton as jmorton
from hotformerloc_tpu.octree.build import build_batched_octree as jbuild
from hotformerloc_tpu.ops import conv as jconv
from hotformerloc_tpu.training.step import StepConfig as JStepConfig
from hotformerloc_tpu.training.step import TrainState
from hotformerloc_tpu.training.step import make_train_step as jmake_step
from hotformerloc_torch.convert import params_from_jax
from hotformerloc_torch.losses import losses as tl
from hotformerloc_torch.models import config as tcfg
from hotformerloc_torch.models import layers as tlayers
from hotformerloc_torch.models.hotformerloc import HOTFormerLoc as TModel
from hotformerloc_torch.models.hotformerloc import build_model_plan
from hotformerloc_torch.models.hotformerloc import input_features as tfeat
from hotformerloc_torch.models.pooling import NetVLADLoupe, PyramidGeM
from hotformerloc_torch.octree.build import build_batched_octree as tbuild
from hotformerloc_torch.ops import conv as tconv
from hotformerloc_torch.training.step import StepConfig, make_train_step
from test_torch_ablations import jax_variables


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _close(got, want, tol=1e-5, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=msg)


# -- MaskedBatchNorm and PowerNorm --------------------------------------------


NORMS = {
    "batchnorm": (jlayers.MaskedBatchNorm, tlayers.MaskedBatchNorm, {}),
    "powernorm": (jlayers.PowerNorm, tlayers.PowerNorm, {}),
    "powernorm_past_warmup": (jlayers.PowerNorm, tlayers.PowerNorm,
                              dict(warmup_iters=2)),
}


@pytest.mark.parametrize("name", sorted(NORMS))
def test_norm_steps_match_jax(name):
    """3 train steps (fresh x, valid mask, upstream g each), then eval."""
    jcls, tcls, kw = NORMS[name]
    C = 6
    rng = np.random.default_rng(0)
    jm = jcls(C, **kw)
    tm = tcls(C, **kw)
    x0 = rng.normal(0, 2, (2, 10, C)).astype(np.float32)
    v = _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(x0)))
    params = {"scale": 1 + 0.3 * rng.normal(size=C).astype(np.float32),
              "bias": 0.3 * rng.normal(size=C).astype(np.float32)}
    stats = dict(v["batch_stats"])
    if "ema_gz" in stats:       # never written: set it to exercise the bwd
        stats["ema_gz"] = 0.5 * rng.normal(size=C).astype(np.float32)
    tm.load_state_dict({k: _t(a) for k, a in
                        params_from_jax(params, tm, stats).items()})
    tm.train()
    for step in range(3):
        x = rng.normal(1, 2, (2, 10, C)).astype(np.float32)
        valid = rng.uniform(size=(2, 10)) < 0.7
        g = rng.normal(size=x.shape).astype(np.float32)

        def f(p, xx):
            return jm.apply({"params": p, "batch_stats": stats}, xx,
                            jnp.asarray(valid), use_running_average=False,
                            mutable=["batch_stats"])
        y, vjp, new = jax.vjp(f, params, jnp.asarray(x), has_aux=True)
        gp, gx = vjp(jnp.asarray(g))
        xt = _t(x).requires_grad_(True)
        yt = tm(xt, _t(valid))
        yt.backward(_t(g))
        _close(yt.detach(), y, msg=f"step {step} y")
        _close(xt.grad, gx, msg=f"step {step} dx")
        _close(tm.weight.grad, gp["scale"], msg="dscale")
        _close(tm.bias.grad, gp["bias"], msg="dbias")
        tm.weight.grad = tm.bias.grad = None
        stats = _np(new["batch_stats"])
        tm.commit(tm.staged)
        for k, a in stats.items():
            _close(getattr(tm, k), a, msg=f"step {step} {k}")
    tm.eval()
    x = rng.normal(size=(2, 10, C)).astype(np.float32)
    y = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x))
    _close(tm(_t(x)).detach(), y, msg="eval")


# -- the transposed conv ---------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_plan():
    rng = np.random.default_rng(1)
    pts = torch.from_numpy(rng.uniform(-1, 1, (2, 200, 3)).astype(np.float32))
    mask = torch.ones(2, 200, dtype=torch.bool)
    mask[1, 150:] = False
    cfg = tcfg.tiny_test_config(num_points=200)
    return build_model_plan(cfg, pts, mask)


def test_octree_deconv_and_vjp_match_jax(tiny_plan):
    d = tiny_plan.octree.depth
    children, parent, octant = tiny_plan.down_tables(d)
    Np = children.shape[1]
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, Np, 5)).astype(np.float32)
    w = rng.normal(size=(8, 5, 7)).astype(np.float32)
    b = rng.normal(size=(7,)).astype(np.float32)
    g = rng.normal(size=(2, parent.shape[1], 7)).astype(np.float32)
    tabs = [jnp.asarray(t.numpy()) for t in (parent, octant, children)]

    def f(xx, ww, bb):
        return jconv.octree_deconv(xx, tabs[0], tabs[1], ww, bb,
                                   children=tabs[2])
    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    gx, gw, gb = vjp(jnp.asarray(g))
    xt, wt, bt = (_t(a).requires_grad_(True) for a in (x, w, b))
    yt = tconv.octree_deconv(xt, parent, octant, wt, bt, children)
    yt.backward(_t(g))
    _close(yt.detach(), y, msg="y")
    for got, want, n in ((xt.grad, gx, "dx"), (wt.grad, gw, "dw"),
                         (bt.grad, gb, "db")):
        _close(got, want, tol=1e-4, msg=n)
    # without the inverse tables: autograd through the gather, equal
    yt2 = tconv.octree_deconv(_t(x), parent, octant, _t(w), _t(b))
    _close(yt2, y, msg="no children")


def test_octree_deconv_norm_relu_matches_jax(tiny_plan):
    d = tiny_plan.octree.depth
    down = tiny_plan.down_tables(d)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, down[0].shape[1], 4)).astype(np.float32)
    valid = tiny_plan.octree.node_valid(d)
    jm = jlayers.OctreeDeconvNormRelu(6, "batchnorm")
    args = [jnp.asarray(t.numpy()) for t in (down[1], down[2])]
    v = _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), *args,
                    jnp.asarray(valid.numpy())))
    tm = tlayers.OctreeDeconvNormRelu(4, 6, "batchnorm")
    tm.load_state_dict(params_from_jax(v["params"], tm, v["batch_stats"]))
    for train in (False, True):
        out = jm.apply(v, jnp.asarray(x), *args, jnp.asarray(valid.numpy()),
                       train, mutable=["batch_stats"])[0]
        tm.train(train)
        _close(tm(_t(x), down, valid).detach(), out, msg=f"train={train}")
    # the init's spread: variance_scaling(8, fan_in) on (8, C, O) is
    # std sqrt(1 / C) for both packages
    big = tlayers.OctreeDeconvNormRelu(64, 64)
    tlayers.init_weights(big, torch.Generator().manual_seed(0))
    jk = jlayers.OctreeDeconvNormRelu(64).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 64)),
        jnp.zeros((1, 8), jnp.int32), jnp.zeros((1, 8), jnp.int32))
    jstd = float(np.std(np.asarray(jk["params"]["kernel"])))
    assert abs(float(big.kernel.std()) / jstd - 1) < 0.1


def test_global_pool_and_masked_mean_match_jax():
    from hotformerloc_torch.models.pooling import masked_mean
    rng = np.random.default_rng(11)
    x = rng.normal(size=(3, 17, 5)).astype(np.float32)
    valid = rng.uniform(size=(3, 17)) < 0.6
    valid[2] = False                       # an empty sample: zeros
    want = jconv.global_pool(jnp.asarray(x), jnp.asarray(valid))
    _close(tconv.global_pool(_t(x), _t(valid)), want)
    _close(masked_mean(_t(x), _t(valid)),
           jpool.masked_mean(jnp.asarray(x), jnp.asarray(valid)))


def test_rpe_bias_scatter_free_vjp_matches_jax():
    """The einsum route's RPE bias and its table gradient (one-hot
    products, no scatter) against JAX's ``rpe_bias``."""
    from hotformerloc_tpu.ops import rpe as jrpe
    from hotformerloc_torch.ops.rpe import rpe_bias
    rng = np.random.default_rng(10)
    xyz = rng.integers(0, 32, (2, 3, 8, 3)).astype(np.int32)
    tab = rng.normal(size=(4, 3 * 13)).astype(np.float32)
    g = rng.normal(size=(2, 3, 4, 8, 8)).astype(np.float32)
    y, vjp = jax.vjp(lambda t: jrpe.rpe_bias(t, jnp.asarray(xyz), 6, 32),
                     jnp.asarray(tab))
    (gt,) = vjp(jnp.asarray(g))
    tt = _t(tab).requires_grad_(True)
    yt = rpe_bias(tt, _t(xyz), 6, 32)
    yt.backward(_t(g))
    _close(yt.detach(), y, msg="bias")
    _close(tt.grad, gt, msg="dtable")


# -- NetVLAD -----------------------------------------------------------------


def test_netvlad_loupe_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 20, 8)).astype(np.float32)
    mask = rng.uniform(size=(3, 20)) < 0.8
    jm = jpool.NetVLADLoupe(8, 4, 16)
    v = _np(jm.init(jax.random.PRNGKey(1), jnp.asarray(x),
                    jnp.asarray(mask)))
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: a + 0.3 * np.abs(rng.normal(size=a.shape)).astype(
            np.float32), v["batch_stats"])
    tm = NetVLADLoupe(8, 4, 16)
    tm.load_state_dict(params_from_jax(v["params"], tm, v["batch_stats"]))
    tm.eval()
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(mask))
    _close(tm(_t(x), _t(mask)).detach(), want, msg="eval")
    want, new = jm.apply(v, jnp.asarray(x), jnp.asarray(mask), True,
                         mutable=["batch_stats"])
    tm.train()
    _close(tm(_t(x), _t(mask)).detach(), want, msg="train")
    for m in (tm.assign_bn, tm.gating.gating_bn):
        m.commit(m.staged)
    got = dict(tm.named_buffers())
    for k, a in params_from_jax(v["params"], tm,
                                _np(new["batch_stats"])).items():
        if k in got:
            _close(got[k], a, msg=k)


@pytest.mark.parametrize("gating", [False, True])
def test_pyramid_gem_head_train_mode_matches_jax(gating):
    """PyramidOctGeM(gc) in train mode (its BatchNorms on batch
    statistics, flax's variance) and eval mode against JAX, at the
    descriptor bar (max abs 1e-4) and the gradient bar (each tensor
    |dg| <= 1e-3 |g_jax| + 1e-8), with the new running statistics within
    1e-5, on 6 samples of spread tokens. flax's E[x^2] - E[x]^2 over 6
    pooled descriptors leaves ~2e-5 of rounding in either package."""
    rng = np.random.default_rng(6)
    toks = [np.abs(rng.normal(0.5, 1.0, (6, n, c))).astype(np.float32)
            for n, c in ((40, 8), (24, 16))]
    masks = [rng.uniform(size=t.shape[:2]) < 0.8 for t in toks]
    jm = jpool.PyramidGeM(12, (8, 16), gating)
    jt = [jnp.asarray(t) for t in toks]
    jmask = [jnp.asarray(m) for m in masks]
    v = _np(jm.init(jax.random.PRNGKey(2), jt, jmask))
    tm = PyramidGeM(12, (8, 16), gating)
    tm.load_state_dict(params_from_jax(v["params"], tm, v["batch_stats"]))
    g = rng.normal(size=(6, 12)).astype(np.float32)

    def f(p, ts):
        return jm.apply({"params": p, "batch_stats": v["batch_stats"]}, ts,
                        jmask, True, mutable=["batch_stats"])
    y, vjp, new = jax.vjp(f, v["params"], jt, has_aux=True)
    gp, gt = vjp(jnp.asarray(g))
    tt = [_t(t).requires_grad_(True) for t in toks]
    tm.train()
    yt = tm(tt, [_t(m) for m in masks])
    yt.backward(_t(g))
    assert float((yt.detach() - _t(y)).abs().max()) <= 1e-4
    grads = [(a.grad, _t(b)) for a, b in zip(tt, gt)]
    grads += [(dict(tm.named_parameters())[k].grad, want)
              for k, want in params_from_jax(_np(gp), tm).items()]
    for got, want in grads:
        assert float((got - want).norm()) <= 1e-3 * float(want.norm()) + 1e-8
    for m in (tm.bn,) + ((tm.gating.gating_bn,) if gating else ()):
        m.commit(m.staged)
    got = dict(tm.named_buffers())
    for k, want in params_from_jax(v["params"], tm,
                                   _np(new["batch_stats"])).items():
        if k in got:
            _close(got[k], want, msg=k)
    tm.eval()
    ye = jm.apply({"params": v["params"], **_np(new)}, jt, jmask)
    assert float((tm([_t(t) for t in toks], [_t(m) for m in masks])
                  - _t(ye)).abs().max()) <= 1e-4


# -- input features -------------------------------------------------------------


def test_input_features_n_d_l_match_jax():
    rng = np.random.default_rng(8)
    pts = rng.uniform(-1, 1, (2, 300, 3)).astype(np.float32)
    nrm = rng.normal(0, 1, (2, 300, 3)).astype(np.float32)
    mask = np.ones((2, 300), bool)
    mask[1, 250:] = False
    joc = jbuild(jnp.asarray(pts), jnp.asarray(mask), 5, 2,
                 normals=jnp.asarray(nrm))
    toc = tbuild(_t(pts), _t(mask), 5, 2, normals=_t(nrm))
    for feats in ("N", "D", "L", "NDLP", "PLDN"):
        _close(tfeat(toc, feats), jfeat(joc, feats), msg=feats)
    with pytest.raises(ValueError, match="normals"):
        tfeat(tbuild(_t(pts), _t(mask), 5, 2), "N")


def test_leaf_normal_is_per_octant_mean():
    rng = np.random.default_rng(9)
    pts = rng.uniform(-1, 1, (1, 200, 3)).astype(np.float32)
    nrm = rng.normal(0, 1, (1, 200, 3)).astype(np.float32)
    oc = tbuild(_t(pts), torch.ones(1, 200, dtype=torch.bool), 4, 2,
                normals=_t(nrm))
    feats = tfeat(oc, "N").numpy()
    cnt = int(oc.count(4)[0])
    keys = oc.key(4)[0][:cnt].numpy()
    pkeys = np.asarray(jmorton.encode(jmorton.points_to_grid(
        jnp.asarray(pts[0]), 4)))
    for i in (0, cnt // 2, cnt - 1):
        sel = pkeys == keys[i]
        np.testing.assert_allclose(feats[0, i], nrm[0][sel].mean(0),
                                   rtol=1e-5, atol=1e-6)
    assert np.all(feats[0, cnt:] == 0)


# -- running statistics through the train step -------------------------------


def _pair_batch(B=8, P=128, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-0.8, 0.8, size=(B // 2, P, 3)).astype(np.float32)
    pts = np.repeat(base, 2, axis=0)
    pts = pts + rng.normal(0, 0.01, size=pts.shape).astype(np.float32)
    groups = np.repeat(np.arange(B // 2), 2)
    return {"points": pts, "pmask": np.ones((B, P), bool),
            "positives_mask": (groups[:, None] == groups[None])
            & ~np.eye(B, dtype=bool),
            "negatives_mask": groups[:, None] != groups[None]}


# SGD at a small rate: the rule under test is which forward's batch
# statistics reach the state; at 1e-3 the parameters after a step
# already differ between the packages by their gradients' fp32 noise
# times the rate, which moved running_phi by 6e-6 at step 2.
LR = 1e-5
STEPS = 3


def _jax_state_after_steps(over):
    """JAX's multistage step (accum 4, SGD) run STEPS times from random
    variables (``jax_variables``: running statistics away from their
    init, PowerNorm at iteration 5) on tiny_test_config(**over):
    (params, batch_stats before and after each step)."""
    cj = jcfg.tiny_test_config(use_pallas_attn=False, use_band_conv=False,
                               num_points=128, drop_path=0.0, **over)
    jm = JModel(cj)
    b = {k: jnp.asarray(a) for k, a in _pair_batch().items()}
    tx = optax.sgd(LR)
    v = jax_variables(jm, b["points"][:1], b["pmask"][:1], None)
    st = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                    opt_state=tx.init(v["params"]),
                    model_state={"batch_stats": v["batch_stats"]})
    params0 = _np(st.params)
    stats = [_np(st.model_state["batch_stats"])]
    step = jmake_step(jm, tx, jl.make_loss("truncatedsmoothap",
                                           positives_per_query=1),
                      JStepConfig(accum_steps=4))
    for i in range(STEPS):
        st, _ = step(st, b, jax.random.PRNGKey(i))
        stats.append(_np(st.model_state["batch_stats"]))
    return params0, stats


@pytest.fixture(scope="module", params=["batchnorm", "powernorm"])
def jax_steps(request):
    return request.param, _jax_state_after_steps(
        dict(conv_norm=request.param))


def _torch_steps(conv_norm, params0, stats0, remat="off", accum=4):
    cfg = tcfg.tiny_test_config(num_points=128, drop_path=0.0,
                                conv_norm=conv_norm)
    if remat != "off":
        cfg = dataclasses.replace(cfg, grad_checkpoint=True,
                                  remat_policy=remat)
    m = TModel(cfg, device="cpu")
    m.load_state_dict(params_from_jax(params0, m, stats0))
    opt = torch.optim.SGD(m.parameters(), lr=LR)
    opt.schedule = lambda step: LR
    step = make_train_step(m, opt, tl.make_loss(
        "truncatedsmoothap", positives_per_query=1),
        StepConfig(accum_steps=accum))
    batch = {k: _t(a) for k, a in _pair_batch().items()}
    out = []
    for i in range(STEPS):
        step(batch, i)
        out.append({k: b.clone() for k, b in m.named_buffers()})
    return m, out


@pytest.mark.parametrize("remat", ["off", None, "save_attn", "save_hot"])
def test_multistage_running_stats_match_jax(jax_steps, remat):
    """Stage 1's last microbatch's update, once per step; stage 3 and the
    other microbatches change nothing; PowerNorm's iters + 1 per step."""
    conv_norm, (params0, jstats) = jax_steps
    m, tstats = _torch_steps(conv_norm, params0, jstats[0], remat)
    for i in range(STEPS):
        want = params_from_jax(params0, m, jstats[i + 1])
        for k, got in tstats[i].items():
            _close(got, want[k], tol=1e-6, msg=f"step {i} {k}")
    iters = [b for k, b in tstats[-1].items() if k.endswith("iters")]
    assert all(int(b) == 5 + STEPS for b in iters)   # from 5, + 1 a step
    assert bool(iters) == (conv_norm == "powernorm")


def test_single_pass_keeps_its_forward_update():
    """The single-pass step commits what its one train forward stages
    (JAX keeps that forward's new model_state)."""
    cfg = tcfg.tiny_test_config(num_points=128, drop_path=0.0,
                                conv_norm="batchnorm",
                                pooling="PyramidOctGeMgc")
    m = TModel(cfg, device="cpu")
    batch = {k: _t(a) for k, a in _pair_batch().items()}
    m.train()
    m(batch["points"], batch["pmask"])
    want = [dict(st) for st in m.staged_stats()]
    m.commit_stats([None] * len(want))       # write nothing, clear
    opt = torch.optim.SGD(m.parameters(), lr=0.0)
    opt.schedule = lambda step: 0.0
    make_train_step(m, opt, tl.make_loss("truncatedsmoothap",
                                         positives_per_query=1))(batch, 0)
    for mod, st in zip(m.stats_modules(), want):
        for k, v in st.items():
            _close(getattr(mod, k), v, tol=1e-6, msg=k)
    assert all(mod.staged is None for mod in m.stats_modules())


def test_mesa_teacher_reads_the_students_running_stats():
    cfg = tcfg.tiny_test_config(num_points=128, drop_path=0.0,
                                conv_norm="powernorm")
    m = TModel(cfg, device="cpu")
    opt = torch.optim.SGD(m.parameters(), lr=LR)
    opt.schedule = lambda step: LR
    step = make_train_step(m, opt, tl.make_loss(
        "truncatedsmoothap", positives_per_query=1),
        StepConfig(accum_steps=2, mesa=0.5, use_ema=True))
    batch = {k: _t(a) for k, a in _pair_batch().items()}
    step(batch, 0)
    before = [b.clone() for b in m.buffers()]
    step(batch, 1)        # the teacher ran on the state before this step
    for e, b in zip(step.state.ema_model.buffers(), before):
        assert torch.equal(e, b)
    assert any(not torch.equal(a, b) for a, b in zip(m.buffers(), before))


def test_stats_refused_over_ranks(monkeypatch):
    """No longer refused: over a group of 2 the step hands the group to
    every norm, which reduces over it in train mode only (eval mode and
    a step without a group never reduce; tests/test_torch_dist_stats.py
    runs the ranks)."""
    from hotformerloc_torch.parallel import dist
    monkeypatch.setattr(dist, "world", lambda group=None: 2)
    m = TModel(tcfg.tiny_test_config(conv_norm="batchnorm",
                                     pooling="PyramidOctGeMgc"),
               device="cpu")
    opt = torch.optim.SGD(m.parameters(), lr=LR)
    group = object()
    step = make_train_step(m, opt, None, group=group)
    mods = m.stats_modules()
    assert step.group is group and len(mods) > 1
    assert all(mod.group is group for mod in mods)
    assert all(mod.reduce_group() is None for mod in mods)     # eval
    m.train()
    assert all(mod.reduce_group() is group for mod in mods)
    make_train_step(m, opt, None)
    assert all(mod.reduce_group() is None for mod in mods)


def test_dropout_masks_repeat_by_seed():
    """flax Dropout's distribution; the same seed draws the same masks, in
    stage 3 and in a checkpointed recompute; eval mode is the identity."""
    d = tlayers.Dropout(0.25)
    x = torch.ones(200, 100)
    assert d(x) is x
    d.seed = 3
    y = d(x)
    vals = np.unique(y.numpy())
    assert len(vals) == 2 and np.allclose(vals, [0.0, 1 / 0.75])
    assert abs(float((y > 0).float().mean()) - 0.75) < 0.02
    assert torch.equal(y, d(x))
    cfg = tcfg.tiny_test_config(num_points=128, drop_path=0.0,
                                attn_drop=0.2, proj_drop=0.2,
                                grad_checkpoint=True)
    m = TModel(cfg, device="cpu")
    batch = {k: _t(a) for k, a in _pair_batch().items()}
    m.train()
    a = m(batch["points"], batch["pmask"], dropout_seed=5)["global"]
    b = m(batch["points"], batch["pmask"], dropout_seed=5)["global"]
    c = m(batch["points"], batch["pmask"], dropout_seed=6)["global"]
    assert torch.equal(a, b) and not torch.allclose(a, c)
    a.sum().backward()                         # checkpointed recompute
    assert all(s.seed is None for s in m.dropout_sites())
    m.eval()
    e = m(batch["points"], batch["pmask"])["global"]
    m.train()
    opt = torch.optim.SGD(m.parameters(), lr=0.0)
    opt.schedule = lambda step: 0.0
    stats = make_train_step(m, opt, tl.make_loss(
        "truncatedsmoothap", positives_per_query=1),
        StepConfig(accum_steps=2, check_recompute=True))(batch, 0)
    assert float(stats["recompute_max_abs"]) == 0.0
    assert not torch.allclose(e, a)


# -- the converter -----------------------------------------------------------


def test_converter_carries_batch_stats():
    """Every parameter and buffer set exactly once, values equal to the
    JAX leaves (the scanned iterations unstacked); without batch_stats
    the buffers are left out; a missing leaf raises."""
    cj = jcfg.tiny_test_config(use_pallas_attn=False, use_band_conv=False,
                               conv_norm="powernorm",
                               pooling="PyramidOctGeMgc", num_points=128)
    pts = jnp.zeros((1, 128, 3))
    shapes = jax.eval_shape(JModel(cj).init, jax.random.PRNGKey(0), pts,
                            jnp.ones((1, 128), bool))
    rng = np.random.default_rng(0)
    v = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(s.dtype), shapes)
    v = _np(v)
    m = TModel(tcfg.tiny_test_config(conv_norm="powernorm",
                                     pooling="PyramidOctGeMgc",
                                     num_points=128), device="cpu")
    sd = params_from_jax(v["params"], m, v["batch_stats"])
    assert set(sd) == set(m.state_dict())
    m.load_state_dict(sd)
    n_bs = sum(a.size for a in jax.tree_util.tree_leaves(v["batch_stats"]))
    assert sum(b.numel() for b in m.buffers()) == n_bs
    it0 = v["batch_stats"]["backbone"]["hotf_stage"]["iter"]["hosa0"][
        "CPE_0"]["Norm_0"]["PowerNorm_0"]
    got = m.backbone.hotf_stage.iters[1].hosa0.cpe.norm
    _close(got.running_phi, it0["running_phi"][1])
    assert int(got.iters) == int(it0["iters"][1])
    _close(m.pooling.gating.gating_bn.var,
           v["batch_stats"]["pooling"]["GatingContext_0"]["gating_bn"]["var"])
    assert set(params_from_jax(v["params"], m)) == {
        n for n, _ in m.named_parameters()}
    del v["batch_stats"]["pooling"]["bn"]
    with pytest.raises(KeyError, match="pooling.bn"):
        params_from_jax(v["params"], m, v["batch_stats"])
