"""The CPE on the gather route, held against the JAX package's dense-grid
CPE, on the CPU (where the K3/K4 Function runs its plain forward and
backward).

* the port's ``CPE`` at depths <= ``dense_cpe_max_depth`` (the gather,
  ``octree_dwconv`` on the depth's neighbour table) against JAX's ``CPE``
  with ``dense_grid=True`` (``ops/conv.octree_dwconv_dense``): forward
  and the gradient of x, fp32, to 1e-5 (tests/test_torch_kernels.py's
  TOL); the gradients of the depthwise kernel and the LayerNorm, sums
  over every row taken in another order, to 1e-5 of max(1, their
  largest magnitude) (~200 here); padding rows of the
  neighbour table are all -1, and the conv's padding rows exactly zero
  on both routes;
* the model's plan carries tap lists at every level, the dense depths
  included, when a gradient is recorded, and no dense voxel maps;
* no CPE of the model reaches the dense-grid conv: a forward and
  backward of the tiny model (whose CPEs are all at dense depths) runs
  the K3/K4 Function once per CPE;
* the port's bf16 embed (``make_embed_fn``, bf16 copy of the weights)
  against JAX's bf16 ``make_embed_step`` (fp32 parameters, bf16 compute)
  with the same converted weights: cos >= 0.999 per descriptor (on
  these inputs the two agree to 0.99997, closer than either comes to
  the fp32 descriptors, 0.9999).
"""
import torch_threads  # noqa: F401  (first: one torch thread per worker)

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hotformerloc_tpu.models import config as jcfg
from hotformerloc_tpu.models.hotformerloc import HOTFormerLoc as JModel
from hotformerloc_tpu.models.layers import CPE as JCPE
from hotformerloc_tpu.ops import conv as jconv
from hotformerloc_tpu.training.step import TrainState, make_embed_step
from hotformerloc_torch.convert import params_from_jax
from hotformerloc_torch.evaluation.embed import make_embed_fn
from hotformerloc_torch.models import config as tcfg
from hotformerloc_torch.models import hotformerloc as thm
from hotformerloc_torch.models.layers import CPE
from hotformerloc_torch.octree.build import build_batched_octree
from hotformerloc_torch.ops import conv as tconv
from hotformerloc_torch.ops.kernels import octree_conv as kconv
from hotformerloc_torch.ops.plan import TapLists, build_plan

TOL = dict(rtol=0, atol=1e-5)
C = 16


@pytest.fixture(scope="module")
def plan():
    """A depth-5 octree of two clouds, the second cut short, whose levels
    3 and 4 hold padding rows; no octree overflow."""
    rng = np.random.default_rng(21)
    pts = rng.uniform(-0.9, 0.9, (2, 700, 3)).astype(np.float32)
    pm = np.ones((2, 700), bool)
    pm[1, 350:] = False
    ot = build_batched_octree(torch.from_numpy(pts), torch.from_numpy(pm),
                              5, 2, (64, 512, 704, 704))
    assert int(ot.overflow.sum()) == 0
    return build_plan(ot)


def _jctx(ctx):
    """The JAX CPE's dense-grid inputs, from the port's (equal) tables."""
    return types.SimpleNamespace(
        depth=ctx.depth, keys=jnp.asarray(ctx.keys.numpy()),
        counts=jnp.asarray(ctx.counts.numpy()),
        xyz=jnp.asarray(ctx.xyz.numpy()),
        node_valid=jnp.asarray(ctx.node_valid.numpy()), dense_idx=None)


@pytest.mark.parametrize("depth", [3, 4])
def test_cpe_gather_equals_jax_dense_cpe(plan, depth):
    assert depth <= tcfg.ModelConfig().dense_cpe_max_depth
    ctx = plan.level_ctx(depth)
    valid = ctx.node_valid.numpy()
    assert (~valid).any(), "the level must hold padding rows"
    neigh = ctx.neigh
    assert bool((neigh[~ctx.node_valid] == -1).all())
    B, N, _ = neigh.shape
    rng = np.random.default_rng(depth)
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    dy = rng.standard_normal((B, N, C)).astype(np.float32)
    jctx = _jctx(ctx)

    jm = JCPE(C, dense_grid=True)
    nb_j = jnp.asarray(neigh.numpy())
    params = jm.init(jax.random.PRNGKey(depth), jnp.asarray(x), nb_j,
                     ctx=jctx)["params"]

    def jf(p, xx):
        return jm.apply({"params": p}, xx, nb_j, ctx=jctx)
    y_j, vjp = jax.vjp(jf, params, jnp.asarray(x))
    gp_j, gx_j = vjp(jnp.asarray(dy))

    tm = CPE(C, device="cpu")
    ln = params["Norm_0"]["LayerNorm_0"]
    with torch.no_grad():
        for t, a in ((tm.dw_kernel, params["dw_kernel"]),
                     (tm.norm.weight, ln["scale"]),
                     (tm.norm.bias, ln["bias"])):
            t.copy_(torch.tensor(np.asarray(a)))
    xt = torch.from_numpy(x).requires_grad_()
    y_t = tm(xt, ctx)
    ps = (xt, tm.dw_kernel, tm.norm.weight, tm.norm.bias)
    grads = torch.autograd.grad(y_t, ps, torch.from_numpy(dy))

    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(gx_j), **TOL)
    jln = gp_j["Norm_0"]["LayerNorm_0"]
    for got, want in zip(grads[1:], (gp_j["dw_kernel"], jln["scale"],
                                     jln["bias"])):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=0,
            atol=TOL["atol"] * max(1.0, float(np.abs(want).max())))

    # the convs themselves: equal, and exactly zero on padding rows
    w = np.array(params["dw_kernel"])[..., 0]
    gather = kconv.octree_dwconv(torch.from_numpy(x), neigh,
                                 torch.from_numpy(w)).numpy()
    dense = np.asarray(jconv.octree_dwconv_dense(
        jnp.asarray(x), jctx.keys, jctx.counts, jctx.xyz, jctx.node_valid,
        jnp.asarray(w), depth))
    np.testing.assert_allclose(gather, dense, **TOL)
    assert np.all(gather[~valid] == 0.0)
    assert np.all(dense[~valid] == 0.0)


def _tiny_points(seed, B=2):
    cfg = tcfg.tiny_test_config()
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.9, 0.9, (B, cfg.num_points, 3)).astype(np.float32)
    pm = np.ones(pts.shape[:2], bool)
    pm[-1, 300:] = False
    return cfg, torch.from_numpy(pts), torch.from_numpy(pm)


def test_model_plan_has_tap_lists_at_every_level():
    cfg, pts, pm = _tiny_points(5)
    assert cfg.dense_depths(), "tiny_test_config must have a dense depth"
    plan = thm.build_model_plan(cfg, pts, pm)
    depths = range(cfg.min_depth, cfg.octree_depth + 1)
    assert plan.dense_idxs == ()
    for d in depths:
        ctx = plan.level_ctx(d)
        assert isinstance(ctx.taps, TapLists), d
        assert ctx.dense_idx is None
    for d in cfg.dense_depths():
        ctx = plan.level_ctx(d)
        assert int(ctx.taps.count.sum()) == int((ctx.neigh >= 0).sum())
    bare = thm.build_model_plan(cfg, pts, pm, tap_lists=False)
    assert all(t is None for t in bare.taps)


def test_no_cpe_reaches_the_dense_grid(monkeypatch):
    """Forward and backward of the tiny model, whose CPEs all sit at
    dense depths: the dense-grid conv is never called, and the K3/K4
    Function runs once per CPE."""
    cfg, pts, pm = _tiny_points(6)
    assert set(cfg.dense_depths()) >= {cfg.transformer_depth,
                                       *cfg.pyramid_depths}

    def refuse(*a, **k):
        raise AssertionError("the dense-grid CPE conv was called")
    monkeypatch.setattr(tconv, "octree_dwconv_dense", refuse)
    monkeypatch.setattr(tconv.DepthwiseConv3d, "apply", refuse)
    calls = []
    real = kconv.OctreeDwconvFn.apply

    def spy(*args):
        calls.append(args[1].shape)
        return real(*args)
    monkeypatch.setattr(kconv.OctreeDwconvFn, "apply", spy)
    model = thm.HOTFormerLoc(cfg, device="cpu")
    out = model(pts, pm)["global"]
    out.square().sum().backward()
    n_cpe = cfg.num_blocks[0] + cfg.num_blocks[-1] * cfg.num_pyramid_levels
    assert len(calls) == n_cpe
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
    assert model.backbone.hotf_stage.iters[0].hosa0.cpe.dw_kernel.grad.abs(
        ).sum() > 0


def test_bf16_embed_matches_jax_bf16_embed():
    """The port's bf16 descriptors against JAX's bf16 embed: the port
    casts a copy of the weights to bf16, JAX keeps fp32 parameters and
    casts them at use, and the two round at other points, so the bar is
    cos >= 0.999 per descriptor (fp32 parity is cos >= 0.9999)."""
    cfg, pts, pm = _tiny_points(7, B=4)
    cj = jcfg.tiny_test_config(use_pallas_attn=False, use_band_conv=False)
    jm = JModel(cj, dtype=jnp.bfloat16)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(pts.numpy()),
                jnp.asarray(pm.numpy()))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       opt_state=None)
    g_j = np.asarray(make_embed_step(jm)(state, jnp.asarray(pts.numpy()),
                                         jnp.asarray(pm.numpy())),
                     np.float32)
    tm = thm.HOTFormerLoc(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, v["params"]), tm))
    g_t = make_embed_fn(tm, torch.bfloat16)(pts, pm)["global"].numpy()
    g_32 = make_embed_fn(tm, torch.float32)(pts, pm)["global"].numpy()
    cos = (g_j * g_t).sum(1) / (np.linalg.norm(g_j, axis=1)
                                * np.linalg.norm(g_t, axis=1))
    assert np.all(np.isfinite(g_t)) and np.all(np.isfinite(g_j))
    assert cos.min() >= 0.999, (cos, np.abs(g_j - g_t).max())
    # each bf16 route is about as far from the fp32 descriptors
    cos_j = (g_j * g_32).sum(1) / np.linalg.norm(g_j, axis=1)
    cos_t = (g_t * g_32).sum(1) / np.linalg.norm(g_t, axis=1)
    assert cos_j.min() >= 0.99 and cos_t.min() >= 0.99, (cos_j, cos_t)
