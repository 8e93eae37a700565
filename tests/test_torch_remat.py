"""The training recipe's backward on the CPU: the scatter-free down-conv
and the activation-checkpoint policies of hotformerloc_torch.

* ``octree_down_conv`` with the inverse tables (``plan.down_tables``):
  dx, dw and db against ``jax.vjp`` of the JAX package's
  ``octree_down_conv`` given ``parent`` and ``octant``, at fp32 (|d| <=
  1e-5 max |ref|) and at bf16 (|d| <= 4e-3 max |ref|, one bf16 rounding:
  both sides sum in fp32 and round once to bf16, in other orders); its
  graph reaches no gather or scatter backward node.
* ``remat_policy`` None / 'save_attn' / 'save_hot' on the tiny model,
  DropPath 0.5 with fixed masks: fp32 gradients bitwise equal to those
  without checkpointing, and the plain K1 / K3 forwards that the backward
  runs again counted: every site under None, K3's only under
  'save_attn', none under 'save_hot'. An unknown policy raises.
"""
import torch_threads  # noqa: F401  (first: one torch thread per worker)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hotformerloc_tpu.ops import conv as jconv
from hotformerloc_torch.models import config as tcfg
from hotformerloc_torch.models.hotformerloc import HOTFormerLoc
from hotformerloc_torch.octree.build import build_batched_octree
from hotformerloc_torch.ops import conv as tconv
from hotformerloc_torch.ops.kernels import octree_conv as kconv
from hotformerloc_torch.ops.kernels import window_attn as kattn
from hotformerloc_torch.ops.plan import build_plan


@pytest.fixture(scope="module")
def down_case():
    """A depth-4 octree of two clouds (the second with masked points, so
    both have padding rows) and its down tables into depth 3."""
    rng = np.random.default_rng(11)
    pts = rng.uniform(-0.9, 0.9, (2, 600, 3)).astype(np.float32)
    pmask = np.ones((2, 600), bool)
    pmask[1, 350:] = False
    ot = build_batched_octree(torch.from_numpy(pts), torch.from_numpy(pmask),
                              4, 2, (64, 512, 600))
    children, parent, octant = build_plan(ot, tap_lists=False).down_tables(4)
    assert (parent < 0).any() and (parent >= 0).any()
    x = rng.standard_normal((2, 600, 16)).astype(np.float32)
    w = (rng.standard_normal((8, 16, 24)) * 0.2).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    dy = rng.standard_normal((2, children.shape[1], 24)).astype(np.float32)
    return children, parent, octant, x, w, b, dy


def _names(fn, seen=None):
    """Class names of every node reachable from grad_fn ``fn``."""
    seen = set() if seen is None else seen
    if fn is not None and fn not in seen:
        seen.add(fn)
        for nxt, _ in fn.next_functions:
            _names(nxt, seen)
    return {type(f).__name__ for f in seen}


@pytest.mark.parametrize("dtype,rel", [("float32", 1e-5),
                                       ("bfloat16", 4e-3)])
def test_down_conv_grads_match_jax_vjp(down_case, dtype, rel):
    children, parent, octant, x, w, b, dy = down_case
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    tabs = [jnp.asarray(t.numpy()) for t in (children, parent, octant)]

    def f(x_, w_, b_):
        return jconv.octree_down_conv(x_, tabs[0], w_, b_, tabs[1], tabs[2])

    jout, vjp = jax.vjp(f, *(jnp.asarray(a, jdt) for a in (x, w, b)))
    refs = [np.asarray(r, np.float32) for r in vjp(jnp.asarray(dy, jdt))]
    ins = [torch.tensor(a, dtype=tdt, requires_grad=True) for a in (x, w, b)]
    out = tconv.octree_down_conv(ins[0], children, ins[1], ins[2], parent,
                                 octant)
    np.testing.assert_allclose(out.float().detach().numpy(),
                               np.asarray(jout, np.float32), rtol=0,
                               atol=rel * float(np.abs(jout).max()))
    names = _names(out.grad_fn)
    assert "DownConvFnBackward" in names
    assert not any("Gather" in n or "Scatter" in n for n in names), names
    out.backward(torch.tensor(dy, dtype=tdt))
    for t, r, what in zip(ins, refs, ("dx", "dw", "db")):
        assert t.grad.dtype == tdt, what
        np.testing.assert_allclose(t.grad.float().numpy(), r, rtol=0,
                                   atol=rel * float(np.abs(r).max()),
                                   err_msg=what)
    # rows with no parent (padding) get exactly zero
    assert (ins[0].grad[parent < 0] == 0).all()
    # without the inverse tables autograd differentiates the gather
    plain = tconv.octree_down_conv(ins[0], children, ins[1], ins[2])
    assert any("Gather" in n for n in _names(plain.grad_fn))


# -- remat policies -----------------------------------------------------------

P = 256
POLICIES = [None, "save_attn", "save_hot"]


@pytest.fixture(scope="module")
def remat_case():
    """Tiny model weights, a batch, fixed DropPath masks, a loss
    projection and the gradients without checkpointing."""
    cfg = tcfg.tiny_test_config(drop_path=0.5, num_points=P)
    rng = np.random.default_rng(5)
    pts = torch.from_numpy(rng.uniform(-0.9, 0.9, (4, P, 3)).astype(
        np.float32))
    pmask = torch.ones(4, P, dtype=torch.bool)
    pmask[3, 180:] = False
    base = HOTFormerLoc(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(3))
    masks = base.draw_drop_masks(4, torch.Generator().manual_seed(4))
    proj = torch.from_numpy(rng.standard_normal((4, cfg.output_dim)).astype(
        np.float32))
    case = (cfg, base.state_dict(), pts, pmask, masks, proj)
    return case, _run(case, False, None)[0]


def _run(case, gc, policy, on_backward=None):
    cfg, state, pts, pmask, masks, proj = case
    m = HOTFormerLoc(dataclasses.replace(cfg, grad_checkpoint=gc,
                                         remat_policy=policy), device="cpu")
    m.load_state_dict(state)
    m.train()
    loss = (m(pts, pmask, drop_masks=masks)["global"] * proj).sum()
    if on_backward is not None:
        on_backward()
    loss.backward()
    return {n: p.grad for n, p in m.named_parameters()}, cfg


class _Counting:
    """Stands in for a module, counting calls of one of its functions."""

    def __init__(self, mod, name):
        self._mod, self._name, self.calls = mod, name, 0

    def __getattr__(self, attr):
        fn = getattr(self._mod, attr)
        if attr != self._name:
            return fn

        def counted(*a, **k):
            self.calls += 1
            return fn(*a, **k)
        return counted


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policy_bitwise_and_recompute_counts(remat_case, monkeypatch,
                                                   policy):
    case, g_ref = remat_case
    k1 = _Counting(kattn, "window_attention_reference")
    k3 = _Counting(tconv, "octree_dwconv")
    monkeypatch.setattr(kattn, "window_attention_reference",
                        k1.window_attention_reference)
    # K3's op reaches the plain conv through octree_conv.py's ``plain``;
    # K4's plain backward calls ops/conv.py's own, uncounted
    monkeypatch.setattr(kconv, "plain", k3)

    def reset():
        k1.calls = k3.calls = 0
    g, cfg = _run(case, True, policy, reset)
    sites = cfg.num_blocks[0] + cfg.num_blocks[-1] * cfg.num_pyramid_levels
    want = {None: (sites, sites), "save_attn": (0, sites),
            "save_hot": (0, 0)}[policy]
    assert (k1.calls, k3.calls) == want
    assert set(g) == set(g_ref)
    for n in g_ref:
        assert torch.equal(g[n], g_ref[n]), n


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        tcfg.tiny_test_config(remat_policy="save_everything")
    assert tcfg.ModelConfig().remat_policy == "save_hot"


@pytest.mark.parametrize("policy", POLICIES)
def test_xcpe_conv_kept_under_save_hot(monkeypatch, policy):
    """A tiny xCPE model (every CPE a full conv, K5 through the op
    ``hotformerloc::octree_conv``): the plain K5 forwards that one
    checkpointed backward runs again are counted, one per block under
    None and 'save_attn', none under 'save_hot', which keeps the op's
    output (JAX's "cpe_out"); the gradients equal those without
    checkpointing, bitwise."""
    cfg = tcfg.tiny_test_config(xcpe=True, drop_path=0.0, num_points=P)
    rng = np.random.default_rng(6)
    pts = torch.from_numpy(rng.uniform(-0.9, 0.9, (2, P, 3)).astype(
        np.float32))
    pmask = torch.ones(2, P, dtype=torch.bool)
    base = HOTFormerLoc(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(7))
    proj = torch.from_numpy(rng.standard_normal((2, cfg.output_dim)).astype(
        np.float32))
    case = (cfg, base.state_dict(), pts, pmask, None, proj)
    g_ref = _run(case, False, None)[0]
    k5 = _Counting(tconv, "octree_conv")
    monkeypatch.setattr(kconv, "plain", k5)

    def reset():
        k5.calls = 0
    g, _ = _run(case, True, policy, reset)
    sites = cfg.num_blocks[0] + cfg.num_blocks[-1] * cfg.num_pyramid_levels
    assert k5.calls == (0 if policy == "save_hot" else sites)
    assert set(g) == set(g_ref)
    for n in g_ref:
        assert torch.equal(g[n], g_ref[n]), n
