"""The model's off-path branches in hotformerloc_torch against the JAX
package, on the CPU, at fp32.

Every ablation variant of tests/test_model.py ``TestAblations`` and every
pooling head of ``test_pooling_heads`` is held here. They run in six
JAX models (``COMBOS``) that each carry several of them at once, so that
the file stays cheap; each variant and head is its own test case on the
model that carries it:

* eval-mode descriptors against JAX's (plain XLA paths, use_pallas_attn
  and use_band_conv off), with random running statistics converted from
  the JAX ``batch_stats``: cosine >= 0.9999 and max abs <= 1e-4;
* for batchnorm, xCPE, rt_size 2 (model A) and powernorm (model B): a
  train-mode forward (batch statistics), its descriptors at the bar
  above and its parameter gradients against jax.grad, each tensor
  |dg| <= 1e-3 |g_jax| + 1e-8, with the updated running statistics
  against JAX's new ``batch_stats`` (atol 1e-5). A parameter that only
  shifts a MaskedBatchNorm's input (chip_smoke.py ``bn_shift_params``)
  has gradient 0 in exact arithmetic; both packages' values are
  rounding, so each must be within 1e-6 of the whole gradient's norm.

The JAX variables are random (``jax_variables``), not the initial ones,
so that every norm scale, GeM exponent and running statistic is away
from its identity value.
"""
import torch_threads  # noqa: F401  (first: one torch thread per worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hotformerloc_tpu.models import config as jcfg
from hotformerloc_tpu.models.hotformerloc import HOTFormerLoc as JModel
from hotformerloc_torch.convert import params_from_jax
from hotformerloc_torch.models import config as tcfg
from hotformerloc_torch.models.hotformerloc import HOTFormerLoc as TModel
from chip_smoke import bn_shift_params

P = 256
# the models: chip_smoke.py's ablations variants A and C, B with the
# default head (its PyramidOctGeMgc moves to F: that head's BatchNorm over
# a batch of 2 pooled descriptors is too ill-conditioned in fp32 for the
# gradient bar, in JAX too; tests/test_torch_norms.py holds it in train
# mode on a wider batch), and three more for the remaining variants
COMBOS = {
    "A": dict(conv_norm="batchnorm", xcpe=True, rt_size=2,
              rt_propagation=True, rt_propagation_scale=0.5,
              pooling="AttnPoolMixer"),
    "B": dict(octf_use_rt=True, conv_norm="powernorm",
              input_features="NDLP"),
    "C": dict(disable_rt=True, downsample_input_embeddings=False,
              octree_depth=5, pooling="PyramidOctGeM"),
    "D": dict(disable_rpe=True, layer_scale=1e-5, adape_mode="pos",
              pooling="AttnPoolGeM"),
    "E": dict(adape_mode=None, pooling="OctGeM"),
    "F": dict(adape_mode="var", pooling="PyramidOctGeMgc"),
}
# tests/test_model.py TestAblations.VARIANTS and the pooling heads -> the
# model that carries each
VARIANTS = {
    "disable_rt": "C", "disable_rpe": "D", "xcpe": "A", "layer_scale": "D",
    "no_adape": "E", "adape_pos": "D", "adape_var": "F", "powernorm": "B",
    "batchnorm": "A", "rt_propagation": "A", "no_stem_down": "C",
    "rt_size2": "A", "octf_use_rt": "B",
}
HEADS = {"OctGeM": "E", "PyramidOctGeM": "C", "PyramidOctGeMgc": "F",
         "PyramidAttnPoolMixer": "B", "AttnPoolMixer": "A",
         "AttnPoolGeM": "D"}
# what each variant sets, checked against the model that carries it
SETS = {
    "disable_rt": dict(disable_rt=True), "disable_rpe": dict(disable_rpe=True),
    "xcpe": dict(xcpe=True), "layer_scale": dict(layer_scale=1e-5),
    "no_adape": dict(adape_mode=None), "adape_pos": dict(adape_mode="pos"),
    "adape_var": dict(adape_mode="var"),
    "powernorm": dict(conv_norm="powernorm"),
    "batchnorm": dict(conv_norm="batchnorm"),
    "rt_propagation": dict(rt_propagation=True, rt_propagation_scale=0.5),
    "no_stem_down": dict(downsample_input_embeddings=False),
    "rt_size2": dict(rt_size=2), "octf_use_rt": dict(octf_use_rt=True),
}


def inputs(seed=3):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (2, P, 3)).astype(np.float32)
    nrm = rng.normal(0, 1, (2, P, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    mask = np.ones((2, P), bool)
    mask[1, 200:] = False
    return pts, nrm, mask


def jax_variables(jm, pts, mask, nrm, seed=0):
    """Random variables shaped like ``jm``'s (jax.eval_shape of its init:
    no compile): kernels and tables N(0, 1/fan_in), norm scales, GeM
    exponents and running variances near their init, every other leaf
    N(0, 0.1), PowerNorm's iteration count 5."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), pts, mask,
                            normals=nrm)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "iters":
            return np.full(s.shape, 5, s.dtype)
        u = rng.normal(0, 1, s.shape).astype(np.float32)
        if name == "p":
            return 3.0 + 0.2 * u
        if name in ("scale", "var", "running_phi"):
            return 1.0 + 0.2 * np.abs(u) if name != "scale" else 1.0 + 0.2 * u
        if name in ("gamma", "rt_gamma_propagate"):
            return 0.5 + 0.1 * u
        if name == "query":
            return u
        if name in ("kernel", "dw_kernel", "cluster_weights"):
            return u / np.sqrt(np.prod(s.shape[:-1]))
        return 0.1 * u
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_model(ct, v):
    tm = TModel(ct, device="cpu")
    tm.load_state_dict(params_from_jax(_np(v["params"]), tm,
                                       _np(v.get("batch_stats", {}))
                                       if "batch_stats" in v else None))
    return tm


@pytest.fixture(scope="module")
def combos():
    """name -> (torch model, JAX eval descriptors, JAX model, variables)
    for each model of COMBOS, built on first use."""
    cache = {}
    pts, nrm, mask = inputs()

    def get(name):
        if name not in cache:
            over = COMBOS[name]
            cj = jcfg.tiny_test_config(use_pallas_attn=False,
                                       use_band_conv=False, num_points=P,
                                       drop_path=0.0, **over)
            jm = JModel(cj)
            args = (jnp.asarray(pts), jnp.asarray(mask))
            v = jax_variables(jm, *args, jnp.asarray(nrm))
            jout = np.asarray(jm.apply(v, *args, normals=jnp.asarray(nrm))
                              ["global"])
            ct = tcfg.tiny_test_config(num_points=P, drop_path=0.0, **over)
            cache[name] = (_torch_model(ct, v), jout, jm, v)
        return cache[name]
    return get


def _check_descriptors(tm, jout):
    pts, nrm, mask = inputs()
    tm.eval()
    with torch.no_grad():
        out = tm(torch.from_numpy(pts), torch.from_numpy(mask),
                 normals=torch.from_numpy(nrm))["global"].numpy()
    assert out.shape == jout.shape and np.isfinite(out).all()
    cos = (out * jout).sum(1) / (np.linalg.norm(out, axis=1)
                                 * np.linalg.norm(jout, axis=1))
    assert cos.min() >= 0.9999, cos
    assert np.abs(out - jout).max() <= 1e-4


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_ablation_descriptors_match_jax(combos, variant):
    name = VARIANTS[variant]
    tm, jout, _, _ = combos(name)
    for k, want in SETS[variant].items():
        assert getattr(tm.cfg, k) == want, (variant, name, k)
    _check_descriptors(tm, jout)


@pytest.mark.parametrize("pooling", sorted(HEADS))
def test_pooling_head_descriptors_match_jax(combos, pooling):
    tm, jout, _, _ = combos(HEADS[pooling])
    assert tm.cfg.pooling == pooling
    _check_descriptors(tm, jout)


@pytest.fixture(scope="module")
def train_grads(combos):
    """name -> (torch model after one train-mode forward and backward,
    its loss, the JAX loss, gradients by the port's names, new
    batch_stats by the port's names)."""
    cache = {}
    pts, nrm, mask = inputs()
    proj = np.random.default_rng(7).normal(0, 1, (2, 64)).astype(np.float32)

    def get(name):
        if name in cache:
            return cache[name]
        tm, _, jm, v = combos(name)
        args = (jnp.asarray(pts), jnp.asarray(mask))

        def loss_of(params):
            out, state = jm.apply({**v, "params": params}, *args,
                                  normals=jnp.asarray(nrm),
                                  deterministic=True, train=True,
                                  mutable=["batch_stats"])
            return (jnp.sum(out["global"] * proj),
                    (out["global"], state["batch_stats"]))
        (jloss, (jdesc, jstate)), jgrad = jax.jit(jax.value_and_grad(
            loss_of, has_aux=True))(v["params"])
        gref = params_from_jax(_np(jgrad), tm)
        sref = {k: t for k, t in params_from_jax(
            _np(v["params"]), tm, _np(jstate)).items()
            if k not in gref}
        tm.train()
        tm.zero_grad(set_to_none=True)
        out = tm(torch.from_numpy(pts), torch.from_numpy(mask),
                 normals=torch.from_numpy(nrm))["global"]
        loss = (out * torch.from_numpy(proj)).sum()
        loss.backward()
        tm.commit_stats()
        tm.eval()
        cache[name] = (tm, out.detach().numpy(), np.asarray(jdesc), gref,
                       sref)
        return cache[name]
    return get


@pytest.mark.parametrize("variant", ["batchnorm", "powernorm", "xcpe",
                                     "rt_size2"])
def test_train_grads_and_stats_match_jax(train_grads, variant):
    tm, desc, jdesc, gref, sref = train_grads(VARIANTS[variant])
    for k, want in SETS[variant].items():
        assert getattr(tm.cfg, k) == want
    cos = (desc * jdesc).sum(1) / (np.linalg.norm(desc, axis=1)
                                   * np.linalg.norm(jdesc, axis=1))
    assert cos.min() >= 0.9999 and np.abs(desc - jdesc).max() <= 1e-4
    assert set(gref) == {n for n, _ in tm.named_parameters()}
    zero = bn_shift_params(tm)
    total = float(torch.sqrt(sum((g ** 2).sum() for g in gref.values())))
    bad = []
    for name, p in tm.named_parameters():
        # None: unused by this forward (A's propagation gains: its head
        # reads the relay tokens), where JAX's gradient is zero
        g = torch.zeros_like(p) if p.grad is None else p.grad
        if name in zero:
            d = max(float(g.norm()), float(gref[name].norm()))
            lim = 1e-6 * total
        else:
            d = float((g - gref[name]).norm())
            lim = 1e-3 * float(gref[name].norm()) + 1e-8
        if not d <= lim:
            bad.append((name, d, lim))
    assert bool(zero) == (tm.cfg.conv_norm == "batchnorm")
    assert not bad, bad[:5]
    buffers = dict(tm.named_buffers())
    assert set(sref) == set(buffers) and sref
    for k, want in sref.items():
        np.testing.assert_allclose(buffers[k].numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
