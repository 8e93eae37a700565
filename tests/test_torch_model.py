"""The whole serving slice of hotformerloc_torch against the JAX package.

* tiny_test_config: JAX HOTFormerLoc (plain XLA paths: use_pallas_attn and
  use_band_conv off, which the JAX package's own tests hold equal to its
  kernels) with converted weights vs the port, at fp32, with the port's
  kernel routing on and off: cosine >= 0.9999 and max abs <= 1e-4 (the
  bar of tests/test_reference_parity.py).
* the converter uses every JAX leaf once and sets every parameter;
* options the JAX package refuses too raise NotImplementedError;
* retrieval_topk equals the JAX function;
* no file of the port, nor chip_smoke.py, imports jax, flax or
  hotformerloc_tpu.
"""
import torch_threads  # noqa: F401  (first: one torch thread per worker)

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hotformerloc_tpu.evaluation.evaluate import retrieval_topk as jtopk
from hotformerloc_tpu.models import config as jcfg
from hotformerloc_tpu.models.hotformerloc import HOTFormerLoc as JModel
from hotformerloc_torch.convert import params_from_jax
from hotformerloc_torch.evaluation.embed import make_embed_fn
from hotformerloc_torch.evaluation.evaluate import retrieval_topk as ttopk
from hotformerloc_torch.models import config as tcfg
from hotformerloc_torch.models.hotformerloc import HOTFormerLoc as TModel

ROOT = pathlib.Path(__file__).resolve().parents[1]

# dense_cpe_max_depth=0 sends every CPE through the gather (K3) path.
VARIANTS = {
    "tiny": {},
    "tiny_gather_cpe": dict(dense_cpe_max_depth=0),
    "tiny_proj_overflow_norpe": dict(
        dense_cpe_max_depth=0, channels=(32, 64, 64), num_heads=(2, 4, 4),
        layer_scale=0.5, disable_rpe=True,
        capacities=(8, 64, 128, 256, 512)),
}


def _np_params(v):
    return jax.tree_util.tree_map(np.asarray, v["params"])


@pytest.fixture(scope="module", params=list(VARIANTS))
def pair(request):
    over = VARIANTS[request.param]
    cj = jcfg.tiny_test_config(use_pallas_attn=False, use_band_conv=False,
                               **over)
    ct = tcfg.tiny_test_config(**over)
    rng = np.random.default_rng(len(request.param))
    pts = rng.uniform(-1, 1, (2, cj.num_points, 3)).astype(np.float32)
    mask = np.ones(pts.shape[:2], bool)
    mask[1, 300:] = False
    jm = JModel(cj)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(mask))
    jout = jm.apply(v, jnp.asarray(pts), jnp.asarray(mask))
    tm = TModel(ct, device="cpu")
    tm.load_state_dict(params_from_jax(_np_params(v), tm))
    return request.param, jout, tm, pts, mask, v


@pytest.mark.parametrize("use_kernels", [True, False])
def test_descriptors_match_jax(pair, use_kernels):
    name, jout, tm, pts, mask, _ = pair
    tm.set_use_kernels(use_kernels)
    with torch.inference_mode():
        out = tm(torch.from_numpy(pts), torch.from_numpy(mask))
    g_j = np.asarray(jout["global"])
    g_t = out["global"].numpy()
    assert np.all(np.isfinite(g_t))
    cos = (g_j * g_t).sum(1)
    maxdiff = np.abs(g_j - g_t).max()
    assert cos.min() >= 0.9999, (name, cos, maxdiff)
    assert maxdiff <= 1e-4, (name, cos, maxdiff)
    assert int(out["octree_overflow"]) == int(jout["octree_overflow"])
    # no band tables, so no band-overflow counter to build
    assert set(out) == {"global", "octree_overflow"}


def test_embed_fn_dtypes(pair):
    _, jout, tm, pts, mask, _ = pair
    tm.set_use_kernels(True)
    p, m = torch.from_numpy(pts), torch.from_numpy(mask)
    g32 = make_embed_fn(tm, torch.float32)(p, m)["global"]
    np.testing.assert_allclose(g32.numpy(), np.asarray(jout["global"]),
                               atol=1e-4)
    gbf = make_embed_fn(tm, torch.bfloat16)(p, m)["global"]
    assert gbf.dtype == torch.float32 and torch.isfinite(gbf).all()
    np.testing.assert_allclose(gbf.norm(dim=1).numpy(), 1.0, atol=1e-5)
    assert next(tm.parameters()).dtype == torch.float32   # not mutated
    assert float((gbf * g32).sum(1).min()) > 0.99


def test_converter_uses_every_leaf_once(pair):
    _, _, tm, _, _, v = pair
    params = _np_params(v)
    sd = params_from_jax(params, tm)
    assert set(sd) == set(tm.state_dict())
    n_jax = sum(a.size for a in jax.tree_util.tree_leaves(params))
    assert sum(t.numel() for t in sd.values()) == n_jax
    # an extra leaf has nowhere to go; a missing one leaves a gap
    extra = dict(params, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError):
        params_from_jax(extra, tm)
    short = dict(params)
    short.pop("pooling")
    with pytest.raises(KeyError):
        params_from_jax(short, tm)


def test_converter_unstacks_scan_params(pair):
    _, _, tm, _, _, v = pair
    stacked = _np_params(v)["backbone"]["hotf_stage"]["iter"]
    sd = params_from_jax(_np_params(v), tm)
    qkv = stacked["rtsa"]["TokenAttention_0"]["qkv"]["kernel"]
    for i in range(qkv.shape[0]):
        np.testing.assert_array_equal(
            sd[f"backbone.hotf_stage.iters.{i}.rtsa.attn.qkv.weight"].numpy(),
            qkv[i].T)


def test_own_init_is_seeded_and_device_independent():
    cfg = tcfg.tiny_test_config()
    a = TModel(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    b = TModel(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    for (n, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), n
    q = a.pooling.attpool0.query
    assert 0.7 < float(q.detach().std()) < 1.3
    w = a.backbone.patch_embed.conv1.kernel
    fan_in = 27 * w.shape[1]
    assert abs(float(w.detach().std()) * np.sqrt(fan_in) - 1.0) < 0.2


# What the JAX package refuses too: unknown heads, norms and ADaPE
# modes, and the relay-token heads without relay tokens. Every option
# of tests/test_model.py's ablations runs (tests/test_torch_ablations.py).
@pytest.mark.parametrize("option", [
    dict(pooling="NetVLAD"), dict(pooling="GeM"),
    dict(pooling="PyramidAttnPoolGeM"), dict(conv_norm="groupnorm"),
    dict(conv_norm="instancenorm"), dict(adape_mode="mean"),
    dict(adape_mode="cov2"), dict(pooling="AttnPoolMixer", disable_rt=True),
    dict(pooling="AttnPoolGeM", disable_rt=True), dict(pooling="MinkLoc")])
def test_unsupported_options_raise(option):
    name = next(iter(option))
    with pytest.raises(NotImplementedError, match=name):
        TModel(tcfg.tiny_test_config(**option), device="cpu")


def test_retrieval_topk_matches_jax():
    rng = np.random.default_rng(4)
    db = rng.standard_normal((40, 16)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    q = db[:10] + rng.normal(0, 0.05, (10, 16)).astype(np.float32)
    dj, ij = jtopk(q, db, k=5)
    dt, it = ttopk(q, db, k=5, device="cpu")
    np.testing.assert_array_equal(ij, it)
    np.testing.assert_allclose(dj, dt, atol=1e-5)
    assert np.all(it[:, 0] == np.arange(10))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((ROOT / "hotformerloc_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = []
    for f in files:
        for mod in _imports(f):
            if mod.split(".")[0] in ("jax", "jaxlib", "flax",
                                     "hotformerloc_tpu"):
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad
