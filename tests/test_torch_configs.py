"""The shipped model configurations in hotformerloc_torch against the JAX
package, on the CPU:

* each configs/*_model.txt parses to the same ModelConfig fields (and
  coordinates) in both packages and passes check_supported;
* cs_wild_places_config equals JAX's field by field;
* window_stats in its three modes ('pos', 'var', 'cov') equals JAX's;
* tiny-model descriptors against the JAX model (plain XLA paths:
  use_pallas_attn and use_band_conv off) with converted weights, at fp32,
  with the port's kernel routing on and off: cos >= 0.9999, max abs <=
  1e-4 (the bar of tests/test_torch_model.py). The variants: 64-token
  windows (64 + 1 relay slot in the H-OSA windows, with empty windows at
  depth 2), and ADaPE modes None (the relay-token CPE, shared or per
  level with projections), 'pos' and 'var';
* the converter maps every leaf of those variants once;
* model gradients with adape_mode=None against jax.grad, to the bar of
  tests/test_torch_train.py (|dg| <= 1e-3 |g_jax| + 1e-8): the
  relay-token CPE's dw_kernel and norm included;
* the train and evaluate CLIs run one tiny epoch and pnv_evaluate on
  the CS-Wild-Places and Wild-Places dataset settings and file layout
  (synthetic .pcd data).
"""
import torch_threads  # noqa: F401  (first: one torch thread per worker)

import dataclasses
import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hotformerloc_tpu.config.params import parse_model_config as jparse
from hotformerloc_tpu.losses import losses as jl
from hotformerloc_tpu.models import config as jcfg
from hotformerloc_tpu.models.hotformerloc import HOTFormerLoc as JModel
from hotformerloc_tpu.ops import window as jwin
from hotformerloc_torch.config.params import parse_model_config as tparse
from hotformerloc_torch.convert import params_from_jax
from hotformerloc_torch.losses import losses as tl
from hotformerloc_torch.models import config as tcfg
from hotformerloc_torch.models.hotformerloc import HOTFormerLoc as TModel
from hotformerloc_torch.ops import window as twin

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODEL_FILES = sorted(p.name for p in (ROOT / "configs").glob("*_model.txt"))


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_four_model_files_shipped():
    assert MODEL_FILES == ["cs-campus3d_model.txt", "cs-wild-places_model.txt",
                           "oxford_model.txt", "wild-places_model.txt"]


@pytest.mark.parametrize("name", MODEL_FILES)
def test_model_file_parses_like_jax(name):
    path = str(ROOT / "configs" / name)
    # the train configs of these datasets set octree_depth 9 (Oxford) or 7
    depth = 9 if name.startswith("oxford") else 7
    j = jparse(path, octree_depth=depth)
    t = tparse(path, octree_depth=depth)
    assert _fields(t.config) == _fields(j.config)
    assert t.coordinates == j.coordinates
    tcfg.check_supported(t.config)


def test_cs_wild_places_config_equals_jax():
    assert _fields(tcfg.cs_wild_places_config()) == _fields(
        jcfg.cs_wild_places_config())
    over = dict(grad_checkpoint=False, k_pooled_tokens=(148, 72, 36))
    assert _fields(tcfg.cs_wild_places_config(**over)) == _fields(
        jcfg.cs_wild_places_config(**over))
    # the model file of the same dataset gives the same model
    f = tparse(str(ROOT / "configs" / "cs-wild-places_model.txt"),
               octree_depth=7).config
    assert f.resolve_capacities() == \
        tcfg.cs_wild_places_config().resolve_capacities()
    assert (f.patch_size, f.dilation, f.octree_depth) == (64, 4, 7)


def test_wild_places_model_has_relay_token_cpe():
    """Wild-Places has no ADaPE line: the port builds the shared
    relay-token CPE at the pyramid width and no ADaPE."""
    cfg = tparse(str(ROOT / "configs" / "wild-places_model.txt"),
                 octree_depth=7).config
    assert cfg.adape_mode is None and not cfg.use_projections
    m = TModel(dataclasses.replace(cfg, num_blocks=(1, 1)), device="cpu")
    names = {n for n, _ in m.named_parameters()}
    assert "backbone.hotf_stage.rt_init_cpe.dw_kernel" in names
    assert m.backbone.hotf_stage.rt_init_cpe.dw_kernel.shape == (27, 256, 1)
    assert not any("adape" in n for n in names)


@pytest.mark.parametrize("mode", ["pos", "var", "cov"])
def test_window_stats_matches_jax(mode):
    rng = np.random.default_rng(len(mode))
    depth, K = 4, 8
    xyz = rng.integers(0, 2 ** depth, (2, 64, 3)).astype(np.int32)
    valid = rng.random((2, 64)) < 0.7
    valid[0, :8] = False               # an empty window
    valid[1, 8:15] = False             # a window of one node
    want = np.asarray(jwin.window_stats(jnp.asarray(xyz), jnp.asarray(valid),
                                        depth, K, mode))
    got = twin.window_stats(torch.from_numpy(xyz), torch.from_numpy(valid),
                            depth, K, mode).numpy()
    assert got.shape == want.shape == (2, 8, {"pos": 3, "var": 6,
                                               "cov": 9}[mode])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.all(got[0, 0] == 0.0) and np.all(got[1, 1, 3:] == 0.0)


# -- descriptors against the JAX model ---------------------------------------

VARIANTS = {
    "patch64": dict(patch_size=64),
    "adape_none": dict(adape_mode=None),
    "adape_none_proj": dict(adape_mode=None, dense_cpe_max_depth=0,
                            channels=(32, 64, 64), num_heads=(2, 4, 4)),
    "adape_pos": dict(adape_mode="pos"),
    "adape_var": dict(adape_mode="var"),
}


def _np_params(v):
    return jax.tree_util.tree_map(np.asarray, v["params"])


@pytest.fixture(scope="module", params=list(VARIANTS))
def pair(request):
    over = VARIANTS[request.param]
    cj = jcfg.tiny_test_config(use_pallas_attn=False, use_band_conv=False,
                               **over)
    rng = np.random.default_rng(7 + len(request.param))
    pts = rng.uniform(-1, 1, (2, cj.num_points, 3)).astype(np.float32)
    mask = np.ones(pts.shape[:2], bool)
    mask[1, 300:] = False
    jm = JModel(cj)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(mask))
    jout = jm.apply(v, jnp.asarray(pts), jnp.asarray(mask))
    tm = TModel(tcfg.tiny_test_config(**over), device="cpu")
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


def test_converter_maps_every_leaf_once(pair):
    name, _, tm, _, _, v = pair
    params = _np_params(v)
    sd = params_from_jax(params, tm)
    assert set(sd) == set(tm.state_dict())
    n_jax = sum(a.size for a in jax.tree_util.tree_leaves(params))
    assert sum(t.numel() for t in sd.values()) == n_jax
    hotf = params["backbone"]["hotf_stage"]
    if name == "adape_none":
        # one shared CPE, used at every level, converted once
        assert "rt_init_cpe" in hotf and "rt_adape" not in hotf
    elif name == "adape_none_proj":
        assert {"rt_init_cpe0", "rt_init_cpe1"} <= set(hotf)
        assert not any(k.startswith("adape_proj") for k in hotf)
    elif name.startswith("adape_"):
        width = {"adape_pos": 3, "adape_var": 6}[name]
        assert hotf["rt_adape"]["Mlp_0"]["fc1"]["kernel"].shape[0] == width
    short = {k: v for k, v in hotf.items() if not k.startswith("rt_")}
    with pytest.raises(KeyError):
        params_from_jax(dict(params, backbone=dict(params["backbone"],
                                                   hotf_stage=short)), tm)


# -- gradients without ADaPE against jax.grad ---------------------------------


def _batch(rng, B, P):
    base = rng.uniform(-0.8, 0.8, size=(B // 2, P, 3)).astype(np.float32)
    pts = np.repeat(base, 2, axis=0)
    pts = pts + rng.normal(0, 0.01, size=pts.shape).astype(np.float32)
    groups = np.repeat(np.arange(B // 2), 2)
    return {"points": pts, "pmask": np.ones((B, P), bool),
            "positives_mask": (groups[:, None] == groups[None])
            & ~np.eye(B, dtype=bool),
            "negatives_mask": groups[:, None] != groups[None]}


@pytest.fixture(scope="module")
def grad_pair():
    over = dict(drop_path=0.0, num_points=256, adape_mode=None)
    cj = jcfg.tiny_test_config(use_pallas_attn=False, use_band_conv=False,
                               **over)
    b = _batch(np.random.default_rng(23), 4, 256)
    b["pmask"][3, 200:] = False
    jm = JModel(cj)
    args = [jnp.asarray(b[k]) for k in ("points", "pmask")]
    v = jm.init(jax.random.PRNGKey(2), *args)
    loss_fn = jl.make_loss("truncatedsmoothap", positives_per_query=1)

    def loss_of(params):
        out = jm.apply({"params": params}, *args)
        return loss_fn(out["global"], jnp.asarray(b["positives_mask"]),
                       jnp.asarray(b["negatives_mask"]))[0]

    jloss, jgrad = jax.jit(jax.value_and_grad(loss_of))(v["params"])
    tm = TModel(tcfg.tiny_test_config(**over), device="cpu")
    tm.load_state_dict(params_from_jax(_np_params(v), tm))
    gref = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrad), tm)
    return tm, b, float(jloss), gref


@pytest.mark.parametrize("use_kernels", [True, False])
def test_grads_without_adape_match_jax(grad_pair, use_kernels):
    tm, b, jloss, gref = grad_pair
    tm.set_use_kernels(use_kernels)
    tm.train()
    tm.zero_grad(set_to_none=True)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    out = tm(tb["points"], tb["pmask"])
    loss, _ = tl.truncated_smoothap(out["global"], tb["positives_mask"],
                                    tb["negatives_mask"],
                                    positives_per_query=1)
    loss.backward()
    tm.eval()
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-5)
    assert set(gref) == {n for n, _ in tm.named_parameters()}
    assert "backbone.hotf_stage.rt_init_cpe.dw_kernel" in gref
    bad = []
    for name, p in tm.named_parameters():
        d = float((p.grad - gref[name]).norm())
        lim = 1e-3 * float(gref[name].norm()) + 1e-8
        if not d <= lim:
            bad.append((name, d, lim))
    assert not bad, bad[:5]
    assert float(tm.backbone.hotf_stage.rt_init_cpe.dw_kernel.grad.norm()) > 0


# -- the train and evaluate CLIs on the Wild-Places datasets ------------------

TINY_MODEL = """[MODEL]
model = HOTFormerLoc-Test
channels = 16,32
num_blocks = 1,1
num_heads = 2,2
num_pyramid_levels = 2
num_octf_levels = 1
ct_size = 1
{adape}patch_size = 8
dilation = 2
input_features = P
downsample_input_embeddings = True
num_input_downsamples = 1
grad_checkpoint = True
conv_norm = layernorm
feature_size = 32
output_dim = 32
pooling = PyramidAttnPoolMixer
k_pooled_tokens = 12,4
coordinates = {coordinates}
normalize_embeddings = True
"""


@pytest.mark.parametrize("name,dataset", [("cs-wild-places", "CSWildPlaces"),
                                          ("wild-places", "WildPlaces")])
def test_train_and_evaluate_clis_on_wild_places_data(tmp_path, name,
                                                     dataset):
    """configs/<name>.txt's settings (normalize_points, MESA, skip_same_run,
    validation with val_file for CS-Wild-Places, cylindrical coordinates
    for Wild-Places) with a tiny model of the shipped model file's ADaPE
    mode and coordinates, on chip_smoke.py's synthetic .pcd dataset at
    256 points: one epoch of the train CLI with its evaluation, then
    pnv_evaluate on the final checkpoint, which must report every
    location of the dataset and the in-training average."""
    import configparser
    import importlib.util

    from hotformerloc_torch.evaluation import pnv_evaluate
    from hotformerloc_torch.training import train as train_cli
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    cp = configparser.ConfigParser()
    cp.read(ROOT / "configs" / f"{name}.txt")
    tr = cp["TRAIN"]
    data = tmp_path / "data"
    locs = smoke.write_wild_dataset(str(data), dataset, tr["train_file"],
                                    tr.get("val_file"), n_locs=6, n_eval=3,
                                    points=256)
    cp["DEFAULT"]["dataset_folder"] = str(data)
    tr.update(batch_size="8", batch_split_size="4", val_batch_size="8",
              epochs="1", eval_freq="1", save_freq="1", octree_depth="5",
              num_workers="0")
    cfg_path = tmp_path / "train.txt"
    with open(cfg_path, "w") as f:
        cp.write(f)
    shipped = tparse(str(ROOT / "configs" / f"{name}_model.txt"))
    adape = shipped.config.adape_mode
    model_cfg = tmp_path / "model.txt"
    model_cfg.write_text(TINY_MODEL.format(
        adape=f"ADaPE_mode = {adape}\n" if adape else "",
        coordinates=shipped.coordinates))
    common = ["--config", str(cfg_path), "--model_config", str(model_cfg),
              "--num_points", "256", "--device", "cpu"]
    trainer = train_cli.main(common + ["--weights_dir", str(tmp_path / "w"),
                                       "--model_name", "t"])
    p = trainer.params
    assert p.dataset_name == dataset
    assert p.model_params.coordinates == shipped.coordinates
    assert trainer.model.cfg.adape_mode == adape
    if dataset == "CSWildPlaces":
        assert p.normalize_points and p.mesa == 1.0 and p.skip_same_run
        assert trainer.val_loader is not None
    with open(os.path.join(trainer.weights_dir, "t_log.jsonl")) as f:
        log = [json.loads(ln) for ln in f]
    phases = [r["phase"] for r in log]
    assert phases.count("train") == 1 and phases.count("eval") == 1
    assert ("val" in phases) == (dataset == "CSWildPlaces")
    for r in log:
        if r["phase"] == "val":
            assert np.isfinite(r["val_loss"])
    assert all(np.isfinite(r["loss"]) for r in log if r["phase"] == "train")
    final = trainer.ckpt_path("final")
    trainer.close()
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        stats = pnv_evaluate.main(common + ["--weights", final])
    finally:
        os.chdir(cwd)
    assert set(stats) == set(locs) | {"average"}
    ev = next(r for r in log if r["phase"] == "eval")
    assert float(stats["average"]["ave_recall"][0]) == ev["avg_AR1"]
