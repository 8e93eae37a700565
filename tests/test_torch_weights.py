"""Reference weights into hotformerloc_torch
(tools/convert_reference_weights.py) against the JAX package's
converter, on the CPU:

* the port's copy of ``synthesize_reference_state_dict`` equals JAX's
  (keys and values), and the port's converted state_dict equals
  ``params_from_jax`` of JAX's ``convert_state_dict`` tensor for tensor,
  exactly, on tiny_test_config and on each shipped configs/*_model.txt
  (the model built on the CPU, no forward); every reference key is used;
* fp32 descriptors of the JAX model with JAX-converted weights against
  the port with port-converted weights (tiny_test_config, JAX's XLA
  paths): cosine >= 0.9999 and max abs <= 1e-4;
* a missing reference key raises KeyError; ``validate`` raises on a
  missing, an extra or a mis-shaped key;
* the CLI's ``--out`` file loads through ``pnv_evaluate``'s
  ``load_model_embed_fn(device="cpu")`` and embeds as the converted
  weights do.
"""
import torch_threads  # noqa: F401  (first: one torch thread per worker)

import glob
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hotformerloc_tpu.config import params as jparams
from hotformerloc_tpu.models import config as jcfg
from hotformerloc_tpu.models.hotformerloc import HOTFormerLoc as JModel
from hotformerloc_tpu.tools import convert_reference_weights as jconv
from hotformerloc_torch.config import params as tparams
from hotformerloc_torch.convert import params_from_jax
from hotformerloc_torch.evaluation.pnv_evaluate import load_model_embed_fn
from hotformerloc_torch.models import config as tcfg
from hotformerloc_torch.models.hotformerloc import HOTFormerLoc as TModel
from hotformerloc_torch.tools import convert_reference_weights as tconv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = sorted(glob.glob(os.path.join(REPO, "configs", "*_model.txt")))
CONFIGS = ["tiny"] + [os.path.basename(p) for p in SHIPPED]


def _configs(name):
    if name == "tiny":
        return jcfg.tiny_test_config(), tcfg.tiny_test_config()
    path = os.path.join(REPO, "configs", name)
    return (jparams.parse_model_config(path).config,
            tparams.parse_model_config(path).config)


@pytest.mark.parametrize("name", CONFIGS)
def test_converted_state_equals_jax_route(name, capsys):
    cj, ct = _configs(name)
    sd = tconv.synthesize_reference_state_dict(ct, seed=3)
    sd_j = jconv.synthesize_reference_state_dict(cj, seed=3)
    assert list(sd) == list(sd_j)
    for k, v in sd.items():
        np.testing.assert_array_equal(v, sd_j[k], err_msg=k)
    model = TModel(ct, device="cpu")
    got = tconv.convert_state_dict(dict(sd), ct)
    tconv.validate(got, model)
    want = params_from_jax(jconv.convert_state_dict(dict(sd), cj), model)
    assert set(got) == set(want) == set(model.state_dict())
    for k, w in want.items():
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], w), k
    assert "WARNING" not in capsys.readouterr().out


def test_descriptors_match_jax_converted():
    cj = jcfg.tiny_test_config(use_pallas_attn=False, use_band_conv=False)
    ct = tcfg.tiny_test_config()
    sd = tconv.synthesize_reference_state_dict(ct, seed=1)
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1, 1, (2, cj.num_points, 3)).astype(np.float32)
    mask = np.ones(pts.shape[:2], bool)
    mask[1, 300:] = False
    jp = jax.tree_util.tree_map(jnp.asarray,
                                jconv.convert_state_dict(dict(sd), cj))
    jout = np.asarray(JModel(cj).apply({"params": jp}, jnp.asarray(pts),
                                       jnp.asarray(mask))["global"])
    tm = TModel(ct, device="cpu")
    tm.load_state_dict(tconv.convert_state_dict(dict(sd), ct))
    with torch.inference_mode():
        got = tm(torch.from_numpy(pts), torch.from_numpy(mask))["global"]
    got = got.numpy()
    cos = (got * jout).sum(1) / (np.linalg.norm(got, axis=1)
                                 * np.linalg.norm(jout, axis=1))
    assert np.all(np.isfinite(got))
    assert cos.min() >= 0.9999 and np.abs(got - jout).max() <= 1e-4, (
        cos, np.abs(got - jout).max())


def test_missing_extra_and_misshaped_keys_raise():
    ct = tcfg.tiny_test_config()
    sd = tconv.synthesize_reference_state_dict(ct)
    del sd["backbone.backbone.patch_embed.proj.conv.weights"]
    with pytest.raises(KeyError, match="patch_embed.proj.conv.weights"):
        tconv.convert_state_dict(sd, ct)
    model = TModel(ct, device="cpu")
    good = tconv.convert_state_dict(tconv.synthesize_reference_state_dict(
        ct), ct)
    name = "pooling.mixer.row_proj.weight"
    for state in ({k: v for k, v in good.items() if k != name},
                  dict(good, stray=torch.zeros(2)),
                  dict(good, **{name: good[name].t()})):
        with pytest.raises(ValueError, match="mismatch"):
            tconv.validate(state, model)


MODEL_TXT = """[MODEL]
model = HOTFormerLoc-Test
channels = 16,32
num_blocks = 1,1
num_heads = 2,2
num_pyramid_levels = 2
num_octf_levels = 1
ct_size = 1
ADaPE_mode = cov
patch_size = 8
dilation = 2
input_features = P
downsample_input_embeddings = True
num_input_downsamples = 1
conv_norm = layernorm
feature_size = 32
output_dim = 32
pooling = PyramidAttnPoolMixer
k_pooled_tokens = 12,4
coordinates = cartesian
normalize_embeddings = True
"""


def test_cli_out_loads_through_pnv_evaluate(tmp_path, capsys):
    (tmp_path / "model.txt").write_text(MODEL_TXT)
    cfg = tparams.parse_model_config(str(tmp_path / "model.txt"),
                                     octree_depth=5, num_points=256).config
    sd = tconv.synthesize_reference_state_dict(cfg, seed=4)
    ref = str(tmp_path / "reference.ckpt")      # the "model" key form
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()},
                "epoch": 3}, ref)
    out = str(tmp_path / "converted.pt")
    state = tconv.main(["--weights", ref, "--model_config",
                        str(tmp_path / "model.txt"), "--octree_depth", "5",
                        "--num_points", "256", "--out", out])
    assert "converted" in capsys.readouterr().out
    params = types.SimpleNamespace(
        model_params=types.SimpleNamespace(config=cfg))
    embed, name = load_model_embed_fn(params, out, device="cpu")
    assert name == "converted"
    rng = np.random.default_rng(5)
    pts = torch.from_numpy(rng.uniform(-0.9, 0.9, (2, 256, 3)).astype(
        np.float32))
    mask = torch.ones(2, 256, dtype=torch.bool)
    m = TModel(cfg, device="cpu")
    m.load_state_dict(state)
    with torch.inference_mode():
        want = m(pts, mask)["global"]
        got = embed(pts, mask)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
