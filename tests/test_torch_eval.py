"""The port's evaluator against the JAX package's, on the CPU.

* get_recall / evaluate / evaluate_splits on synthetic Oxford-format
  pickles with one deterministic numpy embed_fn: the same stats exactly,
  and the same forensics logs (log=True) byte for byte;
* get_latent_vectors of tiny_test_config with the JAX weights carried by
  params_from_jax, against JAX's on the same sets: the repo's fp32 bar
  (cos >= 0.9999, max abs <= 1e-4);
* the port's unpadded last chunk against padding it as JAX does: equal
  descriptors (max abs <= 1e-6);
* pnv_evaluate's main on a saved state_dict equals evaluate() on the
  model it came from.
"""
import torch_threads  # noqa: F401  (first: one torch thread per worker)

import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hotformerloc_tpu.config import params as jparams
from hotformerloc_tpu.evaluation import evaluate as je
from hotformerloc_tpu.evaluation import evaluate_splits as jes
from hotformerloc_tpu.models import config as jcfg
from hotformerloc_tpu.models.hotformerloc import HOTFormerLoc as JModel
from hotformerloc_torch.config import params as tparams
from hotformerloc_torch.convert import params_from_jax
from hotformerloc_torch.evaluation import evaluate as te
from hotformerloc_torch.evaluation import evaluate_splits as tes
from hotformerloc_torch.evaluation import pnv_evaluate as tpe
from hotformerloc_torch.evaluation.embed import make_embed_fn
from hotformerloc_torch.models import config as tcfg
from hotformerloc_torch.models.hotformerloc import HOTFormerLoc as TModel

P = 256
LOCS = ("oxford", "university", "residential", "business")


@pytest.fixture(scope="module")
def oxford_sets(tmp_path_factory):
    """The four Oxford splits: per location 3 runs of 5 places (PNV .bin
    clouds, each run a noisy copy of the place's base cloud); a query's
    true neighbours are the same place in the other runs, one place has
    none in run 0."""
    root = tmp_path_factory.mktemp("oxford_eval")
    rng = np.random.default_rng(3)
    for loc in LOCS:
        bases = rng.uniform(-0.9, 0.9, (5, P, 3))
        dbs, qs = [], []
        for run in range(3):
            db, q = {}, {}
            for j in range(5):
                rel = f"{loc}_{run}_{j}.bin"
                (bases[j] + rng.normal(0, 0.4, (P, 3))).astype(
                    np.float64).tofile(root / rel)
                pos = {"query": rel, "northing": 100.0 * j + run,
                       "easting": 2.0 * run}
                db[j] = dict(pos)
                q[j] = {**pos, **{m: [j] for m in range(3)
                                  if m != run and not (m == 0 and j == 4)}}
            dbs.append(db)
            qs.append(q)
        for kind, sets in (("database", dbs), ("query", qs)):
            with open(root / f"{loc}_evaluation_{kind}.pickle", "wb") as f:
                pickle.dump(sets, f)
    return str(root)


def _params(mod, root, cfg, bs=4):
    return mod.TrainParams(
        dataset_folder=root, val_batch_size=bs, dataset_name="Oxford",
        model_params=mod.FullModelParams(config=cfg))


_W = np.random.default_rng(0).standard_normal((3, 64)).astype(np.float32)


def _np_embed(points, pmask):
    """Per cloud: the masked mean of tanh(points @ W), unit length."""
    p, m = np.asarray(points), np.asarray(pmask)[..., None]
    f = (np.tanh(p @ _W) * m).sum(1) / np.maximum(m.sum(1), 1)
    return f / np.linalg.norm(f, axis=1, keepdims=True)


def _same_stats(a, b):
    """Equal nested stats dicts: same keys in the same order, equal
    leaves."""
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same_stats(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_evaluate_stats_and_logs_equal_jax(oxford_sets, tmp_path,
                                           monkeypatch):
    jp = _params(jparams, oxford_sets, jcfg.tiny_test_config(num_points=P))
    tp = _params(tparams, oxford_sets, tcfg.tiny_test_config(num_points=P))
    out = {}
    for name, mod, params, kw in (("jax", je, jp, {}),
                                  ("torch", te, tp, {"device": "cpu"})):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        out[name] = mod.evaluate(_np_embed, params, log=True,
                                 model_name="m", **kw)
    _same_stats(out["jax"], out["torch"])
    assert 0 < out["torch"]["average"]["ave_recall"][0] < 100
    for log in ("m_log_fp.txt", "m_log_search_results.txt"):
        a = (tmp_path / "jax" / log).read_text()
        assert a and a == (tmp_path / "torch" / log).read_text()


def test_get_recall_and_splits_equal_jax(oxford_sets):
    jp = _params(jparams, oxford_sets, jcfg.tiny_test_config(num_points=P))
    tp = _params(tparams, oxford_sets, tcfg.tiny_test_config(num_points=P))
    with open(os.path.join(oxford_sets,
                           "university_evaluation_database.pickle"),
              "rb") as f:
        dbs = pickle.load(f)
    with open(os.path.join(oxford_sets,
                           "university_evaluation_query.pickle"),
              "rb") as f:
        qs = pickle.load(f)
    dv = [te.get_latent_vectors(_np_embed, s, tp) for s in dbs]
    qv = [te.get_latent_vectors(_np_embed, s, tp) for s in qs]
    for m in range(3):
        for n in range(3):
            a = je.get_recall(m, n, dv, qv, qs, dbs)
            b = te.get_recall(m, n, dv, qv, qs, dbs, device="cpu")
            for x, y in zip(a, b):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    _same_stats(jes.evaluate_splits(_np_embed, jp),
                tes.evaluate_splits(_np_embed, tp, device="cpu"))


@pytest.fixture(scope="module")
def tiny_pair():
    cj = jcfg.tiny_test_config(use_pallas_attn=False, use_band_conv=False,
                               num_points=P)
    ct = tcfg.tiny_test_config(num_points=P)
    jm = JModel(cj)
    pts = jnp.zeros((2, P, 3), jnp.float32)
    v = jax.jit(jm.init)(jax.random.PRNGKey(1), pts, jnp.ones((2, P), bool))
    tm = TModel(ct, device="cpu")
    tm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, v["params"]), tm))
    return cj, ct, jm, v, tm


def test_latent_vectors_match_jax(oxford_sets, tiny_pair):
    cj, ct, jm, v, tm = tiny_pair
    jp = _params(jparams, oxford_sets, cj, bs=3)
    tp = _params(tparams, oxford_sets, ct, bs=3)
    jembed = jax.jit(lambda p, m: jm.apply(v, p, m)["global"])
    tembed = make_embed_fn(tm, torch.float32)
    with open(os.path.join(oxford_sets, "oxford_evaluation_database.pickle"),
              "rb") as f:
        dbs = pickle.load(f)
    for s in dbs[:2]:
        a = je.get_latent_vectors(jembed, s, jp)
        b = te.get_latent_vectors(lambda p, m: tembed(p, m)["global"], s, tp)
        assert a.shape == b.shape == (5, ct.output_dim)
        cos = (a * b).sum(1)
        assert cos.min() >= 0.9999, cos
        assert np.abs(a - b).max() <= 1e-4


def test_unpadded_chunks_equal_padded(oxford_sets, tiny_pair):
    *_, tm = tiny_pair
    tp = _params(tparams, oxford_sets, tcfg.tiny_test_config(num_points=P),
                 bs=3)
    tembed = make_embed_fn(tm, torch.float32)
    sizes = []

    def unpadded(p, m):
        sizes.append(p.shape[0])
        return tembed(p, m)["global"]

    def padded(p, m):                    # the JAX package's padding
        n = p.shape[0]
        rep = tp.val_batch_size - n
        p = torch.cat([p, p[-1:].expand(rep, -1, -1)])
        m = torch.cat([m, m[-1:].expand(rep, -1)])
        return tembed(p, m)["global"][:n]

    with open(os.path.join(oxford_sets, "business_evaluation_query.pickle"),
              "rb") as f:
        s = pickle.load(f)[1]
    a = te.get_latent_vectors(unpadded, s, tp)
    b = te.get_latent_vectors(padded, s, tp)
    assert sizes == [3, 2]                     # 5 clouds, chunks of 3
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_pnv_evaluate_main_equals_evaluate(oxford_sets, tiny_pair, tmp_path,
                                           monkeypatch):
    *_, tm = tiny_pair
    monkeypatch.chdir(tmp_path)
    torch.save(tm.state_dict(), tmp_path / "w.pt")
    train_cfg = tmp_path / "train.txt"
    train_cfg.write_text(f"[DEFAULT]\ndataset_folder = {oxford_sets}\n\n"
                         "[TRAIN]\nval_batch_size = 8\ndataset_name = Oxford\n"
                         "octree_depth = 6\n")
    model_cfg = tmp_path / "model.txt"
    c = tcfg.tiny_test_config(num_points=P)
    model_cfg.write_text(
        "[MODEL]\nchannels = 32,64\nnum_blocks = 2,2\nnum_heads = 2,4\n"
        "num_pyramid_levels = 2\npatch_size = 8\ndilation = 2\n"
        "conv_norm = layernorm\nADaPE_mode = cov\nfeature_size = 64\n"
        "output_dim = 64\npooling = PyramidAttnPoolMixer\n"
        "k_pooled_tokens = 12,4\nnormalize_embeddings = True\n"
        "grad_checkpoint = False\n")
    params = tparams.parse_train_config(str(train_cfg), str(model_cfg),
                                        num_points=P)
    assert dataclasses.replace(params.model_params.config,
                               model=c.model) == c
    stats = tpe.main(["--config", str(train_cfg), "--model_config",
                      str(model_cfg), "--weights", str(tmp_path / "w.pt"),
                      "--num_points", str(P), "--device", "cpu"])
    embed = make_embed_fn(tm, torch.float32)
    want = te.evaluate(lambda p, m: embed(p, m)["global"], params,
                       device="cpu")
    _same_stats(stats, want)
    assert (tmp_path / "pnv_Oxford_results.txt").exists()
