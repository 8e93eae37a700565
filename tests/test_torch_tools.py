"""The port's occupancy, visualisation and step-bisection tools
(hotformerloc_torch/tools, evaluation/visualise_embeddings.py) against
the JAX package's, on the CPU at tiny sizes:

* measure_occupancy: the numpy Morton encoder equals JAX's and the
  port's ``octree/morton.py``; per-cloud counts from the numpy route and
  from the port's octree build equal JAX's, and ``measure`` (counts per
  depth, suggested capacities, padding and overflow shares) equals
  JAX's on the same seeded clouds, both routes;
* visualise_windows: ``window_ids`` equals JAX's and inverts the port's
  ``data_to_windows``; ``octree_window_points`` gives JAX's node centres
  and windows;
* visualise_embeddings writes its t-SNE figure from a tiny model through
  ``load_model_embed_fn(device="cpu")``;
* bisect_step, plan_probe and component_profile run one stage each;
  asked for the CPU, their timing is the host clock and they report no
  device figure.
"""
import torch_threads  # noqa: F401  (first: one torch thread per worker)

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hotformerloc_tpu.models import config as jcfg
from hotformerloc_tpu.octree import morton as jmorton
from hotformerloc_tpu.tools import measure_occupancy as jocc
from hotformerloc_tpu.tools import visualise_windows as jvis
from hotformerloc_torch.config import params as tparams
from hotformerloc_torch.evaluation import visualise_embeddings as tve
from hotformerloc_torch.evaluation.pnv_evaluate import load_model_embed_fn
from hotformerloc_torch.models import config as tcfg
from hotformerloc_torch.octree import morton as tmorton
from hotformerloc_torch.ops.window import data_to_windows
from hotformerloc_torch.tools import bisect_step, component_profile
from hotformerloc_torch.tools import measure_occupancy as tocc
from hotformerloc_torch.tools import plan_probe
from hotformerloc_torch.tools import visualise_windows as tvis


def test_morton_encoder_equals_jax_and_port():
    rng = np.random.default_rng(0)
    xyz = rng.integers(0, 1024, (500, 3)).astype(np.int64)
    got = tocc.encode_np(xyz)
    np.testing.assert_array_equal(got, jocc.encode_np(xyz))
    np.testing.assert_array_equal(
        got, np.asarray(jmorton.encode(jnp.asarray(xyz, jnp.int32))))
    np.testing.assert_array_equal(
        got, tmorton.encode(torch.from_numpy(xyz).to(torch.int32)).numpy())
    pts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    np.testing.assert_array_equal(tocc.points_to_grid_np(pts, 7),
                                  jocc.points_to_grid_np(pts, 7))


@pytest.mark.parametrize("kind", ["uniform", "surface"])
def test_occupancy_equals_jax(kind):
    cj, ct = jcfg.tiny_test_config(), tcfg.tiny_test_config()
    clouds = tocc.synthetic_corpus(kind, 12, ct.num_points, seed=3)
    for a, b in zip(clouds, jocc.synthetic_corpus(kind, 12, cj.num_points,
                                                  seed=3)):
        np.testing.assert_array_equal(a, b)
    counts = np.stack([tocc.occupancy_counts(c, ct.octree_depth,
                                             ct.min_depth) for c in clouds])
    want = np.stack([jocc.occupancy_counts(c, cj.octree_depth, cj.min_depth)
                     for c in clouds])
    np.testing.assert_array_equal(counts, want)
    np.testing.assert_array_equal(
        tocc.octree_occupancy(clouds, ct, "cpu", batch=5), want)
    ref = jocc.measure(clouds, cj, 90.0, 1.2)
    assert tocc.measure(clouds, ct, 90.0, 1.2) == ref
    assert tocc.measure(clouds, ct, 90.0, 1.2, device="cpu") == ref
    assert ref["capacities"] != list(ct.resolve_capacities())


def test_window_ids_equal_jax_and_invert_data_to_windows():
    for K, D, N in ((8, 1, 64), (8, 2, 64), (4, 4, 96)):
        ids = tvis.window_ids(N, K, D)
        np.testing.assert_array_equal(ids, jvis.window_ids(N, K, D))
        w = data_to_windows(torch.arange(N)[None, :, None], K, D)[0, ..., 0]
        expect = np.empty(N, dtype=np.int64)
        for wi in range(w.shape[0]):
            expect[w[wi].numpy()] = wi
        np.testing.assert_array_equal(ids, expect)


def test_octree_window_points_equal_jax():
    pc = np.random.default_rng(1).uniform(-0.9, 0.9, (300, 3)).astype(
        np.float32)
    got = tvis.octree_window_points(pc, 5, 3, 8, 2)
    want = jvis.octree_window_points(pc, 5, 3, 8, 2)
    assert set(got) == set(want) == {3, 4, 5}
    for d in got:
        np.testing.assert_allclose(got[d][0], want[d][0], atol=1e-6)
        np.testing.assert_array_equal(got[d][1], want[d][1])


def test_visualise_embeddings_writes_figure(tmp_path):
    from test_torch_dist import P, _write_trainer_env
    data = tmp_path / "data"
    data.mkdir()
    train, model = _write_trainer_env(data)
    params = tparams.parse_train_config(train, model, num_points=P)
    embed, _ = load_model_embed_fn(params, None, device="cpu")
    out = tmp_path / "tsne.png"
    proj = tve.visualise_embeddings(embed, params, num_queries=3,
                                    query_min_distance=0.0,
                                    out_path=str(out))
    assert out.stat().st_size > 1000
    assert proj.shape == (6, 2) and np.all(np.isfinite(proj))


def _host_only(line):
    assert line["clock"] == "host" and line["wall_ms"] > 0
    assert line["device_ms"] is None and line["idle_share"] is None


def test_bisect_step_one_stage_on_cpu(capsys):
    lines = bisect_step.run(["--device", "cpu", "--tiny", "--stages",
                             "grad", "--iters", "1", "--batch", "4",
                             "--micro", "2"])
    assert [ln["stage"] for ln in lines] == ["grad"]
    _host_only(lines[0])
    printed = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert printed == lines
    with pytest.raises(ValueError):
        bisect_step.run(["--device", "cpu", "--stages", "nope"])


def test_plan_probe_one_kind_on_cpu():
    lines = plan_probe.run(["--device", "cpu", "--tiny", "--only", "child",
                            "--iters", "1", "--batch", "2"])
    cfg = tcfg.tiny_test_config()
    assert [ln["stage"] for ln in lines] == [
        f"child_d{d}" for d in range(cfg.min_depth + 1,
                                     cfg.octree_depth + 1)]
    for ln in lines:
        _host_only(ln)


def test_component_profile_one_experiment_on_cpu(tmp_path):
    out = tmp_path / "profile.json"
    lines, res = component_profile.run(
        ["--device", "cpu", "--tiny", "--exp", "band", "--iters", "1",
         "--out", str(out)])
    names = [next(iter(ln)) for ln in lines]
    assert names == ["band_dw_fwd_C32", "band_dw_bwd_C32",
                     "band_conv_fwd_C32_O32"]
    for ln in lines:
        (row,) = ln.values()
        assert row["maxdiff"] <= 1e-4 and row["ms"] > 0
        assert row["flat_ms"] > 0
    assert json.loads(out.read_text()) == res
    assert res["device"] == "cpu" and res["nvidia_smi"] is None
