"""The port's dataset-preparation tools and its window-attention A/B
(hotformerloc_torch/tools) against the JAX package's, on the CPU at
small sizes. Both packages' tools are numpy over the same
native/pointops.cpp (each package loads its own build), so every
comparison is exact:

* geometry: polygons, circles, ``any_contains``; ``radius_query`` at UTM
  scale on the native route and, with both packages' native libraries
  refused, on the same fallback;
* preprocess: each function, CSF on a small cloud, the quaternion round
  trip, the worker pool;
* fix_broken_timestamps (both tools): the output CSVs byte for byte;
  postprocess_submaps: the written .pcd files byte for byte;
* the tuple builders (pnv, Wild-Places, CS-Wild-Places, CS-Campus3D):
  every pickle they write, loaded through each package's
  ``load_pickle_compat`` in both directions, and the ground truth the
  synthetic trees were built with (chip_smoke.py's writers and checks,
  which the card's ``prep`` and ``entry`` phases run);
* ground_aerial_overlap, visualise_positives' ``pick_positive`` under a
  seed, loader_bench (its keys; it writes only its ``--out``);
* pallas_ab: its inputs are the JAX tool's; both routes agree at fp32 on
  the CPU; ``main`` writes only its ``--out``;
* chip_smoke.py's ``prep`` phase end to end on the CPU.
"""
import torch_threads  # noqa: F401  (first: one torch thread per worker)

import os
import shutil
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from hotformerloc_tpu.data import native as jnative
from hotformerloc_tpu.data import tuples as jtuples
from hotformerloc_tpu.tools import cscampus3d_convert as jcampus
from hotformerloc_tpu.tools import cswildplaces_tuples as jcs
from hotformerloc_tpu.tools import fix_broken_timestamps as jfix
from hotformerloc_tpu.tools import geometry as jgeo
from hotformerloc_tpu.tools import ground_aerial_overlap as jgao
from hotformerloc_tpu.tools import pnv_tuples as jpnv
from hotformerloc_tpu.tools import postprocess_submaps as jpp
from hotformerloc_tpu.tools import preprocess as jpre
from hotformerloc_tpu.tools import visualise_positives as jvp
from hotformerloc_tpu.tools import wildplaces_tuples as jwild
from hotformerloc_tpu.utils.seed import set_seed as jset_seed
from hotformerloc_torch.data import loaders as tloaders
from hotformerloc_torch.data import native as tnative
from hotformerloc_torch.data import tuples as ttuples
from hotformerloc_torch.tools import cscampus3d_convert as tcampus
from hotformerloc_torch.tools import cswildplaces_tuples as tcs
from hotformerloc_torch.tools import fix_broken_timestamps as tfix
from hotformerloc_torch.tools import geometry as tgeo
from hotformerloc_torch.tools import ground_aerial_overlap as tgao
from hotformerloc_torch.tools import loader_bench as tlb
from hotformerloc_torch.tools import pallas_ab as tab
from hotformerloc_torch.tools import pnv_tuples as tpnv
from hotformerloc_torch.tools import postprocess_submaps as tpp
from hotformerloc_torch.tools import preprocess as tpre
from hotformerloc_torch.tools import visualise_positives as tvp
from hotformerloc_torch.tools import wildplaces_tuples as twild
from hotformerloc_torch.utils.seed import set_seed as tset_seed

LOADS = {"jax": jtuples.load_pickle_compat, "torch": ttuples.load_pickle_compat}
TUPLE_MODULES = {"jax": "hotformerloc_tpu.data.tuples",
                 "torch": "hotformerloc_torch.data.tuples"}


def _records(obj):
    if isinstance(obj, dict):
        for v in obj.values():
            yield from _records(v)
    elif isinstance(obj, list):
        for v in obj:
            yield from _records(v)
    elif hasattr(obj, "__dict__"):
        yield obj


def assert_same_pickles(jdir, tdir, names=None):
    """Every pickle (or ``names``) the JAX tool wrote under ``jdir`` equals
    the port's under ``tdir``, each read by both packages'
    ``load_pickle_compat``, which map either package's records onto
    their own."""
    if names is None:
        names = sorted(n for n in os.listdir(jdir) if n.endswith(".pickle"))
        assert names == sorted(n for n in os.listdir(tdir)
                               if n.endswith(".pickle"))
    assert names
    for name in names:
        views = {(pkg, side): load(os.path.join(d, name))
                 for pkg, load in LOADS.items()
                 for side, d in (("jax", jdir), ("torch", tdir))}
        first = views[("jax", "jax")]
        for key, v in views.items():
            assert chip_smoke.same(first, v), (name, key)
            assert {type(r).__module__ for r in _records(v)} <= \
                {TUPLE_MODULES[key[0]]}, (name, key)


def run_main(monkeypatch, module, *argv):
    monkeypatch.setattr(sys, "argv", ["prog", *map(str, argv)])
    return module.main()


def same_files(a, b, suffixes):
    """Relative paths of the files under a with a suffix; each equal in
    bytes to b's."""
    rels = sorted(os.path.relpath(os.path.join(d, f), a)
                  for d, _, fs in os.walk(a) for f in fs
                  if f.endswith(suffixes))
    for rel in rels:
        with open(os.path.join(a, rel), "rb") as fa, \
                open(os.path.join(b, rel), "rb") as fb:
            assert fa.read() == fb.read(), rel
    return rels


# ---- geometry ---------------------------------------------------------

def test_geometry_regions_equal_jax():
    rng = np.random.default_rng(0)
    regions = []
    for g in (jgeo, tgeo):
        regions.append([*(g.Polygon(p.pts) for p in jwild.POLY_VENMAN),
                        g.make_circle(-63, 40), g.Circle(10.0, -5.0, 12.5)])
    pts = np.concatenate([rng.uniform(-500, 200, (300, 2)),
                          [[-468, -82], [-62, 0], [-63, 40], [10, 7.5]]])
    for jr, tr in zip(*regions):
        np.testing.assert_array_equal(np.stack(jr.exterior_xy),
                                      np.stack(tr.exterior_xy))
        for x, y in pts:
            assert jr.contains(x, y) == tr.contains(x, y)
            if isinstance(jr, jgeo.Polygon):
                assert jr.distance(x, y) == tr.distance(x, y)
                assert jr.buffer_contains(x, y, 30.0) == \
                    tr.buffer_contains(x, y, 30.0)
    assert [jgeo.any_contains(regions[0], x, y) for x, y in pts] == \
        [tgeo.any_contains(regions[1], x, y) for x, y in pts]


@pytest.mark.parametrize("route", ["native", "fallback"])
def test_radius_query_utm_equals_jax(route, monkeypatch):
    """As tests/test_tools.py holds JAX's: UTM-magnitude coordinates
    against float64 brute force, and the port against JAX on the same
    route."""
    if route == "native":
        assert tnative.load_library() is not None
        assert jnative.load_library(build_if_missing=False) is not None
    else:
        monkeypatch.setattr(tnative, "load_library", lambda *a, **k: None)
        monkeypatch.setattr(jnative, "load_library", lambda *a, **k: None)
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 200, (500, 2)) + [6.2e6, 4.5e5]
    got = tgeo.radius_query(pts, pts[:50], radius=3.0)
    want = jgeo.radius_query(pts, pts[:50], radius=3.0)
    for q in range(50):
        d2 = ((pts - pts[q]) ** 2).sum(1)
        np.testing.assert_array_equal(got[q], np.sort(np.where(d2 <= 9.0)[0]))
        np.testing.assert_array_equal(got[q], want[q])
        assert got[q].dtype == want[q].dtype
    assert [len(x) for x in tgeo.radius_query(pts[:0], pts[:3], 1.0)] == \
        [0, 0, 0]


def test_port_loads_its_own_native_library():
    lib = tnative.load_library()
    assert os.path.realpath(lib._name) == os.path.realpath(
        tnative.library_path())
    assert os.sep + os.path.join("hotformerloc_torch", "build") in lib._name


# ---- preprocess -------------------------------------------------------

def _cloud(n=1600, seed=0):
    """n ground points (~4 per CSF cell) under n / 4 object points."""
    rng = np.random.default_rng(seed)
    ground = np.concatenate([rng.uniform(-5, 5, (n, 2)),
                             rng.normal(0, 0.05, (n, 1))], 1)
    objects = rng.uniform([-4, -4, 1], [4, 4, 4], (n // 4, 3))
    return np.concatenate([ground, objects])


PREPROCESS = {
    "csf": lambda m, pts: m.remove_ground_csf(pts),
    "voxel": lambda m, pts: m.voxel_down_sample(pts, 0.7),
    "random": lambda m, pts: m.random_down_sample(pts, 500),
    "pnvlad": lambda m, pts: m.pnvlad_down_sample(pts, 256),
    "outliers": lambda m, pts: m.remove_outliers(pts, np.arange(len(pts))),
    "normalise": lambda m, pts: m.normalise_pcl(
        m.voxel_down_sample(pts, 1.0), pts, 400),
}


@pytest.mark.parametrize("fn", sorted(PREPROCESS))
def test_preprocess_equals_jax(fn):
    pts = _cloud()
    got, want = PREPROCESS[fn](tpre, pts), PREPROCESS[fn](jpre, pts)
    if fn == "outliers":
        (got, gts), (want, wts) = got, want
        np.testing.assert_array_equal(gts, wts)
    assert got.dtype == want.dtype and len(got) > 0
    np.testing.assert_array_equal(got, want)
    if fn == "csf":             # the ground goes, (nearly) every object
        assert (got[:, 2] >= 1).all() and len(got) >= 0.95 * 400


def test_voxel_fallback_equals_jax(monkeypatch):
    monkeypatch.setattr(tnative, "load_library", lambda *a, **k: None)
    monkeypatch.setattr(jnative, "load_library", lambda *a, **k: None)
    pts = _cloud()
    np.testing.assert_array_equal(tpre.voxel_down_sample(pts, 0.7),
                                  jpre.voxel_down_sample(pts, 0.7))


def test_quaternions_and_pool_equal_jax():
    rng = np.random.default_rng(1)
    for q in rng.normal(size=(20, 4)):
        R = tpre.quaternion_to_rot(q)
        np.testing.assert_array_equal(R, jpre.quaternion_to_rot(q))
        back = tpre.rot_to_quaternion(R)
        np.testing.assert_array_equal(back, jpre.rot_to_quaternion(R))
        qn = q / np.linalg.norm(q)
        np.testing.assert_allclose(back * np.sign(back[3] * qn[3]), qn,
                                   atol=1e-12)
    assert (tpre.RANDOM_SEED, tpre.CSF_RESOLUTION, tpre.CSF_ITERATIONS) == \
        (jpre.RANDOM_SEED, jpre.CSF_RESOLUTION, jpre.CSF_ITERATIONS)
    xs = [-3, 1, -4, 1, -5]
    assert tpre.multiprocessing_func(abs, xs, 2) == \
        jpre.multiprocessing_func(abs, xs, 2) == [3, 1, 4, 1, 5]


# ---- fix_broken_timestamps, postprocess_submaps ------------------------

@pytest.mark.parametrize("tool", ["fix_broken_timestamps",
                                  "wildplaces_tuples"])
def test_fix_broken_timestamps_equals_jax(tool, tmp_path, monkeypatch):
    raw = tmp_path / "raw"
    rows, fixed = chip_smoke.write_wild_raw(str(raw), runs=2, points=8)
    roots = {k: tmp_path / k for k in ("jax", "torch")}
    for side, root in roots.items():
        shutil.copytree(raw, root)
        if tool == "fix_broken_timestamps":
            run_main(monkeypatch, jfix if side == "jax" else tfix,
                     "--root", root)
        else:
            (jwild if side == "jax" else twild).fix_broken_timestamps(
                str(root))
    rels = same_files(str(roots["jax"]), str(roots["torch"]), (".csv",))
    assert len(rels) == 8
    for path, want in fixed.items():
        with open(str(roots["torch"] / os.path.relpath(path, raw)),
                  "rb") as f:
            assert f.read() == want


def test_postprocess_submaps_equals_jax(tmp_path, monkeypatch):
    raw = str(tmp_path / "raw")
    want = chip_smoke.write_postprocess_raw(raw, n_clouds=3)
    outs = {}
    for side, module in (("jax", jpp), ("torch", tpp)):
        outs[side] = str(tmp_path / side)
        run_main(monkeypatch, module, "--root", raw, "--save_dir",
                 outs[side], "--remove_ground", "--downsample",
                 "--downsample_type", "voxel", "--voxel_size",
                 chip_smoke.PREP_VOXEL, "--min_num_points",
                 chip_smoke.PREP_MIN_POINTS)
    rels = same_files(outs["jax"], outs["torch"], (".pcd", ".txt", ".csv"))
    assert len(rels) == 4            # 2 kept submaps, rejected list, poses
    chip_smoke.check_postprocess(outs["torch"], want)


@pytest.mark.parametrize("kind,normalise,ground", [
    ("pnvlad", True, False), ("random", False, False), ("voxel", False, True)])
def test_postprocess_points_equals_jax(kind, normalise, ground):
    pts = np.random.default_rng(0).uniform(-30, 30, (3000, 3))
    kw = dict(remove_ground=ground, downsample=True, downsample_type=kind,
              downsample_target=300, voxel_size=6.0, normalise=normalise,
              min_num_points=300, radius_max=25.0)
    got, want = tpp.postprocess_points(pts, **kw), \
        jpp.postprocess_points(pts, **kw)
    assert got is not None and len(got) >= 300
    np.testing.assert_array_equal(got, want)


# ---- pnv_tuples -------------------------------------------------------

@pytest.fixture(scope="module")
def entry_tree(tmp_path_factory):
    """chip_smoke.write_entry_dataset at a small size (it asserts the
    port's tuples against its ground truth), and the JAX tool's tuples
    from the same locations CSVs beside them."""
    root = tmp_path_factory.mktemp("entry")
    tdir, jdir = str(root / "torch"), str(root / "jax")
    chip_smoke.write_entry_dataset(tdir, n_locs=4, n_eval=7)
    shutil.copytree(tdir, jdir, ignore=shutil.ignore_patterns("*.pickle"))
    entries = []
    for run in ("run0", "run1"):
        csv = os.path.join(jdir, jpnv.RUNS_FOLDER, run, jpnv.FILENAME)
        entries += [(jpnv.RUNS_FOLDER + run + jpnv.POINTCLOUD_FOLS + ts
                     + ".bin", n, e) for ts, n, e in jpnv._read_locations(csv)]
    jpnv.construct_query_dict(entries, jdir, "training_queries.pickle", 10.0)
    for split in chip_smoke.ENTRY_SPLITS:
        runs_folder, fols, fname = chip_smoke.ENTRY_EVAL_LAYOUT[split]
        jpnv.construct_query_and_database_sets(
            jdir, runs_folder, [f"{split}_run{r}" for r in range(2)], fols,
            fname, jpnv.P_DICT[split], split)
    return jdir, tdir


@pytest.mark.parametrize("split", ["training"] + list(
    chip_smoke.ENTRY_SPLITS))
def test_pnv_entry_tuples_equal_jax(entry_tree, split):
    names = (["training_queries.pickle"] if split == "training" else
             [f"{split}_evaluation_{k}.pickle" for k in ("database",
                                                         "query")])
    assert_same_pickles(*entry_tree, names)


@pytest.mark.parametrize("refined", [False, True])
def test_pnv_generate_training_tuples_equals_jax(refined, tmp_path):
    """Three runs (the last left out, as the tool does), places inside
    and outside the first Oxford test square; pass 1 lies 11 m from pass
    0 at odd places, a positive only at the refined radius (12.5 m)."""
    raw = tmp_path / "raw"
    p1 = jpnv.P_DICT["oxford"][0]
    for r, run in enumerate(("2014-05-19", "2014-06-24", "2014-07-14")):
        rows = [(str(1400000000000000 + 1000 * r + p),
                 p1[0] + (p - 5) * 40.0 + r * 11.0 * (p % 2),
                 p1[1] + (0.0 if p < 7 else 400.0)) for p in range(10)]
        chip_smoke.write_locations(
            str(raw / "oxford" / run / jpnv.FILENAME), rows)
    dirs = {}
    for side, module in (("jax", jpnv), ("torch", tpnv)):
        dirs[side] = str(tmp_path / side)
        shutil.copytree(raw, dirs[side])
        module.generate_training_tuples(dirs[side], refined)
    assert_same_pickles(dirs["jax"], dirs["torch"])
    suffix = "refine2" if refined else "baseline2"
    train, test = (LOADS["torch"](os.path.join(
        dirs["torch"], f"{kind}_queries_{suffix}.pickle"))
        for kind in ("training", "test"))
    assert train and test
    odd = [t for t in train.values() if t.timestamp % 2]
    assert any(len(t.positives) for t in odd) == refined


# ---- wildplaces_tuples --------------------------------------------------

@pytest.fixture(scope="module")
def wild_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("wild")
    raw = str(root / "raw")
    rows, fixed = chip_smoke.write_wild_raw(raw, points=8)
    # the port's tool repairs the CSVs both builders read
    for forest in chip_smoke.WILD_FORESTS:
        for run in sorted(os.listdir(os.path.join(raw, forest))):
            tfix.fix_run(os.path.join(raw, forest, run), "poses_aligned.csv",
                         "poses_aligned_fixed.csv", "Clouds_downsampled")
    dirs = {}
    for side, module in (("jax", jwild), ("torch", twild)):
        dirs[side] = str(root / side)
        os.makedirs(dirs[side])
        module.generate_training_tuples(raw, dirs[side],
                                        "poses_aligned_fixed.csv",
                                        "Clouds_downsampled")
        module.generate_test_sets(raw, dirs[side], "poses_aligned_fixed.csv",
                                  "Clouds_downsampled")
    return rows, fixed, dirs


def test_wildplaces_tuples_equal_jax(wild_tree):
    _, _, dirs = wild_tree
    assert_same_pickles(dirs["jax"], dirs["torch"])
    assert len(os.listdir(dirs["torch"])) == 2 + 2 * 2 + 2 * 3


def test_wildplaces_tuples_ground_truth(wild_tree):
    rows, fixed, dirs = wild_tree
    chip_smoke.check_wild(dirs["torch"], rows, fixed)


# ---- cswildplaces_tuples, ground_aerial_overlap ------------------------

@pytest.fixture(scope="module")
def cswild_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cswild"))
    return root, chip_smoke.write_cswild_raw(root, points=48)


CSWILD_FLAGS = {
    "baseline": {},
    "refined_v2": {"refined": True, "v2_only": True},
    "ground_required": {"query_requires_ground": True},
    "ground_aerial_only": {"ground_aerial_positives_only": True},
}


@pytest.mark.parametrize("flags", sorted(CSWILD_FLAGS))
def test_cswildplaces_tuples_equal_jax(flags, cswild_tree, tmp_path):
    root, rows = cswild_tree
    dirs = {}
    for side, module in (("jax", jcs), ("torch", tcs)):
        dirs[side] = str(tmp_path / side)
        module.generate(root, dirs[side], [], **chip_smoke.CSWILD_ARGS,
                        **CSWILD_FLAGS[flags])
    assert_same_pickles(dirs["jax"], dirs["torch"])
    if flags == "baseline":
        chip_smoke.check_cswild(dirs["torch"], rows)


@pytest.mark.parametrize("split", sorted(chip_smoke.CSWILD_RAW_PLACES))
def test_ground_aerial_overlap_equals_jax(split, cswild_tree):
    root, rows = cswild_tree
    path = os.path.join(root, split)
    got = tgao.process_split(path, "aerial",
                             tloaders.CSWildPlacesPointCloudLoader(), 10.0,
                             0.5)
    want = jgao.process_split(path, "aerial",
                              jgao.CSWildPlacesPointCloudLoader(), 10.0, 0.5)
    assert got == want
    truth = chip_smoke.overlap_truth(rows)[split]
    assert (got["pairs"], got["skipped"]) == (truth["pairs"],
                                              truth["skipped"])
    assert got["mean_overlap"] == 1.0 and got["mean_chamfer"] < 1e-3
    rng = np.random.default_rng(2)
    a, b = rng.uniform(-5, 5, (300, 3)), rng.uniform(-5, 5, (200, 3))
    assert tgao.pair_metrics(a, b, 0.5) == jgao.pair_metrics(a, b, 0.5)


# ---- cscampus3d_convert, visualise_positives ---------------------------

def test_cscampus3d_convert_equals_jax(tmp_path):
    dirs = {}
    for side, module in (("jax", jcampus), ("torch", tcampus)):
        dirs[side] = str(tmp_path / side)
        tp, qp, train, query = chip_smoke.write_campus_raw(dirs[side])
        module.convert_train_pickle(tp, tp.replace(".pickle", "_v2.pickle"))
        module.convert_query_pickle(qp, qp.replace(".pickle", "_v2.pickle"))
    assert_same_pickles(dirs["jax"], dirs["torch"])
    chip_smoke.check_campus(tp, qp, train, query)


@pytest.mark.parametrize("ground_aerial", [False, True])
def test_pick_positive_equals_jax(ground_aerial, cswild_tree, tmp_path):
    root, _ = cswild_tree
    out = str(tmp_path / "tuples")
    tcs.generate(root, out, [], **chip_smoke.CSWILD_ARGS, v2_only=True)
    path = os.path.join(out, "training_queries_CSWildPlaces_baseline_v2"
                             ".pickle")
    picks = {}
    for side, vp, seed in (("jax", jvp, jset_seed), ("torch", tvp,
                                                     tset_seed)):
        tuples = LOADS[side](path)
        seed(7)
        picks[side] = [getattr(vp.pick_positive(tuples, tuples[i],
                                                ground_aerial), "id", None)
                       for i in sorted(tuples)]
    assert picks["jax"] == picks["torch"]
    assert sum(p is not None for p in picks["torch"]) > 0


# ---- loader_bench, pallas_ab ------------------------------------------

def test_loader_bench_writes_only_its_out(tmp_path, monkeypatch):
    root, work = str(tmp_path / "corpus"), tmp_path / "cwd"
    tlb.make_corpus(root, n=16, points=256)
    work.mkdir()
    monkeypatch.chdir(work)
    out = tlb.main(["--root", root, "--batch", "8", "--num_points", "256",
                    "--workers", "1", "--mode", "thread", "--out",
                    str(tmp_path / "bench.json")])
    assert {"batch", "num_points", "mode", "corpus", "host_cpus",
            "nvidia_smi", "workers_1"} <= set(out)
    assert out["corpus"] == 16 and out["workers_1"]["submaps_s"] > 0
    assert len(out["workers_1"]["runs"]) == tlb.REPEATS
    assert out["workers_1"]["speedup"] == 1.0
    assert sorted(os.listdir(tmp_path)) == ["bench.json", "corpus", "cwd"]
    assert os.listdir(work) == []


def test_pallas_ab_inputs_equal_jax(monkeypatch):
    """JAX's bench_case draws its inputs inline (pallas_ab.py:52-60):
    they are caught where it first hands them to WindowAttention."""
    import hotformerloc_tpu.models.attention as jattn
    from hotformerloc_tpu.tools import pallas_ab as jab
    caught = {}

    class Caught(Exception):
        pass

    class Catch:
        def __init__(self, *a, **k):
            pass

        def init(self, key, x, key_mask, xyz):
            caught.update(x=np.asarray(x, np.float32),
                          valid=np.asarray(key_mask), xyz=np.asarray(xyz))
            raise Caught

    monkeypatch.setattr(jattn, "WindowAttention", Catch)
    for BW, K, G, C in ((704, 48, 1, 256), (16, 8, 0, 32)):
        with pytest.raises(Caught):
            jab.bench_case("c", BW=BW, K=K, G=G, C=C, H=4, dilation=1,
                           seed=3)
        x, valid, xyz = tab.make_inputs(BW, K, G, C, seed=3)
        np.testing.assert_array_equal(
            torch.from_numpy(x).to(torch.bfloat16).float().numpy(),
            caught["x"])
        np.testing.assert_array_equal(valid, caught["valid"])
        np.testing.assert_array_equal(xyz, caught["xyz"])


@pytest.mark.parametrize("case", tab.CASES, ids=[c[0] for c in tab.CASES])
def test_pallas_ab_routes_agree_fp32(case):
    """Both routes of bench_case at a tiny shape on the CPU (the kernel
    route runs K1/K2's plain versions there) at fp32: the output within
    the fp32 kernel-vs-plain bar (chip_smoke.TOL), the gradient of x and
    of each parameter within the fp32 backward bars (chip_smoke.TOL_BWD)
    relative to the einsum route's own largest value; no launch
    counted."""
    name, _, _, G, _, _, dil = case
    r = tab.bench_case(name, 16, 8, G, 32, 4, dil, iters=1, device="cpu",
                       dtype=torch.float32)
    bars = chip_smoke.TOL_BWD["fp32"]
    assert r["finite"] and r["T"] == 8 + G
    assert r["maxdiff_vs_einsum"] <= chip_smoke.TOL["fp32"]["window_attn"]
    assert set(r["grad_maxdiff_vs_einsum"]) == {
        "x", "qkv.weight", "qkv.bias", "rpe_table", "proj.weight",
        "proj.bias"}
    for leaf, diff in r["grad_maxdiff_vs_einsum"].items():
        peak = r["einsum_grad_max_abs"][leaf]
        assert peak > 0
        assert diff <= bars["act" if leaf == "x" else "weight"] * peak, leaf
    for route in ("kernel", "einsum"):
        assert not any(r[route]["launches"].values())
        assert r[route]["fwd_ms"] > 0 and r[route]["fwd_bwd_ms"] > 0
        assert r[route]["fwd_host_ms"] == r[route]["fwd_ms"]
        assert r[route]["fwd_device_ms"] is None


def test_pallas_ab_main_writes_only_its_out(tmp_path, monkeypatch):
    """main on the CPU: each case at a tiny shape, the card's name and
    nvidia-smi stubbed."""
    work = tmp_path / "cwd"
    work.mkdir()
    monkeypatch.chdir(work)
    bench = tab.bench_case
    monkeypatch.setattr(tab, "CASES", tuple(
        (c[0], 16, 8, c[3], 32, 4, c[6]) for c in tab.CASES))
    monkeypatch.setattr(tab, "bench_case", lambda *c: bench(
        *c, iters=1, device="cpu"))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: "cpu")
    monkeypatch.setattr(tab, "smi_line", lambda: None)
    out = tab.main(["--out", str(tmp_path / "ab.json")])
    assert [c["case"] for c in out["cases"]] == [c[0] for c in tab.CASES]
    assert out["device"] == "cpu" and out["nvidia_smi"] is None
    assert sorted(os.listdir(tmp_path)) == ["ab.json", "cwd"]
    assert os.listdir(work) == []


# ---- chip_smoke.py's prep phase ----------------------------------------

def test_prep_phase_on_cpu():
    """The card's host-only phase as it runs there, with a 16-cloud
    loader corpus on the loop thread alone: every tool's CLI in a process
    of its own, each checked against its tree's ground truth."""
    out = chip_smoke.prep_phase("cpu", loader_clouds=16, workers="0")
    assert set(out["tool_seconds"]) == {
        "fix_broken_timestamps", "postprocess_submaps",
        "wildplaces_tuples train", "wildplaces_tuples test-sets",
        "cswildplaces_tuples", "cscampus3d_convert",
        "ground_aerial_overlap", "loader_bench"}
    assert out["native_library"] == tnative.library_path()
    assert out["loader_submaps_s"]["0"] > 0
