"""The port's host data pipeline against the JAX package's, on the CPU.

Every comparison is exact (bitwise): the two packages run the same numpy
code on the same seeded generators.

* augmentations: every train / set transform and Normalize /
  CylindricalCoordinates, same input and generator seed;
* the PNV .bin and PCD (ascii and binary) loaders;
* a training-tuples pickle written with the JAX package's classes loads
  through the port's unpickler into the port's classes;
* BatchSampler batches for one seed, over two epochs and a batch
  expansion, and masks_for_batch;
* DataLoader batches on the synthetic pickles of
  tests/test_data_and_eval.py, serial, thread pool and process pool;
* morton_encode through the port's native library (built into
  hotformerloc_torch/build/, never over the tracked native/libpointops.so)
  and through its torch fallback, against the JAX package's;
* a fresh interpreter that imports every module of the port (the
  twelve ported dataset and A/B tools among them) and loads that pickle
  has no jax, flax, optax, orbax or hotformerloc_tpu module; and no
  import statement in the port or in chip_smoke.py, function-local ones
  included, names one (an AST scan).
"""
import torch_threads  # noqa: F401  (first: one torch thread per worker)

import ast
import hashlib
import os
import pickle
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from hotformerloc_tpu.data import augmentation as ja
from hotformerloc_tpu.data import loaders as jlo
from hotformerloc_tpu.data import native as jn
from hotformerloc_tpu.data import pipeline as jp
from hotformerloc_tpu.data import sampler as js
from hotformerloc_tpu.data import tuples as jt
from hotformerloc_torch.data import augmentation as ta
from hotformerloc_torch.data import loaders as tlo
from hotformerloc_torch.data import native as tn
from hotformerloc_torch.data import pipeline as tp
from hotformerloc_torch.data import sampler as ts
from hotformerloc_torch.data import tuples as tt

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def synth_dataset(tmp_path_factory):
    """tests/test_data_and_eval.py's dataset: 8 locations x 2 passes of
    512 points; same-location scans are positives. Written with the JAX
    package's TrainingTuple."""
    root = tmp_path_factory.mktemp("pnv")
    rng = np.random.default_rng(0)
    queries = {}
    for loc in range(8):
        base = rng.uniform(-0.9, 0.9, (512, 3))
        for pass_i in range(2):
            i = loc * 2 + pass_i
            pc = base + rng.normal(0, 0.01, base.shape)
            rel = f"scan_{i:03d}.bin"
            pc.astype(np.float64).tofile(root / rel)
            sibling = loc * 2 + (1 - pass_i)
            queries[i] = jt.TrainingTuple(
                id=i, timestamp=i, rel_scan_filepath=rel,
                positives=np.array([sibling]),
                non_negatives=np.array(sorted([i, sibling])),
                position=np.array([float(loc), 0.0]))
    with open(root / "train_queries.pickle", "wb") as f:
        pickle.dump(queries, f)
    return str(root), queries


def _cloud(seed, n=300):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 3)) \
        .astype(np.float32)


TRANSFORMS = {
    **{f"train{m}": (lambda mod, m=m: mod.make_train_transform(
        m, random_rot_theta=30.0)) for m in (0, 1, 2)},
    "train1_normalized": lambda mod: mod.make_train_transform(
        1, normalize_points=True),
    **{f"set{m}": (lambda mod, m=m: mod.make_set_transform(m, 30.0))
       for m in (1, 2)},
    "val_sphere": lambda mod: mod.make_val_transform(
        True, None, unit_sphere_norm=True),
    "val_scale": lambda mod: mod.make_val_transform(False, 40.0),
    "cylindrical": lambda mod: mod.CylindricalCoordinates(),
    "rotation2": lambda mod: mod.RandomRotation(max_theta=20,
                                                max_theta2=5),
    "jitter_p": lambda mod: mod.JitterPoints(0.01, 0.02, p=0.5),
    "remove_r": lambda mod: mod.RemoveRandomPoints(0.2),
}


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_augmentation_bitwise(name):
    pc = _cloud(len(name)) * 5.0
    jf, tf = TRANSFORMS[name](ja), TRANSFORMS[name](ta)
    for seed in range(3):
        a = jf(pc.copy(), np.random.default_rng(seed))
        b = tf(pc.copy(), np.random.default_rng(seed))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_loaders_equal(tmp_path):
    pts = _cloud(1, 50)
    pts[3] = 0.0                      # a zero point
    pts.astype(np.float64).tofile(tmp_path / "a.bin")
    np.testing.assert_array_equal(
        jlo.PNVPointCloudLoader()(str(tmp_path / "a.bin")),
        tlo.PNVPointCloudLoader()(str(tmp_path / "a.bin")))
    tlo.write_pcd(str(tmp_path / "b.pcd"), pts)
    with open(tmp_path / "c.pcd", "w") as f:
        f.write("VERSION 0.7\nFIELDS x y z i\nSIZE 4 4 4 4\nTYPE F F F F\n"
                f"COUNT 1 1 1 1\nWIDTH {len(pts)}\nHEIGHT 1\n"
                f"POINTS {len(pts)}\nDATA ascii\n")
        for p in pts:
            f.write(f"{p[0]} {p[1]} {p[2]} 7\n")
    for name in ("b.pcd", "c.pcd"):
        path = str(tmp_path / name)
        for ds in ("CSWildPlaces", "WildPlaces"):
            a = jlo.get_pointcloud_loader(ds)(path)
            b = tlo.get_pointcloud_loader(ds)(path)
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(jlo.read_pcd(path), tlo.read_pcd(path))


def test_jax_written_tuples_load_into_port_classes(synth_dataset):
    root, queries = synth_dataset
    q = tt.load_training_queries(os.path.join(root, "train_queries.pickle"))
    assert sorted(q) == sorted(queries)
    for k, a in queries.items():
        b = q[k]
        assert type(b) is tt.TrainingTuple
        assert (b.id, b.timestamp, b.rel_scan_filepath) == \
            (a.id, a.timestamp, a.rel_scan_filepath)
        for f in ("positives", "non_negatives", "position"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f))


def test_evaluation_set_roundtrip(tmp_path):
    qs = [jt.EvaluationTuple(i, f"q{i}.bin", np.array([i, 2.0 * i]))
          for i in range(3)]
    ms = [jt.EvaluationTuple(i, f"m{i}.bin", np.array([i, -1.0]))
          for i in range(4)]
    jt.EvaluationSet(qs, ms).save(str(tmp_path / "e.pickle"))
    s = tt.EvaluationSet().load(str(tmp_path / "e.pickle"))
    j = jt.EvaluationSet().load(str(tmp_path / "e.pickle"))
    np.testing.assert_array_equal(s.get_map_positions(),
                                  j.get_map_positions())
    np.testing.assert_array_equal(s.get_query_positions(),
                                  j.get_query_positions())
    assert [e.rel_scan_filepath for e in s.map_set] == \
        [e.rel_scan_filepath for e in j.map_set]


def test_sampler_equal_with_expansion(synth_dataset):
    _, queries = synth_dataset
    kw = dict(batch_size=4, batch_size_limit=12, batch_expansion_rate=1.7,
              seed=3)
    a, b = js.BatchSampler(queries, **kw), ts.BatchSampler(queries, **kw)
    for _ in range(3):
        ba, bb = a.generate_batches(), b.generate_batches()
        assert ba == bb and len(ba) > 0
        for labels in ba[:2]:
            for x, y in zip(js.masks_for_batch(queries, labels),
                            ts.masks_for_batch(queries, labels)):
                np.testing.assert_array_equal(x, y)
        assert a.expand_batch() == b.expand_batch()
        assert a.batch_size == b.batch_size
    assert a.batch_size == 12


@pytest.mark.parametrize("workers,mode", [(0, "thread"), (2, "thread"),
                                          (2, "process")])
def test_dataloader_bitwise(synth_dataset, workers, mode):
    root, _ = synth_dataset

    def loader(pkg_aug, pkg_lo, pkg_pipe, pkg_s, w, m):
        ds = pkg_pipe.TrainingDataset(
            root, "train_queries.pickle", pkg_lo.PNVPointCloudLoader(),
            pkg_aug.make_train_transform(2, random_rot_theta=30.0),
            pkg_aug.make_set_transform(1, 30.0))
        sampler = pkg_s.BatchSampler(ds.queries, 6, seed=11)
        return pkg_pipe.DataLoader(ds, sampler, num_points=384, seed=4,
                                   num_workers=w, worker_mode=m)

    jl = loader(ja, jlo, jp, js, 0, "thread")
    tl = loader(ta, tlo, tp, ts, workers, mode)
    try:
        for _ in range(2):                  # two epochs
            ja_batches, tb_batches = list(jl), list(tl)
            assert len(ja_batches) == len(tb_batches) == 3
            for a, b in zip(ja_batches, tb_batches):
                assert sorted(a) == sorted(b)
                for k in a:
                    assert a[k].dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k], b[k])
    finally:
        tl.close()
        jl.close()


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_morton_library_and_fallback(monkeypatch):
    tracked = ROOT / "native" / "libpointops.so"
    before = _sha(tracked)
    pts = np.random.default_rng(5).uniform(-1.2, 1.2, (2000, 3)) \
        .astype(np.float32)
    lib = tn.load_library()
    assert lib is not None, "g++ could not build native/pointops.cpp"
    assert Path(tn.library_path()).parent == ROOT / "hotformerloc_torch" \
        / "build"
    for depth in (1, 5, 9, 10):
        want = jn.morton_encode(pts, depth)
        got = tn.morton_encode(pts, depth)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        monkeypatch.setattr(tn, "_LIB", None)
        fallback = tn.morton_encode(pts, depth)
        monkeypatch.setattr(tn, "_LIB", lib)
        assert fallback.dtype == np.int32
        np.testing.assert_array_equal(fallback, want)
    np.testing.assert_array_equal(tn.voxel_downsample(pts, 0.1),
                                  jn.voxel_downsample(pts, 0.1))
    assert _sha(tracked) == before


# the JAX package's dataset-preparation tools and its window-attention
# A/B, each with a counterpart of the same name in the port
PORTED_TOOLS = ("geometry", "preprocess", "fix_broken_timestamps",
                "postprocess_submaps", "pnv_tuples", "wildplaces_tuples",
                "cswildplaces_tuples", "cscampus3d_convert",
                "ground_aerial_overlap", "visualise_positives",
                "loader_bench", "pallas_ab")


def test_port_imports_no_jax_package_anywhere():
    """No import of the JAX package (or of JAX) in any module of the
    port, nor in chip_smoke.py, at any depth: a function-local import
    runs only when the function does, so the fresh interpreter below
    would miss it."""
    banned = ("hotformerloc_tpu", "jax", "jaxlib", "flax", "optax", "orbax")
    files = sorted(str(p) for p in (ROOT / "hotformerloc_torch").rglob(
        "*.py")) + [str(ROOT / "chip_smoke.py")]
    assert len(files) > 60
    assert {str(ROOT / "hotformerloc_torch" / "tools" / f"{m}.py")
            for m in PORTED_TOOLS} <= set(files)
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path}:{node.lineno} {n}" for n in names
                    if n.split(".")[0] in banned]
    assert bad == []


def test_port_imports_no_jax_in_fresh_interpreter(synth_dataset):
    root, _ = synth_dataset
    import hotformerloc_torch
    mods = sorted(m.name for m in pkgutil.walk_packages(
        hotformerloc_torch.__path__, "hotformerloc_torch."))
    assert "hotformerloc_torch.training.trainer" in mods
    assert "hotformerloc_torch.data.pipeline" in mods
    assert {"hotformerloc_torch.tools.convergence_run",
            "hotformerloc_torch.tools.synthetic_benchmark"} <= set(mods)
    assert {f"hotformerloc_torch.tools.{m}" for m in PORTED_TOOLS} <= \
        set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "from hotformerloc_torch.data.tuples import load_training_queries\n"
        f"q = load_training_queries({os.path.join(root, 'train_queries.pickle')!r})\n"
        "assert type(q[0]).__module__ == 'hotformerloc_torch.data.tuples'\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'hotformerloc_tpu'))\n"
        "print('BAD', bad)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert r.returncode == 0, r.stderr[-2000:]
    assert "BAD []" in r.stdout, r.stdout[-2000:]
