"""The port's probe tools and their kernels' plain versions on the CPU,
held against the JAX package:

* gather_bench.real_tables and its locality census equal the JAX tool's,
  exactly;
* take_rows (T1, T4) equals the TPU k_take body's expression
  (take_along_axis on max(neigh[..., 0], 0)) and numpy x[idx], exactly;
* the plain take_rows equals the k_take body at B > 1 on stride-27
  indices with -1 and Nx among them (Nx against the body's gather in
  "clip" mode: the port clamps, where jnp's default would fill NaN), and
  take_rows' launch plan covers every output vector once, in warps whose
  spans touch at most 32 rows (emulating the kernel's index arithmetic),
  with every SM given a block of 4 warps where there are the rows to;
* dwconv_resident (T2) equals the JAX tool's oracle _dwconv_fwd_impl,
  to 1e-5 at fp32 and one bf16 ulp at bf16, and its cluster plan fits a
  block's shared memory, covers every row and channel once and raises
  where nothing fits; dtab's cluster plan likewise;
* each T3 construct's plain version equals the construct body's jnp
  expression (the JAX tool keeps the bodies inside closures), exactly
  for the copies, pad, reshape, lookup and selects, to a relative 1e-5
  for the products, the softmax and the dtab sum; the plain softmax
  equals jax.nn.softmax at every row length its kernel's plan takes
  (1 to 1024, with -1e9 entries and a large one), to 1e-5 max |want|,
  and the plan covers every row and value and refuses L > 1024;
* gather_bench and every mosaic_probe subcommand run end to end with
  --device cpu, pass their own checks and write only under --out;
* every new wrapper refuses a device that is neither CPU nor CUDA, and a
  tool asked for a missing card exits instead of falling back;
* the yardsticks the tools time beside each kernel (one PyTorch call of
  the same function) compute the kernel's function, and the bound
  helper takes the larger of the byte and operation times;
* the profiling helpers time, trace, count parameters and FLOPs;
* onehot4d's and pad's launch plans (onehot_plan, pad_plan) cover every
  output unit once, emulating the kernels' index arithmetic, and the
  emulated outputs equal the plain versions exactly (indices -1, R and
  2^31 - 1; H 16, 8, 6, 1; G 0, 1, 2; K 48, 7, 1); both plans refuse
  what the kernels' entry points refuse, and the floor kernels' wrappers
  refuse the CPU.

The kernels themselves run only on the card (chip_smoke.py's probes
phase holds each against its plain version there).
"""
import torch_threads  # noqa: F401  (first: one torch thread per worker)

import hashlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hotformerloc_tpu.ops import conv as jconv
from hotformerloc_tpu.tools import gather_bench as jbench
from hotformerloc_torch.ops.kernels import constructs as kcon
from hotformerloc_torch.ops.kernels import gather as kgather
from hotformerloc_torch.tools import gather_bench as tbench
from hotformerloc_torch.tools import mosaic_probe as tprobe
from hotformerloc_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tables():
    """(port, JAX) depth-6 tables of gather_bench.real_tables(2, 1024)."""
    return (tbench.real_tables(2, 1024).numpy(),
            np.asarray(jbench.real_tables(2, 1024)))


def test_real_tables_match_jax(tables):
    port, ref = tables
    assert port.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(port, ref)
    # tap 0 (offset -1,-1,-1) is mostly missing: the take_rows cases below
    # exercise the row-0 rule on these tables
    assert (port[..., 0] < 0).mean() > 0.5


def test_locality_census_matches_jax(tables):
    port, ref = tables
    # the JAX tool's census (gather_bench.py main), on the JAX tables
    node = np.arange(ref.shape[1])[None, :, None]
    off = np.abs(ref - node)
    valid = ref >= 0
    want = {f"<= {w}": round(float((off[valid] <= w).mean()), 4)
            for w in (48, 128, 256, 512, 1024, 2048)}
    assert tbench.locality(port) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_take_rows_matches_k_take_body(tables, dtype):
    port, _ = tables
    B, N, _ = port.shape
    C = 64
    x = np.random.default_rng(3).normal(0, 1, (B, N, C)).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(xt.float().numpy(), getattr(jnp, dtype))
    want = []
    for b in range(B):              # k_take's body, one grid step per b
        nk = jnp.maximum(jnp.asarray(port[b]), 0)
        want.append(jnp.take_along_axis(
            xj[b], jnp.broadcast_to(nk[:, 0][:, None], (N, C)), axis=0))
    want = np.asarray(jnp.stack(want), np.float32)
    out = kgather.take_rows(xt, torch.from_numpy(port)[..., 0])
    assert out.dtype == xt.dtype and out.shape == (B, N, C)
    np.testing.assert_array_equal(out.float().numpy(), want)


@pytest.mark.parametrize("case", range(6))
def test_take_rows_matches_numpy_at_t4_shapes(case):
    name, x, idx = tprobe.gather_inputs()[case]
    out = kgather.take_rows(x, idx)
    assert out.dtype == x.dtype, name
    np.testing.assert_array_equal(out.float().numpy(),
                                  x.float().numpy()[idx.numpy()])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_take_rows_reference_matches_k_take_out_of_range(tables, dtype):
    port, _ = tables
    B, N, _ = port.shape
    C = 24
    neigh = port.copy()
    neigh[:, :6, 0] = [-1, N, 0, N - 1, N, -1]
    x = np.random.default_rng(6).normal(0, 1, (B, N, C)).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(xt.float().numpy(), getattr(jnp, dtype))
    want = []
    for b in range(B):              # k_take's body; Nx clamped ("clip")
        nk = jnp.maximum(jnp.asarray(neigh[b]), 0)
        want.append(jnp.take_along_axis(
            xj[b], jnp.broadcast_to(nk[:, 0][:, None], (N, C)), axis=0,
            mode="clip"))
    want = np.asarray(jnp.stack(want), np.float32)
    idx = torch.from_numpy(neigh)[..., 0]
    assert idx.stride() == (N * 27, 27)
    out = kgather.take_rows_reference(xt, idx)
    assert out.dtype == xt.dtype and out.shape == (B, N, C)
    np.testing.assert_array_equal(out.float().numpy(), want)
    # -1 reads row 0, Nx row Nx - 1
    np.testing.assert_array_equal(
        out.float().numpy()[:, :6],
        xt.float().numpy()[:, [0, N - 1, 0, N - 1, N - 1, 0]])


def emulate_take_plan(rows, vecs, plan):
    """take_rows_kernel's index arithmetic in numpy: returns how often
    each flat output vector is copied, after checking that every lane
    finds its vector's row and column and that the row's index was read
    by a lane of its warp (at most 32 rows a warp)."""
    U, th, blocks = plan["per_lane"], plan["threads"], plan["blocks"]
    total = rows * vecs
    seen = np.zeros(total, int)
    lane = np.arange(32)
    q32, r32 = divmod(32, vecs)
    for w in range(blocks * th // 32):
        s = w * 32 * U
        if s >= total:
            continue
        row0, lead = divmod(s, vecs)
        read = lane * vecs <= lead + 32 * U - 1      # lanes reading an index
        rel, v = (lead + lane) // vecs, (lead + lane) % vecs
        for k in range(U):
            f = s + lane + 32 * k
            m = f < total
            assert (rel[m] == f[m] // vecs - row0).all()
            assert (v[m] == f[m] % vecs).all() and read[rel[m]].all()
            seen[f[m]] += 1
            v, rel = v + r32, rel + q32
            rel, v = np.where(v >= vecs, rel + 1, rel), np.where(
                v >= vecs, v - vecs, v)
    return seen


# (rows, vecs): T1, T4's six cases (two share a shape), rows of 9, 3 and
# 1 vectors, a batch of 3 with a ragged last warp
TAKE_PLAN_SHAPES = [(8 * 4224, 32), (512, 64), (512, 32), (4224, 32),
                    (8 * 512, 64), (800, 9), (771, 9), (100, 3), (7, 1),
                    (3 * 257, 16), (1, 64)]


@pytest.mark.parametrize("rows,vecs", TAKE_PLAN_SHAPES)
def test_take_plan_covers_rows_once(rows, vecs):
    plan = kgather.take_plan(rows, vecs)
    U, bw = plan["per_lane"], kgather.BLOCK_WARPS
    assert U in kgather.TAKE_PER_LANE and plan["threads"] == 32 * bw
    assert 32 * U < 31 * vecs + 2                # <= 32 rows a warp's span
    warps = -(-rows * vecs // (32 * U))
    assert plan["blocks"] == -(-warps // bw)
    assert (emulate_take_plan(rows, vecs, plan) == 1).all()
    # every SM a block wherever there are the rows for one on each
    if rows * vecs >= 32 * bw * kgather.SMS:
        assert plan["blocks"] >= kgather.SMS
    # and the most vectors a lane that still does
    more = [u for u in kgather.TAKE_PER_LANE if u > U
            and 32 * u < 31 * vecs + 2]
    assert all(-(-rows * vecs // (32 * u)) < bw * kgather.SMS for u in more)
    with pytest.raises(ValueError, match="no plan"):
        kgather.take_plan(0, vecs)


@pytest.mark.parametrize("L", [1, 31, 32, 33, 49, 64, 65, 1024])
def test_softmax_reference_matches_jax(L):
    rng = np.random.default_rng(L)
    a = rng.normal(0, 3, (2, 19, L)).astype(np.float32)
    a[:, ::3, ::2] = -1e9
    a[0, 1, L // 2] = 80.0
    want = np.asarray(jax.nn.softmax(jnp.asarray(a), axis=-1))
    out = kcon.softmax(torch.from_numpy(a))         # CPU: the plain version
    assert torch.equal(out, kcon.softmax_reference(torch.from_numpy(a)))
    np.testing.assert_allclose(out.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("rows", [392, 1, 131, 5000])
@pytest.mark.parametrize("L", [1, 31, 32, 33, 49, 64, 65, 1024])
def test_softmax_plan_covers_rows_and_values(rows, L):
    plan = kcon.softmax_plan(rows, L)
    P, bw = plan["per_lane"], kgather.BLOCK_WARPS
    # a warp a row, values a lane: the least power of two that holds L
    assert 32 * P >= L and (P == 1 or 16 * P < L) and P & (P - 1) == 0
    assert P <= 32 and plan["threads"] == 32 * bw
    # blocks of 4 warps cover every row once: every SM a block wherever
    # there are the rows for one on each
    assert plan["blocks"] == -(-rows // bw)
    assert (plan["blocks"] - 1) * bw < rows <= plan["blocks"] * bw
    if rows >= bw * kgather.SMS:
        assert plan["blocks"] >= kgather.SMS


def test_softmax_plan_refuses_rows_past_1024():
    assert kcon.softmax_plan(8, 1024)["per_lane"] == 32
    for L in (1025, 0):
        with pytest.raises(ValueError, match="last axis"):
            kcon.softmax_plan(8, L)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dwconv_resident_matches_jax_oracle(tables, dtype):
    port, _ = tables
    B, N, K = port.shape
    C = 32
    rng = np.random.default_rng(4)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    x = torch.from_numpy(rng.normal(0, 1, (B, N, C)).astype(np.float32)).to(
        tdt)
    w = torch.from_numpy(rng.normal(0, 0.2, (K, C)).astype(np.float32)).to(
        tdt)
    ref = jconv._dwconv_fwd_impl(jnp.asarray(x.float().numpy(), jdt),
                                 jnp.asarray(port),
                                 jnp.asarray(w.float().numpy(), jdt))
    ref = torch.from_numpy(np.array(ref, np.float32)).to(tdt)
    out = kgather.dwconv_resident(x, torch.from_numpy(port), w)
    assert out.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-5)
    else:
        assert tbench.bf16_ulps(out, ref) <= 1.0


def _jnp_construct(name, args):
    """The construct bodies of hotformerloc_tpu/tools/mosaic_probe.py
    (lines 66-151) as jnp expressions on the probe's inputs."""
    j = [jnp.asarray(a.float().numpy(), jnp.bfloat16)
         if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16
         else jnp.asarray(a.numpy()) if isinstance(a, torch.Tensor) else a
         for a in args]
    hd = tprobe.HD
    if name == "headloop":
        q, k, _ = j
        acc = jnp.zeros((q.shape[0], q.shape[1], k.shape[1]), jnp.float32)
        for h in range(2):
            acc += jax.lax.dot_general(
                q[:, :, h * hd:(h + 1) * hd], k[:, :, h * hd:(h + 1) * hd],
                (((2,), (2,)), ((0,), (0,))),
                preferred_element_type=jnp.float32)
        return acc
    if name == "reshape":
        return j[0].reshape(-1, 1).astype(jnp.float32)
    if name == "onehot4d":
        idx, tab = j
        col = jax.lax.broadcasted_iota(jnp.int32, (*idx.shape, tab.shape[0]),
                                       3)
        oh = (col == idx[..., None]).astype(jnp.bfloat16)
        return jax.lax.dot_general(oh, tab.astype(jnp.bfloat16),
                                   (((3,), (0,)), ((), ())),
                                   preferred_element_type=jnp.float32)
    if name == "dtab":
        idx, g, R = j
        col = jax.lax.broadcasted_iota(jnp.int32, (*idx.shape, R), 3)
        oh = (col == idx[..., None]).astype(jnp.bfloat16)
        return jax.lax.dot_general(oh, g.astype(jnp.bfloat16),
                                   (((0, 1, 2), (0, 1, 2)), ((), ())),
                                   preferred_element_type=jnp.float32)
    if name == "pad":
        return jnp.pad(j[0], ((0, 0), (1, 0), (1, 0)))
    if name == "selloop":
        idx, tab, nsel = j
        acc = jnp.zeros(idx.shape, jnp.float32)
        for r in range(nsel):
            acc += jnp.where(idx == r, tab[r, 0], 0.0)
        return acc
    if name == "softmax":
        return jax.nn.softmax(j[0], axis=-1)
    if name == "slicestore":
        q, width = j
        return q[:, :, :width] * 2.0
    if name == "dk":
        q, k, _ = j
        return jax.lax.dot_general(q[:, :, :hd], k[:, :, :hd],
                                   (((1,), (1,)), ((0,), (0,))),
                                   preferred_element_type=jnp.float32)
    if name == "packbias":
        q, k, _ = j
        return jax.lax.dot_general(q[:, :, :hd], k[:, :, :hd],
                                   (((2,), (2,)), ((0,), (0,))),
                                   preferred_element_type=jnp.float32)
    raise KeyError(name)


@pytest.mark.parametrize("name", sorted(tprobe.CONSTRUCT_PROBES))
def test_construct_matches_jnp_body(name):
    args = tprobe.construct_inputs()[name]
    fn, ref_fn, _ = kcon.CONSTRUCTS[name]
    out = fn(*args)
    assert torch.equal(out, ref_fn(*args))          # CPU: the plain version
    want = _jnp_construct(name, args)
    assert out.shape == want.shape, (out.shape, want.shape)
    assert str(out.dtype).split(".")[1] == jnp.dtype(want.dtype).name
    o, w = out.float().numpy(), np.asarray(want, np.float32)
    if tprobe.CONSTRUCT_PROBES[name][1]:
        np.testing.assert_array_equal(o, w)
    else:
        np.testing.assert_allclose(o, w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def _lines(text):
    return [json.loads(ln) for ln in text.splitlines()
            if ln.startswith("{")]


def _tree(path):
    return sorted(str(p.relative_to(path)) for p in path.rglob("*"))


def _digest(path):
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_gather_bench_runs_on_cpu(tmp_path, monkeypatch, capsys):
    ab = ROOT / "docs" / "GATHER_AB.json"
    before = _digest(ab)
    monkeypatch.chdir(tmp_path)
    assert tbench.main(["--device", "cpu", "--batch", "1", "--reps", "1",
                        "--out", "out"]) == 0
    lines = _lines(capsys.readouterr().out)
    assert lines[0]["device"] == "cpu" and lines[0]["N"] == 4224
    res = {k: v for ln in lines[2:] for k, v in ln.items()}
    assert sorted(res) == sorted(
        ["flat_gather", "dw_current", "dw_current_fp32", "sorted_gather",
         "rowsize_x4", "rowsize_x16", "pl_take", "pl_dw",
         "pl_dw_alt_cluster", "pl_dw_fp32", "onehot_window"])
    for name, ent in res.items():
        assert "cpu_ms" in ent and "ms" not in ent, name
    # the plans the lines report: both cluster sizes at bf16, the
    # default at fp32; no occupancy without a card
    assert {res[n]["cluster"] for n in ("pl_dw", "pl_dw_alt_cluster")} \
        == set(kgather.RESIDENT_CLUSTERS)
    for name in ("pl_dw", "pl_dw_alt_cluster", "pl_dw_fp32"):
        esz = 4 if name.endswith("fp32") else 2
        assert res[name] | kgather.resident_plan(
            4224, 256, esz, cluster=res[name]["cluster"]) == res[name]
        assert res[name]["active_clusters"] is None
    for name in ("dw_current", "dw_current_fp32", "pl_take", "pl_dw",
                 "pl_dw_alt_cluster", "pl_dw_fp32"):
        assert res[name]["maxdiff"] == 0.0, name    # CPU: plain == oracle
        assert res[name]["bound_ms"] > 0 if name[:2] == "pl" else True
    for name in ("pl_take", "pl_dw", "pl_dw_fp32"):
        assert "plain_cpu_ms" in res[name], name
    assert "library_cpu_ms" in res["pl_take"]
    # T2's bytes: x read and out written once, the table, the weights
    N, C = 4224, 256
    want = (2 * N * C * 2 + N * 27 * 4 + 27 * C * 2) / 3.35e12 * 1e3
    assert res["pl_dw"]["bound_ms"] == pytest.approx(want)
    assert res["pl_dw_fp32"]["bound_ms"] == pytest.approx(
        want + (2 * N * C + 27 * C) * 2 / 3.35e12 * 1e3)
    assert 0.0 <= res["onehot_window"]["esc_frac"] < 0.01
    assert _tree(tmp_path) == ["out", "out/gather_bench.json"]
    assert _digest(ab) == before


@pytest.mark.parametrize("cmd", ["constructs", "gather", "attn", "band"])
def test_mosaic_probe_runs_on_cpu(cmd, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert tprobe.main([cmd, "--device", "cpu", "--reps", "1",
                        "--out", "out"]) == 0
    lines = _lines(capsys.readouterr().out)
    assert lines[0] == {"device": "cpu", "subcommand": cmd}
    want = {"constructs": 10, "gather": 6, "attn": 4, "band": 1}[cmd]
    assert len(lines) == 1 + want
    for ln in lines[1:]:
        assert ln["ok"] is True
        # no device time on the CPU; bound_ms is the H100's least time
        # for the work, computed, not measured
        assert not any(k == "ms" or k.endswith("_ms") and "cpu" not in k
                       and k != "bound_ms" for k in ln), ln
        if cmd in ("constructs", "gather"):
            assert ln["bound_ms"] > 0 and "plain_cpu_ms" in ln, ln
    assert _tree(tmp_path) == ["out", f"out/mosaic_probe_{cmd}.json"]
    if cmd == "attn":
        named = [c for ln in lines[1:] for c in ln["cases"] + ln["bwd_cases"]]
        assert len(named) == len(set(named)) == 11   # every JAX attn case


def _meta_calls():
    m = {"device": "meta"}
    x = torch.empty(2, 8, 16, **m)
    calls = {"take_rows": lambda: kgather.take_rows(
                 x, torch.zeros(2, 8, dtype=torch.int32, **m)),
             "dwconv_resident": lambda: kgather.dwconv_resident(
                 x, torch.zeros(2, 8, 27, dtype=torch.int32, **m),
                 torch.empty(27, 16, **m))}
    for name, args in tprobe.construct_inputs().items():
        fn = kcon.CONSTRUCTS[name][0]
        calls[name] = (lambda fn=fn, args=args: fn(*tprobe.to_device(
            args, torch.device("meta"))))
    return calls


@pytest.mark.parametrize("name", ["take_rows", "dwconv_resident",
                                  *sorted(tprobe.CONSTRUCT_PROBES)])
def test_wrappers_refuse_other_devices(name):
    with pytest.raises(ValueError, match="unsupported device"):
        _meta_calls()[name]()


def test_tools_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tbench.main(["--batch", "1"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        tprobe.main(["gather"])


def test_resident_slice_fits_shared_memory():
    # the probe's shape: a cluster of 16 holds a sample's 256 bf16
    # channels, 264 rows a block (135 KB of x beside 14 KB of weights and
    # 30 KB of tap lists); 8 hold half of them; at fp32 16 hold half and 8
    # a quarter
    plan = kgather.resident_plan(4224, 256, 2)
    assert plan == {"cluster": 16, "slice": 256, "rows": 264,
                    "smem": 264 * 512 + 27 * 512 + 264 * 28 * 4 + 8,
                    "clusters_per_sample": 1}
    assert kgather.resident_plan(4224, 256, 2, cluster=8)["slice"] == 128
    assert kgather.resident_plan(4224, 256, 4)["slice"] == 128
    assert kgather.resident_plan(4224, 256, 4, cluster=8)["slice"] == 64
    # a smaller card's shared memory takes a narrower slice
    assert kgather.resident_plan(4224, 256, 2, smem=120_000)["slice"] == 128
    with pytest.raises(ValueError, match="no cluster plan"):
        kgather.resident_plan(400_000, 256, 2)
    with pytest.raises(ValueError, match="cluster of 17"):
        kgather.resident_plan(4224, 256, 2, cluster=17)


# every (N, C) the tools, chip_smoke.py and these tests give the kernel
RESIDENT_SHAPES = [(4224, 256), (4224, 32), (1000, 48), (10_000, 256)]


@pytest.mark.parametrize("cluster", [None, *kgather.RESIDENT_CLUSTERS])
@pytest.mark.parametrize("esz", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", RESIDENT_SHAPES,
                         ids=[f"N{n}_C{c}" for n, c in RESIDENT_SHAPES])
def test_resident_plan_covers_rows_and_channels(shape, esz, cluster):
    N, C = shape
    plan = kgather.resident_plan(N, C, esz, cluster=cluster)
    cs, S, rows = plan["cluster"], plan["slice"], plan["rows"]
    assert cs == (cluster or kgather.RESIDENT_CLUSTERS[0]) <= 16
    # a block's rows, weights, tap lists and mbarrier fit the H100's 227 KB
    assert plan["smem"] == (rows * S * esz + 27 * S * esz + rows * 28 * 4
                            + 8) <= 232448
    # the blocks' row ranges cover each row exactly once, each block's
    # starting 16-byte aligned in the tap-list words
    assert rows % 4 == 0
    seen = np.zeros(N, int)
    for r in range(cs):
        seen[r * rows:min(N, (r + 1) * rows)] += 1
    assert (seen == 1).all()
    # the clusters' channel slices tile C in whole 16-byte vectors
    assert S * esz % 16 == 0 and C % S == 0
    assert plan["clusters_per_sample"] * S == C
    # the widest slice that fits: twice as wide would not
    wider = [d for d in range(S + 1, C + 1)
             if C % d == 0 and d * esz % 16 == 0]
    assert all(rows * d * esz + 27 * d * esz + rows * 28 * 4 + 8 > 232448
               for d in wider)


@pytest.mark.parametrize("esz", [2, 4], ids=["bf16", "fp32"])
def test_resident_plan_raises_when_nothing_fits(esz):
    # 16 blocks of 227 KB hold about 3.6 MB: 300k rows of one 16-byte
    # vector do not fit, nor does a C without whole vectors
    with pytest.raises(ValueError, match="no cluster plan"):
        kgather.resident_plan(300_000, 16 // esz, esz)
    with pytest.raises(ValueError, match="no cluster plan"):
        kgather.resident_plan(64, 2, esz)


def test_dtab_plan_bins_fit_one_cluster():
    # the probe's dtab: 8 x 48 x 48 rows of 16 heads into 231 rows, one
    # cluster of 16 blocks of 1152 rows (73.7 KB of g, 9 KB of indices and
    # their order), 14.8 KB of bins (16 slices of 232) and 1.8 KB of counts
    n, H, R = tprobe.WT * tprobe.K * tprobe.K, tprobe.H, tprobe.R
    plan = kcon.dtab_plan(n, H, R)
    assert plan == {"cluster": 16, "threads": 1024, "rows_per_block": 1152,
                    "smem": 4 * (16 * 232 + 464 + 1152 * (2 + H))}
    # shares start 16-byte aligned and cover every row
    for m in (1, 5, 18433):
        per = kcon.dtab_plan(m, H, R)["rows_per_block"]
        assert per % 4 == 0 and 16 * per >= m > 16 * (per - 4)
    # what does not fit the card's shared memory is refused, not cut
    with pytest.raises(ValueError, match="do not fit"):
        kcon.dtab_plan(n, H, 232448 // (6 * H))
    with pytest.raises(ValueError, match="do not fit"):
        kcon.dtab_plan(16 * 4096, H, R)
    with pytest.raises(ValueError, match="do not fit"):
        kcon.dtab_plan(n, H, R, smem=48 * 1024)


def test_time_fn_on_cpu_uses_the_host_clock():
    st = profiling.time_fn(lambda: torch.ones(4) * 2, iters=3, warmup=1)
    assert st["clock"] == "host" and st["iters"] == 3
    assert 0 <= st["min_ms"] <= st["median_ms"]
    assert profiling.block({"a": [torch.ones(2)]})["a"][0].sum() == 2
    profiling.fetch_sync((torch.ones(1),))


def test_print_info_and_step_cost(capsys):
    model = torch.nn.Sequential(torch.nn.Linear(8, 4),
                                torch.nn.Sequential(torch.nn.Linear(4, 2)))
    x = torch.ones(5, 8)
    info = profiling.print_info("tiny", model, depth=1, step_fn=model,
                                example_args=(x,))
    assert info["total_params"] == 8 * 4 + 4 + 4 * 2 + 2
    assert info["groups"] == {"0": 36, "1": 10}
    assert info["cost"]["flops"] == 2 * 5 * (8 * 4 + 4 * 2)
    assert "Total parameters: 46" in capsys.readouterr().out
    assert profiling.step_cost(torch.mm, torch.ones(3, 4),
                               torch.ones(4, 6)) == {"flops": 2 * 3 * 4 * 6}


def test_trace_writes_only_into_its_logdir(tmp_path):
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.annotate("inner"):
            torch.ones(16, 16) @ torch.ones(16, 16)
    assert _tree(tmp_path) == ["tr", "tr/kernels.txt", "tr/trace.json"]
    assert "inner" in (tmp_path / "tr" / "trace.json").read_text()


def test_device_ms_refuses_work_without_device_time():
    # CPU work has no device time: the helper raises instead of
    # returning a number that could pass for one
    with pytest.raises(RuntimeError, match="no device time"):
        profiling.device_ms(lambda: torch.ones(8) * 2, iters=2)


@pytest.mark.parametrize("name", sorted(tprobe.CONSTRUCT_PROBES))
def test_construct_library_call_computes_the_construct(name):
    args = tprobe.construct_inputs()[name]
    fn, ref_fn, _ = kcon.CONSTRUCTS[name]
    ref = ref_fn(*args)
    lib = tprobe.construct_library(name, args)
    assert lib is not None, name        # one PyTorch call for every one
    tprobe.check_construct(name, lib().reshape(ref.shape), ref)
    nbytes, flops = tprobe.construct_cost(name, args, ref)
    assert nbytes >= ref.numel() * ref.element_size()
    assert (flops > 0) == (name in ("headloop", "dk", "packbias"))


@pytest.mark.parametrize("case", range(6))
def test_take_library_matches_take_rows(case):
    name, x, idx = tprobe.gather_inputs()[case]
    lib, nbytes = tbench.take_library(x, idx)
    assert torch.equal(lib(), kgather.take_rows(x, idx)), name
    rows = len(np.unique(idx.numpy()))
    assert nbytes == ((rows + idx.numel()) * x.shape[1] * x.element_size()
                      + 4 * idx.numel())


def test_take_library_on_a_strided_batched_table(tables):
    port, _ = tables
    nj = torch.from_numpy(port)
    x = torch.arange(2 * port.shape[1] * 8, dtype=torch.float32).reshape(
        2, -1, 8)
    lib, nbytes = tbench.take_library(x, nj[..., 0])
    assert torch.equal(lib(), kgather.take_rows_reference(x, nj[..., 0]))
    # tap 0 of a 27-wide row: each index in its own 32-byte sector
    assert nbytes % 32 == 0 and nbytes > 32 * nj[..., 0].numel()


def test_bound_ms_takes_the_larger_time():
    ms, by = profiling.bound_ms(3.35e9, 0, "bf16")
    assert ms == pytest.approx(1.0) and by == "bytes"
    ms, by = profiling.bound_ms(0, 2 * 67e9, "fp32")
    assert ms == pytest.approx(2.0) and by == "operations"
    assert profiling.bound_ms(1, 989e9, "bf16")[1] == "operations"


def test_probe_ab_summarises_runs_per_side():
    from hotformerloc_torch.tools import probe_ab
    t4 = "take2d_N512_T512_float32"
    runs = [("a", {"pl_dw": {"device_ms": 0.1, "bound_ms": 0.01,
                             "maxdiff": 0.0},
                   t4: {"device_ms": 0.0018, "library_device_ms": 0.0016}}),
            ("b", {"pl_dw": {"device_ms": 0.03, "cluster": 16},
                   "dk": {"device_ms": 0.002, "body": "tc"}}),
            ("b", {"pl_dw": {"device_ms": 0.031, "cluster": 16}}),
            ("a", {"pl_dw": {"device_ms": 0.11, "bound_ms": 0.01},
                   t4: {"device_ms": 0.0020, "library_device_ms": 0.0017}})]
    summary = probe_ab.summarise(runs)
    assert summary == {
        "a": {"pl_dw": {"device_ms": [0.1, 0.11], "bound_ms": [0.01, 0.01]},
              t4: {"device_ms": [0.0018, 0.0020],
                   "library_device_ms": [0.0016, 0.0017]}},
        "b": {"pl_dw": {"device_ms": [0.03, 0.031], "cluster": [16, 16]},
              "dk": {"device_ms": [0.002], "body": ["tc"]}}}
    med = probe_ab.medians(summary)
    assert med["a"][t4] == pytest.approx({"device_ms": 0.0019,
                                          "library_device_ms": 0.00165})
    assert med["b"]["pl_dw"] == pytest.approx({"device_ms": 0.0305,
                                               "cluster": 16})
    assert med["b"]["dk"] == {"device_ms": 0.002}   # "tc" is no number


def test_probe_ab_reads_every_tool_run():
    from hotformerloc_torch.tools import probe_ab
    # T1/T2, T3 and T4: each tool run's file and its lines' names
    assert [a for _, a in probe_ab.TOOLS] == [[], ["constructs"],
                                              ["gather"]]
    files = {probe_ab.out_file(t, a) for t, a in probe_ab.TOOLS}
    assert files == {"gather_bench.json", "mosaic_probe_constructs.json",
                     "mosaic_probe_gather.json"}
    gather = {"lines": [{"probe": n, "device_ms": 1.0}
                        for n, _, _ in tprobe.gather_inputs()]}
    assert sorted(probe_ab.tool_lines("mosaic_probe", ["gather"], gather)) \
        == sorted(n for n, _, _ in tprobe.gather_inputs())
    cons = {"lines": [{"construct": "softmax", "probe": "softmax3d"}]}
    assert list(probe_ab.tool_lines("mosaic_probe", ["constructs"],
                                    cons)) == ["softmax"]
    assert probe_ab.tool_lines("gather_bench", [], {"results": {
        "pl_take": {}}}) == {"pl_take": {}}


# -- onehot4d and pad on their plans ------------------------------------------


def emulate_onehot(idx, tab, plan):
    """onehot4d_kernel's index arithmetic in numpy: (the (rows, H) output
    it writes, how often it writes each unit), after checking that every
    lane finds its unit's row and place and that the row's index was read
    by a lane of its warp (at most 32 rows a warp)."""
    rows, (R, H) = idx.size, tab.shape
    vec, U = plan["vec"], plan["per_lane"]
    u = H // vec
    total = rows * u
    tv = kcon.onehot4d_reference(torch.arange(R, dtype=torch.int32),
                                 torch.from_numpy(tab)).numpy()
    tv = tv.reshape(R * u, vec)
    out = np.full((total, vec), np.nan, np.float32)
    seen = np.zeros(total, int)
    lane = np.arange(32)
    q32, r32 = divmod(32, u)
    flat = idx.reshape(-1).astype(np.int64)
    for w in range(plan["blocks"] * plan["threads"] // 32):
        s = w * 32 * U
        if s >= total:
            continue
        row0, lead = divmod(s, u)
        read = (lane * u <= lead + 32 * U - 1) & ((row0 + lane) * u < total)
        r = np.where(read, flat[np.minimum(row0 + lane, rows - 1)], -1)
        rel, v = (lead + lane) // u, (lead + lane) % u
        for k in range(U):
            f = s + lane + 32 * k
            m = f < total
            assert (rel[m] < 32).all() and read[rel[m]].all()
            assert (rel[m] == f[m] // u - row0).all()
            assert (v[m] == f[m] % u).all()
            sr = r[rel & 31]
            on = m & (sr >= 0) & (sr < R)
            out[f[m]] = 0.0
            out[f[on]] = tv[sr[on] * u + v[on]]
            seen[f[m]] += 1
            v, rel = v + r32, rel + q32
            rel, v = np.where(v >= u, rel + 1, rel), np.where(
                v >= u, v - u, v)
    return out.reshape(rows, H), seen


# (rows, H): the probe's, H 8, 6, 1, 12, 3, 64, 2, 40, a single row
ONEHOT_PLAN_SHAPES = [(8 * 48 * 48, 16), (333, 8), (1000, 6), (777, 1),
                      (50, 12), (7, 3), (5000, 64), (4097, 2), (100, 40),
                      (1, 16)]


@pytest.mark.parametrize("rows,H", ONEHOT_PLAN_SHAPES)
def test_onehot_plan_covers_units_once(rows, H):
    plan = kcon.onehot_plan(rows, H)
    vec, U, bw = plan["vec"], plan["per_lane"], kgather.BLOCK_WARPS
    assert vec == (4 if H % 4 == 0 else 1) and plan["threads"] == 32 * bw
    u = H // vec
    assert U in kgather.TAKE_PER_LANE and 32 * U < 31 * u + 2
    assert plan["blocks"] == -(-(-(-rows * u // (32 * U))) // bw)
    if rows * u >= 32 * bw * kgather.SMS:       # every SM a block
        assert plan["blocks"] >= kgather.SMS
    R = 231
    rng = np.random.default_rng(rows + H)
    tab = rng.normal(0, 1, (R, H)).astype(np.float32)
    idx = rng.integers(-2, R + 2, (rows,)).astype(np.int32)
    idx[:4] = [-1, R, 2 ** 31 - 1, R - 1][:rows]
    out, seen = emulate_onehot(idx, tab, plan)
    assert (seen == 1).all()
    want = kcon.onehot4d(torch.from_numpy(idx), torch.from_numpy(tab))
    assert np.array_equal(out, want.numpy())     # the plain version


def emulate_pad(b, G, plan):
    """pad_kernel's index arithmetic in numpy, a thread a 16-byte vector
    (the last one the tail): (the output it writes, how often it writes
    each float)."""
    WT, K, _ = b.shape
    P = K + G
    total = WT * P * P
    out = np.full(total, np.nan, np.float32)
    seen = np.zeros(total, int)
    src = b.reshape(-1)
    f0 = 4 * np.arange(plan["blocks"] * plan["threads"])
    live = f0 < total
    w, rem = f0 // (P * P), f0 % (P * P)
    r, j = rem // P, rem % P
    for e in range(4):
        f = f0 + e
        m = live & (f < total)
        inside = (r >= G) & (j >= G)
        at = np.where(inside, (w * K + r - G) * K + j - G, 0)
        vals = np.where(inside, src[np.minimum(at, src.size - 1)], 0.0)
        out[f[m]] = vals[m]
        seen[f[m]] += 1
        j = j + 1
        r, j = np.where(j == P, r + 1, r), np.where(j == P, 0, j)
        w, r = np.where(r == P, w + 1, w), np.where(r == P, 0, r)
    return out.reshape(WT, P, P), seen


# (WT, K, G): the probe's, G 0 and 2, odd K, one window, K 1, a tail
PAD_PLAN_SHAPES = [(8, 48, 1), (8, 48, 0), (8, 48, 2), (3, 7, 1),
                   (1, 5, 2), (1, 48, 1), (5, 1, 1), (2, 7, 0), (1, 1, 0),
                   (13, 9, 2)]


@pytest.mark.parametrize("WT,K,G", PAD_PLAN_SHAPES)
def test_pad_plan_covers_output_once(WT, K, G):
    plan = kcon.pad_plan(WT, K, G)
    total = WT * (K + G) ** 2
    assert (plan["vectors"], plan["tail"]) == divmod(total, 4)
    assert plan["threads"] == 32 * kgather.BLOCK_WARPS
    writers = plan["vectors"] + (plan["tail"] > 0)
    assert (plan["blocks"] - 1) * plan["threads"] < writers \
        <= plan["blocks"] * plan["threads"]
    b = np.random.default_rng(WT * K + G).normal(
        0, 1, (WT, K, K)).astype(np.float32)
    out, seen = emulate_pad(b, G, plan)
    assert (seen == 1).all()
    want = kcon.pad(torch.from_numpy(b), G)          # the plain version
    assert np.array_equal(out, want.numpy())


def test_onehot_and_pad_plans_refuse_what_the_kernels_refuse():
    for rows, H in ((0, 16), (10, 0), (2 ** 27, 16), (2 ** 31, 1)):
        with pytest.raises(ValueError, match="no plan"):
            kcon.onehot_plan(rows, H)
    assert kcon.onehot_plan(2 ** 27 - 1, 16)["vec"] == 4
    for WT, K, G in ((0, 48, 1), (8, 0, 1), (8, 48, -1),
                     (2 ** 20, 46, 2)):
        with pytest.raises(ValueError, match="no plan"):
            kcon.pad_plan(WT, K, G)


def test_floor_kernels_are_card_only():
    x = torch.zeros(64, 4)
    with pytest.raises(ValueError, match="measured on the card"):
        kcon.floor_empty(x)
    with pytest.raises(ValueError, match="measured on the card"):
        kcon.floor_chain(x, torch.zeros(32, dtype=torch.int32), 32)
