"""The kernel modules of hotformerloc_torch on the CPU, where each wrapper
runs its plain version, held against the JAX Pallas ops in interpret
mode (as tests/test_pallas_attn.py and tests/test_band_conv.py run them)
and against the flat JAX ops, to 1e-5:

* K1 window_attn vs fused_window_attention, G in {0, 1}, RPE on/off;
* K3 octree_dwconv vs banded_dwconv and ops/conv.octree_dwconv;
* K5 octree_conv vs banded_conv and ops/conv.octree_conv, on neighbour
  tables of real octrees whose JAX band tables report no overflow.

Their gradients, through the autograd Functions whose backward is K2, K4
and K6 on the card and the plain backward here, are held against
jax.vjp of the same ops (dq/dk/dv/dx to 1e-5; the RPE table and conv
weight gradients to 1e-4), and the plain backwards against autograd of
the plain forwards, on the port's real tables (flip identity included).

The kernels themselves run only on the card: chip_smoke.py holds each
against its plain version there. Here the wrappers must refuse any
device that is neither CPU nor CUDA, and a missing nvcc must raise.
"""
import torch_threads  # noqa: F401  (first: one torch thread per worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hotformerloc_tpu.ops import conv as jconv
from hotformerloc_tpu.ops.pallas import band_conv as jband
from hotformerloc_tpu.ops.pallas.window_attn import fused_window_attention
from hotformerloc_torch.models import layers as tlayers
from hotformerloc_torch.ops import conv as tconv
from hotformerloc_torch.ops.kernels import build
from hotformerloc_torch.ops.kernels import norm as knorm
from hotformerloc_torch.ops.kernels import octree_conv as kconv
from hotformerloc_torch.ops.kernels import window_attn as kattn

TOL = dict(rtol=0, atol=1e-5)


def _attn_inputs(seed, G, BW=8, K=16, C=32, H=4, bnd=12):
    rng = np.random.default_rng(seed)
    T = K + G
    q, k, v = (rng.standard_normal((BW, T, C)).astype(np.float32)
               for _ in range(3))
    xyz = rng.integers(0, 32, (BW, 3, K)).astype(np.int32)
    mask = np.ones((BW, T), np.int32)
    mask[1, 10:] = 0
    mask[3, :] = 0
    table = (rng.standard_normal((3 * (2 * bnd + 1), H)) * 0.1).astype(
        np.float32)
    return q, k, v, xyz, mask, table, H, bnd


@pytest.mark.parametrize("use_rpe,G", [(True, 0), (True, 1), (False, 0),
                                       (False, 1)])
def test_window_attn_matches_pallas(use_rpe, G):
    q, k, v, xyz, mask, table, H, bnd = _attn_inputs(G + 2 * use_rpe, G)
    ref = np.asarray(fused_window_attention(
        *(jnp.asarray(a) for a in (q, k, v, xyz, mask, table)), H, 1, bnd,
        use_rpe, 8, True, 32))
    out = kattn.window_attention(
        *(torch.from_numpy(a) for a in (q, k, v, xyz, mask, table)), H, bnd,
        use_rpe)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert np.all(out.numpy()[mask == 0] == 0.0)


def test_window_attn_bf16_plain_keeps_dtype():
    q, k, v, xyz, mask, table, H, bnd = _attn_inputs(9, 1)
    args = [torch.from_numpy(a) for a in (q, k, v, xyz, mask, table)]
    for i in range(3):
        args[i] = args[i].to(torch.bfloat16)
    out = kattn.window_attention(*args, H, bnd)
    ref = kattn.window_attention(*(torch.from_numpy(a) for a in
                                   (q, k, v, xyz, mask, table)), H, bnd)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=5e-2)


@pytest.fixture(scope="module")
def octree_tables():
    """Real 27-tap tables (B=2, N=512 at depth 5) from the port's octree
    build, and the JAX band tables over them (tile 64, halo 128)."""
    from hotformerloc_torch.octree.build import build_batched_octree
    from hotformerloc_torch.ops.plan import build_plan
    rng = np.random.default_rng(3)
    pts = rng.uniform(-0.9, 0.9, (2, 1024, 3)).astype(np.float32)
    ot = build_batched_octree(torch.from_numpy(pts),
                              torch.ones(2, 1024, dtype=torch.bool), 5, 3,
                              (64, 512, 512))
    neigh = build_plan(ot).neighs[-1].numpy()
    S, HR = 64, 128
    bt = jband.build_band_tables(jnp.asarray(neigh), S, HR)
    assert int(np.asarray(bt.overflow).sum()) == 0
    loc = jband._band_loc(jnp.asarray(neigh), S, HR)
    return neigh, bt, loc


@pytest.mark.parametrize("C", [32, 48])
def test_dwconv_matches_banded_and_flat(octree_tables, C):
    neigh, bt, loc = octree_tables
    rng = np.random.default_rng(C)
    x = rng.standard_normal((2, neigh.shape[1], C)).astype(np.float32)
    w = (rng.standard_normal((27, C)) * 0.2).astype(np.float32)
    out = kconv.octree_dwconv(torch.from_numpy(x), torch.from_numpy(neigh),
                              torch.from_numpy(w)).numpy()
    banded = jband.banded_dwconv(jnp.asarray(x), loc, jnp.asarray(w), bt,
                                 True)
    flat = jconv.octree_dwconv(jnp.asarray(x), jnp.asarray(neigh),
                               jnp.asarray(w))
    np.testing.assert_allclose(out, np.asarray(banded), **TOL)
    np.testing.assert_allclose(out, np.asarray(flat), **TOL)


@pytest.mark.parametrize("C,O", [(32, 32), (64, 48)])
def test_conv_matches_banded_and_flat(octree_tables, C, O):
    neigh, bt, loc = octree_tables
    rng = np.random.default_rng(C + O)
    x = rng.standard_normal((2, neigh.shape[1], C)).astype(np.float32)
    w = (rng.standard_normal((27, C, O)) / np.sqrt(27 * C)).astype(np.float32)
    b = rng.standard_normal(O).astype(np.float32)
    out = kconv.octree_conv(torch.from_numpy(x), torch.from_numpy(neigh),
                            torch.from_numpy(w), torch.from_numpy(b)).numpy()
    banded = jband.banded_conv(jnp.asarray(x), loc, jnp.asarray(w),
                               jnp.asarray(b), bt, True)
    flat = jconv.octree_conv(jnp.asarray(x), jnp.asarray(neigh),
                             jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_allclose(out, np.asarray(banded), **TOL)
    np.testing.assert_allclose(out, np.asarray(flat), **TOL)


@pytest.mark.parametrize("C,O", [(3, 8), (5, 7)])
def test_conv_any_channel_count_matches_flat(octree_tables, C, O):
    """The stem's first conv has C=3, below the JAX band path's limit:
    the port's conv takes any C and equals the flat JAX op."""
    neigh, _, _ = octree_tables
    rng = np.random.default_rng(C * O)
    x = rng.standard_normal((2, neigh.shape[1], C)).astype(np.float32)
    w = (rng.standard_normal((27, C, O)) / np.sqrt(27 * C)).astype(np.float32)
    out = kconv.octree_conv(torch.from_numpy(x), torch.from_numpy(neigh),
                            torch.from_numpy(w), None).numpy()
    flat = jconv.octree_conv(jnp.asarray(x), jnp.asarray(neigh),
                             jnp.asarray(w))
    np.testing.assert_allclose(out, np.asarray(flat), **TOL)


def test_down_and_dense_convs_match_jax():
    """The plain stride-2 conv and the dense-grid depthwise conv."""
    from hotformerloc_torch.octree.build import build_batched_octree
    from hotformerloc_torch.ops.plan import build_plan
    rng = np.random.default_rng(11)
    pts = rng.uniform(-0.9, 0.9, (2, 600, 3)).astype(np.float32)
    ot = build_batched_octree(torch.from_numpy(pts),
                              torch.ones(2, 600, dtype=torch.bool), 4, 2,
                              (64, 512, 600))
    plan = build_plan(ot, dense_depths=(3,))
    x = rng.standard_normal((2, 600, 16)).astype(np.float32)
    w = (rng.standard_normal((8, 16, 24)) * 0.2).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    ch = plan.children(4)
    out = tconv.octree_down_conv(torch.from_numpy(x), ch,
                                 torch.from_numpy(w), torch.from_numpy(b))
    ref = jconv.octree_down_conv(jnp.asarray(x), jnp.asarray(ch.numpy()),
                                 jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    ctx = plan.level_ctx(3)
    x3 = rng.standard_normal((2, 512, 16)).astype(np.float32)
    wd = (rng.standard_normal((27, 16)) * 0.2).astype(np.float32)
    dense = tconv.octree_dwconv_dense(torch.from_numpy(x3), ctx.xyz,
                                      ctx.node_valid, torch.from_numpy(wd), 3,
                                      ctx.dense_idx)
    gather = tconv.octree_dwconv(torch.from_numpy(x3), ctx.neigh,
                                 torch.from_numpy(wd))
    jref = jconv.octree_dwconv_dense(
        jnp.asarray(x3), jnp.asarray(ctx.keys.numpy()),
        jnp.asarray(ctx.counts.numpy()), jnp.asarray(ctx.xyz.numpy()),
        jnp.asarray(ctx.node_valid.numpy()), jnp.asarray(wd), 3)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jref), **TOL)
    np.testing.assert_allclose(dense.numpy(), gather.numpy(), **TOL)


def test_wrappers_refuse_other_devices():
    """Only a CPU tensor reaches a plain version; any other non-CUDA
    device raises instead of falling back."""
    m = dict(device="meta")
    q = torch.empty(2, 9, 8, **m)
    with pytest.raises(ValueError):
        kattn.window_attention(q, q, q, torch.empty(2, 3, 8, dtype=torch.int32,
                                                    **m),
                               torch.empty(2, 9, dtype=torch.int32, **m),
                               torch.empty(21, 2, **m), 2, 3)
    x = torch.empty(2, 10, 4, **m)
    nb = torch.empty(2, 10, 27, dtype=torch.int32, **m)
    with pytest.raises(ValueError):
        kconv.octree_dwconv(x, nb, torch.empty(27, 4, **m))
    with pytest.raises(ValueError):
        kconv.octree_conv(x, nb, torch.empty(27, 4, 5, **m))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "_nvcc_default", str(tmp_path / "no-nvcc"))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build_all()


# -- backward: K2, K4, K6 through their autograd Functions ------------------


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


@pytest.mark.parametrize("use_rpe,G", [(True, 0), (True, 1), (False, 0),
                                       (False, 1)])
def test_window_attn_grads_match_pallas_vjp(use_rpe, G):
    """K2 via WindowAttentionFn on the CPU (the plain backward) against
    jax.vjp of the Pallas op in interpret mode: dq, dk, dv to 1e-5 and
    the RPE table gradient to 1e-4, with a window that has invalid rows
    (1) and one that is all invalid (3)."""
    q, k, v, xyz, mask, table, H, bnd = _attn_inputs(20 + G + 2 * use_rpe, G)
    g = np.random.default_rng(G).standard_normal(q.shape).astype(np.float32)

    def f(q_, k_, v_, tab_):
        return fused_window_attention(q_, k_, v_, jnp.asarray(xyz),
                                      jnp.asarray(mask), tab_, H, 1, bnd,
                                      use_rpe, 8, True, 32)

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v, table)))
    ref = [np.asarray(r) for r in vjp(jnp.asarray(g))]
    ins = [_t(q, True), _t(k, True), _t(v, True), _t(table, True)]
    out = kattn.window_attention(ins[0], ins[1], ins[2], _t(xyz), _t(mask),
                                 ins[3], H, bnd, use_rpe)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    for t, r, name in zip(ins, ref, ("dq", "dk", "dv", "dtable")):
        np.testing.assert_allclose(t.grad.numpy(), r, rtol=0,
                                   atol=1e-4 if name == "dtable" else 1e-5,
                                   err_msg=name)
    assert np.all(ins[0].grad.numpy()[mask == 0] == 0.0)


def test_window_attn_fn_wiring_and_plain_grads():
    """needs_input_grad: only the asked-for gradients come back; the plain
    backward equals autograd through the plain forward; bf16 inputs give
    bf16 dq/dk/dv and an fp32 table gradient."""
    q, k, v, xyz, mask, table, H, bnd = _attn_inputs(31, 1)
    qt, kt, vt, tt = _t(q, True), _t(k), _t(v, True), _t(table, True)
    out = kattn.window_attention(qt, kt, vt, _t(xyz), _t(mask), tt, H, bnd)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    out.backward(g)
    assert kt.grad is None and qt.grad is not None
    q2, v2, t2 = _t(q, True), _t(v, True), _t(table, True)
    ref = kattn.window_attention_reference(q2, _t(k), v2, _t(xyz), _t(mask),
                                           t2, H, bnd)
    want = torch.autograd.grad(ref, (q2, v2, t2), g)
    for got, w in zip((qt.grad, vt.grad, tt.grad), want):
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0, atol=1e-5)
    qb, kb, vb = (_t(a).to(torch.bfloat16).requires_grad_() for a in (q, k, v))
    tb = _t(table, True)
    ob = kattn.window_attention(qb, kb, vb, _t(xyz), _t(mask), tb, H, bnd)
    ob.backward(g.to(torch.bfloat16))
    assert qb.grad.dtype == torch.bfloat16 and tb.grad.dtype == torch.float32


@pytest.mark.parametrize("C", [32, 48])
def test_dwconv_grads_match_banded_and_flat_vjp(octree_tables, C):
    """K4 via OctreeDwconvFn: dx to 1e-5, dw to 1e-4, against the vjp of
    banded_dwconv (interpret) and of the flat op."""
    neigh, bt, loc = octree_tables
    rng = np.random.default_rng(100 + C)
    x = rng.standard_normal((2, neigh.shape[1], C)).astype(np.float32)
    w = (rng.standard_normal((27, C)) * 0.2).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    jn = jnp.asarray(neigh)
    refs = []
    for f in (lambda x_, w_: jband.banded_dwconv(x_, loc, w_, bt, True),
              lambda x_, w_: jconv.octree_dwconv(x_, jn, w_)):
        _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
        refs.append([np.asarray(r) for r in vjp(jnp.asarray(dy))])
    xt, wt = _t(x, True), _t(w, True)
    out = kconv.octree_dwconv(xt, torch.from_numpy(neigh), wt)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(dy))
    for dx_ref, dw_ref in refs:
        np.testing.assert_allclose(xt.grad.numpy(), dx_ref, rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(wt.grad.numpy(), dw_ref, rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("C,O", [(32, 32), (64, 48)])
def test_conv_grads_match_banded_and_flat_vjp(octree_tables, C, O):
    """K6 via OctreeConvFn: dx to 1e-5, dw and db to 1e-4, against the vjp
    of banded_conv (interpret) and of the flat op."""
    neigh, bt, loc = octree_tables
    rng = np.random.default_rng(200 + C + O)
    x = rng.standard_normal((2, neigh.shape[1], C)).astype(np.float32)
    w = (rng.standard_normal((27, C, O)) / np.sqrt(27 * C)).astype(np.float32)
    b = rng.standard_normal(O).astype(np.float32)
    dy = rng.standard_normal((2, neigh.shape[1], O)).astype(np.float32)
    jn = jnp.asarray(neigh)
    refs = []
    for f in (lambda x_, w_, b_: jband.banded_conv(x_, loc, w_, b_, bt, True),
              lambda x_, w_, b_: jconv.octree_conv(x_, jn, w_, b_)):
        _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (x, w, b)))
        refs.append([np.asarray(r) for r in vjp(jnp.asarray(dy))])
    ins = [_t(x, True), _t(w, True), _t(b, True)]
    out = kconv.octree_conv(ins[0], torch.from_numpy(neigh), ins[1], ins[2])
    out.backward(torch.from_numpy(dy))
    for ref in refs:
        for t, r, tol in zip(ins, ref, (1e-5, 1e-4, 1e-4)):
            np.testing.assert_allclose(t.grad.numpy(), r, rtol=0, atol=tol)


def test_conv_grads_c3_without_dx(octree_tables):
    """The stem's first conv: C = 3, x (the input features) needs no
    gradient, so the Function skips dx; dw and db equal the flat op's."""
    neigh, _, _ = octree_tables
    rng = np.random.default_rng(33)
    x = rng.standard_normal((2, neigh.shape[1], 3)).astype(np.float32)
    w = (rng.standard_normal((27, 3, 8)) / 9.0).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    dy = rng.standard_normal((2, neigh.shape[1], 8)).astype(np.float32)
    _, vjp = jax.vjp(lambda w_, b_: jconv.octree_conv(
        jnp.asarray(x), jnp.asarray(neigh), w_, b_), jnp.asarray(w),
        jnp.asarray(b))
    dw_ref, db_ref = (np.asarray(r) for r in vjp(jnp.asarray(dy)))
    xt, wt, bt_ = _t(x), _t(w, True), _t(b, True)
    out = kconv.octree_conv(xt, torch.from_numpy(neigh), wt, bt_)
    out.backward(torch.from_numpy(dy))
    assert xt.grad is None
    np.testing.assert_allclose(wt.grad.numpy(), dw_ref, rtol=0, atol=1e-4)
    np.testing.assert_allclose(bt_.grad.numpy(), db_ref, rtol=0, atol=1e-4)
    dx, dw, db = kconv.octree_conv_bwd(xt, torch.from_numpy(neigh), wt.detach(),
                                       torch.from_numpy(dy), need_dx=False)
    assert dx is None and dw.dtype == torch.float32


@pytest.fixture(scope="module")
def padded_tables():
    """Every 27-tap table of a port octree whose levels hold padding rows
    (counts below capacity)."""
    from hotformerloc_torch.octree.build import build_batched_octree
    from hotformerloc_torch.ops.plan import build_plan
    rng = np.random.default_rng(12)
    pts = rng.uniform(-0.9, 0.9, (2, 700, 3)).astype(np.float32)
    pm = np.ones((2, 700), bool)
    pm[1, 400:] = False
    ot = build_batched_octree(torch.from_numpy(pts), torch.from_numpy(pm), 5,
                              3, (512, 640, 768))
    tables = build_plan(ot).neighs
    counts = [ot.count(d) for d in range(3, 6)]
    assert all(int(c.min()) < t.shape[1] for c, t in zip(counts, tables))
    return tables


def test_flip_identity_on_port_tables(padded_tables):
    """neigh[m, k] = n <=> neigh[n, 26 - k] = m on every level, padding
    rows (all -1) included: the identity behind dx of K4 and K6."""
    for neigh in padded_tables:
        nb = neigh.numpy()
        B, N, K = nb.shape
        b, m, k = np.nonzero(nb >= 0)
        n = nb[b, m, k]
        assert np.all(nb[b, n, K - 1 - k] == m)
        fwd = np.zeros((B, N, K), int)
        fwd[b, n, K - 1 - k] = 1
        assert np.array_equal(fwd, (nb >= 0).astype(int))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_plain_bwd_equals_autograd(padded_tables, dtype):
    """The Functions' plain backward (flip identity + einsum) equals
    torch.autograd.grad of the plain forward (gather + scatter-add) on
    tables with padding rows; bf16 to one rounding of the output."""
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    gen = torch.Generator().manual_seed(5)
    for neigh in padded_tables:
        B, N, _ = neigh.shape
        x = torch.randn(B, N, 16, generator=gen).to(dtype).requires_grad_()
        wd = (0.2 * torch.randn(27, 16, generator=gen)).requires_grad_()
        w = (0.05 * torch.randn(27, 16, 12, generator=gen)).requires_grad_()
        b = torch.randn(12, generator=gen).requires_grad_()
        for fn, plain_fn, args in (
                (kconv.octree_dwconv, tconv.octree_dwconv, (wd,)),
                (kconv.octree_conv, tconv.octree_conv, (w, b))):
            out = fn(x, neigh, *args)
            dy = torch.randn(out.shape, generator=gen).to(dtype)
            got = torch.autograd.grad(out, (x, *args), dy)
            ref = plain_fn(x, neigh, *(a.to(dtype) for a in args))
            want = torch.autograd.grad(ref, (x, *args), dy)
            for gt, wt in zip(got, want):
                assert gt.dtype == wt.dtype
                np.testing.assert_allclose(gt.float().numpy(),
                                           wt.float().numpy(), rtol=tol,
                                           atol=tol)


def test_wrapper_outputs_carry_grad_fn():
    """Every wrapper's output on an input that requires grad carries its
    Function's grad_fn (Function.apply attaches it on any device, so the
    kernels' outputs on the card are never cut from the graph)."""
    x = torch.randn(1, 5, 4, requires_grad=True)
    nb = torch.full((1, 5, 27), -1, dtype=torch.int32)
    nb[0, :, 13] = torch.arange(5, dtype=torch.int32)
    w = torch.randn(27, 4, requires_grad=True)
    assert type(kconv.octree_dwconv(x, nb, w).grad_fn).__name__ \
        == "OctreeDwconvFnBackward"
    assert type(kconv.octree_conv(x, nb, torch.randn(27, 4, 3),
                                  None).grad_fn).__name__ \
        == "OctreeConvFnBackward"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_depthwise_conv3d_backward_equals_autograd(dtype):
    """The dense-grid CPE's explicit backward (27 shifted products) equals
    autograd through F.conv3d (groups=C, padding 1); bf16 to one rounding
    of the input gradient."""
    gen = torch.Generator().manual_seed(8)
    x = torch.randn(2, 6, 8, 8, 8, generator=gen).to(dtype).requires_grad_()
    wk = (0.3 * torch.randn(6, 1, 3, 3, 3, generator=gen)).requires_grad_()
    out = tconv.DepthwiseConv3d.apply(x, wk.to(dtype))
    ref = torch.nn.functional.conv3d(x.float(), wk, padding=1, groups=6)
    np.testing.assert_allclose(out.float().detach().numpy(),
                               ref.detach().numpy(), rtol=0,
                               atol=1e-5 if dtype == torch.float32 else 5e-2)
    g = torch.randn(out.shape, generator=gen)
    got = torch.autograd.grad(out, (x, wk), g.to(dtype))
    want = torch.autograd.grad(ref, (x, wk), g)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=tol,
                                   atol=tol * max(1.0, float(b.abs().max())))


# -- LayerNorm: layer_norm_rows_kernel's wrapper ------------------------------

LN_WIDTHS = (8, 16, 32, 64, 128, 256)
LN_LEADS = {"BNC": (2, 7), "BWTC": (2, 3, 5), "BMC": (3, 11)}


def _ln_inputs(lead, C, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(*lead, C, generator=gen) * 3 + 1).to(dtype)
    w = (1 + 0.5 * torch.randn(C, generator=gen)).to(dtype)
    b = (0.5 * torch.randn(C, generator=gen)).to(dtype)
    return x, w, b


@pytest.mark.parametrize("lead", sorted(LN_LEADS))
@pytest.mark.parametrize("C", LN_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_plain_path_equals_aten(dtype, C, lead):
    """On the CPU the wrapper, the op and the module give F.layer_norm's
    values and dtype, and the op aten's mean and rstd (shaped x.shape[:-1]
    + (1,)), for a contiguous input and a non-contiguous view of it."""
    x, w, b = _ln_inputs(LN_LEADS[lead], C, dtype)
    xt = x.transpose(0, -2).contiguous().transpose(0, -2)
    assert torch.equal(xt, x) and not xt.is_contiguous()
    want = F.layer_norm(x, (C,), w, b, 1e-5)
    _, mean, rstd = torch.native_layer_norm(x, (C,), w, b, 1e-5)
    m = tlayers.layer_norm(C)
    with torch.no_grad():
        m.weight.copy_(w.float())
        m.bias.copy_(b.float())
    for inp in (x, xt):
        got = knorm.layer_norm(inp, w, b, 1e-5)
        y, gm, gr = knorm.layer_norm_op(inp, w, b, 1e-5)
        assert got.dtype == y.dtype == dtype and got.shape == x.shape
        assert torch.equal(got, want) and torch.equal(y, want)
        assert gm.shape == gr.shape == (*x.shape[:-1], 1)
        assert torch.equal(gm, mean) and torch.equal(gr, rstd)
        assert torch.equal(m(inp.to(dtype)), want)


@pytest.mark.parametrize("C", [8, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_grads_equal_autograd(dtype, C):
    """Gradients of x, weight and bias through LayerNormFn equal autograd
    of F.layer_norm (the same aten backward on the same statistics); the
    module's fp32 parameters get fp32 gradients through the cast."""
    x, w, b = _ln_inputs((3, 5), C, dtype, seed=1)
    g = torch.randn(3, 5, C, generator=torch.Generator().manual_seed(2)
                    ).to(dtype)
    got = [t.clone().requires_grad_() for t in (x, w, b)]
    want = [t.clone().requires_grad_() for t in (x, w, b)]
    y = knorm.layer_norm(*got)
    assert type(y.grad_fn).__name__ == "LayerNormFnBackward"
    y.backward(g)
    F.layer_norm(want[0], (C,), want[1], want[2], 1e-5).backward(g)
    for a, e in zip(got, want):
        assert a.grad.dtype == dtype and torch.equal(a.grad, e.grad)
    m = tlayers.layer_norm(C)
    ref = torch.nn.LayerNorm(C, eps=1e-5)
    xs = [x.clone().requires_grad_() for _ in range(2)]
    m(xs[0]).backward(g)
    F.layer_norm(xs[1], (C,), ref.weight.to(dtype), ref.bias.to(dtype),
                 1e-5).backward(g)
    assert torch.equal(xs[0].grad, xs[1].grad)
    for p, q in ((m.weight, ref.weight), (m.bias, ref.bias)):
        assert p.grad.dtype == torch.float32 and torch.equal(p.grad, q.grad)


class _NormBlock(torch.nn.Module):
    """Two LayerNorms around a Linear and a GELU, as a block's MLP."""

    def __init__(self, C):
        super().__init__()
        self.norm1 = tlayers.layer_norm(C)
        self.fc = tlayers.linear(C, C)
        self.norm2 = tlayers.layer_norm(C)
        gen = torch.Generator().manual_seed(3)
        tlayers.init_weights(self, gen)
        with torch.no_grad():
            for n in (self.norm1, self.norm2):
                n.weight.add_(0.3 * torch.randn(C, generator=gen))
                n.bias.add_(0.3 * torch.randn(C, generator=gen))

    def forward(self, x):
        return x + self.norm2(F.gelu(self.fc(self.norm1(x))))


@pytest.mark.parametrize("policy", [None, "save_hot", "keep_layer_norm"])
def test_layer_norm_grads_under_checkpointing(monkeypatch, policy):
    """Under run_block's activation checkpointing the gradients equal
    those of the unchecked block on F.layer_norm. The op is visible to
    the selective policy: 'save_hot' recomputes it (two calls a module),
    a policy keeping ``layer_norm`` does not (one)."""
    from hotformerloc_torch.models import backbone
    from hotformerloc_torch.models.config import tiny_test_config

    if policy == "keep_layer_norm":
        policy = "save_hot"
        monkeypatch.setitem(backbone.REMAT_SAVED_OPS, policy,
                            ("layer_norm",))
        keeps = True
    else:
        keeps = False
    calls = []
    real = knorm.layer_norm_reference
    monkeypatch.setattr(knorm, "layer_norm_reference",
                        lambda *a: calls.append(1) or real(*a))
    cfg = tiny_test_config(grad_checkpoint=True, remat_policy=policy)
    blk = _NormBlock(32)
    x = torch.randn(4, 6, 32, generator=torch.Generator().manual_seed(4))
    xs = [x.clone().requires_grad_() for _ in range(2)]
    backbone.run_block(cfg, blk, xs[0]).square().sum().backward()
    got = [p.grad.clone() for p in blk.parameters()]
    assert len(calls) == (2 if keeps else 4)
    blk.zero_grad()
    for m in (blk.norm1, blk.norm2):
        m.use_kernels = False
    blk(xs[1]).square().sum().backward()
    assert torch.equal(xs[0].grad, xs[1].grad)
    for a, p in zip(got, blk.parameters()):
        assert torch.equal(a, p.grad)


@pytest.mark.parametrize("case", ["meta", "width0", "odd_wide", "too_wide",
                                  "weight_shape", "weight_dtype"])
def test_layer_norm_refuses(case):
    """Other devices, widths the kernel does not take (none, more than 256
    single values, more than 256 vectors) and weights unlike x raise."""
    C, dev, dt, wdt = 16, "cpu", torch.float32, torch.float32
    wshape = None
    if case == "meta":
        dev = "meta"
    elif case == "width0":
        C = 0
    elif case == "odd_wide":
        C = 257
    elif case == "too_wide":
        C, dt, wdt = 2056, torch.bfloat16, torch.bfloat16
    elif case == "weight_shape":
        wshape = (C + 1,)
    else:
        wdt = torch.bfloat16
    x = torch.zeros(3, C, dtype=dt, device=dev)
    w = torch.ones(wshape or (C,), dtype=wdt, device=dev)
    with pytest.raises(ValueError):
        knorm.layer_norm(x, w, torch.zeros_like(w))


@pytest.mark.parametrize("M,C,esz,aligned", [
    (1, 8, 2, True), (37, 8, 2, True), (1000, 32, 2, True),
    (777, 256, 2, True), (300, 512, 2, True), (50, 2048, 2, True),
    (129, 24, 2, True), (200, 3, 4, True), (91, 16, 2, False),
    (65, 100, 4, True), (33, 1024, 4, True), (5000, 64, 4, True)])
def test_layer_norm_plan_covers_every_value_once(M, C, esz, aligned):
    """The kernel's index arithmetic on ``layer_norm_plan``'s plan, with a
    small grid (4 SMs) so that warps loop: every (row, column) is
    written once, no lane reads past its row, a row's lanes are one
    L-lane group of one warp (its shuffles stay inside), and each lane
    holds at most 4 vectors before a reduction (1 from 4 a lane)."""
    p = knorm.layer_norm_plan(M, C, esz, aligned, sms=4)
    units = C // p.vec
    assert p.vec * units == C and p.lanes * p.per_lane >= units
    assert p.lanes == 32 or p.lanes >= units
    assert p.unroll * p.per_lane == max(4, p.per_lane)
    rows_per_group = 32 // p.lanes
    groups = -(-M // rows_per_group)
    nwarps = p.blocks * p.threads // 32
    assert p.blocks <= 4 * knorm.BLOCKS_PER_SM
    hits = np.zeros((M, C), np.int64)
    lanes = np.arange(32)
    sub, row_in = lanes % p.lanes, lanes // p.lanes
    for warp in range(nwarps):
        g = warp
        while g < groups:                     # the kernel's loop
            for u in range(p.unroll):
                row = (g + u * nwarps) * rows_per_group + row_in
                for j in range(p.per_lane):
                    v = sub + j * p.lanes
                    ok = (row < M) & (v < units)
                    for e in range(p.vec):
                        np.add.at(hits, (row[ok], v[ok] * p.vec + e), 1)
            g += p.unroll * nwarps
    assert (hits == 1).all()


def test_layer_norm_plan_on_the_cells_shapes():
    """At the H-OSA shape of both cells (C 256 bf16) the plan is one
    16-byte vector a lane on 32 lanes, 4 rows a warp in flight, on
    ``BLOCKS_PER_SM`` blocks of each SM; the stem's narrow rows share a
    warp."""
    for M in (32 * 88 * 49, 128 * 44 * 65):
        assert knorm.layer_norm_plan(M, 256, 2) == knorm.LayerNormPlan(
            8, 32, 1, 4, False, 256, 132 * knorm.BLOCKS_PER_SM)
    assert knorm.layer_norm_plan(10 ** 6, 32, 2)[:4] == (8, 4, 1, 4)
    assert knorm.layer_norm_plan(2 ** 24, 256, 4).wide


def _ln_widths(cfg):
    from hotformerloc_torch.models.hotformerloc import HOTFormerLoc
    return {m.normalized_shape for m in HOTFormerLoc(cfg, device="meta")
            .modules() if isinstance(m, tlayers.LayerNorm)}


def test_layer_norm_takes_every_shipped_width(monkeypatch):
    """Every LayerNorm width a shipped configuration builds
    (configs/*_model.txt, the models/config.py presets) is one the kernel
    takes on 16-byte vectors, in bf16 and fp32."""
    import glob
    import os

    from hotformerloc_torch.config.params import parse_model_config
    from hotformerloc_torch.models import config as mcfg
    from hotformerloc_torch.models import hotformerloc as mhot

    monkeypatch.setattr(mhot, "init_weights", lambda *a: None)
    root = os.path.join(os.path.dirname(__file__), os.pardir, "configs")
    cfgs = [mcfg.oxford_config(), mcfg.cs_wild_places_config(),
            mcfg.tiny_test_config()]
    cfgs += [parse_model_config(f, octree_depth=7).config
             for f in sorted(glob.glob(os.path.join(root, "*_model.txt")))]
    assert len(cfgs) == 7
    widths = set().union(*(_ln_widths(c) for c in cfgs))
    assert {w[0] for w in widths} >= {8, 16, 32, 64, 128, 256}
    for (C,) in widths:
        for esz in (2, 4):
            assert knorm.layer_norm_plan(1000, C, esz).vec == 16 // esz


def test_norm_bench_runs_on_cpu(tmp_path):
    """tools/norm_bench end to end on the CPU (the plain versions): every
    LayerNorm width of a tiny forward found, every shape held to the
    fp32-statistics result and its training path to aten's (the same
    code here, so exactly), no device number, its file written."""
    from hotformerloc_torch.tools import norm_bench

    lines = norm_bench.run(["--device", "cpu", "--reps", "1",
                            "--out", str(tmp_path)])
    shapes = [ln for ln in lines if "shape" in ln]
    assert sum(ln["calls"] for ln in shapes
               if ln["dtype"] == "bfloat16") > 0
    assert {ln["shape"][1] for ln in shapes} == {8, 16, 32, 64}
    assert all(ln["device_ms"] is None and ln["roofline"] is None
               for ln in shapes)
    assert all(ln.get("err_ulp", 0) <= 1 and ln.get("err_abs", 0) <= 1e-5
               for ln in shapes)
    assert all(ln["y_stats_same"] and ln["mean_err"] == ln["rstd_err"]
               == ln["dx_err"] == ln["dw_err"] == ln["db_err"] == 0
               for ln in shapes)
    assert lines[-1] == {"summary": "tiny_test_config"}
    assert (tmp_path / "norm_bench.json").exists()


@pytest.mark.parametrize("fault", ["y", "mean", "rstd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norm_bench_catches_a_wrong_training_forward(monkeypatch, fault,
                                                     dtype):
    """The tool's training-path check fails when the op's output, mean or
    rstd is off by a fault's size (one row's statistics moved by a
    hundredth, its output by a hundredth of a standard deviation), while
    the serving launch stays right."""
    from hotformerloc_torch.tools import norm_bench

    real = knorm.layer_norm_op

    def faulty(x, w, b, eps):
        y, mean, rstd = (t.clone() for t in real(x, w, b, eps))
        if fault == "y":
            y[3] += (0.01 * w).to(y.dtype)
        else:
            t = mean if fault == "mean" else rstd
            t[3] += 0.01 * (rstd[3] ** -1 if fault == "mean" else t[3])
        return y, mean, rstd

    monkeypatch.setattr(knorm, "layer_norm_op", faulty)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(AssertionError, match="off its limits"):
        norm_bench.shape_line("t", 64, 32, 1, dtype, torch.device("cpu"),
                              1, gen)
