"""The kernel modules of hotformerloc_torch on the CPU, where each wrapper
runs its plain version, held against the JAX Pallas ops in interpret
mode (as tests/test_pallas_attn.py and tests/test_band_conv.py run them)
and against the flat JAX ops, to 1e-5:

* K1 window_attn vs fused_window_attention, G in {0, 1}, RPE on/off;
* K3 octree_dwconv vs banded_dwconv and ops/conv.octree_dwconv;
* K5 octree_conv vs banded_conv and ops/conv.octree_conv, on neighbour
  tables of real octrees whose JAX band tables report no overflow.

The kernels themselves run only on the card: chip_smoke.py holds each
against its plain version there. Here the wrappers must refuse any
device that is neither CPU nor CUDA, and a missing nvcc must raise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hotformerloc_tpu.ops import conv as jconv
from hotformerloc_tpu.ops.pallas import band_conv as jband
from hotformerloc_tpu.ops.pallas.window_attn import fused_window_attention
from hotformerloc_torch.ops import conv as tconv
from hotformerloc_torch.ops.kernels import build
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
