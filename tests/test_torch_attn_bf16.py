"""K1/K2 at bf16 and the choice of their kernel body, on the CPU.

The plain versions of K1 and K2 (ops/kernels/window_attn.py) round where
the JAX kernels round at bf16: the softmax to bf16 before attn . v
(window_attn.py:_fwd_kernel) and before dv, dlog to bf16 before dq and dk
(_bwd_kernel); the table gradient is summed from the fp32 dlog. Held
against fused_window_attention in interpret mode at bf16, from numpy
inputs of a seed:

* forward: every element within one bf16 ulp of JAX, |d| <= 2^-7
  max(1, |ref|), and at least 80% of them bit-equal;
* backward: dq, dk, dv and the table gradient within
  1e-2 max(1, max |ref|) of jax.vjp of the same op.

The same holds at T = 65 (64 nodes and a relay slot, patch 64's H-OSA
windows), with a wholly masked window. ``attn_body`` picks the
tensor-core body for bf16 with a head width that is a multiple of 16 up
to 64, T <= 80 and the tiles within shared memory, the CUDA-core body
otherwise; q, k, v may be strided slices of one projection.
"""
import torch_threads  # noqa: F401  (first: one torch thread per worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hotformerloc_tpu.ops.pallas.window_attn import fused_window_attention
from hotformerloc_torch.ops.kernels import window_attn as kattn

BF16_ULP = 2.0 ** -7


def _inputs(seed, G, BW=8, K=16, C=32, H=2, bnd=12):
    rng = np.random.default_rng(seed)
    T = K + G
    q, k, v, g = (rng.standard_normal((BW, T, C)).astype(np.float32)
                  for _ in range(4))
    xyz = rng.integers(0, 32, (BW, 3, K)).astype(np.int32)
    mask = np.ones((BW, T), np.int32)
    mask[1, 10:] = 0
    mask[3, :] = 0
    table = (rng.standard_normal((3 * (2 * bnd + 1), H)) * 0.1).astype(
        np.float32)
    return q, k, v, g, xyz, mask, table, H, bnd


def _jax_op(xyz, mask, H, bnd):
    def f(q, k, v, table):
        return fused_window_attention(q, k, v, jnp.asarray(xyz),
                                      jnp.asarray(mask), table, H, 1, bnd,
                                      True, 8, True, 32)
    return f


def _bf16_jax(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _bf16_torch(a):
    return torch.from_numpy(a).to(torch.bfloat16)


@pytest.mark.parametrize("G", [0, 1])
def test_bf16_forward_rounds_where_pallas_does(G):
    q, k, v, _, xyz, mask, table, H, bnd = _inputs(0, G)
    ref = np.asarray(_jax_op(xyz, mask, H, bnd)(
        _bf16_jax(q), _bf16_jax(k), _bf16_jax(v), jnp.asarray(table)),
        dtype=np.float32)
    out = kattn.window_attention(
        _bf16_torch(q), _bf16_torch(k), _bf16_torch(v),
        torch.from_numpy(xyz), torch.from_numpy(mask),
        torch.from_numpy(table), H, bnd)
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    diff = np.abs(out - ref)
    assert np.all(diff <= BF16_ULP * np.maximum(1.0, np.abs(ref))), \
        float(diff.max())
    assert np.mean(out == ref) >= 0.8, float(np.mean(out == ref))
    assert np.all(out[mask == 0] == 0.0)


@pytest.mark.parametrize("G", [0, 1])
def test_bf16_backward_matches_pallas_vjp(G):
    q, k, v, g, xyz, mask, table, H, bnd = _inputs(1, G)
    _, vjp = jax.vjp(_jax_op(xyz, mask, H, bnd), _bf16_jax(q), _bf16_jax(k),
                     _bf16_jax(v), jnp.asarray(table))
    ref = [np.asarray(r, dtype=np.float32) for r in vjp(_bf16_jax(g))]
    out = kattn.window_attention_bwd(
        _bf16_torch(q), _bf16_torch(k), _bf16_torch(v),
        torch.from_numpy(xyz), torch.from_numpy(mask),
        torch.from_numpy(table), _bf16_torch(g), H, bnd)
    assert [t.dtype for t in out] == [torch.bfloat16] * 3 + [torch.float32]
    for o, r, name in zip(out, ref, ("dq", "dk", "dv", "dtable")):
        err = float(np.abs(o.float().numpy() - r).max())
        assert err <= 1e-2 * max(1.0, float(np.abs(r).max())), (name, err)
    assert np.all(out[0].float().numpy()[mask == 0] == 0.0)


def test_rounding_is_a_no_op_at_fp32():
    """At fp32 the rounding points change nothing: the plain K1 equals
    attn . v computed from the unrounded softmax."""
    q, k, v, _, xyz, mask, table, H, bnd = _inputs(2, 1)
    args = [torch.from_numpy(a) for a in (q, k, v, xyz, mask, table)]
    out = kattn.window_attention_reference(*args, H, bnd)
    attn, _, _ = kattn._attn_probs(args[0], args[1], args[3], args[4],
                                   args[5], H, bnd, True)
    BW, T, C = q.shape
    vf = args[2].reshape(BW, T, H, C // H)
    want = torch.einsum("whts,wshd->wthd", attn, vf).reshape(BW, T, C)
    assert torch.equal(out, want)


@pytest.mark.parametrize("dtype,T,C,H,want", [
    (torch.bfloat16, 48, 128, 8, "tc"),       # OctFormer, hd 16
    (torch.bfloat16, 49, 256, 16, "tc"),      # H-OSA, hd 16
    (torch.bfloat16, 64, 128, 8, "tc"),
    (torch.bfloat16, 48, 128, 4, "tc"),       # hd 32
    (torch.bfloat16, 49, 256, 8, "tc"),       # hd 32
    (torch.float32, 48, 128, 8, "cc"),        # the fp32 parity path
    (torch.float32, 49, 256, 16, "cc"),
    (torch.bfloat16, 48, 64, 8, "cc"),        # hd 8
    (torch.bfloat16, 48, 120, 5, "cc"),       # hd 24
    (torch.bfloat16, 65, 128, 8, "tc"),       # 64 nodes + a relay slot
])
def test_attn_body_by_dtype_and_shape(dtype, T, C, H, want):
    assert kattn.attn_body(dtype, T, C, H, pos_bnd=38) == want


@pytest.mark.parametrize("dtype,T,C,H,bnd,want,heads", [
    (torch.bfloat16, 65, 256, 16, 51, "tc", 1),   # patch-64 H-OSA
    (torch.bfloat16, 64, 128, 8, 102, "tc", 3),   # patch-64 OctFormer, D 4
    (torch.bfloat16, 64, 128, 8, 51, "tc", 4),    # patch-64 OctFormer, D 1
    (torch.bfloat16, 49, 256, 16, 38, "tc", 4),   # Oxford H-OSA
    (torch.bfloat16, 48, 128, 8, 76, "tc", 4),    # Oxford OctFormer, D 4
    (torch.float32, 65, 256, 16, 51, "cc", 1),
    (torch.bfloat16, 81, 128, 8, 51, "cc", 2),    # beyond MAX_T
])
def test_attn_body_at_the_shipped_shapes(dtype, T, C, H, bnd, want, heads):
    """The tensor-core bodies take every bf16 shape of the four shipped
    configurations: the backward's heads per round shrink (4, 3, 1) until
    its buffers fit beside the window's tiles."""
    assert kattn.attn_body(dtype, T, C, H, bnd) == want
    hpr, fwd, bwd = kattn.tc_plan(T, C, H, bnd)
    assert hpr == heads
    if want == "tc":
        assert max(fwd, bwd) == kattn.tc_smem(T, C, H, bnd) \
            <= kattn.SMEM_LIMIT


def test_shape_check_takes_65_tokens():
    """The launch check accepts T = 65 (it then refuses the meta device)
    and refuses T > MAX_T by its shape."""
    def views(T):
        m = dict(device="meta")
        qkv = torch.empty(2, T, 3 * 64, dtype=torch.bfloat16, **m)
        q, k, v = (qkv[..., i * 64:(i + 1) * 64] for i in range(3))
        return (q, k, v, torch.empty(2, 3, T - 1, dtype=torch.int32, **m),
                torch.empty(2, T, dtype=torch.int32, **m),
                torch.empty(3 * 103, 4, **m), 4, 51)
    with pytest.raises(ValueError, match="unsupported device"):
        kattn.launch_fwd(*views(65))
    with pytest.raises(ValueError, match="unsupported T=81"):
        kattn.launch_fwd(*views(81))


def _inputs65(seed):
    """Patch-64 H-OSA windows at a narrow width: 64 nodes and one relay
    slot, hd 16, pos_bnd 51; window 1 partly and window 3 wholly masked
    (its relay slot too)."""
    return _inputs(seed, 1, BW=8, K=64, C=64, H=4, bnd=51)


def test_bf16_forward_at_65_tokens():
    q, k, v, _, xyz, mask, table, H, bnd = _inputs65(4)
    ref = np.asarray(_jax_op(xyz, mask, H, bnd)(
        _bf16_jax(q), _bf16_jax(k), _bf16_jax(v), jnp.asarray(table)),
        dtype=np.float32)
    out = kattn.window_attention(
        _bf16_torch(q), _bf16_torch(k), _bf16_torch(v),
        torch.from_numpy(xyz), torch.from_numpy(mask),
        torch.from_numpy(table), H, bnd).float().numpy()
    assert out.shape == (8, 65, 64)
    diff = np.abs(out - ref)
    assert np.all(diff <= BF16_ULP * np.maximum(1.0, np.abs(ref))), \
        float(diff.max())
    assert np.mean(out == ref) >= 0.8, float(np.mean(out == ref))
    assert np.all(out[mask == 0] == 0.0)


def test_bf16_backward_at_65_tokens():
    q, k, v, g, xyz, mask, table, H, bnd = _inputs65(5)
    _, vjp = jax.vjp(_jax_op(xyz, mask, H, bnd), _bf16_jax(q), _bf16_jax(k),
                     _bf16_jax(v), jnp.asarray(table))
    ref = [np.asarray(r, dtype=np.float32) for r in vjp(_bf16_jax(g))]
    out = kattn.window_attention_bwd(
        _bf16_torch(q), _bf16_torch(k), _bf16_torch(v),
        torch.from_numpy(xyz), torch.from_numpy(mask),
        torch.from_numpy(table), _bf16_torch(g), H, bnd)
    for o, r, name in zip(out, ref, ("dq", "dk", "dv", "dtable")):
        err = float(np.abs(o.float().numpy() - r).max())
        assert err <= 1e-2 * max(1.0, float(np.abs(r).max())), (name, err)
    assert np.all(out[0].float().numpy()[mask == 0] == 0.0)
    assert np.all(np.isfinite(out[3].numpy()))


def test_attn_body_refuses_tiles_beyond_shared_memory():
    """A window whose bf16 tiles do not fit one block's shared memory
    runs the CUDA-core body."""
    assert kattn.tc_smem(64, 512, 8, 38) > kattn.SMEM_LIMIT
    assert kattn.attn_body(torch.bfloat16, 64, 512, 8, 38) == "cc"
    assert kattn.tc_smem(49, 256, 16, 38) <= kattn.SMEM_LIMIT


def test_strided_inputs_equal_contiguous():
    """q, k, v as slices of one (BW, T, 3C) projection (rows 3C apart, as
    WindowAttention passes them) give the same output and gradients as
    contiguous copies."""
    q, k, v, g, xyz, mask, table, H, bnd = _inputs(3, 1)
    qkv = torch.from_numpy(np.concatenate([q, k, v], -1)).requires_grad_()
    C = q.shape[-1]
    views = [qkv[..., i * C:(i + 1) * C] for i in range(3)]
    assert views[0].stride() == (qkv.shape[1] * 3 * C, 3 * C, 1)
    rest = [torch.from_numpy(a) for a in (xyz, mask)]
    tab = torch.from_numpy(table).requires_grad_()
    out = kattn.window_attention(*views, *rest, tab, H, bnd)
    out.backward(torch.from_numpy(g))
    copies = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tab2 = torch.from_numpy(table).requires_grad_()
    out2 = kattn.window_attention(*copies, *rest, tab2, H, bnd)
    out2.backward(torch.from_numpy(g))
    assert torch.equal(out, out2)
    assert torch.equal(qkv.grad, torch.cat([t.grad for t in copies], -1))
    assert torch.equal(tab.grad, tab2.grad)


def test_backward_refuses_other_devices():
    """Like the forward, the backward entry takes only CPU or CUDA
    tensors: a strided meta view raises instead of falling back."""
    m = dict(device="meta")
    qkv = torch.empty(2, 9, 24, **m)
    q, k, v = (qkv[..., i * 8:(i + 1) * 8] for i in range(3))
    with pytest.raises(ValueError):
        kattn.window_attention_bwd(
            q, k, v, torch.empty(2, 3, 8, dtype=torch.int32, **m),
            torch.empty(2, 9, dtype=torch.int32, **m),
            torch.empty(21, 2, **m), torch.empty(2, 9, 8, **m), 2, 3)
