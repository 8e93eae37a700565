"""The host side of the octree-conv kernels K4, K5 and K6 on the CPU.

* ``ops.plan.build_tap_lists`` (the per-tap pair lists the backward
  weight-gradient kernels walk) equals a numpy brute force over real
  octree tables, with and without padding rows: pairs, order, counts,
  and the capacity slots past each count left at -1;
* ``build_plan`` carries them on every level but the dense depths it is
  asked for (the model asks for none: every CPE runs K3/K4, so its plan
  has them on every level, tests/test_torch_cpe.py), and the model's own
  plan has them only when a gradient is recorded;
* ``conv_body`` picks the tensor-core body for bf16 with C and O
  multiples of 16 and the CUDA-core body otherwise;
* the autograd Functions give the same outputs and gradients with and
  without tap lists (on the CPU they run the plain versions, which
  ignore them), and the same as the plain ops' autograd.

The kernels themselves run only on the card, where chip_smoke.py holds
each against its plain version.
"""
import torch_threads  # noqa: F401  (first: one torch thread per worker)

import numpy as np
import pytest
import torch

from hotformerloc_torch.octree.build import build_batched_octree
from hotformerloc_torch.ops import conv as tconv
from hotformerloc_torch.ops.kernels import octree_conv as kconv
from hotformerloc_torch.ops.plan import TapLists, build_plan, build_tap_lists


def _plan(seed, B, P, caps, cut=None, dense=()):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.9, 0.9, (B, P, 3)).astype(np.float32)
    pm = np.ones((B, P), bool)
    if cut is not None:
        pm[-1, cut:] = False
    ot = build_batched_octree(torch.from_numpy(pts), torch.from_numpy(pm),
                              5, 3, caps)
    return build_plan(ot, dense_depths=dense)


@pytest.fixture(scope="module")
def tables():
    """Every level of two port octrees: one whose capacities are met
    (B=2, N=512 at depth 5, as the kernel tests' tables), one whose
    levels hold padding rows."""
    full = _plan(3, 2, 1024, (64, 512, 512))
    padded = _plan(12, 2, 700, (512, 640, 768), cut=400)
    return list(full.neighs) + list(padded.neighs)


def _brute(nb):
    """Per tap: the (dst, src) global rows of every valid entry, in row
    order."""
    B, N, K = nb.shape
    out = []
    for k in range(K):
        pairs = [(b * N + n, b * N + nb[b, n, k])
                 for b in range(B) for n in range(N) if nb[b, n, k] >= 0]
        out.append(np.array(pairs, np.int64).reshape(-1, 2))
    return out


def test_tap_lists_equal_brute_force(tables):
    for neigh in tables:
        tl = build_tap_lists(neigh)
        B, N, K = neigh.shape
        assert tl.dst.shape == tl.src.shape == (K, B * N)
        assert tl.count.shape == (K,)
        assert tl.dst.dtype == tl.src.dtype == tl.count.dtype == torch.int32
        assert tl.dst.is_contiguous() and tl.src.is_contiguous()
        for k, want in enumerate(_brute(neigh.numpy())):
            n = int(tl.count[k])
            assert n == len(want)
            np.testing.assert_array_equal(tl.dst[k, :n].numpy(), want[:, 0])
            np.testing.assert_array_equal(tl.src[k, :n].numpy(), want[:, 1])
            assert bool((tl.dst[k, n:] == -1).all())
            assert bool((tl.src[k, n:] == -1).all())


def test_tap_lists_of_a_hand_table():
    """A (2, 3, 27) table: sample 1's rows are offset by N, a padding row
    has no taps, and the centre tap lists every valid node."""
    nb = torch.full((2, 3, 27), -1, dtype=torch.int32)
    nb[0, 0, 13], nb[0, 1, 13], nb[1, 0, 13] = 0, 1, 0
    nb[0, 0, 14], nb[0, 1, 12] = 1, 0
    nb[1, 0, 5] = 2
    tl = build_tap_lists(nb)
    assert tl.count.tolist() == [0] * 5 + [1] + [0] * 6 + [1, 3, 1] \
        + [0] * 12
    assert tl.dst[13, :3].tolist() == [0, 1, 3]
    assert tl.src[13, :3].tolist() == [0, 1, 3]
    assert (tl.dst[12, 0].item(), tl.src[12, 0].item()) == (1, 0)
    assert (tl.dst[14, 0].item(), tl.src[14, 0].item()) == (0, 1)
    assert (tl.dst[5, 0].item(), tl.src[5, 0].item()) == (3, 5)
    assert bool((tl.dst[13, 3:] == -1).all())


def test_plan_carries_tap_lists_on_kernel_levels():
    plan = _plan(3, 2, 1024, (64, 512, 512), dense=(3,))
    assert plan.taps[0] is None                    # dense-grid depth 3
    for d in (4, 5):
        ctx = plan.level_ctx(d)
        assert isinstance(ctx.taps, TapLists)
        ref = build_tap_lists(ctx.neigh)
        for a, b in ((ctx.taps.dst, ref.dst), (ctx.taps.src, ref.src),
                     (ctx.taps.count, ref.count)):
            assert torch.equal(a, b)
    assert plan.level_ctx(3).taps is None


def test_plan_without_tap_lists_and_model_forward_without_grad():
    """``tap_lists=False`` builds none; the model builds its own plan
    without them when no gradient is recorded, and with them otherwise
    (the backward kernels are their only readers)."""
    from hotformerloc_torch.models import hotformerloc as hm
    from hotformerloc_torch.models.config import tiny_test_config
    rng = np.random.default_rng(3)
    pts = rng.uniform(-0.9, 0.9, (2, 1024, 3)).astype(np.float32)
    ot = build_batched_octree(torch.from_numpy(pts),
                              torch.ones(2, 1024, dtype=torch.bool), 5, 3,
                              (64, 512, 512))
    assert all(t is None for t in build_plan(ot, tap_lists=False).taps)
    cfg = tiny_test_config(num_points=256)
    model = hm.HOTFormerLoc(cfg, device="cpu")
    built = []
    real = hm.build_model_plan

    def spy(*args, **kw):
        plan = real(*args, **kw)
        built.append(any(t is not None for t in plan.taps))
        return plan
    pts = torch.from_numpy(rng.uniform(-0.9, 0.9, (2, 256, 3)).astype(
        np.float32))
    pmask = torch.ones(2, 256, dtype=torch.bool)
    try:
        hm.build_model_plan = spy
        with torch.no_grad():
            model(pts, pmask)
        model(pts, pmask)
    finally:
        hm.build_model_plan = real
    assert built == [False, True]


@pytest.mark.parametrize("dtype,C,O,want", [
    (torch.bfloat16, 64, 64, "tc"),
    (torch.bfloat16, 128, 128, "tc"),
    (torch.bfloat16, 16, 48, "tc"),
    (torch.bfloat16, 3, 32, "cc"),                 # the stem's first conv
    (torch.bfloat16, 24, 64, "cc"),
    (torch.bfloat16, 64, 40, "cc"),
    (torch.float32, 64, 64, "cc"),
    (torch.float32, 128, 128, "cc"),
    (torch.float16, 64, 64, "cc"),
])
def test_conv_body(dtype, C, O, want):
    assert kconv.conv_body(dtype, C, O) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_functions_with_and_without_tap_lists(tables, dtype):
    """Same outputs and gradients with and without the tap lists, and the
    same as autograd of the plain ops (fp32 to 1e-5, the sums taken in
    another order; bf16 to one rounding of the outputs)."""
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    gen = torch.Generator().manual_seed(7)
    for neigh in tables[::2]:
        B, N, _ = neigh.shape
        tl = build_tap_lists(neigh)
        x = torch.randn(B, N, 16, generator=gen).to(dtype)
        wd = 0.2 * torch.randn(27, 16, generator=gen)
        w = 0.05 * torch.randn(27, 16, 32, generator=gen)
        b = torch.randn(32, generator=gen)
        for fn, plain_fn, args in (
                (kconv.octree_dwconv, tconv.octree_dwconv, (wd,)),
                (kconv.octree_conv, tconv.octree_conv, (w, b))):
            grads = []
            for taps in (None, tl, "plain"):
                xs = x.clone().requires_grad_()
                ps = [a.clone().requires_grad_() for a in args]
                if taps == "plain":
                    out = plain_fn(xs, neigh, *(p.to(dtype) for p in ps))
                else:
                    out = fn(xs, neigh, *ps, taps=taps)
                dy = torch.randn(out.shape, generator=torch.Generator()
                                 .manual_seed(1)).to(dtype)
                grads.append((out, *torch.autograd.grad(out, (xs, *ps), dy)))
            for got, ref in zip(grads[1], grads[0]):
                assert torch.equal(got, ref)
            for got, ref in zip(grads[0], grads[2]):
                assert got.dtype == ref.dtype
                np.testing.assert_allclose(got.detach().float().numpy(),
                                           ref.detach().float().numpy(),
                                           rtol=tol, atol=tol)


def test_explicit_bwds_take_and_ignore_tap_lists(tables):
    """octree_conv_bwd / octree_dwconv_bwd on CPU tensors are the plain
    backwards whatever tap lists they are given."""
    neigh = tables[1]
    B, N, _ = neigh.shape
    tl = build_tap_lists(neigh)
    gen = torch.Generator().manual_seed(4)
    x, dy = torch.randn(B, N, 16, generator=gen), torch.randn(
        B, N, 16, generator=gen)
    w = torch.randn(27, 16, generator=gen)
    for got, ref in zip(kconv.octree_dwconv_bwd(x, neigh, w, dy, taps=tl),
                        tconv.octree_dwconv_bwd(x, neigh, w, dy)):
        assert torch.equal(got, ref)
    wc = torch.randn(27, 16, 16, generator=gen)
    for got, ref in zip(kconv.octree_conv_bwd(x, neigh, wc, dy, taps=tl),
                        tconv.octree_conv_bwd(x, neigh, wc, dy)):
        assert torch.equal(got, ref)


def test_tap_lists_refuse_other_devices():
    """The wrappers refuse a device that is neither CPU nor CUDA before
    they look at the tap lists."""
    m = dict(device="meta")
    x = torch.empty(2, 10, 16, **m)
    nb = torch.empty(2, 10, 27, dtype=torch.int32, **m)
    with pytest.raises(ValueError):
        kconv.octree_dwconv_bwd(x, nb, torch.empty(27, 16, **m), x)
    with pytest.raises(ValueError):
        kconv.octree_conv_bwd(x, nb, torch.empty(27, 16, 16, **m), x)
