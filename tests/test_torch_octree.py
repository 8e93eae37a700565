"""hotformerloc_torch octree + plan vs the JAX package: Morton keys,
octree keys/counts/parents/overflow, every 27-tap neighbour table, child
tables and dense voxel maps are exactly equal; leaf means within 1e-6.
Inputs are numpy arrays from a seed, handed to both packages (CPU)."""
import torch_threads  # noqa: F401  (first: one torch thread per worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hotformerloc_tpu.models import config as jcfg
from hotformerloc_tpu.octree import build as jbuild
from hotformerloc_tpu.octree import morton as jmorton
from hotformerloc_tpu.octree import neigh as jneigh
from hotformerloc_tpu.ops import plan as jplan
from hotformerloc_torch.models import config as tcfg
from hotformerloc_torch.octree import build as tbuild
from hotformerloc_torch.octree import morton as tmorton
from hotformerloc_torch.octree import neigh as tneigh
from hotformerloc_torch.ops import plan as tplan


def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _clouds(B, P, seed, clustered=False):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.9, 0.9, (B, P, 3))
    if clustered:    # dense blobs: many points share leaves at depth 9
        centres = rng.uniform(-0.7, 0.7, (B, 8, 3))
        pick = rng.integers(0, 8, (B, P))
        pts = (np.take_along_axis(centres, pick[..., None], axis=1)
               + rng.normal(0, 0.05, (B, P, 3)))
    pts = np.clip(pts, -0.999, 0.999).astype(np.float32)
    mask = np.ones((B, P), bool)
    mask[-1, P // 2:] = False
    return pts, mask


def test_morton_roundtrip_matches_jax():
    rng = np.random.default_rng(0)
    xyz = rng.integers(0, 1024, (500, 3)).astype(np.int32)
    kj = np.asarray(jmorton.encode(jnp.asarray(xyz)))
    kt = tmorton.encode(torch.from_numpy(xyz)).numpy()
    _eq(kj, kt, "keys")
    _eq(tmorton.decode(torch.from_numpy(kt)).numpy(), xyz, "decode")
    pts = rng.uniform(-1.2, 1.2, (300, 3)).astype(np.float32)
    _eq(jmorton.points_to_grid(jnp.asarray(pts), 9),
        tmorton.points_to_grid(torch.from_numpy(pts), 9), "grid")


CASES = {
    "tiny": (jcfg.tiny_test_config(), tcfg.tiny_test_config(), 512, False),
    "oxford": (jcfg.oxford_config(), tcfg.oxford_config(), 4096, False),
    "oxford_clustered": (jcfg.oxford_config(), tcfg.oxford_config(), 4096,
                         True),
}


@pytest.fixture(scope="module", params=list(CASES))
def both_plans(request):
    cj, ct, P, clustered = CASES[request.param]
    assert cj.resolve_capacities() == ct.resolve_capacities()
    pts, mask = _clouds(2, P, seed=len(request.param), clustered=clustered)
    caps = cj.resolve_capacities()
    oj = jbuild.build_batched_octree(jnp.asarray(pts), jnp.asarray(mask),
                                     cj.octree_depth, cj.min_depth, caps)
    pj = jplan.build_plan(oj, dense_depths=cj.dense_depths())
    ot = tbuild.build_batched_octree(torch.from_numpy(pts),
                                     torch.from_numpy(mask), ct.octree_depth,
                                     ct.min_depth, caps)
    pt = tplan.build_plan(ot, dense_depths=ct.dense_depths())
    return request.param, pj, pt


def test_octree_levels_equal(both_plans):
    name, pj, pt = both_plans
    oj, ot = pj.octree, pt.octree
    for lev in range(len(oj.caps)):
        _eq(oj.keys[lev], ot.keys[lev], f"{name} keys[{lev}]")
        _eq(oj.counts[lev], ot.counts[lev], f"{name} counts[{lev}]")
        if lev > 0:
            _eq(oj.parents[lev], ot.parents[lev], f"{name} parents[{lev}]")
    _eq(oj.overflow, ot.overflow, f"{name} overflow")
    np.testing.assert_allclose(np.asarray(oj.leaf_mean), ot.leaf_mean.numpy(),
                               atol=1e-6, rtol=0)
    _eq(oj.leaf_npts, ot.leaf_npts, f"{name} leaf_npts")
    for d in range(oj.min_depth, oj.depth + 1):
        _eq(oj.xyz(d), ot.xyz(d), f"{name} xyz@{d}")
        _eq(oj.node_valid(d), ot.node_valid(d), f"{name} valid@{d}")


def test_plan_tables_equal(both_plans):
    name, pj, pt = both_plans
    for lev, (a, b) in enumerate(zip(pj.neighs, pt.neighs)):
        _eq(a, b, f"{name} neigh[{lev}]")
    for lev, (a, b) in enumerate(zip(pj.childrens, pt.childrens)):
        assert (a is None) == (b is None)
        if a is not None:
            _eq(a, b, f"{name} children[{lev}]")
    assert len(pj.dense_idxs) == len(pt.dense_idxs)
    for lev, (a, b) in enumerate(zip(pj.dense_idxs, pt.dense_idxs)):
        assert (a is None) == (b is None)
        if a is not None:
            _eq(a, b, f"{name} dense_idx[{lev}]")
    d = pj.octree.depth
    for x, y, what in zip(pj.down_tables(d), pt.down_tables(d),
                          ("children", "parent", "octant")):
        _eq(x, y, f"{name} down_tables {what}")
    # every tap is gathered directly: the plan has no band tables and
    # no band-overflow counter
    assert not hasattr(pt, "band_overflow")


def test_search_table_equals_recurrence(both_plans):
    """neigh_table (direct search) equals the parent recurrence, and the
    JAX search, at the coarsest and the finest depth."""
    name, pj, pt = both_plans
    ot = pt.octree
    for d in (ot.min_depth, ot.depth):
        tab = tneigh.neigh_table(ot, d)
        _eq(tab, pt.neighs[ot.level(d)], f"{name} search vs recurrence @{d}")
        _eq(jneigh.neigh_table(pj.octree, d), tab, f"{name} search @{d}")


def test_kernel_offsets_order():
    for k in ("333", "111", "313"):
        _eq(jneigh.kernel_offsets(k), tneigh.kernel_offsets(k), k)


def test_overflow_counted_like_jax():
    """Capacities far below the occupancy: dropped nodes are counted the
    same way and the surviving tables still agree."""
    pts, mask = _clouds(2, 512, seed=7)
    caps = (8, 24, 64, 128, 256)
    oj = jbuild.build_batched_octree(jnp.asarray(pts), jnp.asarray(mask),
                                     6, 2, caps)
    ot = tbuild.build_batched_octree(torch.from_numpy(pts),
                                     torch.from_numpy(mask), 6, 2, caps)
    assert int(ot.overflow.sum()) > 0
    _eq(oj.overflow, ot.overflow, "overflow")
    pj, pt = jplan.build_plan(oj), tplan.build_plan(ot)
    for lev, (a, b) in enumerate(zip(pj.neighs, pt.neighs)):
        _eq(a, b, f"neigh[{lev}]")
