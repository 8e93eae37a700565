import numpy as np

from portbench.core.traffic import make_pool, surface_cloud

SERVE = {"points": 512, "batch": 3, "pool": 2}
TRAIN = {"points": 512, "batch": 6, "microbatch": 3, "pool": 2,
         "pairs": True, "noise": 0.01}


def test_same_seed_same_pool():
    big = 2 ** 31 + 12345
    a, b = make_pool(TRAIN, big), make_pool(TRAIN, big)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_other_seed_other_pool():
    a, b = make_pool(SERVE, 7), make_pool(SERVE, 8)
    assert not np.array_equal(a["points"], b["points"])


def test_pool_shapes_and_range():
    p = make_pool(SERVE, 3)["points"]
    assert p.shape == (2, 3, 512, 3) and p.dtype == np.float32
    assert np.abs(p).max() <= 0.95
    # batches of a pool are distinct
    assert not np.array_equal(p[0], p[1])


def test_pairs_masks():
    pool = make_pool(TRAIN, 4)
    pos, neg = pool["positives_mask"], pool["negatives_mask"]
    assert pos.sum(1).tolist() == [1] * 6          # each place's twin
    assert not (pos & neg).any() and not pos.diagonal().any()
    pts = pool["points"][0]
    assert np.abs(pts[0] - pts[1]).max() < 0.1     # twins within jitter
    assert np.abs(pts[0] - pts[2]).max() > 0.1


def test_surface_cloud_lies_on_planes():
    rng = np.random.default_rng(0)
    pts, nrm = surface_cloud(rng, 1000, normals=True)
    assert pts.shape == nrm.shape == (1000, 3)
    np.testing.assert_allclose(np.linalg.norm(nrm, axis=1), 1.0, atol=1e-5)
    assert len(np.unique(nrm.round(4), axis=0)) in (3, 4)
