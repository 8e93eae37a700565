"""The FLOP and byte counts behind mfu.* and attn_roofline.*, against
sums written out by hand for tiny_test_config."""
import dataclasses

import pytest
import torch

from hotformerloc_torch.models.config import tiny_test_config
from portbench.core import counts
from portbench.ref.models.config import ModelConfig
from portbench.ref.ops.window import data_to_windows

NODES = {6: 100, 5: 60, 4: 30, 3: 12, 2: 5}
TAPS = {6: 150, 5: 120, 4: 90, 3: 60, 2: 25}


def tiny():
    return ModelConfig(**dataclasses.asdict(tiny_test_config()))


def lev():
    return {d: counts.Level([NODES[d]], [TAPS[d]]) for d in NODES}


def test_forward_flops_by_hand():
    # tiny: stem 3 -> 8 -> 16 -> 32 at depths 6/5/4; OctFormer at depth 4
    # (C 32, 2 heads, patch 8, dilation 1 then 2); HOTFormer at depths 3
    # and 2 (C 64, 4 heads, T 9), 2 iterations; pool k 12 + 4, mixer to 64
    stem = (2 * 3 * 8 * 150 + 2 * 8 * 16 * 100 + 2 * 16 * 16 * 120
            + 2 * 16 * 32 * 60 + 2 * 32 * 32 * 90)
    octf_block = (2 * 32 * 90                          # CPE
                  + 2 * 30 * (4 * 32 * 32 + 2 * 32 * 128)   # qkv, proj, MLP
                  + 4 * 8 * 8 * 32 * 4)                # 4 windows either way
    octf = 2 * octf_block + 2 * 32 * 64 * 30           # + octf_down
    hot_init = 2 * 64 * 64 * 12 + 2 * 3 * (9 * 64 + 64 * 64)
    rtsa = 2 * 3 * (4 * 64 * 64 + 2 * 64 * 256) + 4 * 3 * 3 * 64
    hosa0 = 2 * 64 * 60 + 2 * 14 * (4 * 64 * 64 + 2 * 64 * 256) \
        + 4 * 9 * 9 * 64 * 2
    hosa1 = 2 * 64 * 25 + 2 * 6 * (4 * 64 * 64 + 2 * 64 * 256) \
        + 4 * 9 * 9 * 64 * 1
    pool = 4 * 12 * 64 * 12 + 4 * 4 * 64 * 5
    mixer = 4 * 4 * 64 * 64 * 16 + 2 * 16 * 4 * 64 + 2 * 64 * 16 * 4
    want = stem + octf + hot_init + 2 * (rtsa + hosa0 + hosa1) + pool + mixer
    got = counts.forward_counts(tiny(), lev(), 0)
    assert got["flops"] == want


def test_attention_counts_by_hand():
    got = counts.forward_counts(tiny(), lev(), 0)
    table = 3 * (2 * 9 + 1) * 4                    # bnd int(0.8 * 8 * 2**.5)
    assert got["attn_flops"] == 2 * 4 * 8 * 8 * 32 * 4 \
        + 2 * (4 * 81 * 64 * 2 + 4 * 81 * 64 * 1)
    assert got["attn_bytes"] == 2 * (4 * 8 * 32 * 4 * 2 + table * 2) \
        + 2 * (4 * 9 * 64 * 2 * 2 + table * 4 + 4 * 9 * 64 * 1 * 2
               + table * 4)
    assert got["attn_bwd_flops"] == 2.5 * got["attn_flops"]


@pytest.mark.parametrize("n,patch,dil", [(0, 8, 1), (1, 8, 1), (8, 8, 1),
                                         (9, 8, 1), (30, 8, 2), (16, 8, 2),
                                         (17, 8, 2), (100, 48, 4)])
def test_windows_match_the_partition(n, patch, dil):
    cap = 4 * patch * dil
    valid = (torch.arange(cap) < n)[None]
    want = int(data_to_windows(valid, patch, dil).any(-1).sum())
    assert counts.windows(n, patch, dil) == want


def test_level_counts_from_points():
    cfg = tiny()
    g = torch.Generator().manual_seed(0)
    pts = torch.rand((2, 512, 3), generator=g) * 1.8 - 0.9
    lv = counts.level_counts(cfg, pts, chunk=1)
    assert sorted(lv) == list(range(cfg.min_depth, cfg.octree_depth + 1))
    for d, level in lv.items():
        assert len(level.nodes) == 2
        assert all(0 < n <= 512 for n in level.nodes)
        # each valid node sees itself among its 27 taps, at most 27
        assert all(n <= t <= 27 * n for n, t in zip(level.nodes,
                                                    level.taps))
