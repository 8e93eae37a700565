# Frozen copy of hotformerloc_torch/models/config.py at commit
# 17534d0, for portbench's plain reference: every CUDA kernel call is
# replaced by its plain formulation, data parallelism is dropped.
"""Model configuration: static hyperparameters of HOTFormerLoc.

Own copy of the JAX package's ``ModelConfig`` (hotformerloc_tpu/models/
config.py) so that a config reads the same in both packages. The fields
``use_band_conv``, ``band_tile``, ``band_halo`` and ``use_pallas_attn``
select TPU code paths there and have no effect here: this package picks
kernels with ``HOTFormerLoc.set_use_kernels`` instead.
``grad_checkpoint`` and ``remat_policy`` act as they do there: each
OctFormer block and each HOTFormer iteration recomputes its activations
in the backward but for what the policy keeps (None: nothing;
'save_attn': the window attention outputs; 'save_hot', the default:
those and the CPE conv outputs; models/backbone.py ``run_block``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def default_capacities(num_points: int, depth: int, min_depth: int,
                       multiple_of: int = 8) -> Tuple[int, ...]:
    """Per-depth node capacity schedule (index 0 == min_depth): a depth-d
    level holds at most min(P, 8^d) octants, rounded up to
    ``multiple_of``."""
    caps = []
    for d in range(min_depth, depth + 1):
        cap = min(num_points, 8**d)
        caps.append(round_up(max(cap, 1), multiple_of))
    return tuple(caps)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    model: str = "HOTFormerLoc"
    # backbone
    in_channels: int = 3
    channels: Tuple[int, ...] = (128, 256)
    num_blocks: Tuple[int, ...] = (4, 10)
    num_heads: Tuple[int, ...] = (8, 16)
    num_pyramid_levels: int = 3
    num_octf_levels: int = 1
    patch_size: int = 48
    dilation: int = 4
    drop_path: float = 0.5
    mlp_ratio: float = 4.0
    stem_down: int = 2
    downsample_input_embeddings: bool = True
    rt_size: int = 1
    rt_propagation: bool = False
    rt_propagation_scale: Optional[float] = None
    disable_rt: bool = False
    octf_use_rt: bool = False
    adape_mode: Optional[str] = "cov"     # None | 'pos' | 'var' | 'cov'
    disable_rpe: bool = False
    conv_norm: str = "layernorm"
    layer_scale: Optional[float] = None
    xcpe: bool = False
    proj_drop: float = 0.0
    attn_drop: float = 0.0
    # pooling head
    pooling: str = "PyramidAttnPoolMixer"
    feature_size: int = 256
    output_dim: int = 256
    k_pooled_tokens: Tuple[int, ...] = (74, 36, 18)
    normalize_embeddings: bool = True
    input_features: str = "P"
    # execution (TPU-only switches: kept so configs read the same)
    use_pallas_attn: bool = True
    # The JAX package runs the CPE depthwise conv at depths at or below
    # this on a dense voxel grid (V = 8^d) instead of 27-tap row gathers,
    # which was faster on the TPU. The port computes those CPEs by the
    # gather too (K3/K4): the function is equal (tests/test_ops.py
    # TestDenseDwconv), so the field only keeps configs and converted
    # weights in step with the JAX package.
    dense_cpe_max_depth: int = 4
    use_band_conv: bool = True
    band_tile: int = 128
    band_halo: int = 128
    # octree / static shapes
    octree_depth: int = 9
    num_points: int = 4096
    capacities: Optional[Tuple[int, ...]] = None  # per depth from min_depth
    grad_checkpoint: bool = True
    remat_policy: Optional[str] = "save_hot"

    def __post_init__(self):
        if self.remat_policy not in (None, "save_attn", "save_hot"):
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}")
        if self.rt_size < 1 or self.patch_size % self.rt_size != 0:
            raise ValueError(
                f"patch_size ({self.patch_size}) must be divisible by "
                f"ct_size/rt_size ({self.rt_size})")
        bad = set(self.input_features) - set("NDLP")
        if bad:
            raise ValueError(
                f"invalid input features {sorted(bad)}; must be in "
                "['L','P','D','N']")

    # -- derived ---------------------------------------------------------
    @property
    def num_stages(self) -> int:
        return self.num_octf_levels + self.num_pyramid_levels

    @property
    def transformer_depth(self) -> int:
        """Finest depth seen by the transformer (after the stem)."""
        d = self.octree_depth
        if self.downsample_input_embeddings:
            d -= self.stem_down
        return d

    @property
    def min_depth(self) -> int:
        return self.transformer_depth - self.num_stages + 1

    @property
    def pyramid_depths(self) -> Tuple[int, ...]:
        d0 = self.transformer_depth - self.num_octf_levels
        return tuple(d0 - j for j in range(self.num_pyramid_levels))

    @property
    def block_num(self) -> int:
        return self.patch_size * self.dilation

    def resolve_capacities(self) -> Tuple[int, ...]:
        """Per-depth node capacities (index 0 == min_depth). Transformer
        depths are rounded to multiples of patch_size*dilation so window
        partition is a reshape."""
        if self.capacities is not None:
            caps = self.capacities
            want = self.octree_depth - self.min_depth + 1
            if len(caps) != want:
                raise ValueError(
                    f"capacities needs one entry per depth "
                    f"{self.min_depth}..{self.octree_depth} ({want}), "
                    f"got {len(caps)}")
        else:
            caps = default_capacities(self.num_points, self.octree_depth,
                                      self.min_depth, multiple_of=8)
        caps = list(caps)
        for d in range(self.min_depth, self.transformer_depth + 1):
            i = d - self.min_depth
            caps[i] = round_up(caps[i], self.block_num)
        return tuple(caps)

    def stage_channels(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """(octf_channels, pyramid_channels); a single pyramid value is
        broadcast to num_pyramid_levels."""
        octf = self.channels[:self.num_octf_levels]
        pyr = self.channels[self.num_octf_levels:]
        if len(pyr) == 1:
            pyr = pyr * self.num_pyramid_levels
        assert len(pyr) == self.num_pyramid_levels
        return octf, pyr

    def stage_heads(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        octf = self.num_heads[:self.num_octf_levels]
        pyr = self.num_heads[self.num_octf_levels:]
        if len(pyr) == 1:
            pyr = pyr * self.num_pyramid_levels
        assert len(pyr) == self.num_pyramid_levels
        return octf, pyr

    @property
    def use_projections(self) -> bool:
        pyr = self.channels[self.num_octf_levels:]
        return len(pyr) > 1 and not self.disable_rt

    def dense_depths(self) -> Tuple[int, ...]:
        """Depths whose CPE the JAX package runs on the dense voxel grid
        (the port runs them by the gather)."""
        return tuple(d for d in range(self.min_depth,
                                      self.transformer_depth + 1)
                     if d <= self.dense_cpe_max_depth)

    def drop_path_rates(self) -> Tuple[float, ...]:
        total = sum(self.num_blocks)
        if total <= 1:
            return (0.0,) * total
        return tuple(self.drop_path * i / (total - 1) for i in range(total))


# ADaPE input width per mode (ops/window.py:window_stats); None: no
# ADaPE, the relay tokens start from a CPE'd window mean instead.
ADAPE_STATS = {None: 0, "pos": 3, "var": 6, "cov": 9}


POOLINGS = ("PyramidAttnPoolMixer", "AttnPoolMixer", "AttnPoolGeM",
            "OctGeM", "PyramidOctGeM", "PyramidOctGeMgc")
CONV_NORMS = ("layernorm", "batchnorm", "powernorm")


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError naming each option the JAX package
    refuses too: an unknown pooling head, conv_norm or adape_mode, and a
    relay-token head with relay tokens disabled."""
    unsupported = []
    if cfg.pooling not in POOLINGS:
        unsupported.append(f"pooling={cfg.pooling!r}")
    elif cfg.pooling.startswith("AttnPool") and cfg.disable_rt:
        unsupported.append(f"pooling={cfg.pooling!r} with disable_rt=True "
                           "(relay-token pooling needs relay tokens)")
    if cfg.conv_norm not in CONV_NORMS:
        unsupported.append(f"conv_norm={cfg.conv_norm!r}")
    if cfg.adape_mode not in ADAPE_STATS:
        unsupported.append(f"adape_mode={cfg.adape_mode!r}")
    if unsupported:
        raise NotImplementedError(
            "hotformerloc_torch does not support: " + ", ".join(unsupported))


def oxford_config(**overrides) -> ModelConfig:
    """HOTFormerLoc-Oxford (the reference's hotformerloc_oxford_cfg.txt),
    with the JAX package's occupancy-tuned capacities."""
    kw = dict(octree_depth=9, num_points=4096, patch_size=48,
              capacities=(2688, 4224, 4224, 4224, 4096, 4096))
    kw.update(overrides)
    return ModelConfig(**kw)


def cs_wild_places_config(**overrides) -> ModelConfig:
    """HOTFormerLoc-CSWildPlaces (the reference's
    hotformerloc_cs-wild-places_cfg.txt), with the JAX package's
    occupancy-tuned capacities (depths 2..7)."""
    kw = dict(octree_depth=7, num_points=4096, patch_size=64,
              capacities=(256, 512, 2816, 4096, 4096, 4096))
    kw.update(overrides)
    return ModelConfig(**kw)


def tiny_test_config(**overrides) -> ModelConfig:
    """Small config for unit tests."""
    kw = dict(channels=(32, 64), num_blocks=(2, 2), num_heads=(2, 4),
              num_pyramid_levels=2, num_octf_levels=1, patch_size=8,
              dilation=2, octree_depth=6, num_points=512,
              k_pooled_tokens=(12, 4), feature_size=64, output_dim=64,
              grad_checkpoint=False)
    kw.update(overrides)
    return ModelConfig(**kw)
