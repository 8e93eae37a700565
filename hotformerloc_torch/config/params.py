"""INI config parsing: own copy of hotformerloc_tpu/config/params.py.

The same ``configs/*.txt`` files parse here unchanged; they resolve to
this package's frozen ModelConfig (static model hyperparameters, the
same fields and defaults as the JAX package's) plus a TrainParams
(training/dataset settings).
"""
from __future__ import annotations

import configparser
import dataclasses
import os
from typing import Optional, Sequence, Tuple

from hotformerloc_torch.models.config import ModelConfig


def _int_tuple(s: str) -> Tuple[int, ...]:
    return tuple(int(e) for e in s.split(","))


def parse_model_config(path: str, octree_depth: int = 9,
                       num_points: int = 4096) -> "FullModelParams":
    assert os.path.exists(path), f"Cannot find model config: {path}"
    cp = configparser.ConfigParser()
    cp.read(path)
    p = cp["MODEL"]

    model = p.get("model", "HOTFormerLoc")
    coordinates = p.get("coordinates", "cartesian")
    assert coordinates in ("polar", "cartesian", "cylindrical")
    channels = _int_tuple(p.get("channels", "96,192,384,384"))
    num_blocks = _int_tuple(p.get("num_blocks", "2,2,6,2"))
    num_heads = _int_tuple(p["num_heads"]) if "num_heads" in p \
        else tuple(c // 16 for c in channels)
    kpt = p.get("k_pooled_tokens", "64")
    k_pooled = (int(kpt),) if kpt.isdigit() else _int_tuple(kpt)
    layer_scale = p.get("layer_scale", None)
    layer_scale = float(layer_scale) if layer_scale else None
    ct_prop_scale = p.get("ct_propagation_scale", None)
    ct_prop_scale = float(ct_prop_scale) if ct_prop_scale else None
    adape = p.get("ADaPE_mode", None)
    adape = adape if adape not in (None, "", "None") else None
    # Our extension: occupancy-tuned per-depth node capacities
    # (tools/measure_occupancy.py prints this line). Absent -> the
    # worst-case default schedule (octree/build.py:37-51).
    caps = p.get("capacities", None)
    caps = _int_tuple(caps) if caps else None

    cfg = ModelConfig(
        model=model,
        channels=channels,
        num_blocks=num_blocks,
        num_heads=num_heads,
        num_pyramid_levels=p.getint("num_pyramid_levels", 3),
        num_octf_levels=p.getint("num_octf_levels", 1),
        patch_size=p.getint("patch_size", 32),
        dilation=p.getint("dilation", 4),
        drop_path=p.getfloat("drop_path", 0.5),
        stem_down=p.getint("num_input_downsamples", 2),
        downsample_input_embeddings=p.getboolean(
            "downsample_input_embeddings", True),
        rt_size=p.getint("ct_size", 1),
        rt_propagation=p.getboolean("ct_propagation", False),
        rt_propagation_scale=ct_prop_scale,
        disable_rt=p.getboolean("disable_rt", False),
        octf_use_rt=p.getboolean("use_rt", False),
        adape_mode=adape,
        disable_rpe=p.getboolean("disable_RPE", False),
        conv_norm=p.get("conv_norm", "batchnorm"),
        layer_scale=layer_scale,
        xcpe=p.getboolean("xCPE", False),
        pooling=p.get("pooling", "OctGeM"),
        feature_size=p.getint("feature_size", 256),
        output_dim=p.getint("output_dim", 256),
        k_pooled_tokens=k_pooled,
        normalize_embeddings=p.getboolean("normalize_embeddings", False),
        input_features=p.get("input_features", "P"),
        grad_checkpoint=p.getboolean("grad_checkpoint", True),
        octree_depth=octree_depth,
        num_points=num_points,
        capacities=caps,
    )
    return FullModelParams(config=cfg, coordinates=coordinates,
                           qkv_init=p.get("qkv_init", "trunc_normal,0.02"))


@dataclasses.dataclass
class FullModelParams:
    config: ModelConfig
    coordinates: str = "cartesian"
    qkv_init: str = "trunc_normal,0.02"


@dataclasses.dataclass
class TrainParams:
    """Training and dataset settings of a train config file."""
    dataset_folder: str = ""
    num_workers: int = 2
    batch_size: int = 2048
    batch_split_size: Optional[int] = None
    batch_expansion_th: Optional[float] = None
    batch_size_limit: Optional[int] = None
    batch_expansion_rate: Optional[float] = None
    val_batch_size: int = 256
    lr: float = 1e-3
    epochs: int = 20
    warmup_epochs: Optional[int] = None
    optimizer: str = "Adam"
    scheduler: str = "MultiStepLR"
    scheduler_milestones: Sequence[int] = ()
    gamma: float = 0.1
    min_lr: float = 0.0
    weight_decay: float = 0.0
    loss: str = "truncatedsmoothap"
    margin: Optional[float] = None
    pos_margin: float = 0.2
    neg_margin: float = 0.65
    tau1: float = 0.01
    positives_per_query: int = 4
    similarity: str = "euclidean"
    aug_mode: int = 1
    set_aug_mode: int = 1
    random_rot_theta: float = 5.0
    normalize_points: bool = False
    scale_factor: Optional[float] = None
    unit_sphere_norm: bool = False
    zero_mean: bool = True
    octree_depth: int = 11
    full_depth: int = 2
    train_file: str = ""
    val_file: Optional[str] = None
    validation: bool = True
    test_file: Optional[str] = None
    dataset_name: Optional[str] = None
    skip_same_run: bool = True
    mesa: float = 0.0
    mesa_start_ratio: float = 0.25
    save_freq: int = 0
    eval_freq: int = 0
    wandb: bool = False
    num_points: int = 4096
    debug: bool = False
    verbose: bool = False
    model_params: Optional[FullModelParams] = None


def parse_train_config(params_path: str, model_params_path: str,
                       debug: bool = False, verbose: bool = False,
                       num_points: int = 4096) -> TrainParams:
    assert os.path.exists(params_path), \
        f"Cannot find configuration file: {params_path}"
    cp = configparser.ConfigParser()
    cp.read(params_path)
    d = cp["DEFAULT"]
    t = cp["TRAIN"]

    tp = TrainParams(
        dataset_folder=d.get("dataset_folder", ""),
        num_workers=t.getint("num_workers", 2),
        batch_size=t.getint("batch_size", 64),
        batch_split_size=t.getint("batch_split_size", 0) or None,
        val_batch_size=t.getint("val_batch_size", 256),
        lr=t.getfloat("lr", 1e-3),
        epochs=t.getint("epochs", 20),
        warmup_epochs=(t.getint("warmup_epochs")
                       if "warmup_epochs" in t else None),
        optimizer=t.get("optimizer", "Adam"),
        scheduler=t.get("scheduler", "MultiStepLR"),
        gamma=t.getfloat("gamma", 0.1),
        min_lr=t.getfloat("min_lr", 0.0),
        weight_decay=t.getfloat("weight_decay", 0.0) or 0.0,
        loss=t.get("loss", "truncatedsmoothap").lower(),
        tau1=t.getfloat("tau1", 0.01),
        positives_per_query=t.getint("positives_per_query", 4),
        similarity=t.get("similarity",
                         "cosine" if "smoothap" in
                         t.get("loss", "truncatedsmoothap").lower()
                         else "euclidean"),
        aug_mode=t.getint("aug_mode", 1),
        set_aug_mode=t.getint("set_aug_mode", 1),
        random_rot_theta=t.getfloat("random_rot_theta", 5.0),
        normalize_points=t.getboolean("normalize_points", False),
        unit_sphere_norm=t.getboolean("unit_sphere_norm", False),
        zero_mean=t.getboolean("zero_mean", True),
        octree_depth=t.getint("octree_depth", 11),
        full_depth=t.getint("full_depth", 2),
        train_file=t.get("train_file", ""),
        val_file=t.get("val_file", None),
        validation=t.getboolean("validation", True),
        test_file=t.get("test_file", None),
        dataset_name=t.get("dataset_name", None),
        skip_same_run=t.getboolean("skip_same_run", True),
        mesa=t.getfloat("mesa", 0.0),
        mesa_start_ratio=t.getfloat("mesa_start_ratio", 0.25),
        save_freq=t.getint("save_freq", 0),
        eval_freq=t.getint("eval_freq", 0),
        wandb=t.getboolean("wandb", False),
        num_points=num_points,
        debug=debug,
        verbose=verbose,
    )
    sf = t.get("scale_factor", None)
    tp.scale_factor = float(sf) if sf else None
    if "scheduler_milestones" in t:
        tp.scheduler_milestones = [int(e) for e in
                                   t.get("scheduler_milestones").split(",")]
    else:
        tp.scheduler_milestones = [tp.epochs + 1]
    if "margin" in t:
        tp.margin = t.getfloat("margin")
    if "pos_margin" in t:
        tp.pos_margin = t.getfloat("pos_margin")
    if "neg_margin" in t:
        tp.neg_margin = t.getfloat("neg_margin")
    th = t.get("batch_expansion_th", None)
    if th:
        tp.batch_expansion_th = float(th)
        tp.batch_size_limit = t.getint("batch_size_limit", 256)
        tp.batch_expansion_rate = t.getfloat("batch_expansion_rate", 1.5)
    else:
        tp.batch_size_limit = tp.batch_size

    tp.model_params = parse_model_config(model_params_path,
                                         octree_depth=tp.octree_depth,
                                         num_points=num_points)
    return tp


def update_params_from_dict(tp: TrainParams, overrides: dict) -> TrainParams:
    """Hyperparameter-search overrides: keys matching TrainParams fields update the
    training params; keys matching ModelConfig fields rebuild the
    frozen model config with the new value. Unknown keys raise."""
    model_updates = {}
    cfg = tp.model_params.config if tp.model_params else None
    for k, v in overrides.items():
        if hasattr(tp, k) and k != "model_params":
            setattr(tp, k, v)
        elif cfg is not None and hasattr(cfg, k):
            model_updates[k] = v
        else:
            raise KeyError(f"Unknown hyperparameter override: {k}")
    if model_updates:
        tp.model_params.config = dataclasses.replace(cfg, **model_updates)
    return tp


def loss_kwargs(tp: TrainParams) -> dict:
    return dict(tau1=tp.tau1, similarity=tp.similarity,
                positives_per_query=tp.positives_per_query,
                margin=tp.margin if tp.margin is not None else 0.2,
                pos_margin=tp.pos_margin, neg_margin=tp.neg_margin)
