"""Training loop: epochs, checkpoint/resume, eval hooks, dynamic
batch expansion, metric logging.

Counterpart of hotformerloc_tpu/training/trainer.py, on one device or
over a process group (data parallelism, ``parallel/dist.py``):
  * the port's train step (``training/step.py``: single pass or the
    multistage step over ``batch_size / batch_split_size`` microbatches)
    in place of the jitted one;
  * a checkpoint is one ``torch.save`` file holding the model, the
    optimizer's moments, the update count (so the learning-rate schedule
    resumes where it stopped), the EMA teacher when there is one, and
    ``epoch`` and ``best``, with the JAX package's ``<ckpt>.meta.json``
    side file (``wandb_run_id``, ``sampler_batch_size``);
  * the loader yields numpy batches, which the trainer moves to the
    model's device;
  * over a group of n ranks the step still runs ``batch_size /
    batch_split_size`` global microbatches, as the JAX trainer does:
    ``batch_split_size`` is the global microbatch, each rank loads its
    ``batch_split_size / n`` rows of each (the JAX step's layout under
    its mesh, ``parallel.dist.local_rows``); only rank 0 writes the log,
    the checkpoints and the wandb
    run, and every rank evaluates (retrieval sharded over the ranks), as
    the JAX trainer evaluates on every host.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from hotformerloc_torch.config.params import TrainParams, loss_kwargs
from hotformerloc_torch.data.augmentation import (make_set_transform,
                                                  make_train_transform,
                                                  make_val_transform)
from hotformerloc_torch.data.loaders import get_pointcloud_loader
from hotformerloc_torch.data.pipeline import DataLoader, TrainingDataset
from hotformerloc_torch.data.sampler import BatchSampler
from hotformerloc_torch.evaluation.embed import compute_dtype, make_embed_fn
from hotformerloc_torch.evaluation.evaluate import evaluate
from hotformerloc_torch.losses.losses import make_loss
from hotformerloc_torch.models.hotformerloc import HOTFormerLoc, param_count
from hotformerloc_torch.parallel import dist
from hotformerloc_torch.training.optim import lr_schedule, make_optimizer
from hotformerloc_torch.training.step import (StepConfig, TrainStep,
                                              apply_qkv_init, make_eval_step,
                                              make_train_step)


def save_checkpoint(path: str, step: TrainStep, epoch: int,
                    best_metric: float = 0.0,
                    extra_meta: Optional[Dict] = None):
    """Write the whole training state of ``step`` (its model, optimizer,
    update count and EMA teacher) with ``epoch`` and ``best_metric`` to
    ``path``, through a temporary file renamed into place, and
    ``extra_meta`` to ``path + '.meta.json'``."""
    ema = step.state.ema_model
    ckpt = {"model": step.model.state_dict(),
            "optimizer": step.optimizer.state_dict(),
            "step": int(step.state.step),
            "ema": None if ema is None else ema.state_dict(),
            "epoch": int(epoch), "best": float(best_metric)}
    tmp = path + ".tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)
    with open(path + ".meta.json", "w") as f:
        json.dump(extra_meta or {}, f)


def load_checkpoint(path: str, step: TrainStep):
    """Restore ``save_checkpoint``'s state into ``step`` in place.
    Returns (epoch, best_metric, extra_meta). The file is read to the
    CPU: ``load_state_dict`` moves the model's and the moments' tensors
    to the parameters' device and leaves Adam's step counts on the CPU,
    where torch keeps them (on the card each update would read them back
    with a sync)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    step.model.load_state_dict(ckpt["model"])
    step.optimizer.load_state_dict(ckpt["optimizer"])
    step.state.step = int(ckpt["step"])
    ema = step.state.ema_model
    if (ema is None) != (ckpt["ema"] is None):
        raise ValueError(f"{path}: EMA teacher saved "
                         f"{ckpt['ema'] is not None}, expected "
                         f"{ema is not None}")
    if ema is not None:
        ema.load_state_dict(ckpt["ema"])
    extra = {}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            extra = json.load(f)
    return int(ckpt["epoch"]), float(ckpt["best"]), extra


class MetricLogger:
    """JSONL metric log, and wandb only when asked (imported then)."""

    def __init__(self, path: Optional[str] = None, use_wandb: bool = False):
        self.path = path
        self.wandb = None
        if use_wandb:
            try:
                import wandb
                self.wandb = wandb
            except ImportError:
                print("[WARN] wandb unavailable; logging to JSONL only")

    def ensure_run(self, config: Dict, run_id: Optional[str] = None,
                   name: Optional[str] = None) -> Optional[str]:
        """Start (or resume, given a stored id) the wandb run. Returns the
        active run id."""
        if self.wandb is None:
            return None
        if self.wandb.run is None:
            self.wandb.init(project="hotformerloc_torch", name=name,
                            id=run_id, resume="allow", config=config)
        return getattr(self.wandb.run, "id", None)

    def log(self, record: Dict):
        record = {k: (float(v) if isinstance(v, (np.floating, torch.Tensor))
                      else v) for k, v in record.items()}
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(record) + "\n")
        if self.wandb and self.wandb.run is not None:
            self.wandb.log(record)


def step_seed(seed: int, epoch: int, batch_index: int) -> int:
    """The train step's seed (its DropPath masks) for one batch."""
    return int(np.random.SeedSequence(
        [int(seed), int(epoch), int(batch_index)]).generate_state(1)[0])


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device, non_blocking=True)
            for k, v in batch.items()}


class Trainer:
    """End-to-end training orchestration on one device, or on one rank
    of ``group`` (data parallelism; None: one process).

    ``device``: the card unless the caller passes "cpu" (over a group:
    the rank's card, ``init_from_env``'s). ``dtype``: the
    compute dtype, bf16 on the card and fp32 on the CPU by default
    (parameters stay fp32). ``seed`` draws the initial weights (the qkv
    projections per the model config's ``qkv_init``), the sampler's
    shuffle, the loader's augmentations and every step's DropPath
    masks; over a group the weights are then broadcast from rank 0."""

    def __init__(self, params: TrainParams, weights_dir: str = "weights",
                 model_name: Optional[str] = None,
                 dtype: Optional[torch.dtype] = None, device="cuda",
                 seed: int = 42, group=None):
        self.params = params
        cfg = params.model_params.config
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = dtype or compute_dtype(self.device)
        self.seed = seed
        self.group = group
        self.rank, self.world = dist.rank(group), dist.world(group)
        g = torch.Generator().manual_seed(seed)
        self.model = HOTFormerLoc(cfg, device=self.device, generator=g,
                                  dtype=self.dtype)
        qkv_init = getattr(params.model_params, "qkv_init", None)
        if qkv_init:
            apply_qkv_init(self.model, g, qkv_init)
        dist.broadcast_module_(self.model, 0, group)
        self._print(f"Model: {cfg.model}  parameters: "
                    f"{param_count(self.model)}")
        if params.verbose and self.rank == 0:
            from hotformerloc_torch.utils.profiling import print_info
            print_info(cfg.model, self.model, depth=2)
        self.model_name = model_name or \
            f"{cfg.model}_{time.strftime('%Y%m%d_%H%M')}"
        self.weights_dir = os.path.join(weights_dir,
                                        params.dataset_name or "default")
        os.makedirs(self.weights_dir, exist_ok=True)
        lead = self.rank == 0               # writes logs and checkpoints
        self.logger = MetricLogger(
            os.path.join(self.weights_dir, self.model_name + "_log.jsonl")
            if lead else None, use_wandb=params.wandb and lead)

        # data
        loader = get_pointcloud_loader(params.dataset_name or "")
        tt = make_train_transform(params.aug_mode, params.normalize_points,
                                  params.scale_factor,
                                  params.unit_sphere_norm, params.zero_mean,
                                  params.random_rot_theta)
        st = make_set_transform(params.set_aug_mode, params.random_rot_theta)
        self.train_ds = TrainingDataset(
            params.dataset_folder, params.train_file, loader, tt, st,
            params.model_params.coordinates)
        self.train_sampler = BatchSampler(
            self.train_ds.queries, params.batch_size,
            params.batch_size_limit, params.batch_expansion_rate,
            max_batches=2 if params.debug else None, seed=seed)
        # batch_split_size is the global microbatch, as in the JAX
        # trainer; each rank holds batch_split_size / world of it
        accum_steps = (max(params.batch_size // params.batch_split_size, 1)
                       if params.batch_split_size else 1)
        self.train_loader = DataLoader(self.train_ds, self.train_sampler,
                                       cfg.num_points, seed=seed,
                                       process_index=self.rank,
                                       process_count=self.world,
                                       num_workers=params.num_workers,
                                       micro_batches=accum_steps)
        self.val_loader = None
        if params.validation and params.val_file:
            vt = make_val_transform(params.normalize_points,
                                    params.scale_factor,
                                    params.unit_sphere_norm,
                                    params.zero_mean)
            val_ds = TrainingDataset(params.dataset_folder, params.val_file,
                                     loader, vt, None,
                                     params.model_params.coordinates)
            val_sampler = BatchSampler(val_ds.queries,
                                       params.val_batch_size,
                                       max_batches=2 if params.debug
                                       else None, seed=seed)
            self.val_loader = DataLoader(val_ds, val_sampler,
                                         cfg.num_points, seed=seed,
                                         process_index=self.rank,
                                         process_count=self.world,
                                         num_workers=params.num_workers)

        # steps
        steps_per_epoch = max(len(self.train_ds)
                              // max(params.batch_size, 1), 1)
        sched = lr_schedule(params.lr, steps_per_epoch, params.epochs,
                            params.scheduler, params.scheduler_milestones,
                            params.gamma, params.min_lr,
                            params.warmup_epochs)
        self.optimizer = make_optimizer(self.model.named_parameters(),
                                        params.optimizer, sched,
                                        params.weight_decay)
        self.loss_fn = make_loss(params.loss, **loss_kwargs(params))
        self.use_ema = params.mesa > 0.0
        self.step_cfg_nomesa = StepConfig(accum_steps=accum_steps,
                                          use_ema=self.use_ema, mesa=0.0)
        self.step_cfg_mesa = StepConfig(accum_steps=accum_steps,
                                        use_ema=self.use_ema,
                                        mesa=params.mesa)
        self.train_step = make_train_step(self.model, self.optimizer,
                                          self.loss_fn, self.step_cfg_nomesa,
                                          group)
        self.eval_step = make_eval_step(self.model, self.loss_fn, group)
        self.start_epoch = 1
        self.best_metric = 0.0
        self.wandb_run_id: Optional[str] = None
        # set by elastic.install_preemption_handler on SIGTERM/SIGUSR1
        self.preempted = False
        # one record per step trained: epoch, batch index, batch size,
        # host seconds of the step (it reads its stats back, so it ends
        # with the device idle) and seconds it waited on the loader
        self.step_log: list = []

    # -- lifecycle ------------------------------------------------------
    def _print(self, msg: str) -> None:
        if self.rank == 0:
            print(msg, flush=True)

    def ckpt_path(self, tag: str) -> str:
        return os.path.join(self.weights_dir,
                            f"{self.model_name}_{tag}.ckpt")

    def _extra_meta(self) -> Dict:
        return {"wandb_run_id": self.wandb_run_id,
                "sampler_batch_size": int(self.train_sampler.batch_size)}

    def save(self, tag: str, epoch: int) -> str:
        """Write checkpoint ``tag`` (rank 0 only; every rank holds the
        same state). Returns its path."""
        path = self.ckpt_path(tag)
        if self.rank == 0:
            save_checkpoint(path, self.train_step, epoch, self.best_metric,
                            self._extra_meta())
        return path

    def resume(self, path: str):
        epoch, best, extra = load_checkpoint(path, self.train_step)
        self.start_epoch = epoch + 1
        self.best_metric = best
        bs = int(extra.get("sampler_batch_size", 0))
        if bs > 0:
            self.train_sampler.batch_size = bs
        self.wandb_run_id = extra.get("wandb_run_id") or None
        self._print(f"Resumed from {path} at epoch {epoch}"
                    + (f" (batch_size={bs})" if bs else ""))

    def make_embed_fn(self):
        """(points, pmask) -> (B, D) descriptors of the current weights
        in the compute dtype, as ``pnv_evaluate`` computes them."""
        embed = make_embed_fn(self.model, self.dtype)
        return lambda p, m: embed(p, m)["global"]

    def evaluate(self) -> Dict:
        return evaluate(self.make_embed_fn(), self.params,
                        debug=self.params.debug, device=self.device,
                        group=self.group)

    # -- loop -----------------------------------------------------------
    def train(self):
        p = self.params
        self.wandb_run_id = self.logger.ensure_run(
            {k: v for k, v in vars(p).items()
             if isinstance(v, (int, float, str, bool, type(None)))},
            run_id=self.wandb_run_id, name=self.model_name) \
            or self.wandb_run_id
        mesa_start = int(p.epochs * p.mesa_start_ratio)
        for epoch in range(self.start_epoch, p.epochs + 1):
            t0 = time.time()
            self.train_step.cfg = (self.step_cfg_mesa
                                   if self.use_ema and epoch > mesa_start
                                   else self.step_cfg_nomesa)
            agg: Dict[str, list] = {}
            it = iter(self.train_loader)
            bi, wait = 0, 0.0
            while True:
                tw = time.perf_counter()
                batch = next(it, None)
                if batch is None:
                    break
                ts = time.perf_counter()
                stats = self.train_step(to_device(batch, self.device),
                                        step_seed(self.seed, epoch, bi))
                for k, v in stats.items():
                    agg.setdefault(k, []).append(float(v))
                self.step_log.append({
                    "epoch": epoch, "batch": bi,
                    "size": len(batch["points"]),
                    "step_s": time.perf_counter() - ts, "wait_s": ts - tw})
                wait += ts - tw
                bi += 1
            epoch_stats = {k: float(np.mean(v)) for k, v in agg.items()}
            epoch_stats.update(epoch=epoch, phase="train",
                               time=time.time() - t0, batches=bi,
                               batch_size=self.train_sampler.batch_size,
                               loader_wait=wait)
            self.logger.log(epoch_stats)
            loss_s = epoch_stats.get("loss", float("nan"))
            self._print(f"epoch {epoch}: loss={loss_s:.4f} "
                        f"({bi} batches, {epoch_stats['time']:.1f}s)")

            if self.val_loader is not None:
                vagg: Dict[str, list] = {}
                for batch in self.val_loader:
                    vstats = self.eval_step(to_device(batch, self.device))
                    for k, v in vstats.items():
                        vagg.setdefault(k, []).append(float(v))
                vals = {f"val_{k}": float(np.mean(v))
                        for k, v in vagg.items()}
                vals.update(epoch=epoch, phase="val")
                self.logger.log(vals)

            if not p.debug:
                self.save("latest", epoch)
                if p.save_freq and epoch % p.save_freq == 0:
                    self.save(f"e{epoch}", epoch)

            if p.eval_freq and epoch % p.eval_freq == 0:
                try:
                    stats = self.evaluate()
                except FileNotFoundError as e:
                    self._print(f"[WARN] eval skipped: {e}")
                else:
                    avg = stats["average"]
                    ar1 = float(avg["ave_recall"][0])
                    self.logger.log({
                        "epoch": epoch, "phase": "eval", "avg_AR1": ar1,
                        "avg_AR1p": avg["ave_one_percent_recall"],
                        "avg_MRR": avg["ave_mrr"]})
                    if ar1 > self.best_metric and not p.debug:
                        self.best_metric = ar1
                        self.save("best", epoch)

            # preemption: checkpoint + requeue exit, on every rank when
            # any rank was signalled
            self.preempted = dist.any_rank(self.preempted, self.device,
                                           self.group)
            if self.preempted:
                from hotformerloc_torch.training.elastic import \
                    maybe_requeue_exit
                maybe_requeue_exit(self, epoch)

            # dynamic batch expansion
            if p.batch_expansion_th is not None and \
                    "num_non_zero_triplets" in epoch_stats:
                nzr = (epoch_stats["num_non_zero_triplets"]
                       / max(epoch_stats.get("num_triplets", 1.0), 1.0))
                if nzr < p.batch_expansion_th:
                    if self.train_sampler.expand_batch():
                        self._print(f"Batch expanded to "
                                    f"{self.train_sampler.batch_size}")

        if not p.debug:
            self.save("final", p.epochs)
        return self.train_step

    def close(self) -> None:
        """Stop the loaders' worker pools."""
        self.train_loader.close()
        if self.val_loader is not None:
            self.val_loader.close()
