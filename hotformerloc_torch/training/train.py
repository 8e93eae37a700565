"""Training CLI: counterpart of hotformerloc_tpu/training/train.py.

Usage:
  python -m hotformerloc_torch.training.train --config configs/oxford.txt \
      --model_config configs/oxford_model.txt [--resume_from ckpt] \
      [--debug] [--device cpu]

It trains on the card unless ``--device cpu``. Under ``torchrun`` with
more than one process (WORLD_SIZE > 1) it trains one model data-parallel
over the ranks, each on its own card (``cuda:LOCAL_RANK``, NCCL; gloo
with ``--device cpu``):

  torchrun --nproc_per_node 4 -m hotformerloc_torch.training.train \
      --config configs/oxford.txt --model_config configs/oxford_model.txt

``batch_size`` stays the global batch and ``batch_split_size`` the
global microbatch, as in the JAX trainer: every step runs
``batch_size / batch_split_size`` microbatches at any nproc, and each
card holds ``batch_split_size / nproc`` rows of each. Models with batch
statistics (``conv_norm = batchnorm`` or ``powernorm``, the
``BatchNorm`` of the GeM heads) sum them over the ranks, so they are
the global microbatch's.
"""
from __future__ import annotations

import argparse
import ast
from typing import Optional, Sequence

from hotformerloc_torch.config.params import (parse_train_config,
                                              update_params_from_dict)
from hotformerloc_torch.parallel import dist
from hotformerloc_torch.training.elastic import install_preemption_handler
from hotformerloc_torch.training.trainer import Trainer
from hotformerloc_torch.utils.seed import set_seed


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    """Parse ``argv`` (the command line when None), train, and return
    the trainer."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True,
                    help="Path to training configuration file")
    ap.add_argument("--model_config", required=True,
                    help="Path to the model-specific configuration file")
    ap.add_argument("--resume_from", default=None,
                    help="Checkpoint to resume training from")
    ap.add_argument("--debug", action="store_true",
                    help="2 batches/epoch, no ckpt writes, fake eval")
    ap.add_argument("--verbose", action="store_true",
                    help="per-module parameter breakdown at init")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--num_points", type=int, default=4096,
                    help="Static per-cloud point budget")
    ap.add_argument("--override", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="hyperparameter override (repeatable), e.g. "
                         "--override lr=1e-4 --override patch_size=32")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    ap.add_argument("--weights_dir", default="weights",
                    help="where checkpoints and the metric log go")
    ap.add_argument("--model_name", default=None,
                    help="checkpoint name prefix (default: model + time)")
    args = ap.parse_args(argv)

    set_seed(args.seed)
    params = parse_train_config(args.config, args.model_config,
                                debug=args.debug, verbose=args.verbose,
                                num_points=args.num_points)
    if args.override:
        ov = {}
        for kv in args.override:
            k, _, v = kv.partition("=")
            try:
                ov[k] = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                ov[k] = v
        update_params_from_dict(params, ov)
    group, device = None, args.device
    if dist.env_world() > 1:
        group, device = dist.init_from_env(args.device)
    try:
        trainer = Trainer(params, weights_dir=args.weights_dir,
                          model_name=args.model_name, device=device,
                          seed=args.seed, group=group)
        try:
            if args.resume_from:
                trainer.resume(args.resume_from)
            install_preemption_handler(trainer)
            trainer.train()
        finally:
            trainer.close()
    finally:
        dist.close(group)
    return trainer


if __name__ == "__main__":
    main()
