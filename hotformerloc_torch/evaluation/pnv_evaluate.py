"""Evaluation CLI: counterpart of hotformerloc_tpu/evaluation/pnv_evaluate.py.

Usage:
  python -m hotformerloc_torch.evaluation.pnv_evaluate --config ... \
      --model_config ... --weights weights/.../model_best.ckpt [--log] \
      [--device cpu]

``--weights`` is a checkpoint of this package's trainer
(``training/trainer.py`` ``save_checkpoint``) or a params-only
``state_dict`` file. It runs on the card unless ``--device cpu``.
Under ``torchrun`` with more than one process every rank embeds the
clouds on its own card and the retrieval is sharded over the ranks;
rank 0 prints and writes the results (and the ``--log`` files).
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch

from hotformerloc_torch.config.params import parse_train_config
from hotformerloc_torch.evaluation.embed import compute_dtype, make_embed_fn
from hotformerloc_torch.evaluation.evaluate import (evaluate, print_eval_stats,
                                                    write_eval_stats)
from hotformerloc_torch.models.hotformerloc import HOTFormerLoc
from hotformerloc_torch.parallel import dist


def load_model_embed_fn(params, weights: Optional[str] = None,
                        device="cuda"):
    """(embed_fn, model_name): build the model on ``device``, restore
    ``weights``, and return the (points, pmask) -> (B, D) closure that
    every evaluator calls (bf16 on the card, fp32 on the CPU)."""
    cfg = params.model_params.config
    model = HOTFormerLoc(cfg, device=device)
    if weights:
        state = torch.load(weights, map_location="cpu", weights_only=True)
        model.load_state_dict(state["model"] if "model" in state else state)
    embed = make_embed_fn(model, compute_dtype(device))
    model_name = os.path.splitext(os.path.basename(weights))[0] \
        if weights else cfg.model
    return (lambda p, m: embed(p, m)["global"]), model_name


def main(argv: Optional[Sequence[str]] = None):
    """Evaluate; returns the stats dict that ``evaluate`` gives."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--model_config", required=True)
    ap.add_argument("--weights", default=None,
                    help="checkpoint or state_dict file")
    ap.add_argument("--debug", action="store_true",
                    help="random embeddings, protocol smoke test")
    ap.add_argument("--log", action="store_true",
                    help="log false positives / top-5 matches to txt")
    ap.add_argument("--num_points", type=int, default=4096)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    params = parse_train_config(args.config, args.model_config,
                                debug=args.debug,
                                num_points=args.num_points)
    group, device = None, args.device
    if dist.env_world() > 1:
        group, device = dist.init_from_env(args.device)
    try:
        lead = dist.rank(group) == 0
        embed_fn, model_name = load_model_embed_fn(params, args.weights,
                                                   device)
        stats = evaluate(embed_fn, params, debug=args.debug,
                         log=args.log and lead, model_name=model_name,
                         device=device, group=group)
    finally:
        dist.close(group)
    if lead:
        print_eval_stats(stats)
        prefix = f"{args.model_config}, {args.weights}"
        write_eval_stats(f"pnv_{params.dataset_name}_results.txt", prefix,
                         stats)
    return stats


if __name__ == "__main__":
    main()
