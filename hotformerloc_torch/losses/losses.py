"""Metric-learning losses: TruncatedSmoothAP, batch-hard triplet /
contrastive, MESA distillation.

Counterparts of hotformerloc_tpu/losses/losses.py. Each loss is a
function of (embeddings (B, D), positives_mask (B, B) bool,
negatives_mask (B, B) bool) returning (loss, stats), with stats a dict
of 0-d tensors. Everything is computed in fp32.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

Stats = Dict[str, torch.Tensor]


def tempered_sigmoid(x: torch.Tensor, temp: float) -> torch.Tensor:
    """sigmoid(x / temp) with a +-50 clamp of the exponent."""
    e = torch.clamp(-x / temp, -50.0, 50.0)
    return 1.0 / (1.0 + torch.exp(e))


def compute_aff(e: torch.Tensor, similarity: str = "cosine") -> torch.Tensor:
    """(B, D) -> (B, B) affinity."""
    if similarity == "cosine":
        return e @ e.t()
    if similarity == "euclidean":
        return -_pairwise_l2(e)
    raise ValueError(similarity)


def truncated_smoothap(embeddings: torch.Tensor,
                       positives_mask: torch.Tensor,
                       negatives_mask: torch.Tensor, tau1: float = 0.01,
                       similarity: str = "cosine",
                       positives_per_query: int = 4
                       ) -> Tuple[torch.Tensor, Stats]:
    """Smooth-AP surrogate over the positives_per_query closest
    positives of each query."""
    e = embeddings.float()
    B = e.shape[0]
    pos = positives_mask.to(e.dtype)
    neg = negatives_mask.to(e.dtype)
    s_qz = compute_aff(e, similarity)
    s_pos = torch.where(positives_mask, s_qz.detach(),
                        torch.full_like(s_qz, -torch.inf))
    top_idx = torch.topk(s_pos, positives_per_query, dim=1).indices  # (B, P)
    s_top = torch.gather(s_qz, 1, top_idx)                       # (B, P)
    s_diff = s_qz[:, None, :] - s_top[:, :, None]                # (B, P, B)
    sig = tempered_sigmoid(s_diff, tau1)
    pos_sig = sig * pos[:, None, :]
    # zero the slot where z is the selected positive itself
    self_mask = 1.0 - F.one_hot(top_idx, B).to(sig.dtype)
    pos_sig = pos_sig * self_mask
    r_p = pos_sig.sum(2) + 1.0                                   # (B, P)
    r_omega = r_p + (sig * neg[:, None, :]).sum(2)
    r = r_p / r_omega
    valid_pos = torch.gather(pos, 1, top_idx)
    n_valid = valid_pos.sum(1)
    valid_q = n_valid > 0
    ap_q = (r * valid_pos).sum(1) / torch.clamp(n_valid, min=1.0)
    nq = torch.clamp(valid_q.sum(), min=1)
    ap = torch.where(valid_q, ap_q, torch.zeros_like(ap_q)).sum() / nq
    loss = 1.0 - ap
    with torch.no_grad():
        hard = ((s_diff[:, 0, :] > 0) & negatives_mask).sum(1).float()
        stats = {
            "loss": loss.detach(),
            "ap": ap.detach(),
            "positives_per_query": pos.sum(1).mean(),
            "best_positive_ranking": hard.mean(),
            "recall_at_1": (hard <= 1).float().mean(),
            "avg_embedding_norm": e.norm(dim=1).mean(),
        }
    return loss, stats


def _pairwise_l2(e: torch.Tensor) -> torch.Tensor:
    sq = (e ** 2).sum(1)
    d2 = sq[:, None] + sq[None] - 2 * e @ e.t()
    return torch.sqrt(torch.clamp(d2, min=1e-12))


def _mine_batch_hard(dist, positives_mask, negatives_mask):
    """Hardest positive / hardest negative per anchor. Returns (d_ap,
    ap_idx, d_an, an_idx, row_valid)."""
    zero = torch.zeros_like(dist)
    inf = torch.full_like(dist, torch.inf)
    d_ap = torch.where(positives_mask, dist, zero).max(1).values
    ap_idx = torch.where(positives_mask, dist, -inf).argmax(1)
    d_an_raw = torch.where(negatives_mask, dist, inf)
    d_an, an_idx = d_an_raw.min(1)
    valid = positives_mask.any(1) & negatives_mask.any(1)
    d_an = torch.where(torch.isfinite(d_an), d_an, torch.zeros_like(d_an))
    return d_ap, ap_idx, d_an, an_idx, valid


def _avg_nonzero(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mean over the strictly positive elements of valid rows."""
    nz = (x > 0) & valid
    return torch.where(nz, x, torch.zeros_like(x)).sum() / torch.clamp(
        nz.sum(), min=1)


def batch_hard_triplet_margin(embeddings, positives_mask, negatives_mask,
                              margin: float = 0.2
                              ) -> Tuple[torch.Tensor, Stats]:
    """Batch-hard triplet margin loss with swap (min(d(a,n), d(p,n))) and
    avg-nonzero reduction."""
    e = embeddings.float()
    dist = _pairwise_l2(e)
    d_ap, ap_idx, d_an, an_idx, valid = _mine_batch_hard(
        dist, positives_mask, negatives_mask)
    d_pn = dist[ap_idx, an_idx]
    d_neg = torch.minimum(d_an, d_pn)
    losses = torch.clamp(d_ap - d_neg + margin, min=0.0)
    loss = _avg_nonzero(losses, valid)
    with torch.no_grad():
        nvalid = torch.clamp(valid.sum(), min=1)

        def vmean(x):
            return torch.where(valid, x, torch.zeros_like(x)).sum() / nvalid

        def vext(x, fill, fn):
            return fn(torch.where(valid, x, torch.full_like(x, fill)))

        stats = {
            "loss": loss.detach(),
            "avg_embedding_norm": e.norm(dim=1).mean(),
            "num_triplets": valid.sum().float(),
            "num_non_zero_triplets": ((losses > 0) & valid).sum().float(),
            "mean_pos_pair_dist": vmean(d_ap),
            "mean_neg_pair_dist": vmean(d_an),
            "max_pos_pair_dist": vext(d_ap, -torch.inf, torch.max),
            "min_pos_pair_dist": vext(d_ap, torch.inf, torch.min),
            "max_neg_pair_dist": vext(d_an, -torch.inf, torch.max),
            "min_neg_pair_dist": vext(d_an, torch.inf, torch.min),
        }
    return loss, stats


def batch_hard_contrastive(embeddings, positives_mask, negatives_mask,
                           pos_margin: float = 0.2, neg_margin: float = 0.65
                           ) -> Tuple[torch.Tensor, Stats]:
    """Batch-hard contrastive loss with avg-nonzero reduction."""
    e = embeddings.float()
    dist = _pairwise_l2(e)
    d_ap, _, d_an, _, valid = _mine_batch_hard(dist, positives_mask,
                                               negatives_mask)
    pos_loss = _avg_nonzero(torch.clamp(d_ap - pos_margin, min=0.0), valid)
    neg_loss = _avg_nonzero(torch.clamp(neg_margin - d_an, min=0.0), valid)
    loss = pos_loss + neg_loss
    stats = {
        "loss": loss.detach(),
        "pos_loss": pos_loss.detach(),
        "neg_loss": neg_loss.detach(),
        "num_pairs": 2.0 * valid.sum().float(),
        "avg_embedding_norm": e.detach().norm(dim=1).mean(),
    }
    return loss, stats


def kd_loss(student: torch.Tensor, teacher: torch.Tensor,
            temperature: float = 3.0, scale: float = 50.0) -> torch.Tensor:
    """MESA distillation term: 50 * T-softened KL, batchmean."""
    p_log = F.log_softmax(student / temperature, dim=1)
    q = F.softmax(teacher / temperature, dim=1)
    kl = (q * (torch.log(torch.clamp(q, min=1e-12)) - p_log)).sum(1)
    return scale * kl.mean()


def make_loss(name: str, **kw):
    """Loss factory: 'truncatedsmoothap', 'batchhardtripletmarginloss' or
    'batchhardcontrastiveloss' (case-insensitive)."""
    name = name.lower()
    if name == "truncatedsmoothap":
        return partial(truncated_smoothap,
                       tau1=kw.get("tau1", 0.01),
                       similarity=kw.get("similarity", "cosine"),
                       positives_per_query=kw.get("positives_per_query", 4))
    if name == "batchhardtripletmarginloss":
        return partial(batch_hard_triplet_margin,
                       margin=kw.get("margin", 0.2))
    if name == "batchhardcontrastiveloss":
        return partial(batch_hard_contrastive,
                       pos_margin=kw.get("pos_margin", 0.2),
                       neg_margin=kw.get("neg_margin", 0.65))
    raise NotImplementedError(f"Unknown loss: {name}")
