# Frozen copy of the TruncatedSmoothAP and MESA terms of
# hotformerloc_torch/losses/losses.py at commit 17534d0, for portbench's
# plain reference.
"""The reference's losses: TruncatedSmoothAP and the MESA distillation
term, in fp32."""
from __future__ import annotations

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


def kd_loss(student: torch.Tensor, teacher: torch.Tensor,
            temperature: float = 3.0, scale: float = 50.0) -> torch.Tensor:
    """MESA distillation term: 50 * T-softened KL, batchmean."""
    p_log = F.log_softmax(student / temperature, dim=1)
    q = F.softmax(teacher / temperature, dim=1)
    kl = (q * (torch.log(torch.clamp(q, min=1e-12)) - p_log)).sum(1)
    return scale * kl.mean()
