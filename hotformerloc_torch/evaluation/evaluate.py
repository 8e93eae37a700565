"""Retrieval: top-k nearest database descriptors per query on one device.

Counterpart of the single-device branch of
hotformerloc_tpu/evaluation/evaluate.py:retrieval_topk, with the same
distance formula. Sharded retrieval over several cards is later work.
"""
from __future__ import annotations

import numpy as np
import torch

NUM_NEIGHBORS = 25


def retrieval_topk(queries, database, k: int = NUM_NEIGHBORS,
                   device="cuda"):
    """(Q, C) queries and (D, C) database embeddings -> (dist (Q, k),
    idx (Q, k)) numpy arrays, nearest first by L2 distance."""
    q = torch.as_tensor(np.asarray(queries), dtype=torch.float32,
                        device=device)
    d = torch.as_tensor(np.asarray(database), dtype=torch.float32,
                        device=device)
    k = min(k, d.shape[0])
    with torch.inference_mode():
        sim = q @ d.T
        qn = (q * q).sum(dim=1, keepdim=True)
        dn = (d * d).sum(dim=1)[None, :]
        dist2 = torch.clamp(qn + dn - 2.0 * sim, min=0.0)
        neg, idx = torch.topk(-dist2, k, dim=1)
        dist = torch.sqrt(torch.clamp(-neg, min=0.0))
    return dist.cpu().numpy(), idx.cpu().numpy()
