"""k=2 positive-pair batch sampler with dynamic batch expansion.

Own copy of hotformerloc_tpu/data/sampler.py: batches are built from
groups of 2 positives; when the trainer reports a low active-triplet
ratio the batch grows by ``batch_expansion_rate`` up to
``batch_size_limit`` (``training/trainer.py``). The shuffle draws from a
``random.Random(seed)``, so one seed gives the same batches in both
packages.
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional

import numpy as np


class BatchSampler:
    K = 2  # positives per group

    def __init__(self, queries: Dict[int, object], batch_size: int,
                 batch_size_limit: Optional[int] = None,
                 batch_expansion_rate: Optional[float] = None,
                 max_batches: Optional[int] = None,
                 seed: Optional[int] = None,
                 drop_last: bool = False):
        if batch_expansion_rate is not None:
            assert batch_expansion_rate > 1.0
            assert batch_size <= (batch_size_limit or batch_size)
        self.queries = queries
        self.batch_size = max(batch_size, 2 * self.K)
        self.batch_size_limit = batch_size_limit
        self.batch_expansion_rate = batch_expansion_rate
        self.max_batches = max_batches
        self.drop_last = drop_last
        self.elems = list(queries.keys())
        self._rng = random.Random(seed)

    def expand_batch(self) -> bool:
        if self.batch_expansion_rate is None:
            return False
        if self.batch_size >= (self.batch_size_limit or self.batch_size):
            return False
        old = self.batch_size
        self.batch_size = min(int(self.batch_size
                                  * self.batch_expansion_rate),
                              self.batch_size_limit)
        # keep k=2 group structure
        self.batch_size -= self.batch_size % self.K
        return self.batch_size != old

    def generate_batches(self) -> List[List[int]]:
        rng = self._rng
        unused = set(self.elems)
        batches: List[List[int]] = []
        current: List[int] = []
        order = list(self.elems)
        rng.shuffle(order)
        queue = order

        for sel in queue:
            if sel not in unused:
                continue
            positives = self.queries[sel].positives
            if len(positives) == 0:
                unused.discard(sel)
                continue
            unused.discard(sel)
            unused_pos = [p for p in positives if p in unused]
            if unused_pos:
                second = rng.choice(unused_pos)
                unused.discard(second)
            else:
                second = rng.choice(list(positives))
            current += [sel, int(second)]
            if len(current) >= self.batch_size:
                batches.append(current)
                current = []
                if self.max_batches and len(batches) >= self.max_batches:
                    return batches
        # flush a final smaller batch if it still allows negatives
        if len(current) >= 2 * self.K and not self.drop_last:
            batches.append(current)
        return batches

    def __iter__(self):
        return iter(self.generate_batches())


def masks_for_batch(queries: Dict[int, object],
                    labels: List[int]) -> tuple[np.ndarray, np.ndarray]:
    """(B, B) positives / negatives boolean masks for a batch of query
    ids (collate logic, datasets/dataset_utils.py:119-123)."""
    B = len(labels)
    pos = np.zeros((B, B), dtype=bool)
    neg = np.zeros((B, B), dtype=bool)
    arr = np.asarray(labels)
    # vectorised per row (positives/non_negatives are sorted arrays):
    # the B^2 python loop was ~5-10% of batch assembly time
    for i, a in enumerate(labels):
        q = queries[a]
        if len(q.positives):
            pos[i] = np.isin(arr, q.positives)
        if len(q.non_negatives):
            neg[i] = ~np.isin(arr, q.non_negatives)
        else:
            neg[i] = True
    return pos, neg
