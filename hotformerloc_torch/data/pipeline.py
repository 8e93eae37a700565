"""Host-side dataset + batch assembly feeding the on-device octree build.

Own copy of hotformerloc_tpu/data/pipeline.py. The model builds its
octrees on the card, so the host only loads clouds, augments, clips to
[-1, 1], and packs them into fixed-shape (B, P, 3) numpy arrays with
point-validity masks; the trainer moves each batch to the card. Every
random draw is keyed by (seed + epoch, batch index, row), so a batch is
bitwise equal to the JAX package's for the same seed and sampler.
"""
from __future__ import annotations

import functools
import os
import threading
import queue as queue_mod
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from hotformerloc_torch.data.augmentation import (CylindricalCoordinates,
                                                Compose)
from hotformerloc_torch.data.loaders import PointCloudLoader
from hotformerloc_torch.data.sampler import BatchSampler, masks_for_batch
from hotformerloc_torch.data.tuples import TrainingTuple, load_training_queries
from hotformerloc_torch.parallel.dist import local_rows


def clip_to_unit_box(pc: np.ndarray,
                     cylindrical: bool = False) -> np.ndarray:
    """Drop points outside [-1, 1]^3 (and outside unit xy-radius when
    converting to cylindrical)."""
    m = np.all(np.abs(pc) <= 1.0, axis=1)
    pc = pc[m]
    if cylindrical:
        pc = pc[np.linalg.norm(pc[:, :2], axis=1) <= 1.0]
    return pc


def pack_clouds(clouds: List[np.ndarray], num_points: int,
                rng: Optional[np.random.Generator] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Pack variable-size clouds into (B, P, 3) + (B, P) validity.

    Clouds larger than the static point budget are randomly subsampled
    (uniform, deterministic given rng); smaller ones are zero-padded and
    masked.
    """
    B = len(clouds)
    pts = np.zeros((B, num_points, 3), dtype=np.float32)
    msk = np.zeros((B, num_points), dtype=bool)
    for i, c in enumerate(clouds):
        n = len(c)
        if n > num_points:
            sel = (rng.choice(n, num_points, replace=False)
                   if rng is not None else
                   np.linspace(0, n - 1, num_points).astype(np.int64))
            c = c[sel]
            n = num_points
        pts[i, :n] = c
        msk[i, :n] = True
    return pts, msk


class TrainingDataset:
    """Pickle-tuple-indexed dataset."""

    def __init__(self, dataset_path: str, query_filename: str,
                 pc_loader: PointCloudLoader,
                 transform: Optional[Compose] = None,
                 set_transform: Optional[Compose] = None,
                 coordinates: str = "cartesian"):
        assert os.path.exists(dataset_path), \
            f"Cannot access dataset path: {dataset_path}"
        self.dataset_path = dataset_path
        self.queries: Dict[int, TrainingTuple] = load_training_queries(
            os.path.join(dataset_path, query_filename))
        self.pc_loader = pc_loader
        self.transform = transform
        self.set_transform = set_transform
        self.coordinates = coordinates
        self._coord = CylindricalCoordinates() \
            if coordinates == "cylindrical" else None

    def __len__(self):
        return len(self.queries)

    def load_cloud(self, ndx: int, rng: np.random.Generator) -> np.ndarray:
        path = os.path.join(self.dataset_path,
                            self.queries[ndx].rel_scan_filepath)
        pc = self.pc_loader(path).astype(np.float32)
        if self.transform is not None:
            pc = self.transform(pc, rng)
        return pc

    def finalize_cloud(self, pc: np.ndarray) -> np.ndarray:
        pc = clip_to_unit_box(pc, self.coordinates == "cylindrical")
        if self._coord is not None:
            pc = self._coord(pc)
        return pc

    def make_batch(self, labels: List[int], num_points: int,
                   rng, local_rows: Optional[np.ndarray] = None):
        """Assemble a batch (or, multi-host, one host's shard of it).

        With ``local_rows`` (global row indices) only those rows of the
        global batch are loaded, in that order; the (B, B)
        positive/negative masks are computed from the full global label
        list and row-selected, so the shards stitched together reproduce
        exactly the single-host batch.

        ``rng`` is either a Generator (single-host convenience) or a
        seed-sequence tuple; with a tuple every random draw is keyed by
        (root, batch-position) so the batch content is IDENTICAL for
        any process_count. In particular the batch-level set_transform
        (one rigid rotation per GLOBAL batch) draws the same
        rotation on every host, and each cloud's augmentations are
        keyed by its global row, not by which host loads it.
        """
        if isinstance(rng, np.random.Generator):
            root: Tuple[int, ...] = tuple(
                int(x) for x in rng.integers(0, 2**31 - 1, 2))
        else:
            root = tuple(int(x) for x in rng)
        rows = (np.arange(len(labels)) if local_rows is None
                else np.asarray(local_rows))
        clouds = [
            self.load_cloud(labels[i], np.random.default_rng((*root, 2, i)))
            for i in rows.tolist()]
        if self.set_transform is not None:
            # same batch-level transform draw for all clouds AND all
            # hosts: keyed by (root, 1), independent of the local shard
            merged = np.concatenate(clouds, axis=0)
            merged = self.set_transform(
                merged, np.random.default_rng((*root, 1)))
            sizes = np.cumsum([len(c) for c in clouds])[:-1]
            clouds = np.split(merged, sizes, axis=0)
        clouds = [self.finalize_cloud(c) for c in clouds]
        # Per-cloud subsample keyed by global row (pack_clouds then has
        # nothing left to subsample, keeping packing deterministic).
        clouds = [
            c[np.random.default_rng((*root, 3, i)).choice(
                len(c), num_points, replace=False)]
            if len(c) > num_points else c
            for i, c in zip(rows.tolist(), clouds)]
        pts, msk = pack_clouds(clouds, num_points, rng=None)
        pos, neg = masks_for_batch(self.queries, labels)
        if local_rows is not None:
            pos, neg = pos[rows], neg[rows]
        return {"points": pts, "pmask": msk,
                "positives_mask": pos, "negatives_mask": neg}


# Process-pool worker state: the dataset is shipped once per worker via
# the pool initializer (not per task — the tuple dict can hold 10^4+
# entries).
_POOL_DS: Optional["TrainingDataset"] = None
_POOL_NP: int = 0


def _pool_init(dataset: "TrainingDataset", num_points: int) -> None:
    global _POOL_DS, _POOL_NP
    _POOL_DS = dataset
    _POOL_NP = num_points


def _pool_make(labels, root, rows):
    """Module-level worker entry (picklable) for the process pool."""
    return _POOL_DS.make_batch(labels, _POOL_NP, root, local_rows=rows)


class DataLoader:
    """Epoch iterator with a parallel batch-assembly pool + ordered
    prefetch, so host work overlaps device compute.

    ``num_workers`` > 1 assembles whole batches concurrently in a thread
    pool. Determinism is unaffected: every random draw is already keyed
    by (seed+epoch, batch_index, row) — see make_batch — so assembly
    order cannot change content, and results are yielded strictly in
    batch order. Threads (not processes) suffice because the hot work —
    file reads, float64→32 conversion, rotations/jitter, clip, pack —
    is numpy over whole clouds and releases the GIL.

    Data parallelism: pass ``process_index`` / ``process_count`` (the
    trainer passes its rank and world size) and ``micro_batches`` (the
    train step's accum_steps). Every rank must construct the SAME seeded
    sampler (identical global batch lists); each rank then loads only
    its rows of every batch in the train step's microbatch layout
    (``parallel.dist.local_rows``: its 1/process_count share of each of
    the micro_batches global microbatches, the order
    ``parallel.dist.all_gather_micro`` stitches back). The rule: with
    process_count > 1, a batch whose size is not a multiple of
    ``process_count * micro_batches`` is skipped (such as the sampler's
    ragged flush batch), so every rank holds the same number of rows of
    every microbatch.
    """

    def __init__(self, dataset: TrainingDataset, sampler: BatchSampler,
                 num_points: int, seed: int = 0, prefetch: int = 2,
                 process_index: int = 0, process_count: int = 1,
                 num_workers: int = 0, worker_mode: str = "thread",
                 micro_batches: int = 1):
        self.dataset = dataset
        self.sampler = sampler
        self.num_points = num_points
        self.seed = seed
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count
        self.micro_batches = max(int(micro_batches), 1)
        self.num_workers = num_workers
        self.worker_mode = worker_mode
        self.epoch = 0
        self._pool = None       # persistent across epochs (see _get_pool)

    def _local_rows(self, batch_len: int) -> Optional[np.ndarray]:
        if self.process_count == 1:
            return None
        return local_rows(batch_len, self.micro_batches, self.process_index,
                          self.process_count)

    def _epoch_batches(self):
        batches = self.sampler.generate_batches()
        if self.process_count > 1:
            group = self.process_count * self.micro_batches
            batches = [b for b in batches if len(b) % group == 0]
        return batches

    def _make(self, epoch: int, bi: int, labels) -> dict:
        # Seed root is (seed+epoch, batch_index) — identical on every
        # host AND independent of worker scheduling, so augmentation
        # draws depend on neither process_count nor num_workers.
        return self.dataset.make_batch(
            labels, self.num_points, (self.seed + epoch, bi),
            local_rows=self._local_rows(len(labels)))

    def __iter__(self) -> Iterator[dict]:
        batches = self._epoch_batches()
        epoch = self.epoch
        self.epoch += 1
        if self.num_workers > 1:
            yield from self._iter_pool(epoch, batches)
            return
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)
        stop = object()

        def worker():
            try:
                for bi, labels in enumerate(batches):
                    q.put(self._make(epoch, bi, labels))
            finally:
                q.put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item

    def _get_pool(self):
        """The worker pool, created lazily ONCE and reused across
        epochs: a spawned worker pays seconds of interpreter and import
        start-up, and an epoch may be only a handful of batches."""
        if self._pool is None:
            if self.worker_mode == "process":
                from concurrent.futures import ProcessPoolExecutor
                import multiprocessing as mp
                # 'spawn', not 'fork': forking a process that runs
                # threads (torch's, the loader's) can deadlock.
                # The dataset ships via initargs, so spawned workers
                # need no inherited state.
                self._pool = ProcessPoolExecutor(
                    self.num_workers, mp_context=mp.get_context("spawn"),
                    initializer=_pool_init,
                    initargs=(self.dataset, self.num_points))
                self._submit = functools.partial(self._pool.submit,
                                                 _pool_make)
            else:
                from concurrent.futures import ThreadPoolExecutor
                self._pool = ThreadPoolExecutor(self.num_workers)
                self._submit = functools.partial(self._pool.submit,
                                                 self._make)
        return self._pool

    def close(self) -> None:
        """Shut the persistent pool down (idempotent)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def __del__(self):  # best-effort cleanup
        try:
            self.close()
        except Exception:
            pass

    def _iter_pool(self, epoch: int, batches) -> Iterator[dict]:
        """Pool path: keep num_workers+prefetch batches in flight,
        yield strictly in order.

        worker_mode 'process' spawns workers (sidesteps the GIL-bound
        python share of augmentation);
        'thread' keeps everything in-process (zero-copy results, the
        default). Both produce identical batches (seeding is
        order-independent)."""
        self._get_pool()
        window = self.num_workers + max(self.prefetch, 1)
        pending = {}
        nxt = 0
        for bi, labels in enumerate(batches):
            if self.worker_mode == "process":
                pending[bi] = self._submit(
                    labels, (self.seed + epoch, bi),
                    self._local_rows(len(labels)))
            else:
                pending[bi] = self._submit(epoch, bi, labels)
            while len(pending) >= window:
                yield pending.pop(nxt).result()
                nxt += 1
        while pending:
            yield pending.pop(nxt).result()
            nxt += 1

    def __len__(self):
        return len(self._epoch_batches())
