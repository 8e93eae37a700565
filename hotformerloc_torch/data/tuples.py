"""Training/evaluation tuple records, pickle-compatible with the
published datasets and with the JAX package's tools.

Dataset pickles hold ``datasets.base_datasets.TrainingTuple`` instances
(the original PyTorch code's module) or, when the JAX package's tools
wrote them, ``hotformerloc_tpu.data.tuples`` ones. ``load_pickle_compat``
maps both onto the classes below, so neither module is imported.
"""
from __future__ import annotations

import io
import os
import pickle
from typing import Dict, List

import numpy as np


class TrainingTuple:
    """One training query: id, timestamp, relative scan path, sorted
    positive ids, sorted non-negative ids, (2,) position (northing,
    easting)."""

    def __init__(self, id: int, timestamp: int, rel_scan_filepath: str,
                 positives: np.ndarray, non_negatives: np.ndarray,
                 position: np.ndarray):
        assert position.shape == (2,)
        self.id = id
        self.timestamp = timestamp
        self.rel_scan_filepath = rel_scan_filepath
        self.positives = positives
        self.non_negatives = non_negatives
        self.position = position


class EvaluationTuple:
    def __init__(self, timestamp: int, rel_scan_filepath: str,
                 position: np.ndarray):
        assert position.shape == (2,)
        self.timestamp = timestamp
        self.rel_scan_filepath = rel_scan_filepath
        self.position = position

    def to_tuple(self):
        return self.timestamp, self.rel_scan_filepath, self.position


class EvaluationSet:
    """Map + query evaluation split."""

    def __init__(self, query_set: List[EvaluationTuple] = None,
                 map_set: List[EvaluationTuple] = None):
        self.query_set = query_set
        self.map_set = map_set

    def save(self, path: str):
        pickle.dump([[e.to_tuple() for e in self.query_set],
                     [e.to_tuple() for e in self.map_set]],
                    open(path, "wb"))

    def load(self, path: str):
        query_l, map_l = load_pickle_compat(path)
        self.query_set = [EvaluationTuple(*e) for e in query_l]
        self.map_set = [EvaluationTuple(*e) for e in map_l]
        return self

    def get_map_positions(self) -> np.ndarray:
        return np.stack([e.position for e in self.map_set]).astype(np.float32)

    def get_query_positions(self) -> np.ndarray:
        return np.stack([e.position for e in self.query_set]) \
            .astype(np.float32)


_CLASS_ALIASES = {
    (module, cls.__name__): cls
    for module in ("datasets.base_datasets", "hotformerloc_tpu.data.tuples")
    for cls in (TrainingTuple, EvaluationTuple, EvaluationSet)
}


class _CompatUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _CLASS_ALIASES:
            return _CLASS_ALIASES[(module, name)]
        if name in ("TrainingTuple", "EvaluationTuple", "EvaluationSet"):
            return _CLASS_ALIASES[("datasets.base_datasets", name)]
        return super().find_class(module, name)


def load_pickle_compat(path: str):
    """Unpickle with the class remapping above."""
    with open(path, "rb") as f:
        return _CompatUnpickler(f).load()


def load_training_queries(path: str) -> Dict[int, TrainingTuple]:
    assert os.path.exists(path), f"Cannot access query file: {path}"
    return load_pickle_compat(path)


def in_sorted_array(e: int, array: np.ndarray) -> bool:
    """Membership test in a sorted id array."""
    pos = np.searchsorted(array, e)
    return bool(pos < len(array) and array[pos] == e)
