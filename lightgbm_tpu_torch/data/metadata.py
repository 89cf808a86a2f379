"""Per-dataset metadata: labels, weights, query boundaries, init scores.

The reference ``Metadata`` (``include/LightGBM/dataset.h:36-248``,
``src/io/metadata.cpp``) as the JAX package's ``data/metadata.py`` keeps
it: from arrays, or from the ``.weight``, ``.query`` and ``.init`` side
files beside a data file.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..utils import log


class Metadata:
    def __init__(self, num_data: int = 0):
        self.num_data = num_data
        self.label: Optional[np.ndarray] = None        # [N] f32
        self.weight: Optional[np.ndarray] = None       # [N] f32 or None
        self.query_boundaries: Optional[np.ndarray] = None  # [Q + 1] i32
        self.init_score: Optional[np.ndarray] = None   # [N * K] f64 or None

    def set_label(self, label: np.ndarray) -> None:
        label = np.asarray(label, dtype=np.float32).ravel()
        if self.num_data and len(label) != self.num_data:
            log.fatal("Length of label (%d) != num_data (%d)", len(label), self.num_data)
        self.num_data = len(label)
        self.label = label

    def set_weight(self, weight: Optional[np.ndarray]) -> None:
        if weight is None:
            self.weight = None
            return
        weight = np.asarray(weight, dtype=np.float32).ravel()
        if self.num_data and len(weight) != self.num_data:
            log.fatal("Length of weight (%d) != num_data (%d)", len(weight), self.num_data)
        self.weight = weight

    def set_query(self, group: Optional[np.ndarray]) -> None:
        """``group`` holds each query's size (the Python API's convention);
        stored as boundaries, their sum checked against the rows."""
        if group is None:
            self.query_boundaries = None
            return
        group = np.asarray(group, dtype=np.int64).ravel()
        bounds = np.concatenate([[0], np.cumsum(group)]).astype(np.int32)
        if self.num_data and bounds[-1] != self.num_data:
            log.fatal("Sum of query counts (%d) != num_data (%d)",
                      int(bounds[-1]), self.num_data)
        self.query_boundaries = bounds

    def set_init_score(self, init_score: Optional[np.ndarray]) -> None:
        """``[N * num_class]`` raw scores, class-major, as float64."""
        if init_score is None:
            self.init_score = None
            return
        self.init_score = np.asarray(init_score, dtype=np.float64).ravel()

    @property
    def num_queries(self) -> int:
        return (0 if self.query_boundaries is None
                else len(self.query_boundaries) - 1)

    def query_ids(self) -> Optional[np.ndarray]:
        """Each row's query index ``[N]`` int32."""
        if self.query_boundaries is None:
            return None
        sizes = np.diff(self.query_boundaries)
        return np.repeat(np.arange(len(sizes), dtype=np.int32), sizes)

    def load_side_files(self, data_path: str) -> None:
        """The side files of ``data_path`` that exist: ``<data>.weight``,
        ``<data>.query`` (each query's size) and ``<data>.init``
        (metadata.cpp LoadWeights, LoadQueryBoundaries,
        LoadInitialScore)."""
        wpath = data_path + ".weight"
        if os.path.exists(wpath):
            self.set_weight(np.loadtxt(wpath, dtype=np.float64).ravel())
            log.info("Loading weights from %s", wpath)
        qpath = data_path + ".query"
        if os.path.exists(qpath):
            self.set_query(np.loadtxt(qpath, dtype=np.int64).ravel())
            log.info("Loading query boundaries from %s", qpath)
        ipath = data_path + ".init"
        if os.path.exists(ipath):
            self.set_init_score(np.loadtxt(ipath, dtype=np.float64).ravel())
            log.info("Loading initial scores from %s", ipath)
