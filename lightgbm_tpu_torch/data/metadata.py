"""Per-dataset metadata: labels and weights.

The label and weight part of the reference ``Metadata``
(``include/LightGBM/dataset.h:36-248``, ``src/io/metadata.cpp``), as the
JAX package's ``data/metadata.py`` keeps it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..utils import log


class Metadata:
    def __init__(self, num_data: int = 0):
        self.num_data = num_data
        self.label: Optional[np.ndarray] = None        # [N] f32
        self.weight: Optional[np.ndarray] = None       # [N] f32 or None

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
