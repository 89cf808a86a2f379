"""Evaluation metrics of the slice (host-side numpy, float64).

The reference metric factory (``src/metric/metric.cpp:11-47``) restricted
to ``l2`` (``regression_metric.hpp``), ``binary_logloss`` and ``auc``
(``binary_metric.hpp``).  Metrics take raw ``[K, N]`` scores plus the
objective's ``convert_output``, as ``Metric::Eval(score, objective)``
does; the scores come to the host once per evaluation.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .config import Config, _unsupported
from .data.metadata import Metadata
from .objectives import Objective
from .utils import log

K_EPSILON = 1e-15


class Metric:
    name = "base"
    is_higher_better = False

    def __init__(self, config: Config):
        self.config = config
        self.label: Optional[np.ndarray] = None
        self.weight: Optional[np.ndarray] = None
        self.sum_weights = 0.0

    def init(self, metadata: Metadata, num_data: int) -> None:
        self.label = np.asarray(metadata.label, dtype=np.float64)
        self.weight = (np.asarray(metadata.weight, dtype=np.float64)
                       if metadata.weight is not None else None)
        self.sum_weights = (float(self.weight.sum()) if self.weight is not None
                            else float(num_data))

    def eval(self, score: np.ndarray, objective: Optional[Objective]) -> float:
        raise NotImplementedError

    def _avg(self, loss: np.ndarray) -> float:
        if self.weight is not None:
            return float((loss * self.weight).sum() / self.sum_weights)
        return float(loss.mean())


class L2Metric(Metric):
    """regression_metric.hpp L2: mean squared error of the raw score."""
    name = "l2"

    def eval(self, score, objective):
        s = np.asarray(score[0], dtype=np.float64)
        if objective is not None and objective.name != "regression":
            s = np.asarray(objective.convert_output(s), dtype=np.float64)
        return self._avg((s - self.label) ** 2)


class BinaryLoglossMetric(Metric):
    name = "binary_logloss"

    def eval(self, score, objective):
        prob = np.asarray(objective.convert_output(score[0])
                          if objective is not None else score[0],
                          dtype=np.float64)
        y = self.label > 0
        p = np.clip(np.where(y, prob, 1.0 - prob), K_EPSILON, None)
        return self._avg(-np.log(p))


class AUCMetric(Metric):
    """Weighted rank-sum AUC with tie handling (binary_metric.hpp:157-266),
    over groups of equal scores."""
    name = "auc"
    is_higher_better = True

    def eval(self, score, objective):
        s = np.asarray(score[0], dtype=np.float64)
        y = self.label > 0
        w = self.weight if self.weight is not None else np.ones_like(s)
        order = np.argsort(s, kind="mergesort")
        s_sorted = s[order]
        pos_w = np.where(y, w, 0.0)[order]
        neg_w = np.where(~y, w, 0.0)[order]
        # group equal scores: per-group positive/negative weight
        heads = np.concatenate([[0], np.nonzero(np.diff(s_sorted))[0] + 1])
        p_g = np.add.reduceat(pos_w, heads)
        n_g = np.add.reduceat(neg_w, heads)
        neg_before = np.concatenate([[0.0], np.cumsum(n_g)[:-1]])
        auc_sum = float(np.sum(p_g * (neg_before + 0.5 * n_g)))
        total_pos = pos_w.sum()
        total_neg = neg_w.sum()
        if total_pos <= 0 or total_neg <= 0:
            log.warning("AUC is undefined with a single class")
            return 1.0
        return auc_sum / (total_pos * total_neg)


_REGISTRY = {
    "l2": L2Metric, "mean_squared_error": L2Metric, "mse": L2Metric,
    "regression": L2Metric, "regression_l2": L2Metric,
    "binary_logloss": BinaryLoglossMetric, "binary": BinaryLoglossMetric,
    "auc": AUCMetric,
}


def create_metric(name: str, config: Config) -> Optional[Metric]:
    """Factory (metric.cpp:11-47); None for 'None'/'' style names."""
    n = name.lower().strip()
    if n in ("", "none", "null", "na"):
        return None
    if n not in _REGISTRY:
        _unsupported(f"metric {name}", "training breadth (other metrics)")
    return _REGISTRY[n](config)


def default_metric_for_objective(objective: str) -> str:
    """An empty metric list defaults to the objective's own (config.cpp)."""
    return "binary_logloss" if objective.lower() == "binary" else "l2"
