"""Evaluation metrics (host-side numpy, float64).

The reference metric factory (``src/metric/metric.cpp:11-47``) and
formulas (``regression_metric.hpp``, ``binary_metric.hpp``,
``multiclass_metric.hpp``, ``rank_metric.hpp``, ``map_metric.hpp``,
``xentropy_metric.hpp``, ``dcg_calculator.cpp``), as the JAX package's
``metrics.py:58-391`` writes them.  Metrics take raw ``[K, N]`` scores plus
the objective's ``convert_output``, as ``Metric::Eval(score, objective)``
does; the scores come to the host once per evaluation.  A metric returns
one value per name of :meth:`Metric.names` (NDCG@k and MAP@k one per
``ndcg_eval_at`` position).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .config import Config
from .data.metadata import Metadata
from .objectives import Objective
from .ops.lambdarank import default_label_gain
from .utils import log

K_EPSILON = 1e-15


class Metric:
    name = "base"
    is_higher_better = False  # factor -1 in reference means "minimize"

    def __init__(self, config: Config):
        self.config = config
        self.label: Optional[np.ndarray] = None
        self.weight: Optional[np.ndarray] = None
        self.metadata: Optional[Metadata] = None
        self.sum_weights = 0.0

    def init(self, metadata: Metadata, num_data: int) -> None:
        self.metadata = metadata
        self.label = np.asarray(metadata.label, dtype=np.float64)
        self.weight = (np.asarray(metadata.weight, dtype=np.float64)
                       if metadata.weight is not None else None)
        self.sum_weights = (float(self.weight.sum()) if self.weight is not None
                            else float(num_data))

    def names(self) -> List[str]:
        return [self.name]

    def eval(self, score: np.ndarray, objective: Optional[Objective]) -> List[float]:
        raise NotImplementedError

    def _avg(self, loss: np.ndarray) -> float:
        if self.weight is not None:
            return float((loss * self.weight).sum() / self.sum_weights)
        return float(loss.mean())


class _PointwiseRegressionMetric(Metric):
    """CRTP pattern of regression_metric.hpp:16-110."""

    def point_loss(self, label, score):
        raise NotImplementedError

    def average(self, v: float) -> float:
        return v

    def eval(self, score, objective):
        s = np.asarray(score[0], dtype=np.float64)
        if objective is not None and getattr(objective, "name", "") not in (
                "regression", "regression_l1", "huber", "fair", "poisson"):
            s = np.asarray(objective.convert_output(s), dtype=np.float64)
        return [self.average(self._avg(self.point_loss(self.label, s)))]


class L2Metric(_PointwiseRegressionMetric):
    name = "l2"

    def point_loss(self, label, score):
        return (score - label) ** 2


class RMSEMetric(_PointwiseRegressionMetric):
    name = "rmse"

    def point_loss(self, label, score):
        return (score - label) ** 2

    def average(self, v):
        return float(np.sqrt(v))


class L1Metric(_PointwiseRegressionMetric):
    name = "l1"

    def point_loss(self, label, score):
        return np.abs(score - label)


class HuberMetric(_PointwiseRegressionMetric):
    name = "huber"

    def point_loss(self, label, score):
        d = self.config.huber_delta
        diff = score - label
        return np.where(np.abs(diff) <= d, 0.5 * diff * diff,
                        d * (np.abs(diff) - 0.5 * d))


class FairMetric(_PointwiseRegressionMetric):
    name = "fair"

    def point_loss(self, label, score):
        c = self.config.fair_c
        x = np.abs(score - label)
        return c * x - c * c * np.log1p(x / c)


class PoissonMetric(_PointwiseRegressionMetric):
    name = "poisson"

    def point_loss(self, label, score):
        eps = 1e-10
        s = np.where(score < eps, eps, score)
        return s - label * np.log(s)


class BinaryLoglossMetric(Metric):
    name = "binary_logloss"

    def eval(self, score, objective):
        prob = np.asarray(objective.convert_output(score[0])
                          if objective is not None else score[0], dtype=np.float64)
        y = self.label > 0
        p = np.clip(np.where(y, prob, 1.0 - prob), K_EPSILON, None)
        return [self._avg(-np.log(p))]


class BinaryErrorMetric(Metric):
    name = "binary_error"

    def eval(self, score, objective):
        prob = np.asarray(objective.convert_output(score[0])
                          if objective is not None else score[0], dtype=np.float64)
        err = np.where(prob <= 0.5, self.label > 0, self.label <= 0)
        return [self._avg(err.astype(np.float64))]


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
            return [1.0]
        return [auc_sum / (total_pos * total_neg)]


class MultiLoglossMetric(Metric):
    name = "multi_logloss"

    def eval(self, score, objective):
        p = np.asarray(objective.convert_output(np.asarray(score, np.float64))
                       if objective is not None else score, dtype=np.float64)
        li = self.label.astype(np.int64)
        pt = np.clip(p[li, np.arange(p.shape[1])], K_EPSILON, None)
        return [self._avg(-np.log(pt))]


class MultiErrorMetric(Metric):
    name = "multi_error"

    def eval(self, score, objective):
        s = np.asarray(score, dtype=np.float64)
        pred = s.argmax(axis=0)
        err = (pred != self.label.astype(np.int64)).astype(np.float64)
        return [self._avg(err)]


class XentropyMetric(Metric):
    """xentropy_metric.hpp — cross entropy for labels in [0, 1]."""
    name = "xentropy"

    def eval(self, score, objective):
        p = np.clip(np.asarray(
            objective.convert_output(score[0]) if objective is not None
            else 1.0 / (1.0 + np.exp(-np.asarray(score[0]))), dtype=np.float64),
            K_EPSILON, 1 - K_EPSILON)
        y = self.label
        loss = -(y * np.log(p) + (1 - y) * np.log(1 - p))
        return [self._avg(loss)]


class XentLambdaMetric(Metric):
    """xentropy_metric.hpp — cross entropy with 'lambda' parameterization."""

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if self.weight is not None and np.asarray(self.weight).min() <= 0:
            log.fatal("[xentlambda]: (metric) all weights must be positive")
    name = "xentlambda"

    def eval(self, score, objective):
        # XentLambdaLoss (xentropy_metric.hpp:50-52): weights scale hhat
        # INSIDE the probability transform — prob = 1 - exp(-w * hhat)
        # with hhat = log1p(exp(s)) — and the final average is a PLAIN
        # mean over rows ("weights have a different meaning than for
        # xentropy", :160); log args clipped at 1e-12 like XentLoss
        s = np.asarray(score[0], dtype=np.float64)
        # during training hhat comes from the OBJECTIVE's ConvertOutput
        # (xentropy_metric.hpp:206-219 — even when the objective is not
        # xentlambda, the reference feeds its transform straight in);
        # standalone eval auto-converts via log1p(exp(s))
        if objective is not None:
            hhat = np.asarray(objective.convert_output(s), np.float64)
        else:
            hhat = np.log1p(np.exp(s))
        w = (np.asarray(self.weight, np.float64)
             if self.weight is not None else 1.0)
        z = 1.0 - np.exp(-w * hhat)
        y = self.label
        eps = 1.0e-12
        loss = -(y * np.log(np.maximum(z, eps))
                 + (1 - y) * np.log(np.maximum(1.0 - z, eps)))
        return [float(np.mean(loss))]


class KLDivMetric(Metric):
    """kldiv = xentropy minus label entropy."""
    name = "kldiv"

    def eval(self, score, objective):
        p = np.clip(1.0 / (1.0 + np.exp(-np.asarray(score[0], np.float64))),
                    K_EPSILON, 1 - K_EPSILON)
        y = np.clip(self.label, 0.0, 1.0)
        # YentLoss: x*log(x) = 0 at x in {0, 1} — mask before log
        ys = np.clip(y, K_EPSILON, 1 - K_EPSILON)
        ent = np.where((y > 0) & (y < 1),
                       y * np.log(ys) + (1 - y) * np.log(1 - ys), 0.0)
        loss = ent - (y * np.log(p) + (1 - y) * np.log(1 - p))
        return [self._avg(loss)]


class _RankMetric(Metric):
    def __init__(self, config):
        super().__init__(config)
        self.eval_at = list(config.ndcg_eval_at)
        self.gains = np.asarray(config.label_gain or default_label_gain(),
                                dtype=np.float64)

    def names(self):
        return [f"{self.name}@{k}" for k in self.eval_at]

    def _query_weights(self) -> Tuple[np.ndarray, np.ndarray]:
        bounds = np.asarray(self.metadata.query_boundaries)
        nq = len(bounds) - 1
        if self.weight is not None:
            qw = np.asarray([self.weight[bounds[q]:bounds[q + 1]].mean()
                             for q in range(nq)])
        else:
            qw = np.ones(nq)
        return bounds, qw


class NDCGMetric(_RankMetric):
    """rank_metric.hpp:16-170 + dcg_calculator.cpp."""
    name = "ndcg"
    is_higher_better = True

    def eval(self, score, objective):
        s = np.asarray(score[0], dtype=np.float64)
        bounds, qw = self._query_weights()
        nq = len(bounds) - 1
        results = np.zeros(len(self.eval_at), dtype=np.float64)
        for q in range(nq):
            ls = self.label[bounds[q]:bounds[q + 1]].astype(np.int64)
            ss = s[bounds[q]:bounds[q + 1]]
            order = np.argsort(-ss, kind="mergesort")
            sorted_gain = self.gains[ls[order]]
            ideal_gain = -np.sort(-self.gains[ls])
            disc = 1.0 / np.log2(np.arange(len(ls)) + 2.0)
            for ki, k in enumerate(self.eval_at):
                kk = min(k, len(ls))
                max_dcg = float((ideal_gain[:kk] * disc[:kk]).sum())
                if max_dcg <= 0.0:
                    results[ki] += qw[q]  # all-zero-relevance query counts as 1
                else:
                    dcg = float((sorted_gain[:kk] * disc[:kk]).sum())
                    results[ki] += qw[q] * dcg / max_dcg
        return list(results / qw.sum())


class MapMetric(_RankMetric):
    """map_metric.hpp — mean average precision at k (binary relevance)."""
    name = "map"
    is_higher_better = True

    def eval(self, score, objective):
        s = np.asarray(score[0], dtype=np.float64)
        bounds, qw = self._query_weights()
        nq = len(bounds) - 1
        results = np.zeros(len(self.eval_at), dtype=np.float64)
        for q in range(nq):
            # binary relevance at label > 0.5 (map_metric.hpp:63)
            ls = (self.label[bounds[q]:bounds[q + 1]] > 0.5).astype(np.float64)
            ss = s[bounds[q]:bounds[q + 1]]
            npos = int(ls.sum())          # positives in the WHOLE query
            order = np.argsort(-ss, kind="mergesort")
            rel = ls[order]
            hits = np.cumsum(rel)
            prec = hits / (np.arange(len(rel)) + 1.0)
            for ki, k in enumerate(self.eval_at):
                kk = min(k, len(rel))
                if npos > 0:
                    # CalMapAtK: sum of precisions at hit positions within
                    # top-k, normalized by min(total positives, k) — NOT by
                    # the hits inside the window
                    ap = float((prec[:kk] * rel[:kk]).sum())
                    results[ki] += qw[q] * ap / min(npos, kk)
                else:
                    results[ki] += qw[q]   # no-positive query counts as 1
        return list(results / qw.sum())


_REGISTRY = {
    "l2": L2Metric, "mean_squared_error": L2Metric, "mse": L2Metric,
    "regression": L2Metric, "regression_l2": L2Metric,
    "rmse": RMSEMetric, "root_mean_squared_error": RMSEMetric, "l2_root": RMSEMetric,
    "l1": L1Metric, "mean_absolute_error": L1Metric, "mae": L1Metric,
    "regression_l1": L1Metric,
    "huber": HuberMetric,
    "fair": FairMetric,
    "poisson": PoissonMetric,
    "binary_logloss": BinaryLoglossMetric, "binary": BinaryLoglossMetric,
    "binary_error": BinaryErrorMetric,
    "auc": AUCMetric,
    "ndcg": NDCGMetric, "lambdarank": NDCGMetric,
    "map": MapMetric, "mean_average_precision": MapMetric,
    "multi_logloss": MultiLoglossMetric, "multiclass": MultiLoglossMetric,
    "softmax": MultiLoglossMetric, "multiclassova": MultiLoglossMetric,
    "multi_error": MultiErrorMetric,
    "xentropy": XentropyMetric, "cross_entropy": XentropyMetric,
    "xentlambda": XentLambdaMetric, "cross_entropy_lambda": XentLambdaMetric,
    "kldiv": KLDivMetric, "kullback_leibler": KLDivMetric,
}


def create_metric(name: str, config: Config) -> Optional[Metric]:
    """Factory (metric.cpp:11-47); returns None for 'None'/'' style names."""
    n = name.lower().strip()
    if n in ("", "none", "null", "na"):
        return None
    if n not in _REGISTRY:
        log.fatal("Unknown metric type name: %s", name)
    return _REGISTRY[n](config)


def default_metric_for_objective(objective: str) -> str:
    """config.cpp behavior: empty metric defaults to the objective's own."""
    mapping = {
        "regression": "l2", "regression_l2": "l2", "mse": "l2", "l2": "l2",
        "regression_l1": "l1", "l1": "l1", "mae": "l1",
        "huber": "huber", "fair": "fair", "poisson": "poisson",
        "binary": "binary_logloss",
        "multiclass": "multi_logloss", "softmax": "multi_logloss",
        "multiclassova": "multi_logloss", "ova": "multi_logloss",
        "lambdarank": "ndcg",
        "xentropy": "xentropy", "cross_entropy": "xentropy",
        "xentlambda": "xentlambda", "cross_entropy_lambda": "xentlambda",
    }
    return mapping.get(objective.lower(), "l2")
