"""Objective functions on torch tensors.

The reference's ``ObjectiveFunction`` classes (``src/objective/*.hpp``,
factory ``objective_function.cpp:10-36``), as the JAX package's
``objectives.py:102-491`` writes them: ``init`` moves the labels (and
weights, and any tables) to the training device once, and
``get_gradients(score)`` maps the ``[K, N]`` score tensor to ``(grad,
hess)`` of the same shape on that device (K trees an iteration).
Formulas follow ``regression_objective.hpp`` (L2, L1, huber, fair,
poisson, with the Gaussian hessian of ``common.h:486-495``),
``binary_objective.hpp:13-157``, ``multiclass_objective.hpp``,
``xentropy_objective.hpp:39-268`` and ``rank_objective.hpp:19-245``;
LambdaRank's gradients are one kernel (``ops/lambdarank.py``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from .config import Config
from .data.metadata import Metadata
from .ops.lambdarank import (default_label_gain, lambdarank_grad,
                             lambdarank_schedule, lambdarank_tables,
                             plain_chunks)
from .utils import log

_GAUSS_C_MIN = 1.0e-10


class Objective:
    name = "base"
    boost_from_average = False

    def __init__(self, config: Config):
        self.config = config
        self.num_tree_per_iteration = 1
        self.labels: Optional[torch.Tensor] = None
        self.weights: Optional[torch.Tensor] = None
        self.num_data = 0

    def init(self, metadata: Metadata, num_data: int,
             device: torch.device) -> None:
        self.num_data = num_data
        self._label_host = np.asarray(metadata.label, np.float32)
        self.labels = torch.from_numpy(self._label_host).to(device)
        self._weight_host = (np.asarray(metadata.weight, np.float32)
                             if metadata.weight is not None else None)
        self.weights = (torch.from_numpy(self._weight_host).to(device)
                        if self._weight_host is not None else None)

    def get_gradients(self, score: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def convert_output(self, x):
        return x

    def average_stats(self) -> Tuple[float, float]:
        """(numerator, denominator) of the label average boost-from-average
        transforms (GlobalSyncUpByMean's two sums)."""
        return float(self._label_host.sum()), float(len(self._label_host))

    def init_from_average(self, avg: float) -> float:
        return float(avg)

    def to_string(self) -> str:
        return self.name

    def _w(self, g, h):
        if self.weights is None:
            return g, h
        return g * self.weights, h * self.weights


class RegressionL2(Objective):
    """regression_objective.hpp:11-76 (g = s - y, constant hessian)."""
    name = "regression"
    boost_from_average = True

    def get_gradients(self, score):
        g = score[0] - self.labels
        h = torch.ones_like(g)
        g, h = self._w(g, h)
        return g[None], h[None]


def _gaussian_hessian(score, label, grad, eta, weight):
    """Common::ApproximateHessianWithGaussian (common.h:486-495)."""
    x = torch.abs(score - label)
    a = 2.0 * torch.abs(grad) * weight
    c = torch.clamp((torch.abs(score) + torch.abs(label)) * eta,
                    min=_GAUSS_C_MIN)
    return (weight * torch.exp(-x * x / (2.0 * c * c)) * a
            / (c * math.sqrt(2 * math.pi)))


class RegressionL1(Objective):
    """regression_objective.hpp:78-156."""
    name = "regression_l1"
    boost_from_average = True

    def get_gradients(self, score):
        s = score[0]
        w = self.weights if self.weights is not None else torch.ones_like(s)
        g = torch.where(s > self.labels, 1.0, -1.0) * w
        h = _gaussian_hessian(s, self.labels, g, self.config.gaussian_eta, w)
        return g[None], h[None]


class RegressionHuber(Objective):
    """regression_objective.hpp:158-220: quadratic inside delta, L1 outside
    with the Gaussian hessian."""
    name = "huber"
    boost_from_average = True

    def get_gradients(self, score):
        s = score[0]
        delta = self.config.huber_delta
        w = self.weights if self.weights is not None else torch.ones_like(s)
        diff = s - self.labels
        inside = torch.abs(diff) <= delta
        g_out = torch.where(diff >= 0, delta, -delta) * w
        h_out = _gaussian_hessian(s, self.labels, g_out,
                                  self.config.gaussian_eta, w)
        g = torch.where(inside, diff * w, g_out)
        h = torch.where(inside, w, h_out)
        return g[None], h[None]


class RegressionFair(Objective):
    """regression_objective.hpp:233-293."""
    name = "fair"
    boost_from_average = True

    def get_gradients(self, score):
        c = self.config.fair_c
        x = score[0] - self.labels
        g = c * x / (torch.abs(x) + c)
        h = c * c / (torch.abs(x) + c) ** 2
        g, h = self._w(g, h)
        return g[None], h[None]


class RegressionPoisson(Objective):
    """regression_objective.hpp:298-358, v2.0.5's linear-score form:
    g = s - y, h = s + max_delta_step."""
    name = "poisson"
    boost_from_average = True

    def get_gradients(self, score):
        s = score[0]
        g = s - self.labels
        h = s + self.config.poisson_max_delta_step
        g, h = self._w(g, h)
        return g[None], h[None]


class BinaryLogloss(Objective):
    """binary_objective.hpp:13-157."""
    name = "binary"

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        label = self._label_host
        cnt_pos = int((label > 0).sum())
        cnt_neg = num_data - cnt_pos
        if cnt_pos == 0 or cnt_neg == 0:
            log.warning("Only one class present in label")
        log.info("Number of positive: %d, number of negative: %d",
                 cnt_pos, cnt_neg)
        lw = [1.0, 1.0]
        if self.config.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                lw[0] = cnt_pos / cnt_neg
            else:
                lw[1] = cnt_neg / cnt_pos
        lw[1] *= self.config.scale_pos_weight
        pos = self.labels > 0
        one = torch.ones_like(self.labels)
        self._label_sign = torch.where(pos, one, -one)
        self._label_weight = torch.where(pos, one * lw[1], one * lw[0])

    def get_gradients(self, score):
        sig = self.config.sigmoid
        ls = self._label_sign
        response = -ls * sig / (1.0 + torch.exp(ls * sig * score[0]))
        abs_r = torch.abs(response)
        g = response * self._label_weight
        h = abs_r * (sig - abs_r) * self._label_weight
        g, h = self._w(g, h)
        return g[None], h[None]

    def convert_output(self, x):
        return 1.0 / (1.0 + np.exp(-self.config.sigmoid * np.asarray(x)))

    def to_string(self):
        return f"binary sigmoid:{self.config.sigmoid:g}"

class MulticlassSoftmax(Objective):
    """multiclass_objective.hpp:16-136: K trees an iteration."""
    name = "multiclass"

    def __init__(self, config):
        super().__init__(config)
        self.num_tree_per_iteration = config.num_class

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        li = np.asarray(metadata.label, dtype=np.int32)
        if li.min() < 0 or li.max() >= self.config.num_class:
            log.fatal("Label must be in [0, %d)", self.config.num_class)
        self._onehot = torch.from_numpy(np.ascontiguousarray(
            np.eye(self.config.num_class, dtype=np.float32)[:, li])
        ).to(device)                                          # [K, N]

    def get_gradients(self, score):
        p = torch.softmax(score, dim=0)
        g = p - self._onehot
        h = 2.0 * p * (1.0 - p)
        if self.weights is not None:
            g = g * self.weights[None]
            h = h * self.weights[None]
        return g, h

    def convert_output(self, x):
        x = np.asarray(x, dtype=np.float64)
        e = np.exp(x - x.max(axis=0, keepdims=True))
        return e / e.sum(axis=0, keepdims=True)

    def to_string(self):
        return f"multiclass num_class:{self.config.num_class}"


class MulticlassOVA(Objective):
    """multiclass_objective.hpp:139-210: K binary classifiers."""
    name = "multiclassova"

    def __init__(self, config):
        super().__init__(config)
        self.num_tree_per_iteration = config.num_class

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        li = np.asarray(metadata.label, dtype=np.int32)
        self._sign = torch.from_numpy(np.ascontiguousarray(
            np.where(np.eye(self.config.num_class)[:, li] > 0, 1.0, -1.0),
            dtype=np.float32)).to(device)                     # [K, N]

    def get_gradients(self, score):
        sig = self.config.sigmoid
        response = -self._sign * sig / (1.0 + torch.exp(self._sign * sig
                                                        * score))
        abs_r = torch.abs(response)
        g = response
        h = abs_r * (sig - abs_r)
        if self.weights is not None:
            g = g * self.weights[None]
            h = h * self.weights[None]
        return g, h

    def convert_output(self, x):
        return 1.0 / (1.0 + np.exp(-self.config.sigmoid * np.asarray(x)))

    def to_string(self):
        return (f"multiclassova num_class:{self.config.num_class} "
                f"sigmoid:{self.config.sigmoid:g}")


class CrossEntropy(Objective):
    """xentropy_objective.hpp:39-137 (labels in [0, 1])."""
    name = "xentropy"
    boost_from_average = True

    def get_gradients(self, score):
        z = 1.0 / (1.0 + torch.exp(-score[0]))
        g = z - self.labels
        h = z * (1.0 - z)
        g, h = self._w(g, h)
        return g[None], h[None]

    def convert_output(self, x):
        return 1.0 / (1.0 + np.exp(-np.asarray(x)))

    def average_stats(self):
        label = self._label_host
        if self._weight_host is not None:
            return (float((label * self._weight_host).sum()),
                    float(self._weight_host.sum()))
        return float(label.sum()), float(len(label))

    def init_from_average(self, pavg):
        pavg = min(max(float(pavg), 1e-15), 1.0 - 1e-15)
        init = float(np.log(pavg / (1.0 - pavg)))
        log.info("[xentropy]: pavg=%f -> initscore=%f", pavg, init)
        return init


class CrossEntropyLambda(Objective):
    """xentropy_objective.hpp:139-268 ("xentlambda": intensity-weighted)."""
    name = "xentlambda"
    boost_from_average = True

    def get_gradients(self, score):
        s = score[0]
        y = self.labels
        if self.weights is None:
            z = 1.0 / (1.0 + torch.exp(-s))
            g = z - y
            h = z * (1.0 - z)
        else:
            w = self.weights
            epf = torch.exp(s)
            hhat = torch.log1p(epf)
            z = 1.0 - torch.exp(-w * hhat)
            enf = 1.0 / epf
            g = (1.0 - y / z) * w / (1.0 + enf)
            c = 1.0 / (1.0 - z)
            d = 1.0 + epf
            a = w * epf / (d * d)
            b = (c / (d * d)) * (1.0 + w * epf - c)
            h = a * (1.0 + y * b)
        return g[None], h[None]

    def convert_output(self, x):
        return np.log1p(np.exp(np.asarray(x)))

    average_stats = CrossEntropy.average_stats

    def init_from_average(self, havg):
        init = float(np.log(np.expm1(max(float(havg), 1e-15))))
        log.info("[xentlambda]: havg=%f -> initscore=%f", havg, init)
        return init


class LambdarankNDCG(Objective):
    """rank_objective.hpp:19-245, as ``lightgbm_tpu/objectives.py:353-463``
    computes it: the host builds each query's inverse max DCG, the gains
    and the discounts once, and on a card the kernel's schedule (labels
    grouped, work items); every iteration's gradients are one call of
    :func:`~.ops.lambdarank.lambdarank_grad` (the kernel on a card)."""
    name = "lambdarank"

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if metadata.query_boundaries is None:
            log.fatal("Lambdarank tasks require query information")
        bounds = np.asarray(metadata.query_boundaries)
        self.num_queries = len(bounds) - 1
        label = self._label_host
        gains = self.config.label_gain or default_label_gain()
        if int(label.max()) >= len(gains):
            log.fatal("Label %d exceeds label_gain size", int(label.max()))
        inv, gains, disc = lambdarank_tables(label, bounds, gains,
                                             self.config.max_position)
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        self._bounds = put(bounds.astype(np.int32))
        self._label_i32 = put(label.astype(np.int32))
        self._inv_max_dcg, self._gains, self._discount = (
            put(inv), put(gains), put(disc))
        self._max_len = len(disc)
        # the plain version's chunks on the CPU, the kernel's schedule on
        # a card
        cpu = device.type == "cpu"
        self._chunks = plain_chunks(bounds) if cpu else None
        self._schedule = (None if cpu else lambdarank_schedule(
            label, bounds, gains).to(device))

    def get_gradients(self, score):
        g, h = lambdarank_grad(
            score[0].contiguous(), self._label_i32, self._bounds,
            self._inv_max_dcg, self._gains, self._discount,
            self.config.sigmoid, self._max_len, self.weights, self._chunks,
            self._schedule)
        return g[None], h[None]


_REGISTRY = {
    "regression": RegressionL2,
    "regression_l2": RegressionL2,
    "mean_squared_error": RegressionL2,
    "mse": RegressionL2,
    "l2": RegressionL2,
    "regression_l1": RegressionL1,
    "l1": RegressionL1,
    "mean_absolute_error": RegressionL1,
    "mae": RegressionL1,
    "huber": RegressionHuber,
    "fair": RegressionFair,
    "poisson": RegressionPoisson,
    "binary": BinaryLogloss,
    "multiclass": MulticlassSoftmax,
    "softmax": MulticlassSoftmax,
    "multiclassova": MulticlassOVA,
    "multiclass_ova": MulticlassOVA,
    "ova": MulticlassOVA,
    "ovr": MulticlassOVA,
    "xentropy": CrossEntropy,
    "cross_entropy": CrossEntropy,
    "xentlambda": CrossEntropyLambda,
    "cross_entropy_lambda": CrossEntropyLambda,
    "lambdarank": LambdarankNDCG,
}


def create_objective(config: Config) -> Objective:
    """Factory (objective_function.cpp:10-36)."""
    name = config.objective.lower()
    if name not in _REGISTRY:
        log.fatal("Unknown objective type name: %s", name)
    return _REGISTRY[name](config)


def parse_objective_string(s: str, config: Config) -> Objective:
    """Parse a model-file objective line, e.g. 'binary sigmoid:1'."""
    toks = s.split()
    cfg = config.copy()
    cfg.objective = toks[0]
    for t in toks[1:]:
        if ":" in t:
            k, v = t.split(":", 1)
            if k == "sigmoid":
                cfg.sigmoid = float(v)
            elif k == "num_class":
                cfg.num_class = int(v)
    return create_objective(cfg)
