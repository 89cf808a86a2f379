"""Objective functions on torch tensors: L2 regression and binary logloss.

The reference's ``ObjectiveFunction`` classes (``src/objective/*.hpp``,
factory ``objective_function.cpp:10-36``): ``init`` moves the labels (and
weights) to the training device once, ``get_gradients(score)`` maps the
``[K, N]`` score tensor to ``(grad, hess)`` of the same shape on that
device.  Formulas follow ``regression_objective.hpp:11-76`` and
``binary_objective.hpp:13-157``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .config import Config
from .data.metadata import Metadata
from .utils import log


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
        self.weights = (torch.from_numpy(np.asarray(metadata.weight,
                                                    np.float32)).to(device)
                        if metadata.weight is not None else None)

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


_REGISTRY = {
    "regression": RegressionL2,
    "regression_l2": RegressionL2,
    "mean_squared_error": RegressionL2,
    "mse": RegressionL2,
    "l2": RegressionL2,
    "binary": BinaryLogloss,
}


def create_objective(config: Config) -> Objective:
    """Factory (objective_function.cpp:10-36); config.check_params has
    already refused the objectives outside the slice."""
    return _REGISTRY[config.objective.lower()](config)


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
    if cfg.objective.lower() not in _REGISTRY:
        raise NotImplementedError(
            f"objective {cfg.objective} is not ported to lightgbm_tpu_torch "
            "yet (ROADMAP.md, port queue: training breadth)")
    return create_objective(cfg)
