"""User-facing ``Dataset`` and ``Booster`` (python-package basic.py
semantics, as in ``lightgbm_tpu/basic.py:76`` and :671).

Both run on the CUDA device unless the caller passes ``device="cpu"``
(as a keyword or in ``params``); with no card and no such request they
raise.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from . import data as data_mod
from .boosting import GBDT
from .config import (Config, _unsupported, config_from_params,
                     resolve_device)
from .objectives import create_objective
from .utils import log


def _to_matrix(data) -> np.ndarray:
    if isinstance(data, (str, bytes)) or hasattr(data, "columns"):
        _unsupported("file and pandas inputs",
                     "checkpoints, serving, observability, CLI, sklearn and "
                     "plotting")
    mat = np.asarray(data, dtype=np.float64)
    return mat.reshape(1, -1) if mat.ndim == 1 else mat


class Dataset:
    """Lazily-constructed dataset: binned on the host, then moved to the
    device once."""

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None,
                 feature_name: Union[str, List[str]] = "auto",
                 categorical_feature: Union[str, List] = "auto",
                 params: Optional[Dict[str, Any]] = None):
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group                # each query's size
        self.init_score = init_score      # [N * num_class] raw scores
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params or {})
        self.constructed: Optional[data_mod.TrainingData] = None
        self.bins: Optional[torch.Tensor] = None     # [N, F] uint8, on device

    def _categorical_indices(self, cfg: Config,
                             names: Optional[List[str]]) -> List[int]:
        """Column indices of the categorical features: this Dataset's
        ``categorical_feature`` (indices, or names of ``feature_name``),
        else the ``categorical_feature`` parameter (comma-separated)."""
        cats = self.categorical_feature
        if cats in ("auto", None):
            cats = [c for c in cfg.categorical_column.split(",") if c.strip()]
        out = []
        for c in cats:
            if isinstance(c, str) and not c.strip().lstrip("-").isdigit():
                if not names or c not in names:
                    raise ValueError(f"categorical feature {c!r} is not a "
                                     f"feature name")
                out.append(names.index(c))
            else:
                out.append(int(c))
        return out

    def construct(self, config: Optional[Config] = None,
                  device: Optional[str] = None) -> "Dataset":
        """Bin on the host (dataset.py:92 ``construct``) and move the bin
        matrix to ``device`` (default: ``params['device']``, else cuda)."""
        cfg = config or config_from_params(self.params)
        dev = resolve_device(device or cfg.device)
        if self.constructed is None:
            ref = (self.reference.construct(cfg, str(dev)).constructed
                   if self.reference is not None else None)
            names = (list(self.feature_name)
                     if isinstance(self.feature_name, (list, tuple)) else None)
            self.constructed = data_mod.construct(
                _to_matrix(self.data), cfg,
                label=(None if self.label is None
                       else np.asarray(self.label, np.float32).ravel()),
                weight=(None if self.weight is None
                        else np.asarray(self.weight)),
                group=None if self.group is None else np.asarray(self.group),
                init_score=(None if self.init_score is None
                            else np.asarray(self.init_score)),
                feature_names=names,
                categorical_features=self._categorical_indices(cfg, names),
                reference=ref)
        if self.bins is None or self.bins.device.type != dev.type:
            self.bins = torch.from_numpy(self.constructed.binned).to(dev)
        return self

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None) -> "Dataset":
        """A validation set binned with this dataset's mappers."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score,
                       params=params or self.params)


class Booster:
    """Training/prediction handle (basic.py:1213+ semantics)."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None):
        self.params = dict(params or {})
        self.best_iteration = -1
        self.best_score: Dict = {}
        cfg = config_from_params(self.params)
        self.device = resolve_device(cfg.device)
        log.set_verbosity(cfg.verbose)
        if train_set is not None:
            train_set.construct(cfg, str(self.device))
            self.inner = GBDT(cfg, train_set.constructed,
                              create_objective(cfg), train_set.bins)
        elif model_file is not None:
            with open(model_file) as f:
                self.inner = GBDT.load_from_string(f.read(), cfg)
        elif model_str is not None:
            self.inner = GBDT.load_from_string(model_str, cfg)
        else:
            raise ValueError("Booster needs train_set, model_file or model_str")
        self._predictor = None
        self._predictor_key = None

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        data.construct(self.inner.config, str(self.device))
        self.inner.add_valid_set(
            data.constructed, data.bins, name,
            _to_matrix(data.data) if self.inner.models else None)
        return self

    def update(self) -> bool:
        """One boosting iteration; True when training should stop."""
        return self.inner.train_one_iter()

    def eval_train(self):
        return self.inner.eval_train()

    def eval_valid(self):
        return self.inner.eval_valid()

    def predict(self, data, num_iteration: int = -1, raw_score: bool = False,
                device: Optional[str] = None) -> np.ndarray:
        """Raw or transformed scores of ``data`` ``[N, F]``, computed on
        ``device`` (default: this booster's): ``[N]``, or ``[N, K]`` for K
        classes."""
        dev = resolve_device(device) if device else self.device
        if num_iteration is None or num_iteration <= 0:
            num_iteration = (self.best_iteration if self.best_iteration > 0
                             else -1)
        key = (len(self.inner.models), num_iteration, str(dev))
        if self._predictor_key != key:
            self._predictor = self.inner.predictor(dev, num_iteration)
            self._predictor_key = key
        return self._predictor.predict(_to_matrix(data), raw_score=raw_score)

    def save_model(self, filename: str, num_iteration: int = -1) -> "Booster":
        with open(filename, "w") as f:
            f.write(self.model_to_string(num_iteration))
        return self

    def model_to_string(self, num_iteration: int = -1) -> str:
        if num_iteration is None or num_iteration <= 0:
            num_iteration = (self.best_iteration if self.best_iteration > 0
                             else -1)
        return self.inner.save_model_to_string(num_iteration)
