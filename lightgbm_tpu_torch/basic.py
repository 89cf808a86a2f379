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
from .boosting import GBDT, create_boosting
from .config import (Config, _parse_value, _unsupported, canonicalize_params,
                     config_from_params, resolve_device)
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

    # -- fields (lightgbm_tpu/basic.py:394-460) ------------------------------

    def _meta(self):
        return None if self.constructed is None else self.constructed.metadata

    def set_label(self, label) -> "Dataset":
        self.label = label
        if self._meta() is not None:
            self._meta().set_label(np.asarray(label))
        return self

    def set_weight(self, weight) -> "Dataset":
        self.weight = weight
        if self._meta() is not None:
            self._meta().set_weight(None if weight is None
                                    else np.asarray(weight))
        return self

    def set_group(self, group) -> "Dataset":
        self.group = group
        if self._meta() is not None:
            self._meta().set_query(None if group is None
                                   else np.asarray(group))
        return self

    def set_init_score(self, init_score) -> "Dataset":
        self.init_score = init_score
        if self._meta() is not None:
            self._meta().set_init_score(None if init_score is None
                                        else np.asarray(init_score))
        return self

    def _constructed_meta(self):
        if self.constructed is None:
            self.construct()
        return self.constructed.metadata

    def get_label(self):
        label = self._constructed_meta().label
        return None if label is None else np.asarray(label)

    def get_weight(self):
        return self._constructed_meta().weight

    def get_group(self):
        qb = self._constructed_meta().query_boundaries
        return None if qb is None else np.diff(qb)

    def get_init_score(self):
        return self._constructed_meta().init_score

    def set_field(self, field_name: str, data) -> "Dataset":
        setters = {"label": self.set_label, "weight": self.set_weight,
                   "group": self.set_group, "query": self.set_group,
                   "init_score": self.set_init_score}
        if field_name not in setters:
            raise ValueError(f"Unknown field {field_name!r}")
        return setters[field_name](data)

    def get_field(self, field_name: str):
        getters = {"label": self.get_label, "weight": self.get_weight,
                   "group": self.get_group, "query": self.get_group,
                   "init_score": self.get_init_score}
        if field_name not in getters:
            raise ValueError(f"Unknown field {field_name!r}")
        return getters[field_name]()

    def num_data(self) -> int:
        if self.constructed is None:
            self.construct()
        return self.constructed.num_data

    def num_feature(self) -> int:
        if self.constructed is None:
            self.construct()
        return self.constructed.num_total_features

    def subset(self, used_indices, params=None) -> "Dataset":
        """Rows ``used_indices`` as a Dataset binned with this dataset's
        mappers (lightgbm_tpu/basic.py:518): labels, weights and init
        scores follow their rows, and with query groups each query keeps
        its selected rows, the queries left empty dropped."""
        if self.constructed is None:
            self.construct()
        raw = _to_matrix(self.data)
        idx = np.asarray(used_indices, dtype=np.int64)
        label, w = self.get_label(), self.get_weight()
        init, group = self.get_init_score(), self.get_group()
        sub_group = None
        if group is not None:
            qid = np.repeat(np.arange(len(group)), group.astype(np.int64))
            counts = np.bincount(qid[idx], minlength=len(group))
            sub_group = counts[counts > 0]
        return Dataset(raw[idx],
                       label=None if label is None else label[idx],
                       weight=None if w is None else np.asarray(w)[idx],
                       group=sub_group,
                       init_score=(None if init is None
                                   else np.asarray(init)[idx]),
                       reference=self, params=dict(params or self.params))


class Booster:
    """Training/prediction handle (basic.py:1213+ semantics, as
    ``lightgbm_tpu/basic.py:671-946``)."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None):
        self.params = dict(params or {})
        self.best_iteration = -1
        self.best_score: Dict = {}
        self._train_dataset = train_set
        self._valid_datasets: List[Dataset] = []
        self._train_data_name = "training"
        self._attr: Dict[str, str] = {}
        cfg = config_from_params(self.params)
        self.device = resolve_device(cfg.device)
        log.set_verbosity(cfg.verbose)
        if train_set is not None:
            train_set.construct(cfg, str(self.device))
            self.inner = create_boosting(cfg, train_set.constructed,
                                         create_objective(cfg),
                                         train_set.bins)
        elif model_file is not None:
            with open(model_file) as f:
                self.inner = GBDT.load_from_string(f.read(), cfg)
        elif model_str is not None:
            self.inner = GBDT.load_from_string(model_str, cfg)
        else:
            raise ValueError("Booster needs train_set, model_file or model_str")
        self._predictor = None
        self._predictor_key = None

    # -- training ------------------------------------------------------------

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        data.construct(self.inner.config, str(self.device))
        self.inner.add_valid_set(
            data.constructed, data.bins, name,
            _to_matrix(data.data) if self.inner.models else None)
        self._valid_datasets.append(data)
        return self

    def update(self, train_set: Optional[Dataset] = None, fobj=None) -> bool:
        """One boosting iteration; True when training should stop.  A
        custom objective ``fobj(preds, train_data) -> (grad, hess)`` gets
        the raw training scores as float64 (``[N]``, or ``K * N`` class
        by class) and returns ``K * N`` gradients and hessians."""
        if fobj is None:
            return self.inner.train_one_iter()
        scores = self.inner.scores.double().cpu().numpy()
        preds = scores.reshape(-1) if scores.shape[0] > 1 else scores[0]
        grad, hess = fobj(preds, self._train_dataset)
        return self.inner.train_one_iter(np.asarray(grad), np.asarray(hess))

    def rollback_one_iter(self) -> "Booster":
        self.inner.rollback_one_iter()
        return self

    def current_iteration(self) -> int:
        return self.inner.current_iteration()

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        """Change parameters between iterations (the ``reset_parameter``
        callback's way to schedule ``learning_rate`` or bagging)."""
        canon = canonicalize_params(params)
        for k, v in canon.items():
            setattr(self.inner.config, k, _parse_value(k, v))
        self.params.update(canon)
        return self

    def attr(self, key: str):
        """A free-form model attribute (reference Booster.attr)."""
        return self._attr.get(key)

    def set_attr(self, **kwargs) -> "Booster":
        for k, v in kwargs.items():
            if v is None:
                self._attr.pop(k, None)
            else:
                self._attr[k] = str(v)
        return self

    def set_train_data_name(self, name: str) -> "Booster":
        self._train_data_name = name
        return self

    def free_dataset(self) -> "Booster":
        """Release the training and valid data (bin matrices, scores,
        bags): predict, save and dump still work; training and evaluation
        do not."""
        self._train_dataset = None
        self._valid_datasets = []
        inner = self.inner
        inner.train_set = None
        inner.valid_sets = []
        inner.bins = None
        inner.scores = None
        inner._subset = None
        inner._score_stash = None
        return self

    # -- the model -----------------------------------------------------------

    def get_leaf_output(self, tree_id: int, leaf_id: int) -> float:
        """A leaf's raw output; ``tree_id`` counts the stored trees, the
        boost-from-average tree included (gbdt.cpp:467-483)."""
        return float(self.inner.models[tree_id].leaf_value[leaf_id])

    def set_leaf_output(self, tree_id: int, leaf_id: int,
                        value: float) -> "Booster":
        self.inner.models[tree_id].leaf_value[leaf_id] = float(value)
        self.inner.model_epoch += 1
        return self

    def merge(self, other: "Booster") -> "Booster":
        """LGBM_BoosterMerge: the other model's trees come first."""
        self.inner.merge_from(other.inner)
        return self

    def feature_importance(self, importance_type: str = "split",
                           iteration: int = -1) -> np.ndarray:
        return self.inner.feature_importance(importance_type, iteration)

    def feature_name(self) -> List[str]:
        return list(self.inner.feature_names)

    def num_trees(self) -> int:
        return len(self.inner.models)

    def num_feature(self) -> int:
        return self.inner.max_feature_idx + 1

    def dump_model(self, num_iteration: int = -1) -> Dict:
        """JSON model dump (gbdt.cpp DumpModel)."""
        inner = self.inner
        return {
            "name": "tree",
            "version": "v2",
            "num_class": inner.num_class,
            "num_tree_per_iteration": inner.num_class,
            "label_index": inner.label_idx,
            "max_feature_idx": inner.max_feature_idx,
            "objective": (inner.objective.to_string() if inner.objective
                          else ""),
            "average_output": inner.average_output,
            "feature_names": inner.feature_names,
            "tree_info": [t.to_json(i) for i, t in
                          enumerate(inner._kept_trees(num_iteration))],
        }

    # -- evaluation ----------------------------------------------------------

    def eval(self, data: Dataset, name: str, feval=None):
        """The current model's metrics (and ``feval``'s) on ``data``: a
        valid set already added, or a new one scored from scratch."""
        for ds, vs in zip(self._valid_datasets, self.inner.valid_sets):
            if ds is data:
                break
        else:
            self.add_valid(data, name)
            vs = self.inner.valid_sets[-1]
        res = [(name, m, v, h) for (_, m, v, h) in self.inner._eval(
            vs.name, vs.metrics, vs.scores.double().cpu().numpy())]
        return self._add_feval(res, name, feval, vs.scores, data)

    def eval_train(self, feval=None):
        return self._add_feval(self.inner.eval_train(), "training", feval,
                               self.inner.scores, self._train_dataset)

    def eval_valid(self, feval=None):
        res = self.inner.eval_valid()
        if feval is not None:
            for i, vs in enumerate(self.inner.valid_sets):
                ds = (self._valid_datasets[i]
                      if i < len(self._valid_datasets) else None)
                res = self._add_feval(res, vs.name, feval, vs.scores, ds)
        return res

    @staticmethod
    def _add_feval(res, name, feval, scores, dataset):
        """``feval(preds, data)`` -> ``(metric, value, higher_better)`` or a
        list of them, on the raw scores as float64 (``[N]``, or ``K * N``
        class by class)."""
        if feval is None:
            return res
        host = scores.double().cpu().numpy()
        preds = host.reshape(-1) if host.shape[0] > 1 else host[0]
        out = feval(preds, dataset)
        if isinstance(out, tuple):
            out = [out]
        return list(res) + [(name, metric, value, hib)
                            for metric, value, hib in out]

    # -- prediction and files ------------------------------------------------

    def predict(self, data, num_iteration: int = -1, raw_score: bool = False,
                device: Optional[str] = None) -> np.ndarray:
        """Raw or transformed scores of ``data`` ``[N, F]``, computed on
        ``device`` (default: this booster's): ``[N]``, or ``[N, K]`` for K
        classes."""
        dev = resolve_device(device) if device else self.device
        if num_iteration is None or num_iteration <= 0:
            num_iteration = (self.best_iteration if self.best_iteration > 0
                             else -1)
        key = (len(self.inner.models), self.inner.model_epoch, num_iteration,
               str(dev))
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

    # pickling goes through the model text
    def __getstate__(self):
        return {"params": self.params,
                "best_iteration": self.best_iteration,
                "best_score": self.best_score,
                "model_str": self.inner.save_model_to_string(-1)}

    def __setstate__(self, state):
        self.__init__(params=state["params"], model_str=state["model_str"])
        self.best_iteration = state["best_iteration"]
        self.best_score = state["best_score"]
