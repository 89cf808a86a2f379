"""scikit-learn estimator API over the port's booster
(``lightgbm_tpu/sklearn.py``).

The surface of the reference wrappers
(``python-package/lightgbm/sklearn.py:15-630``): the ``LGBMModel`` base and
``LGBMClassifier`` / ``LGBMRegressor`` / ``LGBMRanker``, the custom
objective and eval-metric adapters, ``fit(eval_set=...,
early_stopping_rounds=...)``, the ``feature_importances_`` /
``best_iteration_`` / ``evals_result_`` attributes, and
``get_params``/``set_params``/``clone``/pickle.  ``fit`` trains through
:func:`~.engine.train`, on the card unless ``device="cpu"`` is among the
estimator's parameters.  Without scikit-learn the module still imports:
its base classes are stand-ins whose ``get_params`` reads the
constructor's arguments, so ``LGBMRegressor`` and ``LGBMRanker`` run
(the JAX package's estimators all raise there), and ``LGBMClassifier``
raises at ``fit``, for want of the label encoder.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from .basic import Booster, Dataset, _to_matrix
from .engine import train

try:
    from sklearn.base import BaseEstimator, ClassifierMixin, RegressorMixin
    from sklearn.preprocessing import LabelEncoder
    _SKLEARN_INSTALLED = True
except ImportError:  # the card's machine has no scikit-learn
    _SKLEARN_INSTALLED = False

    class BaseEstimator:
        """Stand-in: ``get_params`` as scikit-learn's reads the
        constructor's named arguments, so that the regressor and the
        ranker run without scikit-learn."""

        def get_params(self, deep: bool = True) -> Dict[str, Any]:
            import inspect
            sig = inspect.signature(type(self).__init__)
            return {p.name: getattr(self, p.name)
                    for p in sig.parameters.values()
                    if p.name != "self" and p.kind not in (
                        p.VAR_POSITIONAL, p.VAR_KEYWORD)}

    class ClassifierMixin:
        pass

    class RegressorMixin:
        pass

    LabelEncoder = None


class LGBMError(Exception):
    pass


class _ObjectiveFunctionWrapper:
    """Adapt sklearn-style ``func(y_true, y_pred) -> (grad, hess)`` (or with
    the weights, and the groups, as third and fourth arguments) to the
    engine's ``fobj(preds, dataset)`` convention (sklearn.py:15-87)."""

    def __init__(self, func: Callable):
        import inspect
        self.func = func
        self.argc = len(inspect.signature(func).parameters)

    def __call__(self, preds: np.ndarray, dataset: Dataset):
        labels = dataset.get_label()
        argc = self.argc
        if argc == 2:
            grad, hess = self.func(labels, preds)
        elif argc == 3:
            grad, hess = self.func(labels, preds, dataset.get_weight())
        else:
            grad, hess = self.func(labels, preds, dataset.get_weight(),
                                   dataset.get_group())
        return np.asarray(grad, np.float64), np.asarray(hess, np.float64)


class _EvalFunctionWrapper:
    """Adapt ``func(y_true, y_pred) -> (name, value, is_higher_better)`` to
    the engine's ``feval(preds, dataset)`` convention (sklearn.py:90-150)."""

    def __init__(self, func: Callable):
        import inspect
        self.func = func
        self.argc = len(inspect.signature(func).parameters)

    def __call__(self, preds: np.ndarray, dataset: Dataset):
        labels = dataset.get_label() if dataset is not None else None
        argc = self.argc
        if argc == 2:
            return self.func(labels, preds)
        if argc == 3:
            return self.func(labels, preds, dataset.get_weight())
        return self.func(labels, preds, dataset.get_weight(),
                         dataset.get_group())


class LGBMModel(BaseEstimator):
    """Base estimator (sklearn.py:153-460 surface)."""

    def __init__(self, boosting_type: str = "gbdt", num_leaves: int = 31,
                 max_depth: int = -1, learning_rate: float = 0.1,
                 n_estimators: int = 100, max_bin: int = 255,
                 subsample_for_bin: int = 200000,
                 objective: Optional[Union[str, Callable]] = None,
                 min_split_gain: float = 0.0, min_child_weight: float = 1e-3,
                 min_child_samples: int = 20, subsample: float = 1.0,
                 subsample_freq: int = 0, colsample_bytree: float = 1.0,
                 reg_alpha: float = 0.0, reg_lambda: float = 0.0,
                 random_state: Optional[int] = None, n_jobs: int = -1,
                 silent: bool = True, **kwargs):
        self.boosting_type = boosting_type
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.max_bin = max_bin
        self.subsample_for_bin = subsample_for_bin
        self.objective = objective
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.silent = silent
        self._other_params: Dict[str, Any] = dict(kwargs)
        for k, v in kwargs.items():
            setattr(self, k, v)
        self._Booster: Optional[Booster] = None
        self._evals_result: Optional[Dict] = None
        self._best_iteration = -1
        self._n_features = -1
        self._classes = None
        self._n_classes = -1
        self._objective = objective
        self._fobj = None

    # -- sklearn plumbing ---------------------------------------------------

    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        params = super().get_params(deep=deep)
        params.update(self._other_params)
        return params

    def set_params(self, **params) -> "LGBMModel":
        for k, v in params.items():
            setattr(self, k, v)
            if k not in self.__init__.__code__.co_varnames:
                self._other_params[k] = v
        return self

    # -- core fit -----------------------------------------------------------

    def _default_objective(self) -> str:
        return "regression"

    def _lgb_params(self) -> Dict[str, Any]:
        params = self.get_params()
        params.pop("silent", None)
        params.pop("n_estimators", None)
        self._fobj = None
        objective = params.pop("objective", None)
        if callable(objective):
            self._fobj = _ObjectiveFunctionWrapper(objective)
            objective = self._default_objective()
        elif objective is None:
            objective = self._default_objective()
        self._objective = objective
        rename = {  # sklearn name -> native name (alias table, config.h:353-483)
            "min_split_gain": "min_gain_to_split",
            "min_child_weight": "min_sum_hessian_in_leaf",
            "min_child_samples": "min_data_in_leaf",
            "subsample": "bagging_fraction",
            "subsample_freq": "bagging_freq",
            "colsample_bytree": "feature_fraction",
            "reg_alpha": "lambda_l1",
            "reg_lambda": "lambda_l2",
            "random_state": "seed",
            "subsample_for_bin": "bin_construct_sample_cnt",
        }
        out: Dict[str, Any] = {"objective": objective,
                               "boosting": params.pop("boosting_type", "gbdt"),
                               "verbose": -1 if self.silent else 1}
        for k, v in params.items():
            if v is None:
                continue
            out[rename.get(k, k)] = v
        out.pop("n_jobs", None)  # the port sets no thread count
        if out.get("seed") is None:
            out.pop("seed", None)
        return out

    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_init_score=None, eval_group=None,
            eval_metric: Optional[Union[str, Callable, List]] = None,
            early_stopping_rounds: Optional[int] = None,
            verbose: bool = False, feature_name: Union[str, List[str]] = "auto",
            categorical_feature: Union[str, List] = "auto",
            callbacks: Optional[List[Callable]] = None) -> "LGBMModel":
        """sklearn.py fit (:220-379 semantics)."""
        params = self._lgb_params()
        feval = None
        if eval_metric is not None:
            metrics = eval_metric if isinstance(eval_metric, list) \
                else [eval_metric]
            str_metrics = [m for m in metrics if isinstance(m, str)]
            fn_metrics = [m for m in metrics if callable(m)]
            if str_metrics:
                params["metric"] = str_metrics
            if fn_metrics:
                wrappers = [_EvalFunctionWrapper(f) for f in fn_metrics]

                def feval(preds, dataset):  # noqa: F811
                    out = []
                    for w in wrappers:
                        r = w(preds, dataset)
                        out.extend(r if isinstance(r, list) else [r])
                    return out

        X = _ensure_2d(X)
        self._n_features = X.shape[1]
        train_set = Dataset(X, label=np.asarray(y).reshape(-1),
                            weight=sample_weight, group=group,
                            init_score=init_score, params=params,
                            free_raw_data=False)

        valid_sets: List[Dataset] = []
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            for i, (vx, vy) in enumerate(eval_set):
                def _at(coll, idx):
                    return None if coll is None else (
                        coll.get(idx) if isinstance(coll, dict) else coll[idx])
                if vx is X and vy is y:
                    valid_sets.append(train_set)
                else:
                    valid_sets.append(train_set.create_valid(
                        _ensure_2d(vx), label=np.asarray(vy).reshape(-1),
                        weight=_at(eval_sample_weight, i),
                        group=_at(eval_group, i),
                        init_score=_at(eval_init_score, i)))

        evals_result: Dict = {}
        self._Booster = train(
            params, train_set, num_boost_round=self.n_estimators,
            valid_sets=valid_sets or None, valid_names=eval_names,
            fobj=self._fobj, feval=feval,
            early_stopping_rounds=early_stopping_rounds,
            evals_result=evals_result, verbose_eval=verbose,
            feature_name=feature_name,
            categorical_feature=categorical_feature, callbacks=callbacks)
        self._evals_result = evals_result or None
        self._best_iteration = self._Booster.best_iteration
        return self

    def predict(self, X, raw_score: bool = False, num_iteration: int = -1,
                pred_leaf: bool = False, **kwargs) -> np.ndarray:
        X = _ensure_2d(X)
        if self._n_features > 0 and X.shape[1] != self._n_features:
            raise ValueError(
                f"Number of features {X.shape[1]} does not match "
                f"training data {self._n_features}")
        return self.booster_.predict(X, raw_score=raw_score,
                                     num_iteration=num_iteration,
                                     pred_leaf=pred_leaf, **kwargs)

    # -- fitted attributes --------------------------------------------------

    @property
    def booster_(self) -> Booster:
        if self._Booster is None:
            raise LGBMError("No booster found. Need to call fit beforehand.")
        return self._Booster

    @property
    def best_iteration_(self) -> int:
        return self._best_iteration

    @property
    def best_iteration(self) -> int:
        """v2.0.5 sklearn attribute name (python-guide
        sklearn_example.py uses ``gbm.best_iteration``)."""
        return self._best_iteration

    @property
    def evals_result_(self) -> Optional[Dict]:
        return self._evals_result

    @property
    def feature_importances_(self) -> np.ndarray:
        return self.booster_.feature_importance()

    @property
    def n_features_(self) -> int:
        return self._n_features

    @property
    def objective_(self):
        return self._objective


class LGBMRegressor(LGBMModel, RegressorMixin):
    """sklearn.py:463-490 analogue."""

    def _default_objective(self) -> str:
        return "regression"


class LGBMClassifier(LGBMModel, ClassifierMixin):
    """sklearn.py:493-580 analogue: label encoding, binary/multiclass
    objective selection, ``predict_proba``."""

    def _default_objective(self) -> str:
        return "binary" if self._n_classes <= 2 else "multiclass"

    def fit(self, X, y, sample_weight=None, **kwargs):
        if LabelEncoder is None:
            raise LGBMError("LGBMClassifier needs scikit-learn (its "
                            "LabelEncoder)")
        self._le = LabelEncoder().fit(np.asarray(y).reshape(-1))
        self._classes = self._le.classes_
        self._n_classes = len(self._classes)
        y_enc = self._le.transform(np.asarray(y).reshape(-1))
        self._other_params.pop("num_class", None)
        if hasattr(self, "num_class"):
            del self.num_class
        if self._n_classes > 2 and not callable(self.objective):
            self._other_params["num_class"] = self._n_classes
            setattr(self, "num_class", self._n_classes)
        eval_set = kwargs.get("eval_set")
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            kwargs["eval_set"] = [
                (vx, self._le.transform(np.asarray(vy).reshape(-1)))
                for vx, vy in eval_set]
        super().fit(X, y_enc, sample_weight=sample_weight, **kwargs)
        return self

    def predict(self, X, raw_score: bool = False, num_iteration: int = -1,
                **kwargs):
        result = self.predict_proba(X, raw_score=raw_score,
                                    num_iteration=num_iteration, **kwargs)
        if raw_score or kwargs.get("pred_leaf") or kwargs.get("pred_contrib"):
            return result
        idx = np.argmax(result, axis=1) if result.ndim == 2 \
            else (result > 0.5).astype(np.int64)
        return self._classes[idx]

    def predict_proba(self, X, raw_score: bool = False,
                      num_iteration: int = -1, **kwargs) -> np.ndarray:
        result = super().predict(X, raw_score=raw_score,
                                 num_iteration=num_iteration, **kwargs)
        if raw_score or kwargs.get("pred_leaf") or kwargs.get("pred_contrib"):
            return result
        if result.ndim == 1:  # binary: P(y=1)
            return np.vstack([1.0 - result, result]).T
        return result

    @property
    def classes_(self):
        if self._classes is None:
            raise LGBMError("No classes found. Need to call fit beforehand.")
        return self._classes

    @property
    def n_classes_(self) -> int:
        return self._n_classes


class LGBMRanker(LGBMModel):
    """sklearn.py:583-630 analogue (lambdarank; ``group`` required)."""

    def _default_objective(self) -> str:
        return "lambdarank"

    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_group=None, **kwargs):
        if group is None:
            raise ValueError("Should set group for ranking task")
        eval_set = kwargs.get("eval_set")
        if eval_set is not None and eval_group is None:
            raise ValueError("Eval_group cannot be None when eval_set is not None")
        super().fit(X, y, sample_weight=sample_weight, init_score=init_score,
                    group=group, eval_group=eval_group, **kwargs)
        return self


def _ensure_2d(X) -> np.ndarray:
    return _to_matrix(X).astype(np.float64, copy=False)
