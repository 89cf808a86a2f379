"""Training entry point ``train`` (python-package engine.py:18-229, as
``lightgbm_tpu/engine.py:24``): continued training from ``init_model``, the
boosting loop with valid-set evaluation, ``evals_result`` recording and
early stopping over every value of every metric."""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from .basic import Booster, Dataset, _to_matrix
from .config import canonicalize_params
from .utils import log


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          early_stopping_rounds: Optional[int] = None,
          evals_result: Optional[Dict] = None,
          verbose_eval: bool = True,
          init_model: Optional[Union[str, Booster]] = None) -> Booster:
    """Train a booster; runs on the CUDA device unless ``params`` has
    ``device="cpu"``.  ``init_model`` (a ``Booster`` or a model file)
    continues training (``lightgbm_tpu/engine.py:145-157``): its raw
    predictions of the training rows are added to the training scores, its
    trees come first in the model and its iterations count as done."""
    params = canonicalize_params(params)
    if "num_iterations" in params:
        num_boost_round = int(params.pop("num_iterations"))
    if params.get("early_stopping_round"):
        early_stopping_rounds = int(params.pop("early_stopping_round"))
    booster = Booster(params=params, train_set=train_set)
    if init_model is not None:
        prev = (init_model if isinstance(init_model, Booster)
                else Booster(model_file=str(init_model), params=params))
        inner = booster.inner
        raw = prev.inner.predictor(inner.device).predict_raw(
            _to_matrix(train_set.data))
        inner.scores += torch.from_numpy(raw.astype(np.float32)).to(
            inner.device)
        inner.num_init_iteration = prev.inner.current_iteration()
        inner.models = list(prev.inner.models) + inner.models
        inner.boost_from_average_ = prev.inner.boost_from_average_

    valid_sets = valid_sets or []
    if isinstance(valid_sets, Dataset):
        valid_sets = [valid_sets]
    valid_names = valid_names or [f"valid_{i}" for i in range(len(valid_sets))]
    contains_train = False
    train_name = "training"
    for vs, name in zip(valid_sets, valid_names):
        if vs is train_set:
            contains_train, train_name = True, name
            continue
        booster.add_valid(vs, name)
    if evals_result is not None:
        evals_result.clear()

    best_score: List[float] = []
    best_iter: List[int] = []
    best_list: List = []
    for i in range(num_boost_round):
        finished = booster.update()
        results = []
        if valid_sets:
            if contains_train:
                results.extend((train_name, m, v, hib)
                               for (_, m, v, hib) in booster.eval_train())
            results.extend(booster.eval_valid())
        if verbose_eval and results:
            log.info("[%d]\t%s", i + 1, "\t".join(
                f"{n}'s {m}: {v:g}" for n, m, v, _ in results))
        if evals_result is not None:
            for name, metric, value, _ in results:
                evals_result.setdefault(name, {}).setdefault(
                    metric, []).append(value)
        if early_stopping_rounds and results:
            if not best_score:
                best_score = [float("-inf") if hib else float("inf")
                              for (_, _, _, hib) in results]
                best_iter = [0] * len(results)
                best_list = [None] * len(results)
            stop = None
            for k, (_, _, value, hib) in enumerate(results):
                if (value > best_score[k]) if hib else (value < best_score[k]):
                    best_score[k], best_iter[k], best_list[k] = value, i, results
                elif i - best_iter[k] >= early_stopping_rounds:
                    stop = k
                    break
            if stop is not None:
                log.info("Early stopping, best iteration is: [%d]",
                         best_iter[stop] + 1)
                booster.best_iteration = best_iter[stop] + 1
                for name, metric, value, _ in best_list[stop]:
                    booster.best_score.setdefault(name, {})[metric] = value
                break
        if finished:
            break
    return booster
