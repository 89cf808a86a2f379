"""Training callbacks (python-package/lightgbm/callback.py:48-204, as
``lightgbm_tpu/callback.py`` writes them): a callback is called with a
:class:`CallbackEnv` after each iteration, or before it when it carries
``before_iteration``, in the order of its ``order``."""
from __future__ import annotations

import collections
from typing import Callable, Dict, List

from .utils import log


class EarlyStopException(Exception):
    def __init__(self, best_iteration: int, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


# the reference's CallbackEnv namedtuple
CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


def print_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    """Log the evaluation results every ``period`` iterations."""
    def _callback(env: CallbackEnv) -> None:
        if period > 0 and env.evaluation_result_list \
                and (env.iteration + 1) % period == 0:
            parts = []
            for item in env.evaluation_result_list:
                if len(item) == 4:
                    name, metric, value, _ = item
                    parts.append(f"{name}'s {metric}: {value:g}")
                else:
                    name, metric, value, _, stdv = item
                    parts.append(f"{name}'s {metric}: {value:g} + {stdv:g}")
            log.info("[%d]\t%s", env.iteration + 1, "\t".join(parts))
    _callback.order = 10
    return _callback


def record_evaluation(eval_result: Dict) -> Callable:
    """Record every evaluation result into ``eval_result[name][metric]``."""
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dictionary")
    eval_result.clear()

    def _callback(env: CallbackEnv) -> None:
        for item in env.evaluation_result_list:
            name, metric, value = item[0], item[1], item[2]
            eval_result.setdefault(name, collections.OrderedDict())
            eval_result[name].setdefault(metric, [])
            eval_result[name][metric].append(value)
    _callback.order = 20
    return _callback


def reset_parameter(**kwargs) -> Callable:
    """Reset parameters (``learning_rate``, ``bagging_fraction``, ...)
    before each iteration: a value is a list (one entry an iteration) or a
    function of the iteration."""

    def _callback(env: CallbackEnv) -> None:
        new_params = {}
        for key, value in kwargs.items():
            if isinstance(value, list):
                if len(value) != env.end_iteration - env.begin_iteration:
                    raise ValueError(f"Length of list {key} has to equal "
                                     "num_boost_round")
                new_params[key] = value[env.iteration - env.begin_iteration]
            elif callable(value):
                new_params[key] = value(env.iteration - env.begin_iteration)
            else:
                raise ValueError("Only list and callable values are supported "
                                 "as a parameter")
        if new_params:
            env.model.reset_parameter(new_params)
    _callback.before_iteration = True
    _callback.order = 10
    return _callback


def early_stopping(stopping_rounds: int, verbose: bool = True) -> Callable:
    """Stop when no metric improved for ``stopping_rounds`` iterations.  A
    NaN value never counts as an improvement (every comparison with NaN is
    false), so the best score stays the last finite one."""
    best_score: List[float] = []
    best_iter: List[int] = []
    best_score_list: List = []
    cmp_op: List[Callable] = []

    def _init(env: CallbackEnv) -> None:
        if not env.evaluation_result_list:
            raise ValueError("For early stopping, at least one dataset and "
                             "eval metric is required for evaluation")
        if verbose:
            log.info("Train until valid scores didn't improve in %d rounds.",
                     stopping_rounds)
        for item in env.evaluation_result_list:
            best_iter.append(0)
            best_score_list.append(None)
            if item[3]:  # higher is better
                best_score.append(float("-inf"))
                cmp_op.append(lambda x, y: x > y)
            else:
                best_score.append(float("inf"))
                cmp_op.append(lambda x, y: x < y)

    def _callback(env: CallbackEnv) -> None:
        if not cmp_op:
            _init(env)
        for i, item in enumerate(env.evaluation_result_list):
            score = item[2]
            if cmp_op[i](score, best_score[i]):
                best_score[i] = score
                best_iter[i] = env.iteration
                best_score_list[i] = env.evaluation_result_list
            elif env.iteration - best_iter[i] >= stopping_rounds:
                if verbose:
                    log.info("Early stopping, best iteration is: [%d]",
                             best_iter[i] + 1)
                raise EarlyStopException(best_iter[i], best_score_list[i])
    _callback.order = 30
    return _callback
