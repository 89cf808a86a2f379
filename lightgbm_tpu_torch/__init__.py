"""PyTorch/CUDA port of lightgbm_tpu: GBDT training and prediction on an
NVIDIA GPU, with the histogram kernel written by hand for Hopper.

Entry points run on the CUDA device unless the caller asks for the CPU
(``device="cpu"``); without a card and without that request they raise.
The exports are the JAX package's (``lightgbm_tpu/__init__.py``).  The
scikit-learn estimators are imported at their first use
(``lightgbm_tpu_torch.LGBMRegressor``, ``from lightgbm_tpu_torch import
...``): scikit-learn brings scipy and pandas with it, which the package's
own import does not load.
"""
from .basic import Booster, Dataset
from .boosting import NonFiniteError
from .callback import (EarlyStopException, early_stopping, print_evaluation,
                       record_evaluation, reset_parameter)
from .config import Config
from .engine import CVBooster, cv, train
from .plotting import (create_tree_digraph, plot_contrib_summary,
                       plot_importance, plot_metric, plot_tree)

__version__ = "0.1.0"

_ESTIMATORS = ("LGBMModel", "LGBMClassifier", "LGBMRegressor", "LGBMRanker")

__all__ = ["Booster", "CVBooster", "Config", "Dataset", "EarlyStopException",
           "NonFiniteError", "create_tree_digraph", "cv",
           "early_stopping", "plot_contrib_summary", "plot_importance",
           "plot_metric", "plot_tree", "print_evaluation",
           "record_evaluation", "reset_parameter", "train", *_ESTIMATORS]


def __getattr__(name):
    if name in _ESTIMATORS:
        from . import sklearn
        return getattr(sklearn, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
