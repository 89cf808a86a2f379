"""PyTorch/CUDA port of lightgbm_tpu: GBDT training and prediction on an
NVIDIA GPU, with the histogram kernel written by hand for Hopper.

Entry points run on the CUDA device unless the caller asks for the CPU
(``device="cpu"``); without a card and without that request they raise.
The exports are the JAX package's (``lightgbm_tpu/__init__.py``) but its
plotting and sklearn wrappers, which are not ported.
"""
from .basic import Booster, Dataset
from .boosting import NonFiniteError
from .callback import (EarlyStopException, early_stopping, print_evaluation,
                       record_evaluation, reset_parameter)
from .config import Config
from .engine import CVBooster, cv, train

__version__ = "0.1.0"

__all__ = ["Booster", "CVBooster", "Config", "Dataset", "EarlyStopException",
           "NonFiniteError", "cv",
           "early_stopping", "print_evaluation", "record_evaluation",
           "reset_parameter", "train"]
