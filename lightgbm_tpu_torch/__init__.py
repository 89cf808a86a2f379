"""PyTorch/CUDA port of lightgbm_tpu: GBDT training and prediction on an
NVIDIA GPU, with the histogram kernel written by hand for Hopper.

Entry points run on the CUDA device unless the caller asks for the CPU
(``device="cpu"``); without a card and without that request they raise.
"""
from .basic import Booster, Dataset
from .engine import train

__all__ = ["Booster", "Dataset", "train"]
