"""Host-side data layer: binning, metadata, dataset construction."""
from .dataset import TrainingData, construct

__all__ = ["TrainingData", "construct"]
