"""Host-side data layer: binning, metadata, dataset construction, text
files and CSR input."""
from .dataset import TrainingData, construct, construct_csr, construct_streamed
from .metadata import Metadata
from .sparse import CsrMatrix

__all__ = ["CsrMatrix", "Metadata", "TrainingData", "construct",
           "construct_csr", "construct_streamed"]
