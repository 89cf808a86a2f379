"""Host-side CSR container: bounded-peak densification.

The port's own copy of ``lightgbm_tpu/data/sparse.py:26-115``.  The
device storage is dense binned columns (EFB re-compresses mutually
exclusive sparse columns at construction), but getting from a sparse
matrix to those bin columns must not materialize the full ``[nrow,
ncol]`` float64 matrix: an 8-byte-per-cell spike dwarfing both the
nnz-sized source and the 1-byte-per-cell destination.
:class:`CsrMatrix` keeps the copied CSR triplet on the host and densifies
one bounded row chunk at a time (:data:`CSR_CHUNK_BUDGET_BYTES`), so
dataset construction (``dataset.construct_csr`` bins each chunk straight
into the final bin matrix) and prediction peak at one chunk's worth of
dense float64, never the whole matrix.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

# dense working-set ceiling: one yielded chunk is at most this many bytes
# of float64
CSR_CHUNK_BUDGET_BYTES = 64 << 20


def csr_chunk_rows(ncol: int, budget_bytes: Optional[int] = None) -> int:
    """Rows per dense chunk so one chunk stays under the byte budget."""
    budget = CSR_CHUNK_BUDGET_BYTES if budget_bytes is None else budget_bytes
    return max(1, int(budget) // max(1, int(ncol) * 8))


class CsrMatrix:
    """Copied CSR triplet (``indptr``/``indices``/``data``) and shape.

    The buffers are copied on construction, so a caller may free its own
    at once.  ``np.asarray`` still works (a full densify, assembled chunk
    by chunk) for the consumers that need the whole matrix (``cv``,
    ``subset``, continued training); construction and prediction never
    call it."""

    def __init__(self, indptr, indices, data, ncol: int):
        self.indptr = np.array(indptr, dtype=np.int64, copy=True)
        self.indices = np.array(indices, dtype=np.int64, copy=True)
        self.data = np.array(data, dtype=np.float64, copy=True)
        if self.indptr.ndim != 1 or len(self.indptr) < 1:
            raise ValueError("CSR indptr must be a non-empty 1-D array")
        nnz = int(self.indptr[-1])
        if nnz != len(self.indices) or nnz != len(self.data):
            raise ValueError(
                f"CSR buffers disagree: indptr ends at {nnz}, "
                f"{len(self.indices)} indices / {len(self.data)} values")
        self.nrow = len(self.indptr) - 1
        self.ncol = int(ncol)
        self.shape: Tuple[int, int] = (self.nrow, self.ncol)

    @property
    def nnz(self) -> int:
        return len(self.data)

    @property
    def nbytes(self) -> int:
        """Host bytes the triplet holds."""
        return int(self.indptr.nbytes + self.indices.nbytes
                   + self.data.nbytes)

    def __len__(self) -> int:
        return self.nrow

    def rows(self, idx) -> np.ndarray:
        """Dense float64 ``[len(idx), ncol]`` of the selected rows, in the
        given order: CSR rows are O(nnz of the row) random access, so the
        bin mappers' sample needs no full densify."""
        idx = np.asarray(idx, dtype=np.int64)
        counts = self.indptr[idx + 1] - self.indptr[idx]
        out = np.zeros((len(idx), self.ncol), dtype=np.float64)
        total = int(counts.sum())
        if total:
            # element e of the gather = its row's start + its rank within
            # that row
            offs = np.concatenate(([0], np.cumsum(counts)[:-1]))
            take = (np.repeat(self.indptr[idx], counts)
                    + np.arange(total) - np.repeat(offs, counts))
            out[np.repeat(np.arange(len(idx)), counts),
                self.indices[take]] = self.data[take]
        return out

    def iter_dense_chunks(
            self, chunk_rows: Optional[int] = None,
    ) -> Iterator[Tuple[int, np.ndarray]]:
        """``(row0, dense_chunk)`` pairs covering every row once, each
        chunk at most ``chunk_rows`` (by default from the byte budget)
        rows of dense float64."""
        chunk = (csr_chunk_rows(self.ncol) if chunk_rows is None
                 else max(1, int(chunk_rows)))
        for r0 in range(0, self.nrow, chunk):
            r1 = min(self.nrow, r0 + chunk)
            lo = int(self.indptr[r0])
            hi = int(self.indptr[r1])
            block = np.zeros((r1 - r0, self.ncol), dtype=np.float64)
            row_of = np.repeat(np.arange(r1 - r0),
                               np.diff(self.indptr[r0:r1 + 1]))
            block[row_of, self.indices[lo:hi]] = self.data[lo:hi]
            yield r0, block

    def __array__(self, dtype=None, copy=None):
        """Full densify, assembled chunk by chunk."""
        out = np.zeros(self.shape, dtype=np.float64)
        for r0, block in self.iter_dense_chunks():
            out[r0:r0 + len(block)] = block
        if dtype is not None:
            out = out.astype(dtype, copy=False)
        return out
