"""Nibble bin packing, in the joint form of ``lightgbm_tpu/data/packing.py``.

Two physical columns a (lo) and b (hi) of at most 16 bins each share one
byte ``v = a | (b << 4)``.  The byte is the joint (a, b) bin over a 16 x 16
grid, so the histogram kernels read the packed **storage** matrix as they
read any bin matrix, at width ``max(256, B)``, and the two 16-bin
histograms fall out of the joint one by summing over each nibble
(:func:`unfold_packed_hist`).  A packed pair is one storage entry a row for
the histogram instead of two.  The storage matrix keeps the bin matrix's
type (``lightgbm_tpu/data/packing.py:pack_columns``): a pair's joint bin
lies below 256, but a uint16 matrix's wide columns pass through.

The packed matrix is a second device copy beside the unpacked one, read
only by the histogram; routing, the partition's payload and the binned
traversals keep reading the unpacked columns.  The plan is built over
physical columns, after EFB.  :class:`PackedBins` carries the matrix and
its plan together to the growers.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.histogram import widen

PACK_MAX_BIN = 16          # bins a nibble holds
PACK_JOINT_BINS = 256      # the joint (lo, hi) bins of a packed byte


class PackPlan(NamedTuple):
    """The packed layout (``lightgbm_tpu/data/packing.py:111-127``):
    physical column f lies in storage column ``byte_col[f]``, at bit
    ``shift[f]`` (0: the lo nibble, or a byte of its own; 4: the hi
    nibble), and ``is_packed[f]`` says whether it shares the byte.  The
    three arrays are numpy on the host, or tensors after :meth:`to`."""
    byte_col: object           # [Fp] int32
    shift: object              # [Fp] int32, 0 or 4
    is_packed: object          # [Fp] bool
    num_storage_cols: int
    num_phys_cols: int

    @property
    def num_packed(self) -> int:
        return int(self.is_packed.sum())

    def to(self, device) -> "PackPlan":
        """The plan with its arrays as tensors on ``device``, as the
        captured split steps read them."""
        put = lambda a: torch.as_tensor(a, device=device)
        return self._replace(byte_col=put(self.byte_col).long(),
                             shift=put(self.shift),
                             is_packed=put(self.is_packed))


def build_pack_plan(col_num_bins) -> Optional[PackPlan]:
    """Pairing plan over physical columns (``lightgbm_tpu/data/
    packing.py:130-178``): columns of at most 16 bins are packed two a
    byte in column order (an odd leftover keeps a byte of its own, in the
    lo nibble); wider columns come first and pass through.  None when
    packing would not pay: fewer than 2 narrow columns, or the joint
    histogram ``storage_cols * 256`` wider than the unpacked one
    ``phys_cols * max(bins)``."""
    nb = np.asarray(col_num_bins, dtype=np.int64)
    fp = len(nb)
    narrow = np.flatnonzero(nb <= PACK_MAX_BIN)
    if len(narrow) < 2:
        return None
    n_storage = (fp - len(narrow)) + (len(narrow) + 1) // 2
    if n_storage * PACK_JOINT_BINS > fp * int(nb.max()):
        return None
    wide = np.flatnonzero(nb > PACK_MAX_BIN)
    byte_col = np.zeros(fp, dtype=np.int32)
    shift = np.zeros(fp, dtype=np.int32)
    is_packed = np.zeros(fp, dtype=bool)
    c = 0
    for f in wide:
        byte_col[f] = c
        c += 1
    for i in range(0, len(narrow) - 1, 2):
        a, b = narrow[i], narrow[i + 1]
        byte_col[a] = byte_col[b] = c
        shift[b] = 4
        is_packed[a] = is_packed[b] = True
        c += 1
    if len(narrow) % 2:
        byte_col[narrow[-1]] = c
        c += 1
    return PackPlan(byte_col, shift, is_packed, c, fp)


def pack_columns(binned: torch.Tensor, plan: PackPlan) -> torch.Tensor:
    """``[N, Fp]`` bins -> the ``[N, C]`` storage matrix of the same type,
    on the device of ``binned``: nibble pairs merged, other columns
    copied.  The merge runs in int32 (PyTorch has no shift of uint16)."""
    out = torch.zeros((binned.shape[0], plan.num_storage_cols),
                      dtype=torch.int32, device=binned.device)
    byte_col, shift = np.asarray(plan.byte_col), np.asarray(plan.shift)
    for f in range(plan.num_phys_cols):
        c = int(byte_col[f])
        out[:, c] |= widen(binned[:, f]).int() << int(shift[f])
    if binned.dtype == torch.uint16:
        return out.to(torch.int16).view(torch.uint16)
    return out.to(binned.dtype)


def unfold_packed_hist(hist_c: torch.Tensor, plan: PackPlan,
                       out_bins: int) -> torch.Tensor:
    """Storage-column histograms ``[C, B_joint >= 256, S]`` ->
    physical-column histograms ``[Fp, out_bins, S]``
    (``lightgbm_tpu/data/packing.py:181-209``): a packed column's joint
    histogram, as a [16 hi, 16 lo] grid, summed over its partner's axis
    gives each nibble's 16 bins (exact, no parent needed); other columns
    pass through.  ``plan`` holds tensors on the histogram's device
    (:meth:`PackPlan.to`), so this captures in a CUDA graph."""
    c, bj, s = hist_c.shape
    h4 = hist_c[:, :PACK_JOINT_BINS].reshape(c, PACK_MAX_BIN, PACK_MAX_BIN,
                                             s)
    lo_h = h4.sum(dim=1)                       # [C, 16, S] the lo nibble
    hi_h = h4.sum(dim=2)                       # [C, 16, S] the hi nibble
    byte_col = plan.byte_col
    nib = torch.where((plan.shift == 0)[:, None, None],
                      lo_h.index_select(0, byte_col),
                      hi_h.index_select(0, byte_col))    # [Fp, 16, S]
    if out_bins > PACK_MAX_BIN:
        nib = torch.nn.functional.pad(nib, (0, 0, 0,
                                            out_bins - PACK_MAX_BIN))
    else:
        nib = nib[:, :out_bins]
    wide = hist_c.index_select(0, byte_col)[:, :out_bins]
    if out_bins > bj:
        wide = torch.nn.functional.pad(wide, (0, 0, 0, out_bins - bj))
    return torch.where(plan.is_packed[:, None, None], nib, wide)


class PackedBins(NamedTuple):
    """The packed storage matrix ``[N, C]`` (the bin matrix's type) and
    its plan, whose
    arrays are tensors on the matrix's device (:func:`pack_bins`): what a
    grower's histogram reads, at width ``max(256, B)``
    (:meth:`hist_width`), and how it unfolds the result."""
    matrix: torch.Tensor
    plan: PackPlan

    @staticmethod
    def hist_width(max_bin: int) -> int:
        return max(PACK_JOINT_BINS, max_bin)

    def unfold(self, hist_c: torch.Tensor, out_bins: int) -> torch.Tensor:
        return unfold_packed_hist(hist_c, self.plan, out_bins)


def pack_bins(binned: torch.Tensor, plan: PackPlan) -> PackedBins:
    """The storage matrix of ``binned`` under ``plan``, beside the plan
    moved to its device."""
    return PackedBins(pack_columns(binned, plan), plan.to(binned.device))
