"""Routing a split's window: which of its rows go left.

:func:`route_goes_left` is the port of ``lightgbm_tpu/grower.py:372
route_goes_left`` (tree.h:257-313), which the JAX package computes in XLA:
a missing bin (the NaN bin, or the default bin of a zero-missing column)
goes the split's default way, another bin left when it is at most the
threshold, and a categorical split sends a bin left when its ``[B]``
bins-left row says so.

:func:`route_window` routes the window of the leaf that splits, with
everything it needs read from device memory: the window (start, cnt), the
parity of the buffer that holds it, the leaf, and through the leaf its
pooled split.  The serial grower's split step is captured as a CUDA graph,
in which the host knows none of these.  On a CUDA tensor it launches the
hand-written kernel ``csrc/route.cu``; on a CPU tensor it runs
:func:`route_window_plain`, the plain PyTorch version (a slice of the
window, a gather of the split column and :func:`route_goes_left`).
"""
from __future__ import annotations

import ctypes
import struct
from typing import Optional, Sequence

import torch

from . import build
from .histogram import sm_count
from .split import MISSING_NAN, MISSING_ZERO

THREADS = 256           # threads a block (csrc/route.cu kThreads)
MAX_BLOCKS_PER_SM = 16  # the grid's cap; threads stride beyond it


def route_goes_left(binf: torch.Tensor, meta, feat: torch.Tensor,
                    thr: torch.Tensor, dleft: torch.Tensor,
                    is_cat_l: Optional[torch.Tensor] = None,
                    cat_row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Left/right decision for rows with bins ``binf`` of column ``feat``
    (tree.h:257-313); ``feat``/``thr``/``dleft``/``is_cat_l`` are
    one-element device tensors, ``cat_row`` the split's ``[B]`` bins-left
    set (given only when the dataset has categorical features); ``meta`` a
    ``grower.FeatureMeta``."""
    mt_f = meta.missing_type.index_select(0, feat)
    nb_f = meta.num_bin.index_select(0, feat)
    db_f = meta.default_bin.index_select(0, feat)
    is_missing = (((mt_f == MISSING_NAN) & (binf == nb_f - 1))
                  | ((mt_f == MISSING_ZERO) & (binf == db_f)))
    goes_left = torch.where(is_missing, dleft, binf <= thr)
    if cat_row is not None:
        cat_go_left = cat_row[torch.clamp(binf, 0, cat_row.shape[0] - 1)]
        goes_left = torch.where(is_cat_l, cat_go_left, goes_left)
    return goes_left


def route_window_plain(sc: torch.Tensor, odd: torch.Tensor,
                       leaf: torch.Tensor, split_i32: torch.Tensor,
                       split_cat: Optional[torch.Tensor],
                       split_catb: Optional[torch.Tensor], meta,
                       bins: Sequence[torch.Tensor],
                       order: Sequence[Optional[torch.Tensor]],
                       out: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`route_window`: reads the window,
    the parity and the leaf back to the host, slices the window of buffer
    ``odd % 2``, gathers its split column and routes it."""
    start, cnt, par, l = (int(v) for v in torch.cat([
        sc.reshape(2).long(), odd.reshape(1).long(),
        leaf.reshape(1).long()]).tolist())
    par &= 1
    cnt = max(0, min(cnt, bins[0].shape[0] - start))
    if cnt == 0:
        return out
    feat = split_i32[l, 0:1].long()
    f = bins[par].shape[1]
    if order[par] is None:      # the window's rows, in buffer order
        binf = bins[par][start:start + cnt].index_select(1, feat)[:, 0]
    else:
        win = order[par][start:start + cnt].long()
        binf = bins[par].reshape(-1).index_select(0, win * f + feat)
    out[:cnt] = route_goes_left(
        binf.long(), meta, feat, split_i32[l, 1:2].long(),
        split_i32[l, 2:3].bool(),
        split_cat[l:l + 1] if split_cat is not None else None,
        split_catb[l] if split_catb is not None else None)
    return out


# the C entry point's one argument (csrc/route.cu: Args): 14 pointers, the
# rows, 4 ints and the stream
_ARGS = struct.Struct("@14Pq4iP")


def route_window(sc: torch.Tensor, odd: torch.Tensor, leaf: torch.Tensor,
                 split_i32: torch.Tensor, split_cat: Optional[torch.Tensor],
                 split_catb: Optional[torch.Tensor], meta,
                 bins: Sequence[torch.Tensor],
                 order: Sequence[Optional[torch.Tensor]],
                 out: torch.Tensor,
                 rows_upper_bound: Optional[int] = None) -> torch.Tensor:
    """Write ``goes_left`` (1 = left) for positions ``[0, cnt)`` of the
    window (start, cnt) = ``sc`` (``int64[2]``) into ``out`` (bool or
    uint8, at least cnt long) and return ``out``.

    The window lies in buffer ``odd % 2`` (``odd`` an ``int32[1]``):
    ``bins[k]`` holds the leaf-ordered bins of buffer k and ``order`` is
    ``(None, None)`` (``ordered_bins=on``), or ``bins[0] is bins[1]`` is
    the natural bin matrix and ``order[k]`` the row ids of buffer k.  The
    split is leaf ``leaf``'s (an ``int64[1]``) in the pool: row ``leaf`` of
    ``split_i32`` (int32 ``[leaves, 3]``: feature, threshold,
    default_left) and, when the data has categorical columns, of
    ``split_cat`` (bool ``[leaves]``) and ``split_catb`` (bool
    ``[leaves, B]``).  ``meta`` is a ``grower.FeatureMeta`` of int32
    tensors.  ``rows_upper_bound`` bounds cnt (the rows when not given)
    and sizes the grid.  CPU tensors take the plain version; CUDA tensors
    launch the kernel, on their own card, or raise."""
    if not bins[0].is_cuda:
        if bins[0].device.type == "cpu":
            return route_window_plain(sc, odd, leaf, split_i32, split_cat,
                                      split_catb, meta, bins, order, out)
        raise ValueError(f"route_window: unsupported device {bins[0].device}")
    dev = bins[0].get_device()
    rows, f = bins[0].shape
    tensors = [sc, odd, leaf, split_i32, meta.num_bin, meta.missing_type,
               meta.default_bin, *bins, out,
               *[t for t in (split_cat, split_catb, *order) if t is not None]]
    if (any(t.get_device() != dev or not t.is_contiguous() for t in tensors)
            or sc.dtype != torch.int64 or sc.numel() != 2
            or odd.dtype != torch.int32 or odd.numel() != 1
            or leaf.dtype != torch.int64 or leaf.numel() != 1
            or split_i32.dtype != torch.int32 or split_i32.dim() != 2
            or split_i32.shape[1] != 3
            or any(m.dtype != torch.int32 for m in meta[:3])
            or any(b.dtype != torch.uint8 or b.shape != (rows, f)
                   for b in bins)
            or (order[0] is None) != (order[1] is None)
            or any(o is not None and (o.dtype != torch.int32
                                      or o.numel() != rows) for o in order)
            or (split_cat is None) != (split_catb is None)
            or (split_cat is not None and (
                split_cat.dtype != torch.bool or split_catb.dtype != torch.bool
                or split_catb.dim() != 2))
            or out.element_size() != 1 or out.numel() < min(
                rows, rows if rows_upper_bound is None
                else int(rows_upper_bound))):
        raise ValueError("route_window: contiguous tensors on one card: "
                         "sc int64[2], odd int32[1], leaf int64[1], "
                         "split_i32 int32 [leaves, 3], int32 meta, uint8 "
                         "bins [rows, F] for both buffers, int32 orders of "
                         "both or neither, bool split_cat and split_catb "
                         "together, and a 1-byte out over the bound")
    bound = rows if rows_upper_bound is None else int(rows_upper_bound)
    grid = max(1, min(-(-bound // THREADS),
                      MAX_BLOCKS_PER_SM * sm_count(dev)))
    ptr = lambda t: 0 if t is None else t.data_ptr()
    err = build.function("route", "lgbt_route", [ctypes.c_char_p])(
        _ARGS.pack(sc.data_ptr(), odd.data_ptr(), leaf.data_ptr(),
                   split_i32.data_ptr(), ptr(split_cat), ptr(split_catb),
                   meta.num_bin.data_ptr(), meta.missing_type.data_ptr(),
                   meta.default_bin.data_ptr(), bins[0].data_ptr(),
                   bins[1].data_ptr(), ptr(order[0]), ptr(order[1]),
                   out.data_ptr(), rows, f,
                   0 if split_catb is None else split_catb.shape[1], grid,
                   dev, torch._C._cuda_getCurrentRawStream(dev)))
    if err != 0:
        raise RuntimeError(f"route kernel launch failed: CUDA error {err}")
    route_window.launches += 1
    return out


# kernel launches, counted where the kernel is launched and nowhere else
route_window.launches = 0
