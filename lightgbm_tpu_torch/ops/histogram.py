"""Histogram of a leaf's window of rows: the hottest op of GBDT training.

``hist_window`` is the port of ``lightgbm_tpu/ops/histogram.py:
subset_histogram_fused`` (the Pallas kernel ``pallas_hist.py:hist6_fused``):
given the leaf-contiguous ``order`` array and a device ``int32[2]`` holding
(start, cnt), it returns the ``[F, B, 3]`` float32 histogram (Σg, Σh,
count) of the rows ``order[start:start + cnt]`` of the ``[N, F]`` uint8 bin
matrix, each entry laid out like the reference ``HistogramBinEntry``
(``include/LightGBM/bin.h:27-56``).

On a CUDA tensor it launches the hand-written kernel
``csrc/hist_gather.cu``; on a CPU tensor it runs :func:`hist_window_plain`,
the plain PyTorch version of the same function (the JAX package's
``subset_histogram_segment``, :107: a scatter-add over the combined
(feature, bin) index in 2048-row chunks).  Nothing else picks between the
two.

The data-parallel learner (``parallel/gspmd.py``) keeps a row -> leaf map
per row shard instead of an ``order`` window, and measures a leaf with
one of two formulations:

* ``hist_local``, the port of ``subset_histogram_fused_local`` (:212)
  and of the Pallas ``pallas_hist.py:hist6_fused_local``: a shard's
  partial histogram over its rows with ``row_leaf == leaf_id``.  On a
  CUDA tensor it launches ``csrc/hist_local.cu``; on a CPU tensor it runs
  :func:`hist_local_plain`;
* ``hist_flat``, the port of ``subset_histogram_flat`` (:157): one
  scatter-add of already-masked weights over the whole shard.  The JAX
  package computes it outside any Pallas kernel, so it stays PyTorch.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

NUM_STATS = 3        # (sum_grad, sum_hess, count)
MAX_BINS = 256       # uint8 bins
SEGMENT_CHUNK = 2048  # rows per scatter-add chunk of the plain version


def hist_window_plain(order: torch.Tensor, sc: torch.Tensor,
                      bins: torch.Tensor, gw: torch.Tensor, hw: torch.Tensor,
                      cw: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Plain PyTorch histogram of the window: ``index_add_`` of the
    gathered rows' weights over the combined (feature, bin) index, chunked
    like ``subset_histogram_segment`` so the sums accumulate in its order."""
    start, cnt = (int(v) for v in sc.tolist())
    f = bins.shape[1]
    idx = order[start:start + cnt].long()
    rows = bins.index_select(0, idx).long()
    rows += torch.arange(f, device=bins.device) * num_bins
    w = torch.stack([gw[idx], hw[idx], cw[idx]], dim=-1)        # [M, 3]
    hist = torch.zeros((f * num_bins, NUM_STATS), dtype=torch.float32,
                       device=bins.device)
    for c0 in range(0, cnt, SEGMENT_CHUNK):
        r = rows[c0:c0 + SEGMENT_CHUNK]
        vals = w[c0:c0 + SEGMENT_CHUNK, None, :].expand(-1, f, NUM_STATS)
        hist.index_add_(0, r.reshape(-1), vals.reshape(-1, NUM_STATS))
    return hist.view(f, num_bins, NUM_STATS)


def _kernel_fn():
    """The kernel's C entry point with its argument types declared (built
    and loaded at first use)."""
    fn = build.load("hist_gather").lgbt_hist_gather
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_args(fn: str, idx, bins, gw, hw, cw, num_bins) -> None:
    """Device, type and contiguity of a histogram kernel's arguments;
    ``idx`` names its int32 index tensors."""
    dev = bins.device
    for name, t, dtype in (*[(k, v, torch.int32) for k, v in idx.items()],
                           ("bins", bins, torch.uint8),
                           ("gw", gw, torch.float32),
                           ("hw", hw, torch.float32),
                           ("cw", cw, torch.float32)):
        if t.device != dev:
            raise ValueError(f"{fn}: {name} is on {t.device}, "
                             f"bins on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{fn}: {name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    n, f = bins.shape
    if not 1 <= num_bins <= MAX_BINS or f < 1:
        raise ValueError(f"{fn}: {f} columns x {num_bins} bins; the kernel "
                         f"takes at least one column and 1 to {MAX_BINS} bins")
    if gw.numel() != n or hw.numel() != n or cw.numel() != n:
        raise ValueError(f"{fn}: weights must have one entry per row")


def hist_window(order: torch.Tensor, sc: torch.Tensor, bins: torch.Tensor,
                gw: torch.Tensor, hw: torch.Tensor, cw: torch.Tensor,
                num_bins: int,
                rows_upper_bound: Optional[int] = None) -> torch.Tensor:
    """``[F, num_bins, 3]`` histogram of rows ``order[start:start+cnt]``,
    (start, cnt) = ``sc`` (device ``int32[2]``).

    ``rows_upper_bound`` is a host-known bound on cnt (the parent leaf's
    count in the grower) that sizes the kernel's grid; the kernel reads the
    true cnt from ``sc``.  CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    if bins.device.type == "cpu":
        return hist_window_plain(order, sc, bins, gw, hw, cw, num_bins)
    if bins.device.type != "cuda":
        raise ValueError(f"hist_window: unsupported device {bins.device}")
    _check_cuda_args("hist_window", {"order": order, "sc": sc}, bins, gw,
                     hw, cw, num_bins)
    if sc.numel() != 2:
        raise ValueError("hist_window: sc must hold (start, cnt)")
    n, f = bins.shape
    out = torch.zeros((f, num_bins, NUM_STATS), dtype=torch.float32,
                      device=bins.device)
    bound = n if rows_upper_bound is None else int(rows_upper_bound)
    with torch.cuda.device(bins.device):     # launch on the tensors' card
        err = _kernel_fn()(
            order.data_ptr(), sc.data_ptr(), bins.data_ptr(), gw.data_ptr(),
            hw.data_ptr(), cw.data_ptr(), out.data_ptr(), f, num_bins, bound,
            torch.cuda.current_stream(bins.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hist_gather kernel launch failed: CUDA error "
                           f"{err}")
    hist_window.launches += 1
    return out


# kernel launches, counted where the kernel is launched and nowhere else
hist_window.launches = 0


def hist_flat(bins: torch.Tensor, gw: torch.Tensor, hw: torch.Tensor,
              cw: torch.Tensor, num_bins: int) -> torch.Tensor:
    """``[F, num_bins, 3]`` histogram of every row of ``bins`` in one
    unchunked scatter-add; the caller masks the weights to the leaf."""
    f = bins.shape[1]
    idx = bins.long() + torch.arange(f, device=bins.device) * num_bins
    vals = torch.stack([gw, hw, cw], dim=-1)[:, None, :].expand(-1, f,
                                                                NUM_STATS)
    hist = torch.zeros((f * num_bins, NUM_STATS), dtype=torch.float32,
                       device=bins.device)
    hist.index_add_(0, idx.reshape(-1), vals.reshape(-1, NUM_STATS))
    return hist.view(f, num_bins, NUM_STATS)


def hist_local_plain(row_leaf: torch.Tensor, leaf_id: torch.Tensor,
                     bins: torch.Tensor, gw: torch.Tensor, hw: torch.Tensor,
                     cw: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Plain PyTorch shard-local histogram, in the JAX wrapper's
    structure: a stable compaction of the rows with ``row_leaf ==
    leaf_id`` (ascending row ids), then :func:`hist_window_plain` over
    them."""
    order = torch.nonzero(row_leaf == leaf_id.to(row_leaf.dtype)
                          ).view(-1).int()
    sc = torch.tensor([0, order.numel()], dtype=torch.int32)
    return hist_window_plain(order, sc, bins, gw, hw, cw, num_bins)


def _local_kernel_fn():
    fn = build.load("hist_local").lgbt_hist_local
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def hist_local(row_leaf: torch.Tensor, leaf_id: torch.Tensor,
               bins: torch.Tensor, gw: torch.Tensor, hw: torch.Tensor,
               cw: torch.Tensor, num_bins: int) -> torch.Tensor:
    """``[Fc, num_bins, 3]`` partial histogram of a shard's rows ``r``
    with ``row_leaf[r] == leaf_id``: row_leaf ``[n_loc]`` i32, leaf_id a
    device ``int32[1]`` (no host read), bins ``[n_loc, Fc]`` uint8 (the
    shard's column slice, any width), weights ``[n_loc]`` f32.  CPU
    tensors take the plain version; CUDA tensors launch the kernel, on
    their own card, or raise."""
    if bins.device.type == "cpu":
        return hist_local_plain(row_leaf, leaf_id, bins, gw, hw, cw,
                                num_bins)
    if bins.device.type != "cuda":
        raise ValueError(f"hist_local: unsupported device {bins.device}")
    _check_cuda_args("hist_local", {"row_leaf": row_leaf,
                                    "leaf_id": leaf_id}, bins, gw, hw, cw,
                     num_bins)
    n, f = bins.shape
    if row_leaf.numel() != n or leaf_id.numel() != 1:
        raise ValueError("hist_local: row_leaf must have one entry per row "
                         "and leaf_id one element")
    out = torch.zeros((f, num_bins, NUM_STATS), dtype=torch.float32,
                      device=bins.device)
    # a mesh slot may sit on any visible card: launch on the tensors' card
    with torch.cuda.device(bins.device):
        err = _local_kernel_fn()(
            row_leaf.data_ptr(), leaf_id.data_ptr(), bins.data_ptr(),
            gw.data_ptr(), hw.data_ptr(), cw.data_ptr(), out.data_ptr(), n,
            f, num_bins, torch.cuda.current_stream(bins.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hist_local kernel launch failed: CUDA error "
                           f"{err}")
    hist_local.launches += 1
    return out


# kernel launches, counted where the kernel is launched and nowhere else
hist_local.launches = 0
