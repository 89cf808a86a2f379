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
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

NUM_STATS = 3        # (sum_grad, sum_hess, count)
MAX_BINS = 256       # uint8 bins
MAX_COLS = 512       # the JAX kernel's FUSED_MAX_COLS
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


def _check_cuda_args(order, sc, bins, gw, hw, cw, num_bins) -> None:
    dev = bins.device
    for name, t, dtype in (("order", order, torch.int32),
                           ("sc", sc, torch.int32),
                           ("bins", bins, torch.uint8),
                           ("gw", gw, torch.float32),
                           ("hw", hw, torch.float32),
                           ("cw", cw, torch.float32)):
        if t.device != dev:
            raise ValueError(f"hist_window: {name} is on {t.device}, "
                             f"bins on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"hist_window: {name} must be {dtype}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"hist_window: {name} must be contiguous")
    n, f = bins.shape
    if sc.numel() != 2:
        raise ValueError("hist_window: sc must hold (start, cnt)")
    if not 1 <= num_bins <= MAX_BINS or not 1 <= f <= MAX_COLS:
        raise ValueError(f"hist_window: {f} columns x {num_bins} bins is "
                         f"outside the kernel's {MAX_COLS} x {MAX_BINS}")
    if gw.numel() != n or hw.numel() != n or cw.numel() != n:
        raise ValueError("hist_window: weights must have one entry per row")


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
    _check_cuda_args(order, sc, bins, gw, hw, cw, num_bins)
    n, f = bins.shape
    out = torch.zeros((f, num_bins, NUM_STATS), dtype=torch.float32,
                      device=bins.device)
    bound = n if rows_upper_bound is None else int(rows_upper_bound)
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
