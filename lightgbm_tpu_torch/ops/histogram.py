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

Both CUDA kernels share one core (``csrc/hist_core.cuh``) with two
regimes, which :func:`plan_launch` picks on the host from a bound on the
rows that the caller already holds: a small window adds straight into the
output with global reductions, a large one into shared-memory histograms
of a few columns.  The wrappers zero the output inside the C entry point
(on the kernel's stream) and set up each ``ctypes`` entry point once.

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
import functools
import struct
from typing import NamedTuple, Optional

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


# ---- the launch plan of both kernels ---------------------------------------

THREADS = 256              # threads a block (hist_core.cuh kThreads)
# the small regime takes a row bound of at most this many rows: K1's bound
# is the parent's count, and its smaller child holds at most about half of
# it; K3's is the parent's count over all shards
SMALL_MAX_ROWS = 32_768
SMALL_MAX_ROWS_LOCAL = 65_536
GROUP_COLS = 4             # columns of a large-regime shared histogram
LARGE_BLOCKS_PER_SM = 4    # large-regime blocks the grid aims at per SM
LARGE_MIN_ROWS = 1024      # positions a large-regime block takes at least
SMALL_BLOCKS_PER_SM = 16   # small-regime grid; threads stride beyond it
MAX_SMEM = 48 * 1024       # dynamic shared memory without an opt-in
MAX_GRID_Y = 65_535


class LaunchPlan(NamedTuple):
    """How a histogram kernel is launched (``csrc/hist_core.cuh``)."""
    regime: str        # "small": global reductions; "large": shared memory
    grid_x: int        # blocks over the positions
    grid_y: int        # column groups (large regime)
    group_width: int   # columns a block's shared histogram holds
    smem_bytes: int    # dynamic shared memory a block


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan_launch(bound: int, n_feat: int, num_bins: int,
                n_loc: Optional[int] = None, *, num_sms: int,
                small_max_rows: Optional[int] = None) -> LaunchPlan:
    """The launch of ``hist_window`` (``n_loc`` None: a window of at most
    ``bound`` rows) or of ``hist_local`` (a masked scan of ``n_loc`` local
    rows, at most ``bound`` of them in the leaf) on a card of ``num_sms``
    SMs.  A pure function of what the host knows; the kernel reads the
    true count from the device.

    A bound of at most ``small_max_rows`` rows (``SMALL_MAX_ROWS`` for a
    window, ``SMALL_MAX_ROWS_LOCAL`` for a scan; the H100's crossover,
    PERF.md) takes the small regime: a thread per (row, 4-column group,
    statistic) of the window, or per local row of the scan, and no shared
    memory.  More take the large regime: shared histograms of
    ``GROUP_COLS`` columns on ``grid_y``; ``grid_x`` aims at
    ``LARGE_BLOCKS_PER_SM`` blocks on each SM, each over at least
    ``LARGE_MIN_ROWS`` positions."""
    if (n_feat < 1 or not 1 <= num_bins <= MAX_BINS or bound < 0
            or num_sms < 1):
        raise ValueError(f"plan_launch: {n_feat} columns, {num_bins} bins, "
                         f"bound {bound}, {num_sms} SMs")
    if n_loc is None:
        rows = positions = bound
        limit = SMALL_MAX_ROWS if small_max_rows is None else small_max_rows
    else:
        rows, positions = min(bound, n_loc), n_loc
        limit = (SMALL_MAX_ROWS_LOCAL if small_max_rows is None
                 else small_max_rows)
    if rows <= limit:
        # a thread per local row, or per (row, 4-column group, statistic)
        work = positions if n_loc is not None else (
            positions * 3 * _cdiv(n_feat, 4))
        return LaunchPlan("small", max(1, min(
            _cdiv(work, THREADS), SMALL_BLOCKS_PER_SM * num_sms)), 1, 4, 0)
    width = min(n_feat, max(GROUP_COLS,
                            4 * _cdiv(_cdiv(n_feat, MAX_GRID_Y), 4)))
    grid_y = _cdiv(n_feat, width)
    smem = width * num_bins * NUM_STATS * 4
    if smem > MAX_SMEM:
        raise ValueError(f"plan_launch: {n_feat} columns x {num_bins} bins "
                         f"need {smem} bytes of shared memory a block")
    target = max(1, num_sms * LARGE_BLOCKS_PER_SM // grid_y)
    grid_x = max(1, min(_cdiv(positions, LARGE_MIN_ROWS), target))
    return LaunchPlan("large", grid_x, grid_y, width, smem)


# the wrappers' plans: a split's bound recurs across trees and shards
_plan = functools.lru_cache(maxsize=4096)(plan_launch)


@functools.lru_cache(maxsize=None)
def sm_count(device: int) -> int:
    """The SMs of CUDA card ``device``, which size the launch plan."""
    return torch.cuda.get_device_properties(device).multi_processor_count


# ---- the CUDA kernels ----------------------------------------------------

# the C entry points' one argument (csrc/hist_core.cuh: Args): 7 pointers,
# the local rows, 8 ints (sizes, plan, card) and the stream, packed at once
_ARGS = struct.Struct("@7Pq8iP")
_ARG_TYPES = (torch.int32, torch.int32, torch.uint8, torch.float32,
              torch.float32, torch.float32)


def _check_cuda_args(fn: str, names, tensors, num_bins: int) -> None:
    """Device, type and contiguity of a histogram kernel's arguments, the
    two int32 index tensors then bins, gw, hw and cw, named ``names``; and
    the shapes they share.  Messages are built only on failure: the
    wrappers run once per split."""
    bins = tensors[2]
    dev = bins.get_device()
    for name, t, dtype in zip(names, tensors, _ARG_TYPES):
        if t.get_device() != dev:
            raise ValueError(f"{fn}: {name} is on {t.device}, "
                             f"bins on {bins.device}")
        if t.dtype != dtype:
            raise TypeError(f"{fn}: {name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    if bins.dim() != 2 or bins.shape[1] < 1 or not 1 <= num_bins <= MAX_BINS:
        raise ValueError(f"{fn}: bins of shape {tuple(bins.shape)} x "
                         f"{num_bins} bins; the kernel takes [N, F >= 1] "
                         f"and 1 to {MAX_BINS} bins")
    n = bins.shape[0]
    if any(w.numel() != n for w in tensors[3:]):
        raise ValueError(f"{fn}: weights must have one entry per row")


_WINDOW_ARGS = ("order", "sc", "bins", "gw", "hw", "cw")
_LOCAL_ARGS = ("row_leaf", "leaf_id", "bins", "gw", "hw", "cw")


def hist_window(order: torch.Tensor, sc: torch.Tensor, bins: torch.Tensor,
                gw: torch.Tensor, hw: torch.Tensor, cw: torch.Tensor,
                num_bins: int, rows_upper_bound: Optional[int] = None,
                plan: Optional[LaunchPlan] = None) -> torch.Tensor:
    """``[F, num_bins, 3]`` histogram of rows ``order[start:start+cnt]``,
    (start, cnt) = ``sc`` (device ``int32[2]``).

    ``rows_upper_bound`` is a host-known bound on cnt (the parent leaf's
    count in the grower) from which :func:`plan_launch` picks the kernel's
    regime and grid; the kernel reads the true cnt from ``sc``.  ``plan``
    replaces that plan (to time the designs against each other).  CPU
    tensors take the plain version; CUDA tensors launch the kernel, on
    their own card, or raise."""
    if not bins.is_cuda:
        if bins.device.type == "cpu":
            return hist_window_plain(order, sc, bins, gw, hw, cw, num_bins)
        raise ValueError(f"hist_window: unsupported device {bins.device}")
    _check_cuda_args("hist_window", _WINDOW_ARGS,
                     (order, sc, bins, gw, hw, cw), num_bins)
    if sc.numel() != 2:
        raise ValueError("hist_window: sc must hold (start, cnt)")
    n, f = bins.shape
    dev = bins.get_device()
    if plan is None:
        plan = _plan(n if rows_upper_bound is None
                     else int(rows_upper_bound), f, num_bins,
                     num_sms=sm_count(dev))
    out = torch.empty(f, num_bins, NUM_STATS, dtype=torch.float32,
                      device=bins.device)
    # the C side makes the tensors' card current only if it is not
    err = build.function("hist_gather", "lgbt_hist_gather",
                         [ctypes.c_char_p])(_ARGS.pack(
                             order.data_ptr(), sc.data_ptr(), bins.data_ptr(),
                             gw.data_ptr(), hw.data_ptr(), cw.data_ptr(),
                             out.data_ptr(), n, f, num_bins,
                             plan.regime == "large", *plan[1:], dev,
                             torch._C._cuda_getCurrentRawStream(dev)))
    if err != 0:
        raise RuntimeError(f"hist_gather kernel launch failed: CUDA error "
                           f"{err}")
    hist_window.launches += 1
    hist_window.regime_launches[plan.regime] += 1
    return out


# kernel launches, counted where the kernel is launched and nowhere else;
# and the same launches by the regime their plan took
hist_window.launches = 0
hist_window.regime_launches = {"small": 0, "large": 0}


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


def hist_local(row_leaf: torch.Tensor, leaf_id: torch.Tensor,
               bins: torch.Tensor, gw: torch.Tensor, hw: torch.Tensor,
               cw: torch.Tensor, num_bins: int,
               rows_upper_bound: Optional[int] = None,
               plan: Optional[LaunchPlan] = None) -> torch.Tensor:
    """``[Fc, num_bins, 3]`` partial histogram of a shard's rows ``r``
    with ``row_leaf[r] == leaf_id``: row_leaf ``[n_loc]`` i32, leaf_id a
    device ``int32[1]`` (no host read), bins ``[n_loc, Fc]`` uint8 (the
    shard's column slice, any width), weights ``[n_loc]`` f32.

    ``rows_upper_bound`` is a host-known bound on the leaf's rows in the
    shard (the parent leaf's global count in the data-parallel grower) from
    which :func:`plan_launch` picks the kernel's regime; ``plan`` replaces
    that plan.  CPU tensors take the plain version; CUDA tensors launch
    the kernel, on their own card, or raise."""
    if not bins.is_cuda:
        if bins.device.type == "cpu":
            return hist_local_plain(row_leaf, leaf_id, bins, gw, hw, cw,
                                    num_bins)
        raise ValueError(f"hist_local: unsupported device {bins.device}")
    _check_cuda_args("hist_local", _LOCAL_ARGS,
                     (row_leaf, leaf_id, bins, gw, hw, cw), num_bins)
    n, f = bins.shape
    if row_leaf.numel() != n or leaf_id.numel() != 1:
        raise ValueError("hist_local: row_leaf must have one entry per row "
                         "and leaf_id one element")
    dev = bins.get_device()
    if plan is None:
        plan = _plan(n if rows_upper_bound is None
                     else int(rows_upper_bound), f, num_bins, n,
                     num_sms=sm_count(dev))
    out = torch.empty(f, num_bins, NUM_STATS, dtype=torch.float32,
                      device=bins.device)
    # the C side makes the tensors' card current only if it is not
    err = build.function("hist_local", "lgbt_hist_local",
                         [ctypes.c_char_p])(_ARGS.pack(
                             row_leaf.data_ptr(), leaf_id.data_ptr(),
                             bins.data_ptr(), gw.data_ptr(), hw.data_ptr(),
                             cw.data_ptr(), out.data_ptr(), n, f, num_bins,
                             plan.regime == "large", *plan[1:], dev,
                             torch._C._cuda_getCurrentRawStream(dev)))
    if err != 0:
        raise RuntimeError(f"hist_local kernel launch failed: CUDA error "
                           f"{err}")
    hist_local.launches += 1
    hist_local.regime_launches[plan.regime] += 1
    return out


# kernel launches, counted where the kernel is launched and nowhere else;
# and the same launches by the regime their plan took
hist_local.launches = 0
hist_local.regime_launches = {"small": 0, "large": 0}
