"""Histogram of a leaf's window of rows: the hottest op of GBDT training.

``hist_window`` is the port of ``lightgbm_tpu/ops/histogram.py:
subset_histogram_fused`` (the Pallas kernel ``pallas_hist.py:hist6_fused``):
given the leaf-contiguous ``order`` array and a device ``int32[2]`` holding
(start, cnt), it returns the ``[F, B, 3]`` float32 histogram (Σg, Σh,
count) of the rows ``order[start:start + cnt]`` of the ``[N, F]`` bin
matrix, each entry laid out like the reference ``HistogramBinEntry``
(``include/LightGBM/bin.h:27-56``).

The bin matrix is uint8, or uint16 when a column has more than 256 bins
(``data/dataset.py:bin_dtype``).  It stays ``torch.uint16`` on the device,
so its type says how the kernels read it (``uint16_t*``), but PyTorch
implements few operations on that type (no comparison, arithmetic or
index copy on the CPU): PyTorch code reads it only through :func:`widen`
and :func:`bin_rows`,
which widen the rows or columns it reads to int64, never the whole
matrix, and moves it only through its int16 view (:func:`movable`).

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
of a few columns.  Inside the growers' split steps the host holds no
bound but the rows: :func:`plan_device` (a window) and
:func:`plan_device_local` (a shard's masked scan, whose count the
data-parallel step keeps per leaf and shard in device memory) launch
both kernels, each gated on the device by the true count, and
``alt``/``sel`` let the window kernel pick the window's buffer (one of
two, by the leaf's depth parity) from device memory.  The wrappers zero the output inside the C
entry point (on the kernel's stream) and set up each ``ctypes`` entry point
once.

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
from typing import NamedTuple, Optional, Tuple

import torch

from . import build

NUM_STATS = 3        # (sum_grad, sum_hess, count)
MAX_BINS = 256       # uint8 bins
MAX_BINS_U16 = 65536  # uint16 bins
SEGMENT_CHUNK = 2048  # rows per scatter-add chunk of the plain version


def max_bins(bin_bytes: int) -> int:
    """The widest histogram a bin matrix of ``bin_bytes``-byte bins takes."""
    return MAX_BINS if bin_bytes == 1 else MAX_BINS_U16


def movable(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a type that every PyTorch operation takes on every device:
    a uint16 bin tensor as int16, the same bytes (``.view(torch.uint16)``
    turns a result back); other tensors as they are.  Copies, selections,
    concatenations and transposes of a bin matrix go through it."""
    return t.view(torch.int16) if t.dtype == torch.uint16 else t


def widen(bins: torch.Tensor) -> torch.Tensor:
    """int64 values of a uint8 or uint16 bin tensor, or of the int16 view
    (:func:`movable`) of a uint16 one, masked back to 0..65535."""
    if bins.dtype in (torch.uint16, torch.int16):
        return bins.view(torch.int16).long() & 0xFFFF
    return bins.long()


def bin_rows(bins: torch.Tensor, idx: torch.Tensor, dim: int = 0
             ) -> torch.Tensor:
    """The int64 bins of rows (``dim`` 0) or columns (1) ``idx`` of a bin
    matrix, selected on its :func:`movable` view, then :func:`widen`."""
    return widen(movable(bins).index_select(dim, idx))


def hist_window_plain(order: torch.Tensor, sc: torch.Tensor,
                      bins: torch.Tensor, gw: torch.Tensor, hw: torch.Tensor,
                      cw: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Plain PyTorch histogram of the window: ``index_add_`` of the
    gathered rows' weights over the combined (feature, bin) index, chunked
    like ``subset_histogram_segment`` so the sums accumulate in its order."""
    start, cnt = (int(v) for v in sc.tolist())
    f = bins.shape[1]
    idx = order[start:start + cnt].long()
    rows = bin_rows(bins, idx)
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
# the device regime's small kernel takes windows of at most this many rows:
# the smaller child under SMALL_MAX_ROWS, where the small regime won
# (PERF.md)
SMALL_MAX_WINDOW = SMALL_MAX_ROWS // 2
GROUP_COLS = 4             # columns of a large-regime shared histogram
LARGE_BLOCKS_PER_SM = 4    # large-regime blocks the grid aims at per SM
LARGE_MIN_ROWS = 1024      # positions a large-regime block takes at least
SMALL_BLOCKS_PER_SM = 16   # small-regime grid; threads stride beyond it
MAX_SMEM = 48 * 1024       # dynamic shared memory without an opt-in
MAX_SMEM_OPTIN = 232_448   # the H100's opt-in limit a block (227 KB)
MAX_GRID_Y = 65_535


class LaunchPlan(NamedTuple):
    """How a histogram kernel is launched (``csrc/hist_core.cuh``)."""
    regime: str        # "small": global reductions; "large": shared
    #                    memory; "device": both, gated by the true count
    grid_x: int        # blocks over the positions
    grid_y: int        # column groups (large regime)
    group_width: int   # columns a block's shared histogram holds
    smem_bytes: int    # dynamic shared memory a block
    small_grid_x: int = 0   # device regime: the small kernel's blocks
    split_rows: int = 0     # device regime: the small kernel's largest count
    grid_z: int = 1         # large regime: slices of a column's bins
    slice_bins: int = 0     # bins a slice holds (0: all of them)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan_launch(bound: int, n_feat: int, num_bins: int,
                n_loc: Optional[int] = None, *, num_sms: int,
                small_max_rows: Optional[int] = None,
                bin_bytes: int = 1) -> LaunchPlan:
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
    ``LARGE_MIN_ROWS`` positions.

    ``bin_bytes`` is the bin matrix's (1: uint8, up to 256 bins; 2:
    uint16, up to 65,536).  The group's width comes from the bins: 4
    columns up to 1,024 bins, fewer up to 4,096 (48 KB a block), then one
    column, in dynamic shared memory above 48 KB (the kernel raises its
    limit) up to ``MAX_SMEM_OPTIN``, and past that one column's bins cut
    into ``grid_z`` slices of ``slice_bins``."""
    if (n_feat < 1 or bin_bytes not in (1, 2)
            or not 1 <= num_bins <= max_bins(bin_bytes) or bound < 0
            or num_sms < 1):
        raise ValueError(f"plan_launch: {n_feat} columns, {num_bins} bins "
                         f"of {bin_bytes} bytes, bound {bound}, {num_sms} "
                         f"SMs")
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
    column = num_bins * NUM_STATS * 4      # one column's shared bytes
    grid_z, slice_bins = 1, num_bins
    if column * GROUP_COLS <= MAX_SMEM:
        width = min(n_feat, max(GROUP_COLS,
                                4 * _cdiv(_cdiv(n_feat, MAX_GRID_Y), 4)))
    elif column <= MAX_SMEM:
        width = min(n_feat, MAX_SMEM // column)
    else:       # one column a group, its bins in slices past the opt-in
        width = 1
        grid_z = _cdiv(column, MAX_SMEM_OPTIN)
        slice_bins = _cdiv(num_bins, grid_z)
    grid_y = _cdiv(n_feat, width)
    smem = width * slice_bins * NUM_STATS * 4
    if (smem > (MAX_SMEM if grid_z == 1 and width > 1 else MAX_SMEM_OPTIN)
            or grid_y > MAX_GRID_Y):
        raise ValueError(f"plan_launch: {n_feat} columns x {num_bins} bins "
                         f"need {smem} bytes of shared memory a block")
    target = max(1, num_sms * LARGE_BLOCKS_PER_SM // (grid_y * grid_z))
    grid_x = max(1, min(_cdiv(positions, LARGE_MIN_ROWS), target))
    return LaunchPlan("large", grid_x, grid_y, width, smem, grid_z=grid_z,
                      slice_bins=slice_bins)


def plan_device(bound: int, n_feat: int, num_bins: int, *,
                num_sms: int, bin_bytes: int = 1) -> LaunchPlan:
    """The launch of ``hist_window`` over a window of at most ``bound``
    rows whose count only the device knows: the small kernel over the grid
    of a ``SMALL_MAX_WINDOW``-row window, taking counts up to it, and the
    large kernel over the grid of ``bound`` rows, taking the larger ones
    and spreading the true count over all its blocks."""
    large = plan_launch(bound, n_feat, num_bins, num_sms=num_sms,
                        small_max_rows=-1, bin_bytes=bin_bytes)
    small = plan_launch(min(bound, SMALL_MAX_WINDOW), n_feat, num_bins,
                        num_sms=num_sms, small_max_rows=SMALL_MAX_WINDOW,
                        bin_bytes=bin_bytes)
    return large._replace(regime="device", small_grid_x=small.grid_x,
                          split_rows=SMALL_MAX_WINDOW)


def plan_device_local(n_loc: int, n_feat: int, num_bins: int, *,
                      num_sms: int, bin_bytes: int = 1) -> LaunchPlan:
    """The launch of ``hist_local`` over a shard of ``n_loc`` rows whose
    leaf count only the device knows (``hist_local``'s ``leaf_rows``): the
    small kernel's scan takes counts up to ``SMALL_MAX_ROWS_LOCAL``, the
    large kernel, over the grid of a leaf of ``n_loc`` rows, the larger
    ones.  Both scan every local row, so the host's bound is ``n_loc``."""
    large = plan_launch(n_loc, n_feat, num_bins, n_loc, num_sms=num_sms,
                        small_max_rows=-1, bin_bytes=bin_bytes)
    small = plan_launch(min(n_loc, SMALL_MAX_ROWS_LOCAL), n_feat, num_bins,
                        n_loc, num_sms=num_sms, bin_bytes=bin_bytes)
    return large._replace(regime="device", small_grid_x=small.grid_x,
                          split_rows=SMALL_MAX_ROWS_LOCAL)


# the wrappers' plans: a split's bound recurs across trees and shards
_plan = functools.lru_cache(maxsize=4096)(plan_launch)
_plan_local = functools.lru_cache(maxsize=64)(plan_device_local)


@functools.lru_cache(maxsize=None)
def sm_count(device: int) -> int:
    """The SMs of CUDA card ``device``, which size the launch plan."""
    return torch.cuda.get_device_properties(device).multi_processor_count


# ---- the CUDA kernels ----------------------------------------------------

# the C entry points' one argument (csrc/hist_core.cuh: Args): 7 pointers,
# the selector and the 5 of the second set, the per-leaf rows, the local
# rows, 13 ints (sizes, plan, card, bin width) and the stream, packed at
# once
_ARGS = struct.Struct("@14Pq13iP")
_ARG_TYPES = (torch.int32, torch.int32, None, torch.float32, torch.float32,
              torch.float32)
BIN_DTYPES = (torch.uint8, torch.uint16)
_REGIMES = {"small": 0, "large": 1, "device": 2}
_NO_ALT = (0,) * 6


def _check_cuda_args(fn: str, names, tensors, num_bins: int) -> None:
    """Device, type and contiguity of a histogram kernel's arguments, the
    two int32 index tensors then bins (uint8 or uint16), gw, hw and cw,
    named ``names``; and the shapes they share.  Messages are built only
    on failure: the wrappers run once per split."""
    bins = tensors[2]
    dev = bins.get_device()
    for name, t, dtype in zip(names, tensors, _ARG_TYPES):
        if t.get_device() != dev:
            raise ValueError(f"{fn}: {name} is on {t.device}, "
                             f"bins on {bins.device}")
        if (t.dtype not in BIN_DTYPES if dtype is None
                else t.dtype != dtype):
            raise TypeError(f"{fn}: {name} must be "
                            f"{dtype or 'uint8 or uint16'}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    most = max_bins(bins.element_size())
    if bins.dim() != 2 or bins.shape[1] < 1 or not 1 <= num_bins <= most:
        raise ValueError(f"{fn}: bins of shape {tuple(bins.shape)} x "
                         f"{num_bins} bins; the kernel takes [N, F >= 1] "
                         f"and 1 to {most} bins of {bins.dtype}")
    n = bins.shape[0]
    if any(w.numel() != n for w in tensors[3:]):
        raise ValueError(f"{fn}: weights must have one entry per row")


def _plan_ints(plan: LaunchPlan, num_bins: int, bins: torch.Tensor,
               dev: int):
    """The 11 ints of ``_ARGS`` after the sizes, in ``Args`` order: the
    plan, the card and the bin width."""
    return (_REGIMES[plan.regime], *plan[1:5], dev, plan.small_grid_x,
            plan.split_rows, plan.grid_z, plan.slice_bins or num_bins,
            bins.element_size())


_WINDOW_ARGS = ("order", "sc", "bins", "gw", "hw", "cw")
_LOCAL_ARGS = ("row_leaf", "leaf_id", "bins", "gw", "hw", "cw")


def _pick(sel: Optional[torch.Tensor], first, alt):
    """The plain versions' buffer set: ``alt`` when ``sel`` is odd."""
    return first if sel is None or not int(sel.reshape(-1)[0]) & 1 else alt


def hist_window(order: torch.Tensor, sc: torch.Tensor, bins: torch.Tensor,
                gw: torch.Tensor, hw: torch.Tensor, cw: torch.Tensor,
                num_bins: int, rows_upper_bound: Optional[int] = None,
                plan: Optional[LaunchPlan] = None,
                alt: Optional[Tuple[torch.Tensor, ...]] = None,
                sel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[F, num_bins, 3]`` histogram of rows ``order[start:start+cnt]``,
    (start, cnt) = ``sc`` (device ``int32[2]``).

    ``rows_upper_bound`` is a host-known bound on cnt (the parent leaf's
    count in the grower) from which :func:`plan_launch` picks the kernel's
    regime and grid; the kernel reads the true cnt from ``sc``.  ``plan``
    replaces that plan (to time the designs against each other;
    :func:`plan_device` leaves the regime to the device).  ``alt`` is a
    second ``(order, bins, gw, hw, cw)`` of the same shapes, taken when the
    device ``int32[1]`` ``sel`` is odd.  CPU tensors take the plain
    version; CUDA tensors launch the kernel, on their own card, or
    raise."""
    if (alt is None) != (sel is None):
        raise ValueError("hist_window: alt and sel go together")
    if not bins.is_cuda:
        if bins.device.type == "cpu":
            return hist_window_plain(
                *_pick(sel, (order, sc, bins, gw, hw, cw),
                       (alt[0], sc, *alt[1:]) if alt else None), num_bins)
        raise ValueError(f"hist_window: unsupported device {bins.device}")
    _check_cuda_args("hist_window", _WINDOW_ARGS,
                     (order, sc, bins, gw, hw, cw), num_bins)
    if alt is not None:
        _check_cuda_args("hist_window", _WINDOW_ARGS,
                         (alt[0], sc, *alt[1:]), num_bins)
        if (alt[1].shape != bins.shape or alt[1].dtype != bins.dtype
                or alt[0].shape != order.shape
                or sel.get_device() != bins.get_device()
                or sel.dtype != torch.int32 or sel.numel() != 1):
            raise ValueError("hist_window: the second set must match the "
                             "first, sel be an int32[1] on its card")
    if sc.numel() != 2:
        raise ValueError("hist_window: sc must hold (start, cnt)")
    n, f = bins.shape
    dev = bins.get_device()
    if plan is None:
        plan = _plan(n if rows_upper_bound is None
                     else int(rows_upper_bound), f, num_bins,
                     num_sms=sm_count(dev), bin_bytes=bins.element_size())
    out = torch.empty(f, num_bins, NUM_STATS, dtype=torch.float32,
                      device=bins.device)
    alt_ptrs = (_NO_ALT if alt is None else
                (sel.data_ptr(), *[t.data_ptr() for t in alt]))
    # the C side makes the tensors' card current only if it is not
    err = build.function("hist_gather", "lgbt_hist_gather",
                         [ctypes.c_char_p])(_ARGS.pack(
                             order.data_ptr(), sc.data_ptr(), bins.data_ptr(),
                             gw.data_ptr(), hw.data_ptr(), cw.data_ptr(),
                             out.data_ptr(), *alt_ptrs, 0, n, f, num_bins,
                             *_plan_ints(plan, num_bins, bins, dev),
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
hist_window.regime_launches = {"small": 0, "large": 0, "device": 0}


def hist_flat(bins: torch.Tensor, gw: torch.Tensor, hw: torch.Tensor,
              cw: torch.Tensor, num_bins: int) -> torch.Tensor:
    """``[F, num_bins, 3]`` histogram of every row of ``bins`` in one
    unchunked scatter-add; the caller masks the weights to the leaf."""
    f = bins.shape[1]
    idx = widen(bins) + torch.arange(f, device=bins.device) * num_bins
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
               plan: Optional[LaunchPlan] = None,
               leaf_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[Fc, num_bins, 3]`` partial histogram of a shard's rows ``r``
    with ``row_leaf[r] == leaf_id``: row_leaf ``[n_loc]`` i32, leaf_id a
    device ``int32[1]`` (no host read), bins ``[n_loc, Fc]`` uint8 or
    uint16 (the shard's column slice, any width), weights ``[n_loc]``
    f32.

    ``leaf_rows`` (int32, one entry per leaf id) holds every leaf's rows
    in the shard in device memory, as the data-parallel split step keeps
    them; then :func:`plan_device_local` leaves the regime to the device,
    which reads the leaf's count there.  ``plan`` replaces that plan (a
    host-picked :func:`plan_launch`, to time the regimes against each
    other); a device-regime plan needs ``leaf_rows``.  CPU tensors take
    the plain version, which needs neither; CUDA tensors launch the
    kernel, on their own card, or raise."""
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
    if leaf_rows is not None and (
            leaf_rows.get_device() != dev or leaf_rows.dtype != torch.int32
            or leaf_rows.dim() != 1 or not leaf_rows.is_contiguous()):
        raise ValueError("hist_local: leaf_rows must be a contiguous int32 "
                         "vector on the card of bins")
    if (plan is None or plan.regime == "device") and leaf_rows is None:
        raise ValueError("hist_local: the device regime gates the leaf's "
                         "count in leaf_rows, which was not given")
    if plan is None:
        plan = _plan_local(n, f, num_bins, num_sms=sm_count(dev),
                           bin_bytes=bins.element_size())
    out = torch.empty(f, num_bins, NUM_STATS, dtype=torch.float32,
                      device=bins.device)
    # the C side makes the tensors' card current only if it is not
    err = build.function("hist_local", "lgbt_hist_local",
                         [ctypes.c_char_p])(_ARGS.pack(
                             row_leaf.data_ptr(), leaf_id.data_ptr(),
                             bins.data_ptr(), gw.data_ptr(), hw.data_ptr(),
                             cw.data_ptr(), out.data_ptr(), *_NO_ALT,
                             0 if leaf_rows is None else leaf_rows.data_ptr(),
                             n, f, num_bins,
                             *_plan_ints(plan, num_bins, bins, dev),
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
hist_local.regime_launches = {"small": 0, "large": 0, "device": 0}
