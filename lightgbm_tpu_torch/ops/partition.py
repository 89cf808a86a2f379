"""Stable partition of a leaf's window: the grower's split step.

``partition_window`` is the port of ``lightgbm_tpu/ops/pallas_compact.py:
compact_window`` (the Pallas kernel ``compact_pallas``): given a list of
row-major matrices whose rows follow the leaf-contiguous ``order``
(``order`` itself first, then the leaf-ordered bins and weights of
``ordered_bins=on``), the window ``[start, start + cnt)`` and a 1-byte
``goes_left`` mask over its positions (``bool`` or ``uint8``, nonzero =
left), it writes each matrix's window, stably partitioned (lefts first,
both sides in their original order; the reference's
``DataPartition::Split``, ``data_partition.hpp:94-146``), into the same
positions of a second matrix.  It returns the left count ``nl`` as a
device ``int32[1]``.

Out of place, ``src -> dst``: the grower keeps two buffers of every matrix
and alternates them by the leaf's depth parity, so no pass copies the
window back.  The three versions share that interface:

* :func:`partition_window` takes the window as a device ``int64[2]``
  (start, cnt), as the grower holds it, a host bound on cnt that sizes the
  grid, and optionally the leaf's depth parity as a device ``int32[1]``
  ``odd``, which swaps ``src`` and ``dst`` when odd.  The serial grower's
  captured split step knows neither cnt nor which buffer holds the
  window: it passes the rows as the bound.  On a CUDA tensor it launches
  the hand-written kernel ``csrc/partition.cu``: three launches a call
  (none for a bound of 0), of which the true cnt picks the one that does
  the work up to ``SMALL_MAX_ROWS`` positions or the two that do it
  above; the others return at once.  On a CPU tensor it runs
  :func:`partition_window_plain`;
* :func:`partition_window_plain`, the plain PyTorch version (a
  cumulative-sum rank and one scatter a matrix), on host (start, cnt);
* :func:`partition_window_sort`, ``partition_impl=sort``: a stable sort
  on the 0/1 key, which the JAX package computes outside Pallas with
  ``lax.sort``.
"""
from __future__ import annotations

import ctypes
import struct
from typing import NamedTuple, Optional, Sequence

import torch

from . import build
from .histogram import movable

MAX_MATS = 9          # matrices a call moves: order + 8 payload matrices
# the small launch (each tile sums the window's mask itself) takes windows
# of at most this many positions (the H100's crossover, PERF.md), the
# count and write launches (look-back) the larger ones; csrc/partition.cu
# kSmallMax
SMALL_MAX_ROWS = 196_608
TILE = 2048           # positions a block and a status word cover (kTile)
MAX_GRID_X = 2 ** 31 - 1
LAUNCHES = 3          # kernel launches a call: small, count, write


def partition_window_plain(src: Sequence[torch.Tensor],
                           dst: Sequence[torch.Tensor], start: int, cnt: int,
                           goes_left: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch partition of the window ``[start, start + cnt)`` of
    each ``src`` matrix into ``dst``: stable ranks from one cumulative sum,
    then one scatter a matrix.  Returns ``nl`` as ``int32[1]``."""
    dev = src[0].device
    if cnt == 0:
        return torch.zeros(1, dtype=torch.int32, device=dev)
    gl = goes_left[:cnt].bool()
    c1 = torch.cumsum(gl, 0, dtype=torch.int64)
    nl = c1[-1:]
    c0 = torch.arange(1, cnt + 1, device=dev) - c1
    rank = torch.where(gl, c1 - 1, nl + c0 - 1)
    for s, d in zip(src, dst):
        s, d = movable(s), movable(d)
        d[start:start + cnt].index_copy_(0, rank, s[start:start + cnt])
    return nl.int()


def partition_window_sort(src: Sequence[torch.Tensor],
                          dst: Sequence[torch.Tensor], start: int, cnt: int,
                          goes_left: torch.Tensor) -> torch.Tensor:
    """``partition_impl=sort``: a stable sort of the window on the key
    (0 left, 1 right), the permutation gathered from each ``src`` matrix
    into ``dst``.  Returns ``nl`` as ``int32[1]``."""
    dev = src[0].device
    if cnt == 0:
        return torch.zeros(1, dtype=torch.int32, device=dev)
    gl = goes_left[:cnt].bool()
    perm = torch.sort((~gl).to(torch.uint8), stable=True).indices
    for s, d in zip(src, dst):
        s, d = movable(s), movable(d)
        torch.index_select(s[start:start + cnt], 0, perm,
                           out=d[start:start + cnt])
    return gl.sum(dtype=torch.int32).view(1)


class LaunchPlan(NamedTuple):
    """How the partition kernel is launched for a window bound."""
    grid: int          # blocks of the count and write launches: one a
    #                    tile of TILE positions of the bound
    small_grid: int    # blocks of the small launch: the tiles of at most
    #                    SMALL_MAX_ROWS positions
    launches: int      # kernel launches of the call


def plan_launch(bound: int) -> LaunchPlan:
    """The launch of a call over at most ``bound`` positions: a pure
    function of what the host knows; the kernel reads the true cnt."""
    if bound < 0:
        raise ValueError(f"plan_launch: bound {bound}")
    grid = max(1, -(-bound // TILE))
    if grid > MAX_GRID_X:
        raise ValueError(f"plan_launch: {bound} positions")
    return LaunchPlan(grid, max(1, -(-min(bound, SMALL_MAX_ROWS) // TILE)),
                      0 if bound == 0 else LAUNCHES)


def partition_scratch(rows: int, device) -> torch.Tensor:
    """Zeroed scratch for kernel calls over windows of up to ``rows``
    positions on ``device``: the count and write launches' status word of
    8 bytes a tile of ``TILE`` positions and a ticket, which the kernel
    leaves at 0.  Allocate once and reuse."""
    words = -(-max(rows, 1) // TILE) + 1
    return torch.zeros(words, dtype=torch.int64, device=device)


# the C entry point's one argument (csrc/partition.cu: Args): the source,
# destination and row width of MAX_MATS matrices, 5 pointers, 3 sizes, 2
# ints and the stream
_ARGS = struct.Struct(f"@{MAX_MATS}P{MAX_MATS}P{MAX_MATS}q5P3q2iP")
_NULLS = (0,) * MAX_MATS


def _row_bytes(t: torch.Tensor) -> int:
    return (t.shape[1] if t.dim() > 1 else 1) * t.element_size()


def _check_cuda_args(src, dst, sc, goes_left, bound: int, scratch,
                     odd) -> None:
    """Device, type, contiguity and shapes of the kernel's arguments.
    Messages are built only on failure: the grower calls once per split."""
    if not 1 <= len(src) <= MAX_MATS or len(dst) != len(src):
        raise ValueError(f"partition_window: 1 to {MAX_MATS} source "
                         f"matrices and as many destinations, got "
                         f"{len(src)} and {len(dst)}")
    dev = src[0].get_device()
    n = src[0].shape[0]
    for s, d in zip(src, dst):
        if (s.get_device() != dev or d.get_device() != dev
                or not s.is_contiguous() or not d.is_contiguous()
                or s.dim() > 2 or s.shape != d.shape or s.dtype != d.dtype
                or s.shape[0] != n):
            raise ValueError("partition_window: each source and its "
                             "destination must be contiguous vectors or "
                             "matrices of one shape and type, with one row "
                             "per entry of order, on one card")
    if (sc.get_device() != dev or sc.dtype != torch.int64
            or sc.numel() != 2 or not sc.is_contiguous()):
        raise ValueError("partition_window: sc must be a contiguous int64 "
                         "(start, cnt) on order's card")
    if (goes_left.get_device() != dev or goes_left.element_size() != 1
            or not goes_left.is_contiguous() or goes_left.numel() < bound
            or not 0 <= bound <= n):
        raise ValueError(f"partition_window: goes_left must be a contiguous "
                         f"1-byte mask on order's card covering the bound "
                         f"{bound} (at most {n} rows)")
    if scratch.get_device() != dev or scratch.dtype != torch.int64:
        raise ValueError("partition_window: scratch must be int64 on "
                         "order's card (partition_scratch)")
    if odd is not None and (odd.get_device() != dev or odd.numel() != 1
                            or odd.dtype != torch.int32):
        raise ValueError("partition_window: odd must be an int32[1] on "
                         "order's card")


def partition_window(src: Sequence[torch.Tensor],
                     dst: Sequence[torch.Tensor], sc: torch.Tensor,
                     goes_left: torch.Tensor, rows_upper_bound: int,
                     scratch: Optional[torch.Tensor] = None,
                     odd: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stably partition the window (start, cnt) = ``sc`` (an ``int64[2]``
    on the matrices' device) of each ``src`` matrix (``src[0]`` is
    ``order``) by ``goes_left[:cnt]`` into the same positions of ``dst``;
    returns ``nl`` (``int32[1]``).

    ``rows_upper_bound`` is a host-known bound on cnt that sizes the grid
    (:func:`plan_launch`); the kernel reads the true window from ``sc``.
    ``scratch`` (from :func:`partition_scratch`, sized for at least the
    bound) is allocated when not given.  ``odd`` (a device ``int32[1]``)
    swaps ``src`` and ``dst`` when odd.  CPU tensors take the plain
    version; CUDA tensors launch the kernel, on their own card, or
    raise."""
    if not src[0].is_cuda:
        if src[0].device.type == "cpu":
            start, cnt = (int(v) for v in sc.tolist())
            if odd is not None and int(odd.reshape(-1)[0]) & 1:
                src, dst = dst, src
            return partition_window_plain(src, dst, start, cnt, goes_left)
        raise ValueError(f"partition_window: unsupported device "
                         f"{src[0].device}")
    bound = int(rows_upper_bound)
    if scratch is None:
        scratch = partition_scratch(bound, src[0].device)
    _check_cuda_args(src, dst, sc, goes_left, bound, scratch, odd)
    plan = plan_launch(bound)
    if plan.launches == 0:     # an empty window: nothing to move
        return torch.zeros(1, dtype=torch.int32, device=src[0].device)
    if plan.grid >= scratch.numel():
        raise ValueError(f"partition_window: scratch of {scratch.numel()} "
                         f"words is too small for {bound} positions")
    dev = src[0].get_device()
    nl = torch.empty(1, dtype=torch.int32, device=src[0].device)
    pad = MAX_MATS - len(src)
    # the C side makes the tensors' card current only if it is not
    err = build.function("partition", "lgbt_partition", [ctypes.c_char_p])(
        _ARGS.pack(*[t.data_ptr() for t in src], *_NULLS[:pad],
                   *[t.data_ptr() for t in dst], *_NULLS[:pad],
                   *[_row_bytes(t) for t in src], *_NULLS[:pad],
                   goes_left.data_ptr(), sc.data_ptr(), nl.data_ptr(),
                   scratch.data_ptr(), 0 if odd is None else odd.data_ptr(),
                   src[0].shape[0], bound, scratch.numel() - 1, len(src),
                   dev, torch._C._cuda_getCurrentRawStream(dev)))
    if err != 0:
        raise RuntimeError(f"partition kernel launch failed: CUDA error "
                           f"{err}")
    partition_window.launches += 1
    return nl


# kernel calls, counted where the kernel is launched and nowhere else (a
# call is LAUNCHES kernel launches)
partition_window.launches = 0
