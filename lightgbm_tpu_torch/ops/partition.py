"""Stable partition of a leaf's window: the grower's split step.

``partition_window`` is the port of ``lightgbm_tpu/ops/pallas_compact.py:
compact_window`` (the Pallas kernel ``compact_pallas``): given the
leaf-contiguous ``order`` array, a device ``int32[2]`` holding (start,
cnt) and a ``uint8`` ``goes_left`` mask over the window's positions, it
reorders ``order[start:start + cnt]`` in place so that the rows going left
come first and both sides keep their original order (the reference's
``DataPartition::Split``, ``data_partition.hpp:94-146``).  Payload
matrices whose rows follow ``order`` (the leaf-ordered bins and weights
of ``ordered_bins=on``) move the same way.  It returns the left count
``nl`` as a device ``int32[1]``.

On a CUDA tensor it launches the hand-written kernel ``csrc/partition.cu``
(four launches: count, scan, write, copy back; one call in the counter);
on a CPU tensor it runs :func:`partition_window_plain`, the plain PyTorch
version (the grower's cumsum-rank scatter).  :func:`partition_window_sort`
is the ``partition_impl=sort`` form: a stable sort on the 0/1 key, which
the JAX package computes outside Pallas with ``lax.sort``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from . import build

MAX_PAYLOAD = 8       # payload matrices per call (the kernel's kMaxPayload)


def partition_window_plain(order: torch.Tensor, start: int, cnt: int,
                           goes_left: torch.Tensor,
                           payload: Sequence[torch.Tensor] = ()
                           ) -> torch.Tensor:
    """Plain PyTorch partition of the window ``[start, start + cnt)``
    (host ints): stable ranks from one cumulative sum, then one scatter of
    the window and of each payload's rows.  Returns ``nl`` as ``int32[1]``
    on ``order``'s device."""
    dev = order.device
    if cnt == 0:
        return torch.zeros(1, dtype=torch.int32, device=dev)
    gl = goes_left[:cnt].bool()
    c1 = torch.cumsum(gl, 0, dtype=torch.int64)
    nl = c1[-1:]
    c0 = torch.arange(1, cnt + 1, device=dev) - c1
    rank = torch.where(gl, c1 - 1, nl + c0 - 1)
    for t in (order, *payload):
        win = t[start:start + cnt]
        win.copy_(torch.empty_like(win).index_copy_(0, rank, win))
    return nl.int()


def partition_window_sort(order: torch.Tensor, start: int, cnt: int,
                          goes_left: torch.Tensor,
                          payload: Sequence[torch.Tensor] = ()
                          ) -> torch.Tensor:
    """``partition_impl=sort``: a stable sort of the window on the key
    (0 left, 1 right) and the same permutation applied to the payload
    rows.  Returns ``nl`` as ``int32[1]``."""
    dev = order.device
    if cnt == 0:
        return torch.zeros(1, dtype=torch.int32, device=dev)
    gl = goes_left[:cnt].bool()
    perm = torch.sort((~gl).to(torch.uint8), stable=True).indices
    for t in (order, *payload):
        win = t[start:start + cnt]
        win.copy_(win.index_select(0, perm))
    return gl.sum(dtype=torch.int32).view(1)


def _row_bytes(t: torch.Tensor) -> int:
    return (t[0].numel() if t.dim() > 1 else 1) * t.element_size()


def _lib():
    """The kernel's C entry points with their argument types declared
    (built and loaded at first use)."""
    lib = build.load("partition")
    fn = lib.lgbt_partition
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        sz = lib.lgbt_partition_scratch_bytes
        sz.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        sz.restype = ctypes.c_longlong
    return lib


def _scratch_bytes(rows: int, payload: Sequence[torch.Tensor] = ()) -> int:
    """Bytes of scratch a kernel call over up to ``rows`` window positions
    with this payload needs (the grower allocates it once per tree)."""
    widths = (ctypes.c_longlong * max(len(payload), 1))(
        *[_row_bytes(p) for p in payload])
    return int(_lib().lgbt_partition_scratch_bytes(rows, len(payload),
                                                   widths))


def partition_scratch(order: torch.Tensor,
                      payload: Sequence[torch.Tensor] = ()
                      ) -> Optional[torch.Tensor]:
    """Scratch for kernel calls over any window of ``order`` with this
    payload, to allocate once and reuse; None for CPU tensors, whose plain
    version needs none."""
    if order.device.type != "cuda":
        return None
    return torch.empty(_scratch_bytes(order.numel(), payload),
                       dtype=torch.uint8, device=order.device)


def _check_cuda_args(order, sc, goes_left, payload, bound) -> None:
    dev = order.device
    for name, t, dtype in (("order", order, torch.int32),
                           ("sc", sc, torch.int32),
                           ("goes_left", goes_left, torch.uint8)):
        if t.device != dev:
            raise ValueError(f"partition_window: {name} is on {t.device}, "
                             f"order on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"partition_window: {name} must be {dtype}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"partition_window: {name} must be contiguous")
    if sc.numel() != 2:
        raise ValueError("partition_window: sc must hold (start, cnt)")
    if goes_left.numel() < bound or bound > order.numel():
        raise ValueError(f"partition_window: the grid bound {bound} exceeds "
                         f"goes_left ({goes_left.numel()}) or order "
                         f"({order.numel()})")
    if len(payload) > MAX_PAYLOAD:
        raise ValueError(f"partition_window: at most {MAX_PAYLOAD} payload "
                         f"matrices, got {len(payload)}")
    for p in payload:
        if p.device != dev or not p.is_contiguous() or (
                p.shape[0] != order.numel()):
            raise ValueError("partition_window: each payload must be a "
                             "contiguous matrix on order's device with one "
                             "row per entry of order")


def partition_window(order: torch.Tensor, sc: torch.Tensor,
                     goes_left: torch.Tensor,
                     payload: Sequence[torch.Tensor] = (),
                     rows_upper_bound: Optional[int] = None,
                     scratch: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stably partition ``order[start:start+cnt]`` in place by
    ``goes_left[:cnt]`` (``uint8``), (start, cnt) = ``sc`` (device
    ``int32[2]``), moving each payload's rows with it; returns ``nl``
    (``int32[1]``).

    ``rows_upper_bound`` is a host-known bound on cnt that sizes the
    kernel's grid and scratch; the kernel reads the true cnt from ``sc``.
    ``scratch`` (``uint8``, from :func:`partition_scratch`) is allocated
    when not given.  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if order.device.type == "cpu":
        start, cnt = (int(v) for v in sc.tolist())
        return partition_window_plain(order, start, cnt, goes_left, payload)
    if order.device.type != "cuda":
        raise ValueError(f"partition_window: unsupported device "
                         f"{order.device}")
    bound = order.numel() if rows_upper_bound is None else int(
        rows_upper_bound)
    _check_cuda_args(order, sc, goes_left, payload, bound)
    need = _scratch_bytes(bound, payload)
    if scratch is None:
        scratch = torch.empty(need, dtype=torch.uint8, device=order.device)
    elif (scratch.device != order.device or scratch.dtype != torch.uint8
          or scratch.numel() < need):
        raise ValueError(f"partition_window: scratch must be {need} uint8 "
                         f"bytes on {order.device}")
    nl = torch.empty(1, dtype=torch.int32, device=order.device)
    n_pay = len(payload)
    ptrs = (ctypes.c_void_p * max(n_pay, 1))(
        *[p.data_ptr() for p in payload])
    widths = (ctypes.c_longlong * max(n_pay, 1))(
        *[_row_bytes(p) for p in payload])
    err = _lib().lgbt_partition(
        order.data_ptr(), sc.data_ptr(), goes_left.data_ptr(), n_pay, ptrs,
        widths, scratch.data_ptr(), nl.data_ptr(), bound,
        torch.cuda.current_stream(order.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"partition kernel launch failed: CUDA error "
                           f"{err}")
    partition_window.launches += 1
    return nl


# kernel calls (four launches each), counted where the kernel is launched
# and nowhere else
partition_window.launches = 0
