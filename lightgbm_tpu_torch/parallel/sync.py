"""Collectives across the processes of a training.

The port of the part of ``lightgbm_tpu/parallel/sync.py`` that training
needs: ``process_count`` and ``process_index`` (:139-165), the host-object
collectives ``allgather_object`` and ``broadcast_object`` (:280-373) with
their length and CRC check, and ``CollectiveError`` (:72), raised when a
collective fails or outlives ``collective_timeout``, the process group's
timeout (:167-215), naming the operation.  The JAX package moves host
objects through its distributed runtime; here they ride a gloo group that
:func:`~.mesh.init_distributed_from_config` always makes, whatever backend
carries the tensors (:func:`bind`).

Device tensors go through :func:`all_reduce`, on the default group: NCCL
when each process has a card of its own, gloo otherwise (CPU tensors, or
CUDA tensors of processes that share a card).  Only all-reduce and
broadcast are used for tensors, the collectives gloo carries for CUDA
tensors, and an all-reduce gives every process the same bits, so every
process finds the same split.

Left out, with the supervisor they belong to (ROADMAP.md §1.6): the
incarnation epoch fence (:76-127), fault injection and corruption
(:256-272) and the retry ladder (``collective_retries``).
"""
from __future__ import annotations

import pickle
import time
import zlib
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist


class CollectiveError(RuntimeError):
    """A collective across processes failed or timed out."""


# the gloo group of the host-object collectives (None: the default group,
# when the tensors' backend is gloo too), and the timeout of both groups;
# set by bind() when the process group comes up, cleared by unbind()
_host_group = None
_timeout_s: Optional[float] = None


def bind(host_group, timeout_s: float) -> None:
    """Record the host-object group and the groups' timeout (called by
    :func:`~.mesh.init_distributed_from_config`)."""
    global _host_group, _timeout_s
    _host_group, _timeout_s = host_group, float(timeout_s)


def unbind() -> None:
    global _host_group, _timeout_s
    _host_group, _timeout_s = None, None


def process_count() -> int:
    """Processes in the training; 1 when no process group is up."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size()


def process_index() -> int:
    """This process's rank; 0 when no process group is up."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0
    return dist.get_rank()


def _run(what: str, fn):
    """``fn()``, a collective; a failure, a timeout included (gloo raises
    one when a peer does not answer within the group's timeout), becomes
    a :class:`CollectiveError` that names the operation and this rank."""
    try:
        return fn()
    except RuntimeError as e:
        raise CollectiveError(
            f"{what} failed on process {process_index()} of "
            f"{process_count()} (collective_timeout {_timeout_s:g} s; a "
            f"peer process is stuck, dead or failed): {e}") from e


def _frame(obj: Any):
    payload = pickle.dumps(obj)
    return len(payload), zlib.crc32(payload), payload


def _unframe(frame, what: str, peer: int) -> Any:
    n, crc, payload = frame
    got = zlib.crc32(payload)
    if len(payload) != n or got != crc:
        raise CollectiveError(
            f"{what} payload from process {peer} failed its length/CRC "
            f"check (sent {n} bytes, crc {crc:08x}; received "
            f"{len(payload)}, {got:08x})")
    return pickle.loads(payload)


def allgather_object(obj: Any) -> List[Any]:
    """One picklable host object from every process, in rank order (the
    reference's Allgather of serialized blobs), each checked by its length
    and CRC."""
    if process_count() == 1:
        return [obj]
    out: List[Any] = [None] * process_count()
    _run("allgather_object", lambda: dist.all_gather_object(
        out, _frame(obj), group=_host_group))
    return [_unframe(f, "allgather_object", i) for i, f in enumerate(out)]


def broadcast_object(obj: Any = None) -> Any:
    """Process 0's object on every process; only process 0 pickles it."""
    if process_count() == 1:
        return obj
    box = [_frame(obj) if process_index() == 0 else None]
    _run("broadcast_object", lambda: dist.broadcast_object_list(
        box, src=0, group=_host_group))
    return _unframe(box[0], "broadcast_object", 0)


_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX} if dist.is_available() else {}


def all_reduce(t: torch.Tensor, op: str = "sum", what: str = "all_reduce",
               stats: Optional[Dict[str, float]] = None,
               host: bool = False) -> torch.Tensor:
    """Reduce ``t`` in place across the processes (``op`` sum, min or max)
    and return it; the default group carries it, or, with ``host``, the
    host-object group (a small CPU tensor of decisions).  ``stats``, when
    given, counts ``collective_calls`` and ``collective_bytes`` and, with
    ``stats["timed"]`` set, ``collective_s``: the host seconds of the
    call between two synchronisations of its card, so that the device
    work queued before it is not charged to it."""
    if process_count() == 1:
        return t
    timed = stats is not None and stats.get("timed")
    if timed and t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    _run(what, lambda: dist.all_reduce(
        t, op=_OPS[op], group=_host_group if host else None))
    if stats is not None:
        if timed:
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
            stats["collective_s"] = (stats.get("collective_s", 0.0)
                                     + time.perf_counter() - t0)
        stats["collective_calls"] = stats.get("collective_calls", 0) + 1
        stats["collective_bytes"] = (stats.get("collective_bytes", 0)
                                     + t.numel() * t.element_size())
    return t
