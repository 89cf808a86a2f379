"""Collectives across the processes of a training.

The port of ``lightgbm_tpu/parallel/sync.py``: ``process_count`` and
``process_index`` (:139-165), the host-object collectives
``allgather_object`` and ``broadcast_object`` (:280-373) with their length
and CRC check, ``CollectiveError`` (:72), the retry ladder (:229-253,
``configure`` :128, ``collective_retries``), the fault points
``collective_fail`` and ``collective_corrupt`` (:256-272) and the
incarnation epoch fence (``StaleEpochError``, :76-127) with its
``stale_rejoin`` fault point (:119).  Every host-object collective is
counted by :func:`~..obs.collectives.note_collective`.  The JAX package
moves host objects through its distributed runtime; here they ride a gloo
group that :func:`~.mesh.init_distributed_from_config` always makes,
whatever backend carries the tensors (:func:`bind`).

**The ladder.**  Each host-object collective is one attempt of a bounded
ladder: ``collective_retries`` more attempts, with a backoff that doubles
from 0.25 s, each retry counted (``collective_retries`` counter, a
``collective_retry`` event).  It retries what is safe to retry: a fault
injected before the collective is issued, and a payload that fails its
length or CRC check after every process received it (each process that
armed the same ``collective_corrupt`` spec sees it at the same call and
retries with the others).  A collective that gloo itself fails — a peer
that does not answer within ``collective_timeout``, a peer that died — is
not retried: after a timeout gloo closes the group's connections ("Application
timeout caused pair closure"), and every later collective on that group
fails at once on every process.  It raises :class:`CollectiveError` at
once, naming the operation.  (The JAX package runs each attempt on a
thread of its own with a deadline and retries it.)

**The fence.**  Every payload carries the incarnation epoch its sender was
launched under (``LGBM_TPU_GROUP_EPOCH``, which the supervisor sets at
each launch); a frame of another epoch raises :class:`StaleEpochError`
naming both epochs, which the ladder never retries.  The process group's
rendezvous checks the epoch the supervisor stamped on disk first
(:func:`~.mesh.init_distributed_from_config`).

Device tensors go through :func:`all_reduce`, on the default group: NCCL
when each process has a card of its own, gloo otherwise (CPU tensors, or
CUDA tensors of processes that share a card).  Only all-reduce and
broadcast are used for tensors, the collectives gloo carries for CUDA
tensors, and an all-reduce gives every process the same bits, so every
process finds the same split.
"""
from __future__ import annotations

import pickle
import time
import zlib
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from ..utils import faults as faults_mod
from ..utils import log

# the ladder's budget: attempts after the first (engine.train sets it from
# collective_retries), and the first backoff, which doubles a retry
_RETRIES = 2
_BACKOFF = 0.25


class CollectiveError(RuntimeError):
    """A collective across processes failed or timed out."""


class StaleEpochError(CollectiveError):
    """A collective frame (or a rendezvous) of a dead incarnation of the
    group: ``frame_epoch`` is what the stale sender was launched under,
    ``group_epoch`` what this process was.  Never retried."""

    def __init__(self, msg: str, *, frame_epoch: int, group_epoch: int):
        super().__init__(msg)
        self.frame_epoch = int(frame_epoch)
        self.group_epoch = int(group_epoch)


class _GroupFailed(CollectiveError):
    """The collective itself failed in gloo or NCCL (a timeout, a dead
    peer): the group's connections are closed, so it is never retried."""


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


def configure(retries: Optional[int] = None) -> None:
    """Set the ladder's retries (``collective_retries``; engine.train sets
    it for each training).  The timeout is the process group's, fixed when
    the group comes up (``collective_timeout``)."""
    global _RETRIES
    if retries is not None:
        _RETRIES = int(retries)


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


def _group_epoch() -> int:
    # function-local: checkpoint.py reaches back into this module
    from ..checkpoint import group_epoch
    return group_epoch()


def _check_frame_epoch(frame_epoch: int, what: str, peer: Any = "?") -> None:
    """The fence: a frame whose epoch differs from this process's raises
    :class:`StaleEpochError` naming both epochs and the sender, with a
    ``stale_epoch_rejected`` event."""
    mine = _group_epoch()
    if int(frame_epoch) == mine:
        return
    from ..obs.counters import counters
    counters.event("stale_epoch_rejected", op=what, peer=str(peer),
                   frame_epoch=int(frame_epoch), group_epoch=mine)
    log.warning("%s: rejected frame from process %s at incarnation epoch "
                "%d (this group is epoch %d)", what, peer,
                int(frame_epoch), mine)
    raise StaleEpochError(
        f"{what}: frame from process {peer} carries incarnation epoch "
        f"{int(frame_epoch)} but this group is epoch {mine} — a process "
        "from a dead incarnation tried to rejoin; terminate it (it will "
        "not become current by retrying)",
        frame_epoch=int(frame_epoch), group_epoch=mine)


def _run(what: str, fn):
    """``fn()``, a collective; a failure, a timeout included (gloo raises
    one when a peer does not answer within the group's timeout), becomes
    a :class:`CollectiveError` that names the operation and this rank."""
    try:
        return fn()
    except RuntimeError as e:
        raise _GroupFailed(
            f"{what} failed on process {process_index()} of "
            f"{process_count()} (collective_timeout {_timeout_s:g} s; a "
            f"peer process is stuck, dead or failed; not retried: the "
            f"group's connections are closed): {e}") from e


def _retrying(what: str, attempt_fn: Callable[[], Any]) -> Any:
    """The bounded ladder around one collective attempt; every retry is
    counted (``collective_retries``) and recorded (``collective_retry``)."""
    from ..obs.counters import counters
    last: Optional[BaseException] = None
    for attempt in range(_RETRIES + 1):
        try:
            return attempt_fn()
        except (StaleEpochError, _GroupFailed):
            raise
        except Exception as e:
            last = e
            if attempt == _RETRIES:
                break
            counters.inc("collective_retries", op=what)
            counters.event("collective_retry", op=what, attempt=attempt + 1,
                           error=str(e))
            log.warning("%s failed (attempt %d/%d): %s — retrying",
                        what, attempt + 1, _RETRIES + 1, e)
            time.sleep(_BACKOFF * (2 ** attempt))
    raise CollectiveError(
        f"{what} failed after {_RETRIES + 1} attempt(s): {last}") from last


def _maybe_inject(what: str) -> None:
    fi = faults_mod.get_faults()
    if fi.enabled and fi.fire("collective_fail"):
        raise faults_mod.InjectedFault(f"collective_fail: injected {what} "
                                       "failure")


def _maybe_corrupt(frames: list) -> list:
    """``collective_corrupt``: the first received payload's first byte
    flipped, so that its CRC check must catch it."""
    fi = faults_mod.get_faults()
    if fi.enabled and fi.fire("collective_corrupt") and frames:
        n, crc, epoch, payload = frames[0]
        if payload:
            payload = bytes([payload[0] ^ 0xFF]) + payload[1:]
        frames = [(n, crc, epoch, payload)] + list(frames[1:])
    return frames


def _note(op: str, payload: bytes) -> None:
    from ..obs.collectives import note_collective
    note_collective(op, payload, None, "parallel/sync")


def _maybe_stale_rejoin(what: str) -> None:
    """``stale_rejoin`` (``lightgbm_tpu/parallel/sync.py:119``): one frame
    of the previous incarnation arrives at this collective, which the
    fence must reject.  Checked before the one-process short cut, so
    that the fence is testable with no peers."""
    fi = faults_mod.get_faults()
    if fi.enabled and fi.fire("stale_rejoin"):
        _check_frame_epoch(_group_epoch() - 1, what, peer="injected-stale")


def _frame(obj: Any):
    payload = pickle.dumps(obj)
    return len(payload), zlib.crc32(payload), _group_epoch(), payload


def _unframe(frame, what: str, peer: int) -> Any:
    n, crc, epoch, payload = frame
    _check_frame_epoch(epoch, what, peer)
    got = zlib.crc32(payload)
    if len(payload) != n or got != crc:
        raise CollectiveError(
            f"{what} payload from process {peer} failed its length/CRC "
            f"check (sent {n} bytes, crc {crc:08x}; received "
            f"{len(payload)}, {got:08x}) — corrupt or torn transfer")
    return pickle.loads(payload)


def allgather_object(obj: Any) -> List[Any]:
    """One picklable host object from every process, in rank order (the
    reference's Allgather of serialized blobs), each checked by its epoch,
    length and CRC, through the ladder."""

    def attempt() -> List[Any]:
        _maybe_inject("allgather_object")
        _maybe_stale_rejoin("allgather_object")
        if process_count() == 1:
            return [obj]
        frame = _frame(obj)
        out: List[Any] = [None] * process_count()
        _run("allgather_object", lambda: dist.all_gather_object(
            out, frame, group=_host_group))
        _note("allgather_object", frame[3])
        return [_unframe(f, "allgather_object", i)
                for i, f in enumerate(_maybe_corrupt(out))]

    return _retrying("allgather_object", attempt)


def broadcast_object(obj: Any = None) -> Any:
    """Process 0's object on every process; only process 0 pickles it."""

    def attempt() -> Any:
        _maybe_inject("broadcast_object")
        _maybe_stale_rejoin("broadcast_object")
        if process_count() == 1:
            return obj
        box = [_frame(obj) if process_index() == 0 else None]
        _run("broadcast_object", lambda: dist.broadcast_object_list(
            box, src=0, group=_host_group))
        _note("broadcast_object", box[0][3])
        return _unframe(_maybe_corrupt(box)[0], "broadcast_object", 0)

    return _retrying("broadcast_object", attempt)


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
