"""Deterministic fault injection (``lightgbm_tpu/utils/faults.py``, whole).

Every recovery path of the port can be exercised on demand, on the CPU:
a comma-separated spec names *injection points* wired into the snapshot
writer (:mod:`lightgbm_tpu_torch.checkpoint`), the gradients
(:mod:`lightgbm_tpu_torch.boosting`), the host-object collectives
(:mod:`lightgbm_tpu_torch.parallel.sync`), the histogram wrappers
(:mod:`lightgbm_tpu_torch.ops.histogram`, and the start of a replayed
split step, :class:`lightgbm_tpu_torch.grower.SplitLoop`) and the
training loop's iteration boundary (:mod:`lightgbm_tpu_torch.engine`).

Spec grammar (``fault_inject`` param / ``LGBM_TPU_FAULT_INJECT`` env)::

    fault_inject=nan_grad@3,torn_checkpoint@4,collective_fail_once

* ``point@k``    — fire when the point is hit at iteration ``k`` (one-shot:
  a rolled-back iteration is re-entered at the same index and must not
  re-poison itself);
* ``point_once`` — fire on the first hit, regardless of iteration;
* ``point``      — fire on every hit;
* ``point…:rank=R`` — fire only in the process of rank ``R``
  (``LGBM_TPU_RANK``, else the process group's rank); the config rejects
  ranks outside ``num_machines``.

Known points, the JAX package's list, so that a spec parses the same way
in both packages (unknown names are rejected at parse time):

===================  ========================================================
``torn_checkpoint``  the snapshot writer leaves a torn file at the final
                     path and raises :class:`SimulatedCrash`
``nan_grad``         the first gradient becomes NaN for the iteration
``inf_hess``         the first hessian becomes +inf for the iteration
``collective_fail``  a host-object collective attempt raises
                     :class:`InjectedFault` before it is issued (the retry
                     ladder retries it)
``collective_corrupt``  the received payload is bit-flipped, so that the
                     CRC check must catch it
``hist_fail``        a histogram wrapper (or, on the graph loop, the start
                     of a replayed split step) raises :class:`InjectedFault`
``preempt``          a preemption notice "arrives": training writes a
                     checkpoint at the next iteration boundary and exits
``torn_shard_rank``  this rank's shard of a snapshot set is torn
``torn_manifest``    rank 0 dies writing the set's manifest
``rank_crash_in_barrier``  this rank dies after its shard, before the
                     commit barrier
``rank_crash``       hard process death at an iteration boundary
                     (``os._exit(70)``)
``rank_hang``        the process wedges at an iteration boundary
``slow_heartbeat``   heartbeat writes silently never land
``host_lost``        a host that never comes back: the rank dies hard
                     (``os._exit(70)``) at an iteration boundary, and
                     every relaunched incarnation of that rank dies again
                     at startup, before its first heartbeat (the
                     supervisor's ``world_shrink_after`` counts these)
``stale_rejoin``     one frame of the previous incarnation epoch reaches a
                     host-object collective; the epoch fence rejects it
                     with ``StaleEpochError``
===================  ========================================================

When no spec is installed the active plan is the shared
:data:`NULL_FAULTS`, whose ``fire()`` is a constant ``False``.
"""
from __future__ import annotations

import os
import threading
from typing import List, Optional

KNOWN_POINTS = ("torn_checkpoint", "nan_grad", "inf_hess", "collective_fail",
                "collective_corrupt", "hist_fail", "preempt",
                "torn_shard_rank", "torn_manifest", "rank_crash_in_barrier",
                "rank_crash", "rank_hang", "slow_heartbeat", "host_lost",
                "stale_rejoin")


def current_rank() -> int:
    """The rank a ``:rank=R`` qualifier is checked against:
    ``LGBM_TPU_RANK`` (set by the supervisor and the multi-process
    harnesses), else the process group's rank (0 when no group is up)."""
    env = os.environ.get("LGBM_TPU_RANK")
    if env is not None:
        try:
            return int(env)
        except ValueError:
            pass
    from ..parallel.sync import process_index
    return process_index()


class InjectedFault(RuntimeError):
    """An error deliberately raised by an armed injection point."""


class SimulatedCrash(RuntimeError):
    """Stands in for SIGKILL in tests: training dies mid-snapshot-write."""


class _Entry:
    __slots__ = ("point", "iteration", "once", "rank", "fired")

    def __init__(self, point: str, iteration: Optional[int], once: bool,
                 rank: Optional[int] = None):
        self.point = point
        self.iteration = iteration
        self.once = once
        self.rank = rank
        self.fired = 0


def parse_spec(spec: str) -> List[_Entry]:
    """Parse a fault spec; raises ``ValueError`` on unknown points."""
    entries: List[_Entry] = []
    for raw in str(spec or "").split(","):
        tok = raw.strip()
        if not tok:
            continue
        rank: Optional[int] = None
        if ":" in tok:
            tok, qual = tok.split(":", 1)
            q = qual.strip().lower()
            if not q.startswith("rank="):
                raise ValueError(f"fault_inject: unknown qualifier in "
                                 f"{raw!r} (only :rank=R is understood)")
            try:
                rank = int(q[len("rank="):])
            except ValueError:
                raise ValueError(f"fault_inject: bad rank in {raw!r}")
            if rank < 0:
                raise ValueError(f"fault_inject: rank must be >= 0 in "
                                 f"{raw!r}")
        iteration: Optional[int] = None
        if "@" in tok:
            tok, it = tok.split("@", 1)
            try:
                iteration = int(it)
            except ValueError:
                raise ValueError(f"fault_inject: bad iteration in {raw!r}")
        once = iteration is not None
        if tok.endswith("_once"):
            tok = tok[:-len("_once")]
            once = True
        if tok not in KNOWN_POINTS:
            raise ValueError(f"fault_inject: unknown point {tok!r} "
                             f"(known: {', '.join(KNOWN_POINTS)})")
        entries.append(_Entry(tok, iteration, once, rank))
    return entries


class FaultPlan:
    """An armed set of injection points."""
    enabled = True

    def __init__(self, spec: str):
        self.spec = spec
        self._entries = parse_spec(spec)
        self._lock = threading.Lock()

    def fire(self, point: str, iteration: Optional[int] = None) -> bool:
        """Should ``point`` trigger now?  One call = one hit (one-shot
        entries burn on the hit that matches them)."""
        hit = False
        rank: Optional[int] = None     # resolved lazily, at most once
        with self._lock:
            for e in self._entries:
                if e.point != point:
                    continue
                if e.iteration is not None and e.iteration != iteration:
                    continue
                if e.rank is not None:
                    if rank is None:
                        rank = current_rank()
                    if e.rank != rank:
                        continue
                if e.once and e.fired:
                    continue
                e.fired += 1
                hit = True
        return hit

    def fired(self, point: str) -> int:
        with self._lock:
            return sum(e.fired for e in self._entries if e.point == point)

    def has_point(self, point: str) -> bool:
        """Is ``point`` armed at all (fired or not)?  Lets a caller decide
        once, up front, whether a per-iteration check is worth running
        (engine.py's preemption coordination)."""
        with self._lock:
            return any(e.point == point for e in self._entries)

    def targets(self, point: str, rank: Optional[int] = None) -> bool:
        """Is ``point`` armed FOR THIS RANK (honoring ``:rank=R``
        qualifiers, ignoring ``@K`` pins), without burning a one-shot
        entry?  The ``host_lost`` startup check needs exactly this: a
        relaunched incarnation asks "was this rank declared lost?" — a
        question about the spec, not a firing."""
        with self._lock:
            return any(e.point == point
                       and (e.rank is None or rank is None or e.rank == rank)
                       for e in self._entries)


class NullFaults:
    """Disabled plan — the shared default; ``fire`` never triggers."""
    enabled = False
    spec = ""

    def fire(self, point: str, iteration: Optional[int] = None) -> bool:
        return False

    def fired(self, point: str) -> int:
        return 0

    def has_point(self, point: str) -> bool:
        return False

    def targets(self, point: str, rank: Optional[int] = None) -> bool:
        return False


NULL_FAULTS = NullFaults()

_active = NULL_FAULTS


def get_faults():
    """The process-wide active fault plan (NullFaults when disarmed)."""
    return _active


def install(spec: str) -> FaultPlan:
    """Arm a spec as the process-wide plan; returns it (pass the previous
    value of :func:`get_faults` to :func:`restore` to scope the arming)."""
    global _active
    _active = FaultPlan(spec) if str(spec or "").strip() else NULL_FAULTS
    return _active


def restore(plan) -> None:
    """Re-install a previously active plan (engine-scoped arming)."""
    global _active
    _active = plan


def clear() -> None:
    global _active
    _active = NULL_FAULTS


# armed from the environment at import, as the JAX package arms it
_env_spec = os.environ.get("LGBM_TPU_FAULT_INJECT", "")
if _env_spec.strip():
    install(_env_spec)
