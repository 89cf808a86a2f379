"""Per-rank flight recorder (``lightgbm_tpu/obs/flight.py``): a bounded,
rotated, rank-tagged JSONL event stream a run appends to while it runs.

Armed with ``obs_stream_path``, every rank streams to
``<obs_stream_path>.rank_R`` (:func:`stream_path`):

* **progress records**: boosting appends one iteration-stamped record a
  ``train_one_iter`` (seconds, trees a second, ms a leaf, the observed
  histogram kernel, the device-memory peak, the collective bytes, and,
  when they are armed, devprof's idle gap, the streamed pipeline's waits
  and the latest evaluation values).  Every field is host state the loop
  already holds: a record reads nothing from the card;
* **structured events as they happen**: the recorder is a sink of the
  counter registry (:meth:`~.counters.CounterRegistry.add_sink`);
* **memory inflections**: the armed memory monitor writes an
  ``hbm_peak`` line whenever the peak grows past its last mark by more
  than 10 %.

The stream rotates at :data:`MAX_BYTES`, with one retained generation.
Writes are unsynced appends (the heartbeat's discipline).  The
supervisor tails every rank's stream and compares progress rates
(:func:`detect_stragglers`).  Disarmed, the active recorder is the shared
:data:`NULL_FLIGHT` no-op.  The file format is the JAX package's: either
package's streams are read by the other's readers.
"""
from __future__ import annotations

import json
import os
import statistics
import threading
import time
from typing import Any, Dict, List, Optional

from .trace import process_index

MAX_BYTES = 4 << 20        # rotate past this; one .1 generation retained


def stream_path(base: str, rank: int) -> str:
    """The per-rank stream file for an ``obs_stream_path`` base (the
    ``<output_model>.heartbeat.rank_R`` naming convention)."""
    return f"{base}.rank_{rank}"


class NullFlightRecorder:
    """Disarmed recorder: every operation is a constant no-op, shared
    process-wide so the instrumented hot paths never allocate."""
    enabled = False
    path: Optional[str] = None

    def record(self, kind: str, **fields) -> None:
        pass

    def progress(self, iteration: int, **fields) -> None:
        pass

    def records(self, kind: str, rows) -> None:
        pass

    def close(self) -> None:
        pass


NULL_FLIGHT = NullFlightRecorder()


class FlightRecorder:
    """Armed recorder bound to one stream file."""
    enabled = True

    def __init__(self, path: str, rank: Optional[int] = None,
                 max_bytes: int = MAX_BYTES):
        self.path = str(path)
        self.rank = int(rank) if rank is not None else process_index()
        self.max_bytes = max(4096, int(max_bytes))
        self._lock = threading.Lock()
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        self._fh = open(self.path, "a")
        self._size = self._fh.tell()

    def record(self, kind: str, **fields) -> None:
        """Append one event line.  Unsynced (liveness, not durability —
        the heartbeat rule); a full disk must never kill training."""
        from ..checkpoint import group_epoch   # lazy: import cycle
        rec = {"t": round(time.time(), 3), "rank": self.rank,
               "event": str(kind), "epoch": group_epoch()}
        rec.update(fields)
        line = json.dumps(rec, default=str) + "\n"
        with self._lock:
            try:
                if self._size + len(line) > self.max_bytes:
                    self._rotate()
                self._fh.write(line)
                self._fh.flush()
                self._size += len(line)
            except (OSError, ValueError):
                pass             # a dead stream is a stale one, not a crash

    def progress(self, iteration: int, **fields) -> None:
        self.record("progress", iteration=int(iteration), **fields)

    def records(self, kind: str, rows) -> None:
        """Append one ``kind`` line for each field dict of ``rows``, in one
        write and one flush (the split audit's hundreds of lines a tree);
        the lines are :meth:`record`'s."""
        from ..checkpoint import group_epoch   # lazy: import cycle
        head = {"t": round(time.time(), 3), "rank": self.rank,
                "event": str(kind), "epoch": group_epoch()}
        text = "".join(json.dumps({**head, **fields}, default=str) + "\n"
                       for fields in rows)
        with self._lock:
            try:
                if self._size + len(text) > self.max_bytes:
                    self._rotate()
                self._fh.write(text)
                self._fh.flush()
                self._size += len(text)
            except (OSError, ValueError):
                pass

    def _rotate(self) -> None:
        self._fh.close()
        os.replace(self.path, self.path + ".1")
        self._fh = open(self.path, "a")
        self._size = 0

    def close(self) -> None:
        with self._lock:
            try:
                self._fh.close()
            except (OSError, ValueError):
                pass

    # counter-registry sink: every structured event streams as it happens
    def _absorb_event(self, ev: Dict[str, Any]) -> None:
        fields = {k: v for k, v in ev.items() if k != "event"}
        self.record(ev.get("event", "?"), **fields)


_active: Any = NULL_FLIGHT


def get_flight():
    """The process-wide active recorder (NULL_FLIGHT when disarmed)."""
    return _active


def start(path: str, rank: Optional[int] = None,
          max_bytes: int = MAX_BYTES) -> FlightRecorder:
    """Arm a recorder on ``path`` and subscribe it to the counter-registry
    event stream."""
    global _active
    from .counters import counters
    stop()
    _active = FlightRecorder(path, rank=rank, max_bytes=max_bytes)
    counters.add_sink(_active._absorb_event)
    return _active


def stop() -> Optional[str]:
    """Disarm; returns the stream path that was active, or None."""
    global _active
    fl, _active = _active, NULL_FLIGHT
    if not fl.enabled:
        return None
    from .counters import counters
    counters.remove_sink(fl._absorb_event)
    fl.close()
    return fl.path


# ------------------------------------------------------------------ readers


def read_stream(path: str, include_rotated: bool = True) -> List[dict]:
    """Every parseable record of a stream, rotated generation first.
    Torn-tail tolerant: a killed writer leaves a readable prefix and the
    final partial line is skipped, never raised on."""
    out: List[dict] = []
    paths = ([path + ".1"] if include_rotated else []) + [path]
    for p in paths:
        try:
            with open(p) as f:
                text = f.read()
        except OSError:
            continue
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out


def tail_records(path: str, max_bytes: int = 65536) -> List[dict]:
    """The records in the last ``max_bytes`` of a stream (the supervisor's
    cheap repeated read; the first line of the window may be partial and
    is dropped along with any torn tail)."""
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            if size > max_bytes:
                f.seek(size - max_bytes)
            chunk = f.read().decode("utf-8", errors="replace")
    except OSError:
        return []
    lines = chunk.splitlines()
    if size > max_bytes and lines:
        lines = lines[1:]              # partial first line of the window
    out = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            continue
    return out


# ------------------------------------------------------- straggler verdicts


def progress_rate(records: List[dict]) -> Optional[float]:
    """Iterations per second across the ``progress`` records of one rank's
    stream window, or None when fewer than two usable records exist."""
    prog = [r for r in records
            if r.get("event") == "progress"
            and isinstance(r.get("iteration"), (int, float))
            and isinstance(r.get("t"), (int, float))]
    if len(prog) < 2:
        return None
    di = float(prog[-1]["iteration"]) - float(prog[0]["iteration"])
    dt = float(prog[-1]["t"]) - float(prog[0]["t"])
    if di <= 0 or dt <= 0:
        return None
    return di / dt


def recent_idle_gap(records: List[dict]) -> Optional[float]:
    """Median ``idle_gap_fraction`` across the ``progress`` records of one
    rank's stream window (present when the devprof plane was armed), or
    None — a straggler verdict that can say "the gap is host-side idle,
    not device work" is worth far more than a bare rate ratio."""
    gaps = [float(r["idle_gap_fraction"]) for r in records
            if r.get("event") == "progress"
            and isinstance(r.get("idle_gap_fraction"), (int, float))]
    if not gaps:
        return None
    return round(statistics.median(gaps), 4)


def detect_stragglers(rates: Dict[int, Optional[float]],
                      factor: float) -> List[Dict[str, Any]]:
    """Ranks whose progress rate falls ``factor`` behind the group median
    (``rate * factor < median``).  Needs at least two ranks with measured
    rates; a rank with no rate yet is unknown, not a straggler (the
    heartbeat layer owns "silent")."""
    valid = {r: float(v) for r, v in rates.items() if v}
    if len(valid) < 2:
        return []
    med = statistics.median(valid.values())
    out = []
    for rank, rate in sorted(valid.items()):
        if rate * float(factor) < med:
            out.append({"rank": rank, "rate": round(rate, 4),
                        "median_rate": round(med, 4),
                        "behind": round(med / rate, 2)})
    return out
