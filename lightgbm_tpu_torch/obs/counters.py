"""Process-wide counter and event registry (``lightgbm_tpu/obs/counters.py``).

Named counters with optional tags, gauges, and a bounded ring of
structured events whose overflow is counted (``events_dropped``).  The
checkpoint, the supervisor and the collectives report through it, under
the JAX package's event names:

* the resume paths (:mod:`lightgbm_tpu_torch.checkpoint`):
  ``checkpoint_skipped`` (iteration and reason for every torn or demoted
  snapshot a scan rejected), ``checkpoint_resume`` (iteration and
  ``kind=single|group``), ``preempt_checkpoint``, ``stale_sweep``;
* the supervisor (:mod:`lightgbm_tpu_torch.supervisor`): ``rank_dead``,
  ``rank_hang``, ``group_restart``, ``restart_budget_exhausted``,
  ``crash_report``;
* the collectives (:mod:`lightgbm_tpu_torch.parallel.sync`): the
  ``collective_retries`` counter, ``collective_retry`` and
  ``stale_epoch_rejected`` events, and ``collective_calls`` /
  ``collective_bytes`` (:mod:`.collectives`);
* the histogram wrappers: ``hist_dispatch`` tagged ``method=``, whose
  dominant tag is :meth:`CounterRegistry.observed_kernel`.

Sinks (:meth:`CounterRegistry.add_sink`) see every event as it is
recorded: the flight recorder (:mod:`.flight`) streams them to disk.  The
trace (:mod:`.trace`), the report and the ``/metrics`` view
(:mod:`.metrics`) read :meth:`CounterRegistry.snapshot`.
"""
from __future__ import annotations

import collections
import threading
from typing import Any, Dict, List, Optional


def _tag_key(tags: Dict[str, Any]) -> str:
    if not tags:
        return ""
    return ",".join(f"{k}={tags[k]}" for k in sorted(tags))


class CounterRegistry:
    """Thread-safe registry: counters[name][tag_key] -> number."""

    # the events are a ring of the newest MAX_EVENTS, so host memory never
    # grows without bound
    MAX_EVENTS = 512

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Dict[str, float]] = {}
        self._events: collections.deque = collections.deque(
            maxlen=self.MAX_EVENTS)
        self._gauges: Dict[str, float] = {}
        self._events_dropped = 0
        self._sinks: List[Any] = []

    # ------------------------------------------------------------- writers

    def inc(self, name: str, value: float = 1, **tags) -> None:
        key = _tag_key(tags)
        with self._lock:
            bucket = self._counters.setdefault(name, {})
            bucket[key] = bucket.get(key, 0) + value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def event(self, name: str, **fields) -> None:
        """Record a structured event, stamped with this process's rank.  At
        capacity the oldest event goes and ``events_dropped`` counts it;
        every sink sees the event, outside the lock."""
        from ..parallel.sync import process_index   # lazy: import cycle
        ev = {"event": name, "proc": process_index(), **fields}
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self._events_dropped += 1
            self._events.append(ev)
            sinks = tuple(self._sinks)
        for sink in sinks:
            try:
                sink(ev)
            except Exception:
                pass             # a telemetry sink never breaks an emitter

    def add_sink(self, fn) -> None:
        """Call ``fn(event)`` for every event recorded from now on."""
        with self._lock:
            if fn not in self._sinks:
                self._sinks.append(fn)

    def remove_sink(self, fn) -> None:
        with self._lock:
            if fn in self._sinks:
                self._sinks.remove(fn)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._events.clear()
            self._events_dropped = 0

    # ------------------------------------------------------------- readers

    def get(self, name: str) -> Dict[str, float]:
        with self._lock:
            return dict(self._counters.get(name, {}))

    def total(self, name: str) -> float:
        with self._lock:
            return sum(self._counters.get(name, {}).values())

    def events(self, name: Optional[str] = None) -> List[dict]:
        with self._lock:
            evs = list(self._events)
        return evs if name is None else [e for e in evs
                                         if e.get("event") == name]

    def events_tail(self, n: int) -> List[dict]:
        """The newest ``n`` events across all names: what a crash report
        writes (checkpoint.write_crash_report)."""
        with self._lock:
            evs = list(self._events)
        return evs[-max(0, int(n)):]

    def events_dropped(self) -> int:
        with self._lock:
            return self._events_dropped

    def snapshot(self) -> Dict[str, Any]:
        """Counters, gauges, events and the overflow count, with this
        process's rank: what the trace embeds and the report reads."""
        from ..parallel.sync import process_index
        with self._lock:
            return {"counters": {n: dict(b)
                                 for n, b in self._counters.items()},
                    "gauges": dict(self._gauges),
                    "events": list(self._events),
                    "events_dropped": self._events_dropped,
                    "process_index": process_index()}

    def observed_kernel(self) -> Optional[str]:
        """The histogram kernel this process dispatched most: the dominant
        ``method=`` tag of ``hist_dispatch``; None before any histogram."""
        per_method: Dict[str, float] = {}
        for key, v in self.get("hist_dispatch").items():
            tags = dict(kv.split("=", 1) for kv in key.split(",") if "=" in kv)
            m = tags.get("method")
            if m:
                per_method[m] = per_method.get(m, 0) + v
        if not per_method:
            return None
        return max(per_method, key=per_method.get)


counters = CounterRegistry()
