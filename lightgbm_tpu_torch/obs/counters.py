"""Process-wide counter and event registry (``lightgbm_tpu/obs/counters.py``).

Named counters with optional tags and a bounded ring of structured
events.  The checkpoint, the supervisor and the collectives
report through it, under the JAX package's event names:

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
  ``collective_bytes`` of the host-object collectives.

The trace, flight recorder and metrics exporter that read this registry
in the JAX package belong to the observability item (ROADMAP.md §1.6).
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

    # ------------------------------------------------------------- writers

    def inc(self, name: str, value: float = 1, **tags) -> None:
        key = _tag_key(tags)
        with self._lock:
            bucket = self._counters.setdefault(name, {})
            bucket[key] = bucket.get(key, 0) + value

    def event(self, name: str, **fields) -> None:
        """Record a structured event, stamped with this process's rank."""
        from ..parallel.sync import process_index   # lazy: import cycle
        ev = {"event": name, "proc": process_index(), **fields}
        with self._lock:
            self._events.append(ev)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._events.clear()

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


counters = CounterRegistry()
