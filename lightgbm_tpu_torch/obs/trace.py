"""Nested-span tracer: Chrome-trace JSON/JSONL out
(``lightgbm_tpu/obs/trace.py``).

One process-wide active tracer (:func:`start` / :func:`stop` /
:func:`get_tracer`):

* **disabled** (the default) it is a :class:`NullTracer` whose ``span()``
  returns ONE shared no-op context manager: an instrumented phase costs a
  lookup and two no-op calls, and allocates nothing;
* **enabled** it records wall-clock spans as Chrome trace events
  (``ph: "X"``, microsecond ``ts``/``dur``) and mirrors every span into
  ``torch.profiler.record_function``, so that host spans line up with a
  ``torch.profiler`` capture (``profile_dir``, :mod:`.devprof`).

A ``*.jsonl`` path gets one event object per line (a killed process still
leaves a readable prefix); any other path the standard
``{"traceEvents": [...], "otherData": {...}}`` object.  Summary payloads
(the counter snapshot, the metrics snapshot, phase-timer totals, the
device profile, the model-quality summary) ride as instant events named
``telemetry.summary``, so one file carries the whole story;
:mod:`.report` renders it.

The split step's ``split_find`` span (``grower.py:LeafPool.find``) fires
where its Python runs: once per CUDA-graph capture on the graph loops,
never at a replay; its events say so with ``traced=True``, as the JAX
package's fire once per compilation.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional


def process_index() -> int:
    """This process's rank in its training group (0 alone): traces of
    several ranks stay distinguishable after they are merged."""
    from ..parallel.sync import process_index as rank    # lazy: cycle
    return rank()


class _NullSpan:
    """Shared no-op context manager (the disabled fast path)."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every operation is a no-op; ``span()`` hands back
    the one shared :data:`NULL_SPAN`."""
    enabled = False
    path: Optional[str] = None

    def span(self, name: str, **args):
        return NULL_SPAN

    def instant(self, name: str, **args) -> None:
        pass

    def summary(self, name: str, payload: Dict[str, Any]) -> None:
        pass

    def events(self) -> List[dict]:
        return []


NULL_TRACER = NullTracer()


class _Span:
    __slots__ = ("_tr", "_name", "_args", "_ts", "_rf")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tr = tracer
        self._name = name
        self._args = args
        self._ts = 0.0
        self._rf = None

    def __enter__(self):
        from torch.profiler import record_function
        self._rf = record_function(self._name)
        self._rf.__enter__()
        self._ts = self._tr._now_us()
        return self

    def __exit__(self, *exc):
        dur = self._tr._now_us() - self._ts
        self._rf.__exit__(*exc)
        ev = {"name": self._name, "ph": "X", "ts": round(self._ts, 3),
              "dur": round(dur, 3), "pid": self._tr.pid,
              "proc": self._tr.proc, "tid": threading.get_ident()}
        if self._args:
            ev["args"] = self._args
        self._tr._append(ev)
        return False


class Tracer:
    """Recording tracer.  Thread-safe; timestamps are microseconds since
    construction (``perf_counter``, like the phase timers)."""
    enabled = True

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.pid = os.getpid()
        self.proc = process_index()
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._events: List[dict] = []

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _append(self, ev: dict) -> None:
        with self._lock:
            self._events.append(ev)

    def span(self, name: str, **args) -> _Span:
        """One complete ("X") event; nesting is ts/dur containment, as
        Chrome and Perfetto rebuild it."""
        return _Span(self, name, args)

    def instant(self, name: str, **args) -> None:
        ev = {"name": name, "ph": "i", "s": "p",
              "ts": round(self._now_us(), 3), "pid": self.pid,
              "proc": self.proc, "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        self._append(ev)

    def summary(self, name: str, payload: Dict[str, Any]) -> None:
        """A structured payload as a ``telemetry.summary`` instant."""
        self.instant("telemetry.summary", kind=name, **{"payload": payload})

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def write(self, path: Optional[str] = None) -> Optional[str]:
        """Write the trace to ``path`` (default: the constructor's), with a
        final metrics snapshot and counter snapshot so that the file
        stands alone."""
        path = path or self.path
        from .counters import counters
        from . import metrics as obs_metrics
        self.summary("metrics", obs_metrics.snapshot())
        self.summary("counters", counters.snapshot())
        if not path:
            return None
        events = self.events()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            if path.endswith(".jsonl"):
                for ev in events:
                    f.write(json.dumps(ev, default=str) + "\n")
            else:
                json.dump({"traceEvents": events,
                           "otherData": {"producer": "lightgbm_tpu_torch.obs"}},
                          f, default=str)
        return path


_active: Any = NULL_TRACER


def get_tracer():
    """The process-wide active tracer (NullTracer when telemetry is off)."""
    return _active


def start(path: Optional[str] = None) -> Tracer:
    """Install a recording tracer as the process-wide active one."""
    global _active
    _active = Tracer(path)
    return _active


def stop() -> Optional[str]:
    """Write the active trace (if it has a path) and disable tracing;
    returns the written path or None."""
    global _active
    tr, _active = _active, NULL_TRACER
    if isinstance(tr, Tracer):
        return tr.write()
    return None


@contextlib.contextmanager
def tracing(path: Optional[str] = None):
    """``with tracing("t.json"):`` enables tracing for a block and writes
    on exit."""
    tr = start(path)
    try:
        yield tr
    finally:
        stop()
