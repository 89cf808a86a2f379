"""Phase timers (``lightgbm_tpu/utils/timer.py``).

The reference accumulates per-phase ``std::chrono`` counters under
``#ifdef TIMETAG`` (``serial_tree_learner.cpp:10-37``, ``gbdt.cpp:22-64``).
Here they are always on (one clock read a phase) and each phase is
mirrored into the telemetry tracer (:mod:`..obs.trace`): the shared no-op
when telemetry is off, a Chrome-trace span and a
``torch.profiler.record_function`` range when it is on.

A phase times the host's dispatch: nothing here waits for the device, so
on a card a phase's seconds are the time to queue its work, and the time
the card takes lands in the phase whose host read waits for it (the
tree's copy to the host in ``tree``).  The first firing of a phase
includes the CUDA-graph capture and the kernels' first build;
:meth:`PhaseTimers.steady_means` leaves it out.
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict

from ..obs import memory as obs_memory
from ..obs import trace as obs_trace
from . import log


class PhaseTimers:
    """Accumulating wall-clock counters keyed by phase name."""

    def __init__(self):
        self.seconds: Dict[str, float] = collections.defaultdict(float)
        self.counts: Dict[str, int] = collections.defaultdict(int)
        # each phase's first duration: the one that holds the capture
        self.first: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        span = obs_trace.get_tracer().span(name)
        span.__enter__()
        try:
            yield
        finally:
            # the phase's peak device bytes on the span (a no-op unless the
            # tracer and the memory monitor are both armed; a host read)
            obs_memory.get_memory().annotate(span)
            span.__exit__(None, None, None)
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        self.seconds[name] += seconds
        self.counts[name] += 1
        self.first.setdefault(name, seconds)

    def steady_means(self) -> Dict[str, float]:
        """Mean seconds a phase with its first firing (the capture) left
        out; a phase that fired once reports that firing."""
        out: Dict[str, float] = {}
        for name, total in list(self.seconds.items()):
            n = self.counts.get(name, 0)
            first = self.first.get(name, 0.0)
            out[name] = ((total - first) / (n - 1)) if n > 1 \
                else (first if n else 0.0)
        return out

    def report(self, header: str = "phase timers") -> str:
        parts = [f"{k}: {v:.3f}s/{self.counts[k]}x"
                 for k, v in sorted(self.seconds.items(),
                                    key=lambda kv: -kv[1])]
        text = f"{header}: " + ", ".join(parts) if parts \
            else f"{header}: (empty)"
        log.debug("%s", text)
        obs_trace.get_tracer().summary(header, {
            "seconds": dict(self.seconds), "counts": dict(self.counts)})
        return text

    def reset(self) -> None:
        self.seconds.clear()
        self.counts.clear()
        self.first.clear()
