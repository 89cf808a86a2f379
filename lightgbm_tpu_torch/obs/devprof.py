"""Device-time attribution over ``torch.profiler``
(``lightgbm_tpu/obs/devprof.py``).

A host span (:mod:`.trace`, :mod:`..utils.timer`) times the dispatch of
work, not the card's time.  Armed (``device_profile``), this module opens
one ``torch.profiler`` window around each of ``profile_iters``
steady-state boosting iterations, exports the window's Chrome trace,
parses it on the host and attributes the card's kernel time to phases.
The first firing is never profiled: it holds the CUDA-graph capture and
the kernels' first build (the JAX package's compile).  Each window is
parsed when it closes, so its idle-gap fraction (the share of the
window's host time the card was not busy) is known before the flight
recorder's progress record of that iteration is written.

**Attribution by kernel name.**  The JAX package attributes by the
``jax.named_scope`` names XLA carries into its ops.  Here the split step
runs as a replayed CUDA graph, inside which ``record_function`` ranges
do not fire, so a kernel's phase comes from one table,
:data:`KERNEL_PHASES`: the port's own kernel symbols first; then a
PyTorch kernel launched by a ``cudaGraphLaunch`` falls to the split step
(``split_find``: the step's scan and bookkeeping); any other kernel to
the host phase window (``boosting``, ``bagging``, ``tree``, ``score``,
``metric``, mirrored into the capture by the tracer) that holds it.

**Lost records.**  The profiler can drop records on a slow host.  A
window whose trace lost kernel records says so (``records_lost``,
:func:`records_lost`) in its iteration entry and in the summary
(``lossy_windows``), instead of quietly attributing less.

Disarmed, the plane is the shared :data:`NULL_DEVPROF`, whose
``iteration()`` returns the shared :data:`NULL_WINDOW`.  The parsing
layer (:func:`load_trace_events`, :func:`op_events`,
:func:`phase_windows`, :func:`attribute`, :func:`records_lost`) is pure:
the CPU tests feed it synthetic traces.
"""
from __future__ import annotations

import collections
import gzip
import json
import os
import shutil
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

from .counters import counters

SCHEMA_VERSION = 1

# the one table of kernel-name attribution: a device op whose name holds a
# token is that token's phase (first match wins)
KERNEL_PHASES = (
    ("hist_gather", "histogram"),       # K1, csrc/hist_gather.cu
    ("hist_local", "histogram"),        # K3, csrc/hist_local.cu
    ("lgbt_partition", "partition"),    # K2, csrc/partition.cu
    ("lgbt_route", "partition"),        # route_window, route_rows
    ("lgbt_block_route", "partition"),  # route_rows_block
    ("lgbt_cat_group", "split_find"),   # csrc/cat_group.cu
    ("lgbt_lambdarank", "boosting"),    # csrc/lambdarank.cu
    ("lgbt_traverse", "traverse"),      # csrc/traverse.cu, the JAX
    #                                     engine's named_scope("traverse")
    ("lgbt_margin", "predict_margin"),  # csrc/traverse.cu
)
# where a PyTorch kernel launched by a replayed split step goes
GRAPH_PHASE = "split_find"
# host phase windows the tracer mirrors into every capture
HOST_PHASES = ("histogram", "split_find", "partition", "boosting",
               "bagging", "tree", "score", "metric", "predict_bin",
               "predict_traverse", "predict_margin", "serving_batch")
# the Chrome-trace categories of the card's activity in a torch.profiler
# export
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
KERNEL_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                   "cuLaunchKernel", "cuLaunchKernelEx",
                   "cudaLaunchCooperativeKernel")
GRAPH_LAUNCHES = ("cudaGraphLaunch", "cuGraphLaunch")

TOP_K = 10


# ------------------------------------------------------------------ parsing


def load_trace_events(path: str) -> List[dict]:
    """Trace events of a Chrome-trace file: ``.json`` / ``.json.gz`` holding
    ``{"traceEvents": [...]}`` or a bare list, or ``.jsonl`` with one event
    a line (a torn tail is tolerated)."""
    opener = gzip.open if path.endswith(".gz") else open
    if path.endswith(".jsonl"):
        events = []
        with opener(path, "rt") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    events.append(json.loads(line))
                except ValueError:
                    break
        return events
    with opener(path, "rt") as f:
        doc = json.load(f)
    if isinstance(doc, dict):
        return list(doc.get("traceEvents", []))
    return list(doc) if isinstance(doc, list) else []


def _device_pids(events: List[dict]) -> set:
    """Process ids a trace labels as devices (``process_name`` metadata
    naming a GPU or a ``/device:``)."""
    pids = set()
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            name = str((ev.get("args") or {}).get("name", "")).lower()
            if "/device:" in name or name.startswith("gpu"):
                pids.add(ev.get("pid"))
    return pids


def op_events(events: List[dict]) -> List[dict]:
    """Complete ("X") events of the card's activity: kernels, copies and
    fills (:data:`DEVICE_CATS`), or events on a device-labelled process.
    Python frames (``$`` names) and the GPU side of ``record_function``
    ranges are left out."""
    device_pids = _device_pids(events)
    out = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        name = str(ev.get("name", ""))
        cat = str(ev.get("cat", ""))
        if name.startswith("$") or cat == "gpu_user_annotation":
            continue
        if cat in DEVICE_CATS or ev.get("pid") in device_pids:
            out.append(ev)
    return out


def phase_windows(events: List[dict]) -> List[Tuple[float, float, str]]:
    """Host phase windows ``(ts, end, phase)`` of the tracer's
    ``record_function`` ranges, sorted by start."""
    wins = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        if str(ev.get("cat", "")) in DEVICE_CATS + ("gpu_user_annotation",):
            continue
        name = str(ev.get("name", ""))
        if name in HOST_PHASES:
            ts = float(ev.get("ts", 0.0))
            wins.append((ts, ts + float(ev.get("dur", 0.0)), name))
    wins.sort()
    return wins


def _correlation(ev: dict) -> Optional[int]:
    c = (ev.get("args") or {}).get("correlation")
    try:
        return int(c) or None      # CUPTI's ids start at 1
    except (TypeError, ValueError):
        return None


def graph_correlations(events: List[dict]) -> set:
    """Correlation ids of the graph launches (``cudaGraphLaunch``) a trace
    recorded: the kernels carrying one came from a replayed split step."""
    return {c for ev in events
            if ev.get("ph") == "X" and str(ev.get("name", "")) in
            GRAPH_LAUNCHES and (c := _correlation(ev)) is not None}


def kernel_phase(name: str) -> Optional[str]:
    """The phase :data:`KERNEL_PHASES` gives a kernel name, or None."""
    for token, phase in KERNEL_PHASES:
        if token in name:
            return phase
    return None


def _window_phase(ev: dict,
                  wins: List[Tuple[float, float, str]]) -> Optional[str]:
    """The innermost host window holding the op's midpoint; else the one
    overlapping it most; else the last one that began before it (the
    card runs behind the host's dispatch)."""
    ts = float(ev.get("ts", 0.0))
    end = ts + float(ev.get("dur", 0.0))
    mid = (ts + end) / 2.0
    containing = [w for w in wins if w[0] <= mid <= w[1]]
    if containing:
        return min(containing, key=lambda w: w[1] - w[0])[2]
    best, best_ov = None, 0.0
    for w in wins:
        ov = min(end, w[1]) - max(ts, w[0])
        if ov > best_ov:
            best, best_ov = w[2], ov
    if best:
        return best
    before = [w for w in wins if w[0] <= ts]
    return before[-1][2] if before else None


def _busy_us(ops: List[dict], t0: Optional[float] = None,
             t1: Optional[float] = None) -> float:
    """Union length (µs) of the op intervals, clipped to ``[t0, t1]``:
    the card's busy time with overlaps counted once."""
    spans = []
    for ev in ops:
        a = float(ev.get("ts", 0.0))
        b = a + float(ev.get("dur", 0.0))
        if t0 is not None:
            a = max(a, t0)
        if t1 is not None:
            b = min(b, t1)
        if b > a:
            spans.append((a, b))
    spans.sort()
    busy, cur_a, cur_b = 0.0, None, None
    for a, b in spans:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        busy += cur_b - cur_a
    return busy


def lost_records(events: List[dict]) -> Dict[str, int]:
    """The records a trace lost, by kind, from its correlation ids:
    ``launches`` (a kernel launch, :data:`KERNEL_LAUNCHES`, with no kernel
    record), ``kernels`` (a kernel record with no launch record, counted
    only when the trace has launch records at all) and ``graph_kernels``
    (each graph launch's kernels short of the window's fullest graph
    launch: a window replays one split step, whose launches each make the
    same kernels)."""
    launches, kernels, graphs = set(), collections.Counter(), set()
    for ev in events:
        if ev.get("ph") != "X":
            continue
        c = _correlation(ev)
        if c is None:
            continue
        name = str(ev.get("name", ""))
        if str(ev.get("cat", "")) == "kernel":
            kernels[c] += 1
        elif name in KERNEL_LAUNCHES:
            launches.add(c)
        elif name in GRAPH_LAUNCHES:
            graphs.add(c)
    per = [kernels.get(c, 0) for c in graphs]
    return {"launches": sum(1 for c in launches if not kernels.get(c)),
            "kernels": sum(1 for c in kernels if c not in launches
                           and c not in graphs and launches | graphs),
            "graph_kernels": sum(max(per) - n for n in per) if per else 0}


def records_lost(events: List[dict]) -> int:
    """The kernel records a trace lost (:func:`lost_records`, summed)."""
    return sum(lost_records(events).values())


def attribute(events: List[dict], top_k: int = TOP_K,
              ops: Optional[List[dict]] = None,
              graph_corr: Optional[set] = None) -> Dict[str, Any]:
    """The card's op time by phase: kernel names first
    (:data:`KERNEL_PHASES`), then a graph-launched kernel to
    :data:`GRAPH_PHASE`, then the host window.  Returns the phase table,
    the top ``top_k`` ops, each op's count, the totals and the attributed
    share.  ``ops`` and ``graph_corr`` pass already-classified windows
    (the armed profiler keeps those, not whole traces)."""
    if ops is None:
        ops = op_events(events)
    if graph_corr is None:
        graph_corr = graph_correlations(events)
    wins = phase_windows(events)
    phase_us: Dict[str, float] = {}
    per_op: Dict[Tuple[str, str], Dict[str, float]] = {}
    counts: Dict[str, int] = collections.Counter()
    attributed = 0.0
    total = 0.0
    for ev in ops:
        dur = float(ev.get("dur", 0.0))
        total += dur
        name = str(ev.get("name", ""))
        counts[name] += 1
        phase = kernel_phase(name)
        if phase is None and _correlation(ev) in graph_corr:
            phase = GRAPH_PHASE
        if phase is None:
            phase = _window_phase(ev, wins)
        if phase:
            phase_us[phase] = phase_us.get(phase, 0.0) + dur
            attributed += dur
        key = (name, phase or "(unattributed)")
        agg = per_op.setdefault(key, {"us": 0.0, "count": 0})
        agg["us"] += dur
        agg["count"] += 1
    top = sorted(per_op.items(), key=lambda kv: -kv[1]["us"])[:top_k]
    return {
        "phase_device_ms": {p: round(us / 1e3, 4)
                            for p, us in sorted(phase_us.items(),
                                                key=lambda kv: -kv[1])},
        "top_ops": [{"op": name, "phase": phase,
                     "ms": round(agg["us"] / 1e3, 4),
                     "count": int(agg["count"])}
                    for (name, phase), agg in top],
        "op_counts": dict(sorted(counts.items())),
        "op_count": len(ops),
        "total_op_ms": round(total / 1e3, 4),
        "attributed_ms": round(attributed / 1e3, 4),
        "attributed_fraction": round(attributed / total, 4) if total else None,
        "device_busy_ms": round(_busy_us(ops) / 1e3, 4),
    }


# ----------------------------------------------------------------- profiler


class _NullWindow:
    """Shared no-op iteration context (the disarmed fast path)."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_WINDOW = _NullWindow()


class NullDeviceProfiler:
    """Disarmed plane: every operation a no-op; ``iteration()`` hands back
    the shared :data:`NULL_WINDOW`."""
    enabled = False

    def iteration(self, index: int = 0):
        return NULL_WINDOW

    def pop_idle_gap(self) -> Optional[float]:
        return None

    def summary(self) -> Optional[Dict[str, Any]]:
        return None


NULL_DEVPROF = NullDeviceProfiler()


class _IterWindow:
    __slots__ = ("_dp", "_index")

    def __init__(self, dp: "DeviceProfiler", index: int):
        self._dp = dp
        self._index = index

    def __enter__(self):
        self._dp._enter(self._index)
        return self

    def __exit__(self, *exc):
        self._dp._exit(self._index, failed=exc[0] is not None)
        return False


class DeviceProfiler:
    """Armed plane: one ``torch.profiler`` window a profiled iteration,
    exported and parsed when it closes."""
    enabled = True

    def __init__(self, profile_iters: int = 2, top_k: int = TOP_K):
        # each window's exported trace lives here until it is parsed
        self.log_dir = tempfile.mkdtemp(prefix="lgbm_devprof_")
        self.profile_iters = max(1, int(profile_iters))
        self.top_k = top_k
        self._seen = 0            # firings seen (the first is the capture)
        self._prof = None
        self._t_start = 0.0
        self._last_gap: Optional[float] = None
        self.iterations: List[Dict[str, Any]] = []
        # classified as each window closes: the graph launches' correlation
        # ids are a window's own
        self._ops: List[dict] = []
        self._host_events: List[dict] = []
        self._graph_corr: set = set()
        self._lost = 0

    def iteration(self, index: int = 0) -> _IterWindow:
        return _IterWindow(self, index)

    @staticmethod
    def _cuda() -> bool:
        import torch
        return torch.cuda.is_available() and torch.cuda.is_initialized()

    def _enter(self, index: int) -> None:
        self._seen += 1
        if self._seen <= 1 or len(self.iterations) >= self.profile_iters:
            return
        import torch
        import torch.profiler as tp
        acts = [tp.ProfilerActivity.CPU]
        if self._cuda():
            acts.append(tp.ProfilerActivity.CUDA)
            # the window holds this iteration's work only
            torch.cuda.synchronize()
        self._prof = tp.profile(activities=acts)
        self._prof.start()
        self._t_start = time.perf_counter()

    def _exit(self, index: int, failed: bool = False) -> None:
        if self._prof is None:
            return
        import torch
        prof, self._prof = self._prof, None
        if self._cuda():
            torch.cuda.synchronize()
        host_s = time.perf_counter() - self._t_start
        prof.stop()
        if failed:
            return
        path = os.path.join(self.log_dir, "iter_%05d.json" % index)
        prof.export_chrome_trace(path)
        events = load_trace_events(path)
        os.unlink(path)
        ops = op_events(events)
        lost_by = lost_records(events)
        lost = sum(lost_by.values())
        busy_us = _busy_us(ops)
        # the host window runs from the profiler's start to the wait for
        # the card at the window's end
        host_us = host_s * 1e6
        overlap = min(1.0, busy_us / host_us) if host_us > 0 else 0.0
        gap = round(max(0.0, 1.0 - overlap), 4)
        self._last_gap = gap
        self._ops.extend(ops)
        self._graph_corr |= graph_correlations(events)
        self._host_events.extend(
            ev for ev in events if ev.get("ph") == "X"
            and str(ev.get("name")) in HOST_PHASES
            and str(ev.get("cat", "")) not in DEVICE_CATS)
        self._lost += lost
        self.iterations.append({
            "iteration": int(index),
            "host_ms": round(host_s * 1e3, 4),
            "device_busy_ms": round(busy_us / 1e3, 4),
            "overlap_fraction": round(overlap, 4),
            "idle_gap_fraction": gap,
            "records_lost": int(lost),
            "records_lost_by": lost_by,
        })
        counters.event("devprof_capture", iteration=int(index),
                       ops=len(ops), device_busy_ms=round(busy_us / 1e3, 3),
                       idle_gap_fraction=gap, records_lost=int(lost))
        from . import metrics as obs_metrics
        obs_metrics.note_capture()

    def pop_idle_gap(self) -> Optional[float]:
        """The just-profiled iteration's idle-gap fraction, once (the
        progress record takes it)."""
        gap, self._last_gap = self._last_gap, None
        return gap

    def summary(self) -> Optional[Dict[str, Any]]:
        """The ``device_profile`` block: attribution over every window and
        each window's accounting, with the records the windows lost."""
        block: Dict[str, Any] = {
            "schema_version": SCHEMA_VERSION,
            "source": "torch.profiler",
            "profile_iters": self.profile_iters,
            "captured_iterations": len(self.iterations),
            "iterations": list(self.iterations),
            "records_lost": int(self._lost),
            "lossy_windows": sum(1 for it in self.iterations
                                 if it["records_lost"]),
        }
        block.update(attribute(self._host_events, top_k=self.top_k,
                               ops=self._ops, graph_corr=self._graph_corr))
        return block

    def finalize(self) -> Optional[Dict[str, Any]]:
        if self._prof is not None:    # training stopped inside a window
            self._prof.stop()
            self._prof = None
        out = self.summary()
        shutil.rmtree(self.log_dir, ignore_errors=True)
        return out


# ------------------------------------------------- process-wide singleton

_active: Any = NULL_DEVPROF
_last_summary: Optional[Dict[str, Any]] = None


def get_devprof():
    """The process-wide device profiler (NULL_DEVPROF when disarmed)."""
    return _active


def start(profile_iters: int = 2) -> DeviceProfiler:
    """Arm the device-time attribution plane process-wide."""
    global _active
    if isinstance(_active, DeviceProfiler):
        stop()
    _active = DeviceProfiler(profile_iters=profile_iters)
    return _active


def stop() -> Optional[Dict[str, Any]]:
    """Disarm; returns (and keeps) the final ``device_profile`` block."""
    global _active, _last_summary
    dp, _active = _active, NULL_DEVPROF
    if isinstance(dp, DeviceProfiler):
        _last_summary = dp.finalize()
        return _last_summary
    return None


def last_summary() -> Optional[Dict[str, Any]]:
    """The most recent finalized ``device_profile`` block."""
    return _last_summary
