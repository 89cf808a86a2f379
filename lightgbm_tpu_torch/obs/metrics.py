"""The live metrics plane (``lightgbm_tpu/obs/metrics.py``): a
process-wide Prometheus view of the telemetry registry, scrapeable while
training runs.

One view is derived from the counters and gauges of
:mod:`.counters`, the phase timers' steady-state means, the memory
monitor's gauges and the components' live sources, rendered in the
Prometheus text exposition format (``text/plain; version=0.0.4``), and
served by a standalone exporter thread (``metrics_port``; rank R binds
``metrics_port + R``, the supervisor binds its own port).

A scrape reads host state only: counter dicts, wall-clock totals and
files.  Rendering touches no device and issues no collective.  Disarmed,
the active exporter is the shared :data:`NULL_EXPORTER`.

Components register sample *sources* (:func:`register_source`, weakly
referenced): each booster its phase-timer families, the supervisor
its restart and heartbeat gauges, the model-quality tracker its
per-feature gains.  A source returns ``[(name, labels, value, type),
...]``; names get the ``lgbm_tpu_`` prefix (the JAX package's families,
so one dashboard reads either package) and are sanitized at render time.
"""
from __future__ import annotations

import json
import re
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

from .counters import counters

PREFIX = "lgbm_tpu_"
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
# stamped into snapshot() blocks (bench JSONs, obs_diff artifacts) so a
# consumer can tell when the sample vocabulary changed shape
SCHEMA_VERSION = 1

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_OK = re.compile(r"[^a-zA-Z0-9_]")


def sanitize_name(name: str) -> str:
    name = _NAME_OK.sub("_", str(name))
    if not name or name[0].isdigit():
        name = "_" + name
    return name


def _label_value(v: Any) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _format_labels(labels: Dict[str, Any]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{_LABEL_OK.sub("_", str(k))}="{_label_value(v)}"'
        for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt(v: Any) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def _split_tags(key: str) -> Dict[str, str]:
    return dict(kv.split("=", 1) for kv in key.split(",") if "=" in kv)


# ------------------------------------------------------------------ sources

# weakly referenced zero-arg callables returning
# [(name, labels, value, type), ...]; dead components drop out on render
_sources: List[Any] = []


def register_source(fn: Callable[[], list]) -> None:
    """Register a live sample source (bound methods via ``WeakMethod`` so
    a source never keeps its component alive)."""
    try:
        ref = weakref.WeakMethod(fn)
    except TypeError:
        ref = weakref.ref(fn)
    _sources.append(ref)


def _collect_sources() -> List[Tuple[str, Dict[str, Any], float, str]]:
    out: List[Tuple[str, Dict[str, Any], float, str]] = []
    live = []
    for ref in _sources:
        fn = ref()
        if fn is None:
            continue
        live.append(ref)
        try:
            out.extend(fn())
        except Exception:
            # a scrape must never fail because one component is mid-
            # teardown; the remaining families still render
            continue
    _sources[:] = live
    return out


# ------------------------------------------------------------ capture age

# wall-clock of the newest on-chip evidence (a devprof capture window or
# an explicitly noted profile/capture artifact); None = never this process
_last_capture_ts: Optional[float] = None


def note_capture(ts: Optional[float] = None) -> None:
    """Record that fresh device-profile evidence was just captured
    (called by :mod:`.devprof` per completed window)."""
    global _last_capture_ts
    _last_capture_ts = time.time() if ts is None else float(ts)


def last_capture_age() -> float:
    """Seconds since the newest capture, or -1 when none happened — the
    early warning of stale device evidence: a scrape answers "is the
    on-card evidence stale?" without reading artifacts."""
    if _last_capture_ts is None:
        return -1.0
    # whole-second resolution: staleness is a minutes/hours question, and
    # back-to-back scrapes (snapshot vs a live GET) must agree sample-wise
    return float(int(max(0.0, time.time() - _last_capture_ts)))


# ---------------------------------------------------------------- rendering


def _families() -> Dict[str, Tuple[str, Dict[str, float]]]:
    """The full metrics view as ``{metric: (type, {label_str: value})}``.

    Counter families (registry counters + source counters) sum across
    duplicate series (two boosters contributing the same phase counter);
    gauge duplicates resolve last-wins.
    """
    fams: Dict[str, Tuple[str, Dict[str, float]]] = {}

    def add(name: str, labels: Dict[str, Any], value: float,
            mtype: str) -> None:
        metric = PREFIX + sanitize_name(name)
        if mtype == "counter" and not metric.endswith("_total"):
            metric += "_total"
        mtype0, series = fams.setdefault(metric, (mtype, {}))
        key = _format_labels(labels)
        if mtype0 == "counter" and key in series:
            series[key] += float(value)
        else:
            series[key] = float(value)

    snap = counters.snapshot()
    for name, buckets in snap["counters"].items():
        for key, v in buckets.items():
            add(name, _split_tags(key), v, "counter")
    for name, v in snap["gauges"].items():
        add(name, {}, v, "gauge")
    add("events_dropped", {}, snap["events_dropped"], "counter")
    add("process_index", {}, snap["process_index"], "gauge")
    add("last_capture_age_seconds", {}, last_capture_age(), "gauge")
    for name, labels, value, mtype in _collect_sources():
        add(name, dict(labels or {}), value, mtype)
    return fams


def render_prometheus() -> str:
    """The whole metrics view in Prometheus text exposition format."""
    lines: List[str] = []
    for metric, (mtype, series) in sorted(_families().items()):
        lines.append(f"# TYPE {metric} "
                     f"{'counter' if mtype == 'counter' else 'gauge'}")
        for key, v in sorted(series.items()):
            lines.append(f"{metric}{key} {_fmt(v)}")
    return "\n".join(lines) + "\n"


def snapshot() -> Dict[str, Any]:
    """Machine-readable twin of :func:`render_prometheus`: a flat
    ``{"<metric>{labels}": value}`` sample map plus the schema version —
    what ``bench.py`` embeds as the ``metrics_snapshot`` block and
    ``scripts/obs_diff.py`` compares."""
    samples: Dict[str, float] = {}
    for metric, (_, series) in _families().items():
        for key, v in series.items():
            samples[metric + key] = v
    return {"schema_version": SCHEMA_VERSION, "samples": samples}


def parse_prometheus(text: str) -> Dict[str, float]:
    """Inverse of :func:`render_prometheus` (sample-name fidelity only):
    ``{"metric{labels}": value}``.  Comment/blank lines are skipped;
    malformed lines are tolerated (a torn scrape is still comparable)."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            key, val = line.rsplit(" ", 1)
            out[key] = float(val)
        except ValueError:
            continue
    return out


# ----------------------------------------------------------------- exporter


class NullExporter:
    """Disarmed exporter (the shared no-op singleton)."""
    enabled = False
    port: Optional[int] = None

    def stop(self) -> None:
        pass


NULL_EXPORTER = NullExporter()


class MetricsExporter:
    """Standalone scrape endpoint: one daemon thread serving
    ``GET /metrics`` (Prometheus text) and ``GET /healthz`` (JSON).
    ``port`` is the actually bound port (pass 0 for an ephemeral one —
    the *param* value 0 means "off" and never reaches here)."""
    enabled = True

    def __init__(self, port: int, host: str = ""):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from ..utils import log

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):       # noqa: N802 - stdlib API name
                if self.path.startswith("/metrics"):
                    body = render_prometheus().encode()
                    ctype = CONTENT_TYPE
                    code = 200
                    counters.inc("metrics_scrapes")
                elif self.path.startswith("/healthz"):
                    body = json.dumps({"ok": True}).encode()
                    ctype = "application/json"
                    code = 200
                else:
                    body = b"unknown path; try /metrics\n"
                    ctype = "text/plain"
                    code = 404
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                log.debug("metrics exporter: " + fmt, *args)

        self._httpd = ThreadingHTTPServer((host, int(port)), Handler)
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="lgbm-metrics-exporter",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


_active: Any = NULL_EXPORTER


def get_exporter():
    """The process-wide active exporter (NULL_EXPORTER when disarmed)."""
    return _active


def start_exporter(port: int):
    """Arm the process-wide exporter on ``port`` (0 = ephemeral).  A port
    that cannot be bound raises, naming it: the port has no hidden
    fallback, and a run that asked for live metrics does not go on
    without them (the JAX package warns and disarms)."""
    global _active
    from ..utils import log
    stop_exporter()
    try:
        _active = MetricsExporter(port)
    except OSError as e:
        raise RuntimeError(f"metrics exporter: cannot bind port {port} "
                           f"({e})") from e
    log.info("metrics exporter: GET /metrics on port %d", _active.port)
    return _active


def stop_exporter() -> None:
    """Disarm and release the port (idempotent)."""
    global _active
    exp, _active = _active, NULL_EXPORTER
    exp.stop()
