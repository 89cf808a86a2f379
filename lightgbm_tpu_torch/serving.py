"""The serving loop: request coalescing, microbatch dispatch, hot model
swap.  ``python -m lightgbm_tpu_torch.serving`` is the command line.

The host side of the serving path (``lightgbm_tpu/serving.py``; the device
side is :mod:`lightgbm_tpu_torch.inference`):

* **Latency-budget batching.**  Concurrent requests land in one queue; one
  dispatcher thread coalesces them into the largest ``serving_buckets``
  bucket reachable within ``latency_budget_ms`` of the oldest waiting
  request, then runs one microbatch for the whole coalition.  Each
  request's rows stay contiguous, so a request is answered by exactly one
  model: there is no torn read.
* **Hot model swap.**  With ``model_watch`` set, a watcher thread polls the
  checkpoint commit point (``checkpoint.latest_committed_iteration``:
  plain snapshots, or shard sets whose rank-0 manifest validates; either
  package's) and, when a trainer commits a newer iteration, loads the
  model, builds and prewarms its engine off the serving path, and swaps
  it in between microbatches.  A microbatch holds the model it started
  with; the next dispatch takes the new one.  The server builds its own
  engine for each model (never the booster's cached one, which other
  callers share), so its drift windows see only served rows, and the
  new engine's buffer sets are allocated at its prewarm, before the
  swap: a dispatch allocates nothing (``dispatch_allocs`` in the stats).
* **Observability.**  Every dispatch is a trace span and a
  ``predict_dispatch`` counter; the server keeps per-bucket latency
  reservoirs whose p50/p99/QPS summary lands in :meth:`ModelServer.stats`,
  in the trace file as the ``serving stats`` summary (rendered by
  ``python -m lightgbm_tpu_torch.obs``), and on ``GET /metrics``.

The server runs on ``cuda`` unless its params say ``device=cpu``; without
a card it raises.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

import numpy as np

from . import checkpoint as checkpoint_mod
from .config import config_from_params, parse_serving_buckets, resolve_device
from .inference import PredictEngine, jit_entries
from .obs import metrics as obs_metrics
from .obs import trace as obs_trace
from .obs.counters import counters as obs_counters
from .utils import log

# per-bucket latency histogram edges (ms) for the obs report
_HIST_EDGES_MS = (0.5, 1, 2, 5, 10, 20, 50, 100, 500)


class _Request:
    __slots__ = ("x", "future", "t_enq", "raw_score", "n")

    def __init__(self, x: np.ndarray, raw_score: bool):
        self.x = x
        self.n = x.shape[0]
        self.raw_score = raw_score
        self.future: Future = Future()
        self.t_enq = time.perf_counter()


class ServingStats:
    """Per-bucket latency reservoirs and throughput counters
    (thread-safe)."""

    RESERVOIR = 4096

    def __init__(self):
        self._lock = threading.Lock()
        self._lat: Dict[int, collections.deque] = {}
        self._requests = 0
        self._rows = 0
        self._batches = 0
        self._swaps = 0
        self._allocs = 0
        self._t0 = time.perf_counter()

    def record_batch(self, bucket: int, request_latencies_ms: List[float],
                     rows: int, allocs: int = 0) -> None:
        with self._lock:
            self._allocs += allocs
            d = self._lat.setdefault(bucket,
                                     collections.deque(maxlen=self.RESERVOIR))
            d.extend(request_latencies_ms)
            self._requests += len(request_latencies_ms)
            self._rows += rows
            self._batches += 1

    def record_swap(self) -> None:
        with self._lock:
            self._swaps += 1

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            elapsed = max(time.perf_counter() - self._t0, 1e-9)
            buckets = {}
            for b, d in sorted(self._lat.items()):
                lat = np.asarray(d, np.float64)
                hist = {}
                lo = 0.0
                for edge in _HIST_EDGES_MS:
                    hist[f"<={edge}ms"] = int(((lat > lo)
                                               & (lat <= edge)).sum()
                                              + (lo == 0.0) * (lat == 0).sum())
                    lo = edge
                hist[f">{_HIST_EDGES_MS[-1]}ms"] = int(
                    (lat > _HIST_EDGES_MS[-1]).sum())
                buckets[str(b)] = {
                    "count": int(len(lat)),
                    "p50_ms": round(float(np.percentile(lat, 50)), 3),
                    "p99_ms": round(float(np.percentile(lat, 99)), 3),
                    "max_ms": round(float(lat.max()), 3),
                    "hist": hist,
                }
            return {"requests": self._requests, "rows": self._rows,
                    "batches": self._batches, "swaps": self._swaps,
                    "dispatch_allocs": self._allocs,
                    "elapsed_s": round(elapsed, 3),
                    "qps": round(self._requests / elapsed, 2),
                    "rows_per_s": round(self._rows / elapsed, 1),
                    "buckets": buckets}


class ModelServer:
    """Queue, dispatcher and (optional) model watcher around one
    ``inference.PredictEngine`` (``lightgbm_tpu/serving.py:ModelServer``).

    ``submit`` is the asynchronous call (returns a Future), ``predict`` the
    blocking one.  ``start()``/``stop()`` run the threads; constructing
    with ``autostart=False`` and enqueueing before ``start()`` makes the
    coalescing deterministic (the tests do so)."""

    def __init__(self, booster=None, model_file: Optional[str] = None,
                 model_str: Optional[str] = None,
                 params: Optional[Dict[str, Any]] = None,
                 prewarm: bool = True, autostart: bool = True):
        from .basic import Booster
        self.params = dict(params or {})
        cfg = config_from_params(self.params)
        self.device = resolve_device(cfg.device)
        self.latency_budget_s = float(cfg.latency_budget_ms) / 1e3
        self.buckets = parse_serving_buckets(cfg.serving_buckets)
        self.watch_prefix = str(cfg.model_watch or "")
        self.watch_interval = float(cfg.model_watch_interval)
        self.drift_threshold = float(cfg.drift_threshold)
        self.drift_window_rows = int(cfg.drift_window_rows)
        self.traversal = str(cfg.serving_traversal)
        self._drift = None
        if booster is None and model_file is None and model_str is None \
                and not self.watch_prefix:
            raise ValueError("ModelServer needs a booster, model_file, "
                             "model_str, or model_watch prefix")
        if booster is None and (model_file or model_str):
            booster = Booster(params=self.params, model_file=model_file,
                              model_str=model_str)
        self._lock = threading.Lock()
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._booster = None
        self._predictor = None
        self._engine = None
        self.loaded_iteration: Optional[int] = None
        self.stats_ = ServingStats()
        self._running = False
        self._threads: List[threading.Thread] = []
        # the live metrics plane: the per-bucket latency stats become
        # families on GET /metrics, on this server's HTTP front and, with
        # metrics_port set, on a standalone exporter
        obs_metrics.register_source(self._metrics_samples)
        self._own_exporter = None
        if int(cfg.metrics_port) > 0:
            self._own_exporter = obs_metrics.start_exporter(
                int(cfg.metrics_port))
        if booster is not None:
            self._install(booster, iteration=None, prewarm=prewarm)
        elif self.watch_prefix:
            # watch-only start: serve once the trainer commits anything
            if not self._poll_model_watch(prewarm=prewarm):
                log.warning("model_watch: no committed checkpoint under %s "
                            "yet; serving starts after the first commit",
                            self.watch_prefix)
        if autostart:
            self.start()

    # ------------------------------------------------------------- install

    def _install(self, booster, iteration: Optional[int],
                 prewarm: bool) -> None:
        """Build the engine and predictor of ``booster`` and swap them in.
        Everything expensive (flatten, buffers, the kernels' first launch)
        runs before the swap: the dispatcher never waits on it."""
        gbdt = getattr(booster, "inner", booster)
        engine = PredictEngine(gbdt.models, gbdt.num_class,
                               buckets=self.buckets,
                               traversal=self.traversal, device=self.device)
        predictor = gbdt.predictor(self.device, engine=engine)
        # the drift watchdog: armed only when the model text carries a
        # feature_distribution section (written by a training with the
        # model-quality plane armed), attached before the swap so that the
        # first dispatched batch is counted
        drift = None
        dist = getattr(gbdt, "feature_distribution", None)
        if dist:
            from .obs import model_quality as obs_model_quality
            drift = obs_model_quality.DriftMonitor(
                engine.bundle, dist,
                feature_names=list(getattr(gbdt, "feature_names", []) or []),
                threshold=self.drift_threshold,
                window_rows=self.drift_window_rows)
            if drift.enabled:
                engine.drift = drift
            else:
                drift = None
        if prewarm:
            engine.prewarm()
        with self._lock:
            first = self._predictor is None
            self._booster = booster
            self._engine = engine
            self._predictor = predictor
            self._drift = drift
            self.loaded_iteration = iteration
        if not first:
            self.stats_.record_swap()
            obs_counters.inc("serving_model_swap")
        obs_counters.event("model_swap" if not first else "model_load",
                           iteration=iteration,
                           trees=engine.bundle.num_trees,
                           exec=engine.bundle.exec_id())
        log.info("serving: %s model%s (%d trees, exec %s)",
                 "swapped in" if not first else "loaded",
                 f" at iteration {iteration}" if iteration is not None
                 else "", engine.bundle.num_trees, engine.bundle.exec_id())

    def _poll_model_watch(self, prewarm: bool = True) -> bool:
        """One watcher step: load and install a newer committed checkpoint
        if the trainer published one.  True when a swap (or the first
        load) happened."""
        from .boosting import GBDT
        it = checkpoint_mod.latest_committed_iteration(self.watch_prefix)
        if it is None or it == self.loaded_iteration:
            return False
        plain = checkpoint_mod.snapshot_path(self.watch_prefix, it)
        if not os.path.exists(plain):
            # a shard set: rank 0's shard carries the model text, the
            # manifest is the commit point that admitted it
            plain = checkpoint_mod.shard_path(self.watch_prefix, it, 0)
        try:
            model_str, _ = checkpoint_mod.load_snapshot(plain)
            gbdt = GBDT.load_from_string(model_str,
                                         config_from_params(self.params))
        except (checkpoint_mod.CheckpointError, OSError, ValueError) as e:
            # a commit that validates at the manifest but fails to load is
            # reported, never served
            obs_counters.event("model_swap_failed", iteration=it,
                               reason=str(e)[:200])
            log.warning("model_watch: checkpoint at iteration %s failed to "
                        "load (%s); keeping the current model", it, e)
            return False
        self._install(gbdt, iteration=it, prewarm=prewarm)
        return True

    def _watch_loop(self) -> None:
        while self._running:
            time.sleep(self.watch_interval)
            if not self._running:
                return
            try:
                self._poll_model_watch()
            except Exception as e:   # the watcher must never die silently
                obs_counters.event("model_swap_failed", iteration=None,
                                   reason=str(e)[:200])
                log.warning("model_watch poll failed: %s", e)

    # ------------------------------------------------------------ requests

    def submit(self, X, raw_score: bool = False) -> Future:
        x = np.atleast_2d(np.asarray(X, np.float64))
        req = _Request(x, raw_score)
        self._queue.put(req)
        return req.future

    def predict(self, X, raw_score: bool = False):
        return self.submit(X, raw_score).result()

    def stats(self) -> Dict[str, Any]:
        s = self.stats_.summary()
        s["loaded_iteration"] = self.loaded_iteration
        s["predict_jit_entries"] = _jit_entries_gauge()
        drift = self._drift
        if drift is not None:
            s["drift"] = drift.stats()
        return s

    def _metrics_samples(self) -> List[tuple]:
        """This server's ``/metrics`` families: throughput counters, the
        loaded iteration and buffer-set gauges, and per-bucket latency
        (p50/p99/max gauges and a windowed histogram from the reservoir's
        edge counts: the reservoir keeps the newest
        ``ServingStats.RESERVOIR`` latencies).  Host reads only."""
        s = self.stats_.summary()
        # serving_requests, serving_batches and serving_model_swap come
        # from the dispatch path's counters; this source adds the rest
        out = [
            ("serving_rows", {}, float(s["rows"]), "counter"),
            ("serving_loaded_iteration", {},
             float(-1 if self.loaded_iteration is None
                   else self.loaded_iteration), "gauge"),
            ("serving_jit_entries", {}, float(jit_entries()), "gauge"),
        ]
        for bucket, rec in s.get("buckets", {}).items():
            labels = {"bucket": bucket}
            for q in ("p50_ms", "p99_ms", "max_ms"):
                out.append((f"serving_{q}", labels, float(rec[q]), "gauge"))
            cum = 0.0
            for edge in _HIST_EDGES_MS:
                cum += float(rec["hist"].get(f"<={edge}ms", 0))
                out.append(("serving_latency_ms_bucket",
                            dict(labels, le=str(edge)), cum, "gauge"))
            out.append(("serving_latency_ms_bucket",
                        dict(labels, le="+Inf"), float(rec["count"]),
                        "gauge"))
            out.append(("serving_latency_ms_count", labels,
                        float(rec["count"]), "gauge"))
        drift = self._drift
        if drift is not None:
            out.extend(drift.samples())
        return out

    # ---------------------------------------------------------- dispatcher

    def _collect(self) -> Optional[List[_Request]]:
        """Wait for the next request, then coalesce companions until the
        largest bucket is full or ``latency_budget_ms`` from the first
        queued request has passed.  Requests already queued join even
        past the deadline: they cost the coalition no wait.  (The JAX
        package stops at the deadline, so under a backlog older than the
        budget it serves one request a microbatch.)"""
        try:
            first = self._queue.get(timeout=0.1)
        except queue.Empty:
            return None
        batch = [first]
        rows = first.n
        deadline = first.t_enq + self.latency_budget_s
        max_rows = self.buckets[-1]
        while rows < max_rows:
            remaining = deadline - time.perf_counter()
            try:
                nxt = (self._queue.get(timeout=remaining) if remaining > 0
                       else self._queue.get_nowait())
            except queue.Empty:
                break
            batch.append(nxt)
            rows += nxt.n
        return batch

    def _serve_batch(self, batch: List[_Request], predictor) -> None:
        """One coalesced microbatch on the model ``predictor`` (taken by
        the caller before any swap could land): every request of the
        coalition is answered by that one model."""
        rows = sum(r.n for r in batch)
        tracer = obs_trace.get_tracer()
        with tracer.span("serving_batch", requests=len(batch), rows=rows):
            x = batch[0].x if len(batch) == 1 else \
                np.concatenate([r.x for r in batch], axis=0)
            # raw and transformed requests coalesce: the transform is a
            # host step on the raw scores
            allocs = predictor.engine.dispatch_allocs
            raw = predictor.predict_raw(x)
            allocs = predictor.engine.dispatch_allocs - allocs
            done_t = time.perf_counter()
            lo = 0
            lats = []
            for r in batch:
                sl = raw[:, lo:lo + r.n]
                lo += r.n
                try:
                    r.future.set_result(
                        predictor._transform(sl, raw_score=r.raw_score))
                except Exception as e:      # a transform fault, per request
                    r.future.set_exception(e)
                lats.append((done_t - r.t_enq) * 1e3)
        bucket = next((b for b in self.buckets if rows <= b),
                      self.buckets[-1])
        self.stats_.record_batch(bucket, lats, rows, allocs)
        obs_counters.inc("serving_requests", len(batch))
        obs_counters.inc("serving_batches", bucket=bucket)

    def _dispatch_loop(self) -> None:
        while self._running:
            batch = self._collect()
            if batch is None:
                continue
            with self._lock:          # the model of this coalition
                predictor = self._predictor
            if predictor is None:
                for r in batch:
                    r.future.set_exception(
                        RuntimeError("no model loaded yet (model_watch saw "
                                     "no committed checkpoint)"))
                continue
            try:
                self._serve_batch(batch, predictor)
            except Exception as e:
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "ModelServer":
        if self._running:
            return self
        self._running = True
        t = threading.Thread(target=self._dispatch_loop,
                             name="lgbm-serving-dispatch", daemon=True)
        t.start()
        self._threads = [t]
        if self.watch_prefix:
            w = threading.Thread(target=self._watch_loop,
                                 name="lgbm-serving-watch", daemon=True)
            w.start()
            self._threads.append(w)
        return self

    def stop(self) -> Dict[str, Any]:
        """Stop the threads, write the ``serving stats`` summary to the
        trace, and return the final stats."""
        self._running = False
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []
        if self._own_exporter is not None:
            # only the exporter this server armed
            if obs_metrics.get_exporter() is self._own_exporter:
                obs_metrics.stop_exporter()
            self._own_exporter = None
        s = self.stats()
        obs_trace.get_tracer().summary("serving stats", s)
        return s


def _jit_entries_gauge() -> int:
    n = jit_entries()
    obs_counters.gauge("predict_jit_entries", n)
    return n


# --------------------------------------------------------------------- CLI


def _http_server(server: ModelServer, port: int):
    """A small stdlib HTTP front on ``port`` (0: an ephemeral one), not
    yet serving: POST /predict {"data": [[...]...]} -> {"predictions":
    [...]}; GET /stats, GET /healthz, GET /metrics (Prometheus text, the
    live telemetry plane's scrape point)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, payload) -> None:
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path.startswith("/healthz"):
                self._json(200, {"ok": server._predictor is not None,
                                 "loaded_iteration":
                                     server.loaded_iteration})
            elif self.path.startswith("/stats"):
                self._json(200, server.stats())
            elif self.path.startswith("/metrics"):
                obs_counters.inc("metrics_scrapes")
                body = obs_metrics.render_prometheus().encode()
                self.send_response(200)
                self.send_header("Content-Type", obs_metrics.CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if not self.path.startswith("/predict"):
                self._json(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(n) or b"{}")
                x = np.asarray(body["data"], np.float64)
                out = server.predict(x, raw_score=bool(
                    body.get("raw_score", False)))
                self._json(200, {"predictions": np.asarray(out).tolist()})
            except Exception as e:     # a bad request answers 400
                self._json(400, {"error": str(e)[:500]})

        def log_message(self, fmt, *args):   # through the package's logger
            log.debug("serving http: " + fmt, *args)

    httpd = ThreadingHTTPServer(("", port), Handler)
    log.info("serving: HTTP on port %d (POST /predict, GET /stats, "
             "GET /healthz)", httpd.server_address[1])
    return httpd


def _run_http(server: ModelServer, port: int) -> None:
    """Serve :func:`_http_server`'s front until interrupted."""
    httpd = _http_server(server, port)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


def _run_replay(server: ModelServer, n_requests: int, n_features: int,
                seed: int = 0) -> Dict[str, Any]:
    """A synthetic replay of mixed-size requests against a live server:
    the buffer-set and latency smoke."""
    rng = np.random.RandomState(seed)
    sizes = rng.choice([1, 1, 3, 8, 17, 64, 200, 512, 1500, 4096],
                       size=n_requests)
    futures = [server.submit(rng.randn(int(s), n_features))
               for s in sizes]
    for f in futures:
        f.result(timeout=300)
    return server.stats()


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lightgbm_tpu_torch.serving",
        description="Model server on a CUDA card (or the CPU)")
    ap.add_argument("--model", help="model text file to serve")
    ap.add_argument("--watch", default="",
                    help="checkpoint prefix (trainer output_model) to hot-"
                         "swap from (model_watch param)")
    ap.add_argument("--port", type=int, default=8080,
                    help="HTTP port (ignored under --replay)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="standalone Prometheus exporter port (the "
                         "metrics_port param; GET /metrics also rides "
                         "the main HTTP front)")
    ap.add_argument("--latency-budget-ms", type=float, default=None)
    ap.add_argument("--buckets", default=None,
                    help="serving_buckets ladder, e.g. 1,8,64,512,4096")
    ap.add_argument("--watch-interval", type=float, default=None)
    ap.add_argument("--replay", type=int, default=0, metavar="N",
                    help="serve N synthetic mixed-size requests, print the "
                         "stats JSON, exit")
    ap.add_argument("--features", type=int, default=28,
                    help="synthetic replay feature count")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the engine runs (default cuda; no card "
                         "raises)")
    args = ap.parse_args(argv)
    if not args.model and not args.watch:
        ap.error("need --model and/or --watch")
    params: Dict[str, Any] = {"verbose": -1, "device": args.device}
    if args.latency_budget_ms is not None:
        params["latency_budget_ms"] = args.latency_budget_ms
    if args.buckets:
        params["serving_buckets"] = args.buckets
    if args.watch:
        params["model_watch"] = args.watch
    if args.watch_interval is not None:
        params["model_watch_interval"] = args.watch_interval
    if args.metrics_port is not None:
        params["metrics_port"] = args.metrics_port
    server = ModelServer(model_file=args.model or None, params=params)
    if args.replay:
        stats = _run_replay(server, args.replay, args.features)
        server.stop()
        print(json.dumps(stats))
        return 0
    _run_http(server, args.port)
    server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
