"""The port's live telemetry plane (``lightgbm_tpu_torch/obs/flight.py``,
``obs/metrics.py``) and the supervisor's health legs
(``supervisor.py:_metrics_samples``, ``_straggler_check``), held against
the JAX package (``tests/test_metrics.py``).

* The flight recorder streams progress records and the registry's events
  as they happen, rotates at its size limit, tolerates torn tails; its
  readers and the straggler verdicts (``progress_rate``,
  ``detect_stragglers``, ``recent_idle_gap``) give the JAX package's
  answers on the same records, and each package reads the other's
  streams.
* ``render_prometheus`` gives the JAX package's text on the same
  registry; ``parse_prometheus`` inverts it; the exporter serves it; a
  port that cannot be bound raises.
* A training armed with ``obs_stream_path`` and ``metrics_port`` writes
  one progress record an iteration and adds no collective.
* The supervisor's ``/metrics`` carries its budget, its world and each
  rank's heartbeat age; a supervised two-process run with one throttled
  rank raises one ``rank_straggler`` event for it and still completes.
"""
import json
import os
import sys
import urllib.request

import numpy as np
import pytest

from lightgbm_tpu.obs import flight as jflight
from lightgbm_tpu.obs import metrics as jmetrics
from lightgbm_tpu.obs.counters import CounterRegistry as JRegistry
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import checkpoint as ckpt
from lightgbm_tpu_torch import supervisor as sup_mod
from lightgbm_tpu_torch.obs import flight, metrics
from lightgbm_tpu_torch.obs.counters import counters

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {"PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
       "JAX_PLATFORMS": "cpu"}


@pytest.fixture(autouse=True)
def _fresh():
    counters.reset()
    yield
    flight.stop()
    metrics.stop_exporter()


# ---- the flight recorder --------------------------------------------------

def test_recorder_streams_progress_and_events(tmp_path):
    path = flight.stream_path(str(tmp_path / "fl"), 3)
    assert path.endswith(".rank_3")
    fl = flight.start(path, rank=3)
    fl.progress(1, seconds=0.5)
    counters.event("checkpoint_resume", iteration=2)
    assert flight.stop() == path
    counters.event("after_stop")              # no longer a sink
    recs = flight.read_stream(path)
    assert [r["event"] for r in recs] == ["progress", "checkpoint_resume"]
    assert recs[0]["rank"] == 3 and recs[0]["iteration"] == 1
    assert recs[1]["iteration"] == 2 and "epoch" in recs[1]
    assert flight.get_flight() is flight.NULL_FLIGHT
    # the JAX package's reader reads the port's stream, record for record
    assert jflight.read_stream(path) == recs


def test_rotation_and_torn_tail(tmp_path):
    path = str(tmp_path / "s.rank_0")
    fl = flight.FlightRecorder(path, rank=0, max_bytes=4096)
    for i in range(200):
        fl.progress(i, pad="x" * 40)
    fl.close()
    assert os.path.exists(path + ".1")
    assert os.path.getsize(path) <= 4096
    with open(path, "a") as f:
        f.write('{"event": "progress", "iter')
    recs = flight.read_stream(path)
    its = [r["iteration"] for r in recs]
    assert its == sorted(its) and its[-1] == 199
    assert flight.read_stream(path, include_rotated=False)[-1] == recs[-1]
    tail = flight.tail_records(path, max_bytes=1000)
    assert tail == jflight.tail_records(path, max_bytes=1000)
    assert tail and tail[-1]["iteration"] == 199


def _records(seed, ranks=3):
    rng = np.random.default_rng(seed)
    out = {}
    for r in range(ranks):
        rate = rng.uniform(0.5, 4.0) if r else 0.05
        t = 1000.0 + rng.uniform(0, 5)
        recs = []
        for i in range(1, 9):
            t += 1.0 / rate
            rec = {"t": round(t, 3), "rank": r, "event": "progress",
                   "iteration": i}
            if r == 0 and i % 2:
                rec["idle_gap_fraction"] = float(rng.uniform(0, 1))
            recs.append(rec)
        recs.insert(3, {"t": t, "event": "checkpoint_resume"})
        out[r] = recs
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("factor", [1.5, 4.0])
def test_straggler_verdicts_equal_jax(seed, factor):
    recs = _records(seed)
    rates = {r: flight.progress_rate(v) for r, v in recs.items()}
    assert rates == {r: jflight.progress_rate(v) for r, v in recs.items()}
    assert flight.detect_stragglers(rates, factor) == \
        jflight.detect_stragglers(rates, factor)
    for v in recs.values():
        assert flight.recent_idle_gap(v) == jflight.recent_idle_gap(v)
    assert flight.detect_stragglers({0: 1.0, 1: None}, 2.0) == []


def test_records_in_one_write_are_record_lines(tmp_path):
    """``records`` (one write for a tree's split audit) writes the lines
    ``record`` writes, field for field."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    rows = [{"node": i, "gain": 0.5 * i, "feature": f"f{i}"}
            for i in range(5)]
    fa, fb = flight.FlightRecorder(a, rank=1), flight.FlightRecorder(b, rank=1)
    for r in rows:
        fa.record("split_audit", **r)
    fb.records("split_audit", rows)
    fa.close()
    fb.close()
    strip = lambda recs: [{k: v for k, v in r.items() if k != "t"}
                          for r in recs]
    assert strip(flight.read_stream(a)) == strip(flight.read_stream(b))
    flight.NULL_FLIGHT.records("x", rows)


def test_disarmed_recorder_is_a_shared_noop():
    fl = flight.get_flight()
    assert fl is flight.NULL_FLIGHT and not fl.enabled
    fl.progress(1, seconds=1.0)
    fl.record("x")
    assert flight.stop() is None


# ---- the metrics view -----------------------------------------------------

def _fill(reg):
    reg.inc("collective_calls", op="allgather_object", site="parallel/sync")
    reg.inc("collective_bytes", 96, op="allgather_object",
            site="parallel/sync")
    reg.inc("hist_dispatch", 4, method="hist_window")
    reg.inc("metrics_scrapes")
    reg.gauge("memory_peak_bytes", 123456.0)
    reg.gauge("world_size", 2)
    reg.gauge("ratio", 0.25)


@pytest.mark.parametrize("sources", [False, True], ids=["registry",
                                                        "sources"])
def test_render_prometheus_equals_jax(monkeypatch, sources):
    """The same registry contents and sources render the same text (with
    the rank and the capture age pinned, which each package reads from
    its own process)."""
    jreg = JRegistry()
    monkeypatch.setattr(jmetrics, "counters", jreg)
    counters.reset()
    _fill(counters)
    _fill(jreg)
    monkeypatch.setattr(metrics, "_sources", [])
    monkeypatch.setattr(jmetrics, "_sources", [])
    monkeypatch.setattr(metrics, "_last_capture_ts", None)
    monkeypatch.setattr(jmetrics, "_last_capture_ts", None)
    if sources:
        def src():
            return [("phase_seconds", {"phase": "tree"}, 1.5, "counter"),
                    ("phase_steady_ms", {"phase": "tree"}, 12.25, "gauge"),
                    ("rank_heartbeat_age_seconds", {"rank": "1"}, -1.0,
                     "gauge")]
        metrics.register_source(src)
        jmetrics.register_source(src)
    text = metrics.render_prometheus()
    assert text == jmetrics.render_prometheus()
    parsed = metrics.parse_prometheus(text)
    assert parsed == jmetrics.parse_prometheus(text)
    assert parsed["lgbm_tpu_world_size"] == 2
    assert parsed['lgbm_tpu_hist_dispatch_total{method="hist_window"}'] == 4
    assert metrics.snapshot()["samples"] == jmetrics.snapshot()["samples"]


def test_exporter_serves_metrics_and_refuses_a_taken_port():
    exp = metrics.start_exporter(0)
    assert exp.enabled and exp.port > 0
    with urllib.request.urlopen(f"http://127.0.0.1:{exp.port}/metrics",
                                timeout=30) as r:
        assert r.headers["Content-Type"] == metrics.CONTENT_TYPE
        body = r.read().decode()
    assert "lgbm_tpu_process_index 0" in body
    with urllib.request.urlopen(f"http://127.0.0.1:{exp.port}/healthz",
                                timeout=30) as r:
        assert json.loads(r.read()) == {"ok": True}
    metrics.stop_exporter()
    assert metrics.get_exporter() is metrics.NULL_EXPORTER
    import socket
    holder = socket.socket()
    holder.bind(("", 0))
    holder.listen(1)
    try:
        with pytest.raises(RuntimeError, match="cannot bind port"):
            metrics.start_exporter(holder.getsockname()[1])
    finally:
        holder.close()
    assert metrics.get_exporter() is metrics.NULL_EXPORTER


def test_armed_training_streams_one_progress_record_an_iteration(tmp_path):
    """Flight recorder and exporter armed: a progress record an iteration
    with the JAX package's fields, a live scrape of the booster's
    families during training, and no collective added."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((600, 5))
    y = (x[:, 0] > 0).astype(float)
    base = str(tmp_path / "fl")
    scraped = {}

    def scrape(env):
        if env.iteration == 2:
            port = metrics.get_exporter().port
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
                scraped.update(metrics.parse_prometheus(r.read().decode()))
    scrape.before_iteration = True
    p = dict(objective="binary", num_leaves=7, verbose=-1, device="cpu",
             obs_stream_path=base, metrics_port=_free_port(),
             telemetry=True)
    bst = lt.train(p, lt.Dataset(x, y, params=p), 4, verbose_eval=False,
                   valid_sets=[lt.Dataset(x, y, params=p)],
                   callbacks=[scrape])
    stream = flight.read_stream(flight.stream_path(base, 0))
    recs = [r for r in stream if r["event"] == "progress"]
    # the model-quality plane follows telemetry: a split_audit line a split
    audits = [r for r in stream if r["event"] == "split_audit"]
    assert len(audits) == sum(t.num_leaves - 1 for t in bst.inner.models)
    assert {"feature", "gain", "left_count", "right_count"} <= set(audits[0])
    assert [r["iteration"] for r in recs] == [1, 2, 3, 4]
    for k in ("seconds", "trees_per_sec", "ms_per_leaf", "kernel",
              "hbm_peak_bytes"):
        assert k in recs[-1], k
    assert "valid_0:binary_logloss" in recs[-1]["eval"]
    assert scraped["lgbm_tpu_train_iterations"] == 2
    assert scraped['lgbm_tpu_phase_iterations_total{phase="tree"}'] == 2
    assert counters.get("collective_calls") == {}
    assert metrics.get_exporter() is metrics.NULL_EXPORTER


def _free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ---- the supervisor's legs ------------------------------------------------

def test_supervisor_metrics_samples(tmp_path, monkeypatch):
    monkeypatch.setattr(metrics, "_sources", [])
    out = str(tmp_path / "m.txt")
    sup = sup_mod.Supervisor(["true"], out, 2, restart_limit=3)
    hb = ckpt.Heartbeat(ckpt.heartbeat_path(out, 0), 0.0)
    hb.stamp(7, force=True)
    parsed = metrics.parse_prometheus(metrics.render_prometheus())
    assert parsed["lgbm_tpu_restart_budget_remaining"] == 3
    assert parsed["lgbm_tpu_last_restart_unix"] == 0
    assert parsed["lgbm_tpu_supervisor_world"] == 2
    assert parsed["lgbm_tpu_world_size"] == 2
    assert parsed["lgbm_tpu_rank_evicted_total"] == 0
    assert parsed['lgbm_tpu_rank_iteration{rank="0"}'] == 7
    assert parsed['lgbm_tpu_rank_heartbeat_age_seconds{rank="0"}'] >= 0
    assert parsed['lgbm_tpu_rank_heartbeat_age_seconds{rank="1"}'] == -1
    del sup


STRAGGLER_WORKER = r"""
import os, time
import numpy as np
import lightgbm_tpu_torch as lt

rank = int(os.environ["LGBM_TPU_RANK"])
rng = np.random.RandomState(5)
x = rng.randn(300, 6)
y = (x @ rng.randn(6) > 0).astype(float)

def throttle(env):
    if rank == 1:
        time.sleep(0.5)      # alive, beating, but slow

lt.train({"objective": "binary", "num_leaves": 5, "verbose": -1,
          "device": "cpu", "heartbeat_interval": 0.05,
          "obs_stream_path": os.environ["TEST_STREAM"],
          "output_model": os.environ["TEST_SNAP"]},
         lt.Dataset(x, y), 8, verbose_eval=False, callbacks=[throttle])
print("WORKER_DONE", rank, flush=True)
"""


def test_supervised_two_process_straggler_event(tmp_path):
    """Two independent supervised ranks, rank 1 throttled 0.5 s an
    iteration: one ``rank_straggler`` event names it, no restart, and
    both streams carry rank-tagged progress (tests/test_metrics.py:357)."""
    script = tmp_path / "worker.py"
    script.write_text(STRAGGLER_WORKER)
    stream = str(tmp_path / "flight.jsonl")
    sup = sup_mod.Supervisor(
        [sys.executable, str(script)], str(tmp_path / "m.txt"), 2,
        heartbeat_interval=0.05, hang_timeout=120.0, restart_limit=0,
        poll_interval=0.05,
        env=dict(ENV, TEST_STREAM=stream, TEST_SNAP=str(tmp_path / "m.txt")),
        obs_stream=stream, straggler_factor=4.0, straggler_interval=0.2)
    assert sup.run() == 0
    evs = counters.events("rank_straggler")
    assert len(evs) == 1 and evs[0]["rank"] == 1
    assert evs[0]["rate"] < evs[0]["median_rate"]
    assert evs[0]["behind"] >= 4.0
    assert counters.events("group_restart") == []
    for r in (0, 1):
        recs = flight.read_stream(flight.stream_path(stream, r))
        assert any(e["event"] == "progress" and e["rank"] == r
                   for e in recs)


def test_straggler_check_cites_the_idle_gap(tmp_path):
    """A stream whose progress records carry devprof's idle gap: the
    verdict cites its median, as the JAX package's does."""
    stream = str(tmp_path / "fl")
    for r, step in ((0, 0.1), (1, 0.1), (2, 2.0)):
        with open(flight.stream_path(stream, r), "w") as f:
            for i in range(1, 6):
                f.write(json.dumps({"t": 100 + i * step, "rank": r,
                                    "event": "progress", "iteration": i,
                                    "idle_gap_fraction": 0.8}) + "\n")
    sup = sup_mod.Supervisor(["true"], str(tmp_path / "m.txt"), 3,
                             obs_stream=stream, straggler_factor=4.0)
    sup._straggler_check(1e9)
    sup._straggler_check(2e9)          # once an incarnation
    evs = counters.events("rank_straggler")
    assert len(evs) == 1 and evs[0]["rank"] == 2
    assert evs[0]["idle_gap_fraction"] == 0.8
    assert counters.snapshot()["gauges"]["rank_straggler_behind_r2"] == 20.0


def test_streamed_training_records_its_waits(tmp_path):
    """``data_stream=chunked`` with the recorder armed: each progress
    record carries ``stream_wait_ms`` and ``stream_stall_fraction`` (0 on
    the CPU, whose copies are the host slices themselves)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((900, 5))
    y = (x[:, 1] > 0).astype(float)
    base = str(tmp_path / "fl")
    p = dict(objective="binary", num_leaves=5, verbose=-1, device="cpu",
             data_stream="chunked", stream_chunk_rows=256,
             obs_stream_path=base)
    lt.train(p, lt.Dataset(x, y, params=p), 3, verbose_eval=False)
    recs = [r for r in flight.read_stream(flight.stream_path(base, 0))
            if r["event"] == "progress"]
    assert len(recs) == 3
    assert all(r["stream_wait_ms"] == 0 and r["stream_stall_fraction"] == 0
               for r in recs)
