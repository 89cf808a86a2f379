"""The port's observability plane (``lightgbm_tpu_torch/obs/``): the
tracer, the phase timers, the memory monitor, the collectives' counts,
the report and the model-quality tracker, held against the JAX package
(``tests/test_obs.py``, ``tests/test_model_quality.py``).

* The tracer writes Chrome-trace JSON and JSONL (spans nested by
  containment, ``telemetry.summary`` instants with the counter and
  metrics snapshots) and, disarmed, hands back one shared no-op span.
* The phase timers' steady-state means equal the JAX package's on the same
  durations; a training's trace carries its phases, the ``split_find``
  span (``traced``) and the counters.
* The memory monitor samples the registered boosters' census on the CPU
  and leaves a ``memory_summary`` event at stop.
* The collectives' counts have one home (``obs/collectives.py``): the
  host-object collectives and ``intercept`` over ``torch.distributed``.
* The report (markdown and ``--json``) renders the same text in both
  packages from the same trace files, one rank or several; the port's
  training trace renders through the JAX package's report too.
* With ``model_quality=on`` the model text (with its
  ``feature_distribution:`` section) equals the JAX package's on integer
  trees, and the section parses back.
"""
import json
import os
import tracemalloc

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.obs import model_quality as jmq
from lightgbm_tpu.obs import report as jreport
from lightgbm_tpu.utils.timer import PhaseTimers as JPhaseTimers
from lightgbm_tpu_torch.obs import collectives, memory
from lightgbm_tpu_torch.obs import model_quality as mq
from lightgbm_tpu_torch.obs import report
from lightgbm_tpu_torch.obs import trace as obs_trace
from lightgbm_tpu_torch.obs.counters import counters
from lightgbm_tpu_torch.parallel import sync
from lightgbm_tpu_torch.utils.timer import PhaseTimers


@pytest.fixture(autouse=True)
def _fresh():
    counters.reset()
    yield
    obs_trace.stop()
    memory.stop()


def _problem(n=800, f=5, seed=3):
    rng = np.random.RandomState(seed)
    x = (rng.randint(0, 16, size=(n, f)) / 2.0).astype(np.float64)
    y = (x @ rng.randn(f) > 0).astype(np.float64)
    return x, y


def _int_fobj(preds, ds):
    y = np.asarray(ds.get_label(), np.float64)
    g = np.where(y > 0, -2.0, 1.0) + np.mod(np.floor(
        np.asarray(preds, np.float64) * 4.0), 3.0)
    return g, np.ones_like(g)


# ---- the tracer -----------------------------------------------------------

def test_span_nesting_and_chrome_json(tmp_path):
    path = str(tmp_path / "t.json")
    with obs_trace.tracing(path) as tr:
        with tr.span("outer", a=1):
            with tr.span("inner"):
                pass
        tr.instant("mark", k="v")
    with open(path) as f:
        doc = json.load(f)
    evs = {e["name"]: e for e in doc["traceEvents"]}
    assert doc["otherData"]["producer"] == "lightgbm_tpu_torch.obs"
    o, i = evs["outer"], evs["inner"]
    assert o["ph"] == i["ph"] == "X" and o["args"] == {"a": 1}
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
    kinds = [e["args"]["kind"] for e in doc["traceEvents"]
             if e["name"] == "telemetry.summary"]
    assert kinds == ["metrics", "counters"]
    assert obs_trace.get_tracer() is obs_trace.NULL_TRACER


def test_jsonl_output_and_partial_tolerance(tmp_path):
    path = str(tmp_path / "t.jsonl")
    with obs_trace.tracing(path) as tr:
        with tr.span("a"):
            pass
    with open(path, "a") as f:
        f.write('{"name": "torn", "ph"')        # a killed writer's tail
    evs = report.load_events(path)
    assert evs[0]["name"] == "a"
    assert all(e["name"] != "torn" for e in evs)


def test_disabled_tracer_is_allocation_free():
    obs_trace.stop()
    t = obs_trace.get_tracer()
    assert t is obs_trace.NULL_TRACER and not t.enabled
    assert t.span("a", x=1) is t.span("b") is obs_trace.NULL_SPAN
    tracemalloc.start()
    snap0 = tracemalloc.take_snapshot()
    for _ in range(1000):
        with t.span("hot"):
            pass
    grown = sum(s.size_diff for s in tracemalloc.take_snapshot()
                .compare_to(snap0, "filename")
                if s.traceback[0].filename == obs_trace.__file__)
    tracemalloc.stop()
    assert grown <= 0
    t.instant("nope")
    t.summary("nope", {})
    assert t.events() == []


def test_spans_mirror_into_torch_profiler():
    """An armed span is a ``record_function`` range of a profiler window:
    what devprof's host phase windows are made of."""
    import torch.profiler as tp
    with obs_trace.tracing() as tr, tp.profile(
            activities=[tp.ProfilerActivity.CPU]) as prof:
        with tr.span("zz_mirrored"):
            torch.ones(4).sum()
    assert any(e.key == "zz_mirrored" for e in prof.key_averages())


# ---- the phase timers -----------------------------------------------------

@pytest.mark.parametrize("durs", [[0.5, 0.1, 0.1], [0.2], [1.0, 0.3, 0.2,
                                                          0.1]])
def test_phase_timers_steady_means_equal_jax(durs):
    ours, theirs = PhaseTimers(), JPhaseTimers()
    for d in durs:
        ours.add("tree", d)
        theirs.add("tree", d)
        ours.add("score", d / 2)
        theirs.add("score", d / 2)
    assert ours.steady_means() == theirs.steady_means()
    assert dict(ours.counts) == dict(theirs.counts)


def test_phase_timers_feed_the_tracer_sink():
    with obs_trace.tracing() as tr:
        t = PhaseTimers()
        with t.phase("zz_phase"):
            pass
        t.report("zz timers")
        events = tr.events()
    assert any(e["name"] == "zz_phase" and e["ph"] == "X" for e in events)
    assert any(e["name"] == "telemetry.summary"
               and e["args"]["kind"] == "zz timers"
               and "zz_phase" in e["args"]["payload"]["seconds"]
               for e in events)


@pytest.fixture(scope="module")
def traced_training(tmp_path_factory):
    d = tmp_path_factory.mktemp("traced")
    path = str(d / "t.json")
    x, y = _problem()
    p = dict(objective="binary", num_leaves=7, verbose=-1, device="cpu",
             trace_path=path)
    counters.reset()
    bst = lt.train(p, lt.Dataset(x, y, params=p), 3, verbose_eval=False)
    return bst, path


def test_training_trace_holds_phases_split_find_and_counters(
        traced_training):
    bst, path = traced_training
    evs = report.load_events(path)
    spans = [e for e in evs if e.get("ph") == "X"]
    names = {e["name"] for e in spans}
    assert {"train", "iteration", "boosting", "bagging", "tree",
            "score"} <= names
    finds = [e for e in spans if e["name"] == "split_find"]
    assert finds and all(e["args"]["traced"] for e in finds)
    snap = report.summary_payload(evs, "counters")
    assert report.observed_kernel(snap["counters"]) == "hist_window"
    assert snap["gauges"]["memory_peak_bytes"] > 0
    assert any(e["event"] == "memory_summary" for e in snap["events"])
    timers = report.summary_payload(evs, "training phase timers")
    assert timers["counts"]["tree"] == 3
    assert sum(e["name"] == "iteration" for e in spans) == 3


# ---- the memory monitor ---------------------------------------------------

def test_memory_monitor_samples_the_census_on_the_cpu():
    x, y = _problem()
    p = dict(objective="binary", num_leaves=7, verbose=-1, device="cpu")
    bst = lt.train(p, lt.Dataset(x, y, params=p), 2, verbose_eval=False)
    assert memory.device_memory_stats("cpu") is None
    mon = memory.start()
    assert mon.source == "live_census"
    census = memory.live_census(bst)
    got = mon.sample("test")
    assert got >= sum(census.values())
    tags = {r["tag"] for r in mon.top_residents(k=50)}
    assert set(census) <= tags
    summ = memory.stop()
    assert summ["measured_peak_bytes"] >= sum(census.values())
    ev = counters.events("memory_summary")[-1]
    assert ev["source"] == "live_census"
    assert memory.get_memory() is memory.NULL_MEMORY
    assert memory.NULL_MEMORY.sample() is None


# ---- the collectives ------------------------------------------------------

def test_note_collective_and_totals():
    collectives.note_collective("all_reduce", torch.zeros(8), None, "x.py:1")
    collectives.note_collective("allgather_object", b"12345", None,
                                "parallel/sync")
    assert collectives.totals() == {"calls": 2, "bytes": 32 + 5}
    assert counters.get("collective_bytes")["op=all_reduce,site=x.py:1"] == 32
    assert collectives.tree_nbytes({"a": [np.zeros(3, np.float64),
                                          torch.zeros(2, 2)]}) == 24 + 16


def test_intercept_counts_torch_distributed_collectives(tmp_path):
    """``intercept`` over a one-process gloo group: each tensor collective
    is recorded with its bytes and site, and counted when asked."""
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'rdzv'}", rank=0,
        world_size=1)
    try:
        with collectives.intercept(count=True) as recs:
            t = torch.ones(5)
            dist.all_reduce(t)
            dist.broadcast(t, src=0)
        assert [r["op"] for r in recs] == ["all_reduce", "broadcast"]
        assert recs[0]["bytes"] == 20 and not recs[0]["per_split"]
        # no frame of the port on the stack: a call from outside it
        assert recs[0]["site"] == "?"
        assert counters.total("collective_calls") == 2
        assert dist.all_reduce.__name__ == "all_reduce"
    finally:
        dist.destroy_process_group()


def test_host_object_collectives_count_through_one_home(monkeypatch):
    """``parallel/sync.py`` counts through ``note_collective``: a stand-in
    group of two processes, one payload each."""
    monkeypatch.setattr(sync, "process_count", lambda: 2)
    import torch.distributed as dist

    def fake_gather(out, frame, group=None):
        out[0] = out[1] = frame
    monkeypatch.setattr(dist, "all_gather_object", fake_gather)
    assert sync.allgather_object({"a": 1}) == [{"a": 1}, {"a": 1}]
    got = counters.get("collective_bytes")
    import pickle
    assert got == {"op=allgather_object,site=parallel/sync":
                   len(pickle.dumps({"a": 1}))}


# ---- the report against the JAX package -----------------------------------

def _synthetic_trace(path, proc=0, with_all=True):
    evs = []
    t = 0.0
    for i in range(3):
        for name, dur in (("iteration", 900.0), ("tree", 700.0),
                          ("score", 50.0)):
            evs.append({"name": name, "ph": "X", "ts": t, "dur": dur * (
                3 if i == 0 else 1), "pid": 1, "proc": proc, "tid": 1,
                "args": {"peak_bytes": 1000 + i}})
            t += dur
    evs.append({"name": "split_find", "ph": "X", "ts": 5.0, "dur": 40.0,
                "pid": 1, "proc": proc, "tid": 1,
                "args": {"traced": True, "impl": "fused"}})
    snap = {"counters": {"hist_dispatch": {"method=hist_window": 3},
                         "collective_bytes": {
                             "op=allgather_object,site=parallel/sync": 64}},
            "gauges": {"memory_peak_bytes": 123456.0, "world_size": 2},
            "events": [{"event": "checkpoint_resume", "proc": proc,
                        "iteration": 2}],
            "events_dropped": 0, "process_index": proc}
    if with_all:
        evs.append({"name": "telemetry.summary", "ph": "i", "ts": t,
                    "args": {"kind": "device_profile", "payload": {
                        "captured_iterations": 2, "total_op_ms": 10.0,
                        "attributed_fraction": 1.0,
                        "phase_device_ms": {"histogram": 6.0,
                                            "split_find": 4.0},
                        "top_ops": [{"op": "hist_gather_large", "phase":
                                     "histogram", "ms": 6.0, "count": 9}],
                        "iterations": [{"iteration": 1, "host_ms": 20.0,
                                        "device_busy_ms": 10.0,
                                        "overlap_fraction": 0.5,
                                        "idle_gap_fraction": 0.5}]}}})
        evs.append({"name": "telemetry.summary", "ph": "i", "ts": t,
                    "args": {"kind": "model_quality", "payload": {
                        "trees_seen": 3, "top_features": [
                            {"feature": "f0", "gain": 9.0, "splits": 3}],
                        "gain_curve": [[1, 5.0], [2, 3.0], [3, 1.0]]}}})
    evs.append({"name": "telemetry.summary", "ph": "i", "ts": t,
                "args": {"kind": "counters", "payload": snap}})
    with open(path, "w") as f:
        if path.endswith(".jsonl"):
            for e in evs:
                f.write(json.dumps(e) + "\n")
        else:
            json.dump({"traceEvents": evs}, f)
    return path


@pytest.mark.parametrize("files", [1, 2], ids=["one_rank", "two_ranks"])
def test_report_text_and_json_equal_jax(tmp_path, files, capsys):
    paths = [_synthetic_trace(str(tmp_path / f"t{r}.json{'l' * r}"), proc=r,
                              with_all=r == 0) for r in range(files)]
    assert report.render(paths) == jreport.render(paths)
    assert report.main(["--json"] + paths) == 0
    ours = json.loads(capsys.readouterr().out)
    assert jreport.main(["--json"] + paths) == 0
    theirs = json.loads(capsys.readouterr().out)
    assert ours == theirs and ours["schema_version"] == 4
    assert report.REPORT_SCHEMA_VERSION == jreport.REPORT_SCHEMA_VERSION


def test_port_trace_renders_in_both_packages(traced_training, capsys):
    """The port's training trace is one the JAX package's report reads,
    table for table."""
    _, path = traced_training
    assert report.render(path) == jreport.render(path)
    assert report.main([path]) == 0
    assert "Per-phase spans" in capsys.readouterr().out


# ---- the model-quality tracker --------------------------------------------

def test_model_text_with_model_quality_equals_jax():
    """Integer trees with ``model_quality=on``: the model text, its
    ``feature_distribution:`` section included, equals the JAX package's;
    the section parses back on load, and is absent with the plane off."""
    x, y = _problem(n=1200, f=6, seed=11)
    x[::7, 2] = np.nan
    p = dict(objective="binary", num_leaves=7, verbose=-1,
             model_quality="on", enable_bundle=False)
    jb = lj.train(p, lj.Dataset(x, label=y), 4, fobj=_int_fobj,
                  verbose_eval=False)
    pt = dict(p, device="cpu")
    tb = lt.train(pt, lt.Dataset(x, y, params=pt), 4, fobj=_int_fobj,
                  verbose_eval=False)
    ours, theirs = tb.model_to_string(), jb.model_to_string()
    assert "feature_distribution:" in ours
    assert ours == theirs
    back = lt.Booster(model_str=ours, params={"device": "cpu"})
    assert back.inner.feature_distribution == \
        mq.parse_distribution(ours.splitlines())
    off = lt.train(dict(pt, model_quality="off"),
                   lt.Dataset(x, y, params=pt), 1, fobj=_int_fobj,
                   verbose_eval=False)
    assert "feature_distribution:" not in off.model_to_string()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_format_and_parse_distribution_equal_jax(seed):
    rng = np.random.default_rng(seed)
    dist = {int(f): [(float(v), int(c)) for v, c in zip(
        np.sort(rng.standard_normal(5)), rng.integers(1, 99, 5))]
        for f in rng.choice(20, 4, replace=False)}
    text = mq.format_distribution(dist)
    assert text == jmq.format_distribution(dist)
    assert mq.parse_distribution(text.splitlines()) == \
        jmq.parse_distribution(text.splitlines()) == dist


def test_tracker_folds_trees_as_jax():
    """The same host trees folded by both trackers give the same summary
    and metric samples; ``resolve_armed`` follows telemetry on ``auto``."""
    x, y = _problem(n=600, f=4, seed=5)
    p = dict(objective="binary", num_leaves=5, verbose=-1, device="cpu")
    bst = lt.train(p, lt.Dataset(x, y, params=p), 3, verbose_eval=False)
    ours, theirs = mq.ModelQualityTracker(["a", "b", "c", "d"]), \
        jmq.ModelQualityTracker(["a", "b", "c", "d"])
    for i, tree in enumerate(bst.inner.models):
        ours.observe_tree(i, i, tree)
        theirs.observe_tree(i, i, tree)
    assert ours.summary() == theirs.summary()
    assert ours.metrics_samples() == theirs.metrics_samples()
    for v in ("on", "off", "auto"):
        for tele in (True, False):
            assert mq.resolve_armed(v, tele) == jmq.resolve_armed(v, tele)
    assert mq.get_tracker() is mq.NULL_MODEL_QUALITY


# ---- the keys ---------------------------------------------------------------

@pytest.mark.parametrize("params,message", [
    ({"model_quality": "maybe"}, "model_quality must be auto, on, or off"),
    ({"metrics_port": 70000}, "metrics_port must be in"),
    ({"profile_iters": 0}, "profile_iters must be >= 1"),
    ({"device_profile": True, "profile_dir": "d"},
     "device_profile cannot be combined with profile_dir"),
    ({"straggler_factor": 1.0}, "straggler_factor must be > 1"),
])
def test_observability_keys_checked_as_jax(params, message):
    """The JAX package's checks (lightgbm_tpu/config.py:718, :799-814),
    with its messages."""
    from lightgbm_tpu.config import config_from_params as jconfig
    from lightgbm_tpu_torch.config import config_from_params
    with pytest.raises(RuntimeError, match=message):
        config_from_params(params)
    with pytest.raises(Exception, match=message.split(":")[0]):
        jconfig(params)


def test_profile_dir_writes_a_torch_profiler_trace(tmp_path):
    """``profile_dir``: one Chrome trace of the boosting loop a rank, with
    the tracer's phases in it when telemetry is on."""
    x, y = _problem(n=300)
    d = str(tmp_path / "prof")
    p = dict(objective="binary", num_leaves=5, verbose=-1, device="cpu",
             profile_dir=d, telemetry=True)
    lt.train(p, lt.Dataset(x, y, params=p), 2, verbose_eval=False)
    evs = report.load_events(os.path.join(d, "trace.rank_0.json"))
    names = {e.get("name") for e in evs}
    assert {"train", "iteration", "tree"} <= names
