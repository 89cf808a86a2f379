"""Device-time attribution over ``torch.profiler``
(``lightgbm_tpu_torch/obs/devprof.py``; ``tests/test_devprof.py``).

* The parsing layer reads a synthetic ``torch.profiler`` Chrome trace:
  the card's ops by category, the host phase windows of the tracer's
  ``record_function`` ranges, attribution by kernel name
  (``KERNEL_PHASES``), then a graph-launched PyTorch kernel to the split
  step, then the host window; the records a window lost, from its
  correlation ids.  Where the JAX package's parser has the same function
  (loading, busy time, window attribution) the two agree.
* Disarmed, the plane is one shared no-op with one shared window.
* Armed on the CPU (``device_profile``), the first iteration is not
  profiled, ``profile_iters`` windows are, and the trace carries the
  ``device_profile`` block, which the report renders.
"""
import gzip
import json

import numpy as np
import pytest

from lightgbm_tpu.obs import devprof as jdevprof
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.obs import devprof, report
from lightgbm_tpu_torch.obs.counters import counters

GRAPH, LAUNCH, LOST_LAUNCH = 7, 11, 12


def _trace(lose_graph_kernel=False):
    """One boosting iteration as torch.profiler exports it: the tracer's
    ranges, a graph launch whose replay made a port kernel and a PyTorch
    kernel, a plain launch of a PyTorch kernel in the ``score`` window, a
    copy, and a launch whose kernel record is missing."""
    host, dev = 100, 0
    ev = [
        {"ph": "M", "name": "process_name", "pid": dev,
         "args": {"name": "GPU 0"}},
        {"ph": "X", "cat": "user_annotation", "name": "iteration",
         "pid": host, "tid": 1, "ts": 0.0, "dur": 1000.0},
        {"ph": "X", "cat": "user_annotation", "name": "tree", "pid": host,
         "tid": 1, "ts": 10.0, "dur": 600.0},
        {"ph": "X", "cat": "user_annotation", "name": "score", "pid": host,
         "tid": 1, "ts": 700.0, "dur": 200.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "tree",
         "pid": dev, "tid": 7, "ts": 10.0, "dur": 600.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": host,
         "tid": 1, "ts": 705.0, "dur": 3.0},
        {"ph": "X", "cat": "python_function", "name": "$python", "pid": host,
         "tid": 1, "ts": 1.0, "dur": 2.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
         "pid": host, "tid": 1, "ts": 20.0, "dur": 5.0,
         "args": {"correlation": GRAPH}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
         "pid": host, "tid": 1, "ts": 300.0, "dur": 5.0,
         "args": {"correlation": GRAPH + 100}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": host, "tid": 1, "ts": 710.0, "dur": 4.0,
         "args": {"correlation": LAUNCH}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": host, "tid": 1, "ts": 720.0, "dur": 4.0,
         "args": {"correlation": LOST_LAUNCH}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
         "pid": host, "tid": 1, "ts": 730.0, "dur": 4.0,
         "args": {"correlation": 13}},
    ]
    for c, t0 in ((GRAPH, 40.0), (GRAPH + 100, 320.0)):
        ev.append({"ph": "X", "cat": "kernel",
                   "name": "void hist_gather_large<unsigned char>(int*)",
                   "pid": dev, "tid": 7, "ts": t0, "dur": 30.0,
                   "args": {"correlation": c}})
        if not (lose_graph_kernel and c == GRAPH + 100):
            ev.append({"ph": "X", "cat": "kernel",
                       "name": "void at::native::reduce_kernel<512>()",
                       "pid": dev, "tid": 7, "ts": t0 + 40.0, "dur": 10.0,
                       "args": {"correlation": c}})
        ev.append({"ph": "X", "cat": "kernel",
                   "name": "lgbt_route_kernel", "pid": dev, "tid": 7,
                   "ts": t0 + 60.0, "dur": 5.0, "args": {"correlation": c}})
    ev.append({"ph": "X", "cat": "kernel",
               "name": "void at::native::vectorized_elementwise_kernel<4>()",
               "pid": dev, "tid": 7, "ts": 800.0, "dur": 20.0,
               "args": {"correlation": LAUNCH}})
    ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
               "pid": dev, "tid": 7, "ts": 980.0, "dur": 10.0,
               "args": {"correlation": 13}})
    return ev


def test_op_events_and_phase_windows():
    ev = _trace()
    ops = devprof.op_events(ev)
    assert [o["cat"] for o in ops].count("kernel") == 7
    assert sum(o["cat"] == "gpu_memcpy" for o in ops) == 1
    assert all(o["cat"] != "gpu_user_annotation" for o in ops)
    wins = devprof.phase_windows(ev)
    assert [w[2] for w in wins] == ["tree", "score"]
    assert devprof.graph_correlations(ev) == {GRAPH, GRAPH + 100}


def test_attribution_by_kernel_name_graph_then_window():
    out = devprof.attribute(_trace())
    ph = out["phase_device_ms"]
    # K1 twice (30 us each), the route kernel twice (5 us each), the
    # graph-launched reduce twice (10 us each) to the split step, the
    # score window's elementwise kernel and the copy after it
    assert ph == {"histogram": 0.06, "split_find": 0.02, "score": 0.03,
                  "partition": 0.01}
    assert out["attributed_fraction"] == 1.0
    assert out["op_counts"]["lgbt_route_kernel"] == 2
    assert out["top_ops"][0]["op"].startswith("void hist_gather_large")
    assert out["device_busy_ms"] == pytest.approx(out["total_op_ms"])
    for token, phase in devprof.KERNEL_PHASES:
        assert devprof.kernel_phase(f"void {token}_x<1>()") == phase
    assert devprof.kernel_phase("void at::native::foo()") is None


def test_records_lost_from_correlation_ids():
    """The launch at 720 has no kernel record: one lost.  A graph launch
    short of the fullest one by a kernel: one more."""
    assert devprof.records_lost(_trace()) == 1
    assert devprof.lost_records(_trace()) == {"launches": 1, "kernels": 0,
                                              "graph_kernels": 0}
    assert devprof.records_lost(_trace(lose_graph_kernel=True)) == 2
    assert devprof.lost_records(_trace(lose_graph_kernel=True))[
        "graph_kernels"] == 1
    # a kernel whose launch record was lost
    no_launch = [e for e in _trace() if not (
        e.get("name") == "cudaLaunchKernel"
        and e["args"]["correlation"] == LAUNCH)]
    assert devprof.lost_records(no_launch) == {"launches": 1, "kernels": 1,
                                               "graph_kernels": 0}
    whole = [e for e in _trace()
             if (e.get("args") or {}).get("correlation") != LOST_LAUNCH]
    assert devprof.records_lost(whole) == 0


def test_parsing_agrees_with_jax_where_it_overlaps(tmp_path):
    ev = _trace()
    for name in ("t.json", "t.json.gz", "t.jsonl"):
        path = str(tmp_path / name)
        if name.endswith(".gz"):
            with gzip.open(path, "wt") as f:
                json.dump({"traceEvents": ev}, f)
        elif name.endswith(".jsonl"):
            with open(path, "w") as f:
                f.write("\n".join(json.dumps(e) for e in ev) + "\n{\"torn")
        else:
            with open(path, "w") as f:
                json.dump({"traceEvents": ev}, f)
        assert devprof.load_trace_events(path) == \
            jdevprof.load_trace_events(path) == ev
    ops = devprof.op_events(ev)
    assert devprof._busy_us(ops) == jdevprof._busy_us(ops)
    assert devprof._busy_us(ops, 0.0, 100.0) == \
        jdevprof._busy_us(ops, 0.0, 100.0)
    wins = devprof.phase_windows(ev)
    for op in ops:
        assert devprof._window_phase(op, wins) == \
            jdevprof._window_phase(op, wins)


def test_disarmed_plane_is_a_shared_noop():
    dp = devprof.get_devprof()
    assert dp is devprof.NULL_DEVPROF and not dp.enabled
    assert dp.iteration(0) is dp.iteration(5) is devprof.NULL_WINDOW
    with dp.iteration(3):
        pass
    assert dp.pop_idle_gap() is None and dp.summary() is None
    assert devprof.stop() is None


def test_armed_on_the_cpu_profiles_after_the_first_iteration(tmp_path):
    """``device_profile`` with ``profile_iters=2`` over 4 rounds on the
    CPU: iterations 1 and 2 profiled (0 holds the first build), no device
    op on the CPU (an idle gap of 1), the block in the trace and the
    report's device-time section; the progress record carries the gap."""
    counters.reset()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((500, 4))
    y = (x[:, 0] > 0).astype(float)
    path = str(tmp_path / "t.json")
    p = dict(objective="binary", num_leaves=5, verbose=-1, device="cpu",
             device_profile=True, profile_iters=2, trace_path=path,
             obs_stream_path=str(tmp_path / "fl"))
    lt.train(p, lt.Dataset(x, y, params=p), 4, verbose_eval=False)
    dp = devprof.last_summary()
    assert dp["source"] == "torch.profiler"
    assert dp["captured_iterations"] == 2
    assert [it["iteration"] for it in dp["iterations"]] == [1, 2]
    assert all(it["idle_gap_fraction"] == 1.0 for it in dp["iterations"])
    assert dp["records_lost"] == 0 and dp["lossy_windows"] == 0
    evs = report.load_events(path)
    assert report.summary_payload(evs, "device_profile") == \
        json.loads(json.dumps(dp))
    assert "Device time (devprof attribution)" in report.render(path)
    assert len(counters.events("devprof_capture")) == 2
    from lightgbm_tpu_torch.obs import flight
    recs = [r for r in flight.read_stream(str(tmp_path / "fl.rank_0"))
            if r["event"] == "progress"]
    assert [r.get("idle_gap_fraction") for r in recs] == [None, 1.0, 1.0,
                                                          None]
    assert devprof.get_devprof() is devprof.NULL_DEVPROF


def test_lossy_window_says_so_in_the_report():
    """A summary that lost records renders a line saying so (the same
    text as the JAX package's otherwise)."""
    from lightgbm_tpu.obs import report as jreport
    block = {"captured_iterations": 2, "total_op_ms": 1.0,
             "attributed_fraction": 1.0, "phase_device_ms": {"tree": 1.0},
             "top_ops": [], "iterations": [], "records_lost": 3,
             "lossy_windows": 1}
    ev = [{"name": "telemetry.summary", "ph": "i",
           "args": {"kind": "device_profile", "payload": block}}]
    ours = report._devprof_lines(ev)
    assert any("lost 3 kernel record(s) in 1 window(s)" in ln
               for ln in ours)
    block["records_lost"] = 0
    assert report._devprof_lines(ev) == jreport._devprof_lines(ev)


@pytest.mark.gpu
def test_devprof_windows_on_the_card():
    """On a card: the windows see the port's kernels by name (run by
    ``chip_smoke.py`` phase 25c at full width)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: chip_smoke.py phase 25c runs this")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((20_000, 6))
    y = (x[:, 0] > 0).astype(float)
    p = dict(objective="binary", num_leaves=31, verbose=-1,
             device_profile=True, profile_iters=2)
    lt.train(p, lt.Dataset(x, y, params=p), 3, verbose_eval=False)
    dp = devprof.last_summary()
    assert any("hist_gather" in k for k in dp["op_counts"])
    assert dp["phase_device_ms"].get("histogram", 0) > 0
