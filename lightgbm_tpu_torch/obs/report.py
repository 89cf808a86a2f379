"""Render a telemetry trace into per-phase / per-kernel markdown tables
(``lightgbm_tpu/obs/report.py``).

``python -m lightgbm_tpu_torch.obs <trace>...`` is the command line.  It
reads every format :mod:`.trace` writes: a Chrome-trace object
(``{"traceEvents": [...]}``), a bare JSON array, or JSONL (a killed
process leaves a readable prefix).  The trace stands alone: its final
``telemetry.summary`` events carry the counter snapshot alongside the
span timeline.

Several trace files (one a rank) merge into one report: every span is
rank-tagged (``[r<k>] span``, from the ``proc`` stamp of each event, else
file order) and each file's summaries render side by side.  The text and
the ``--json`` schema (:data:`REPORT_SCHEMA_VERSION`) are the JAX
package's, so either package's traces render the same in both; the
tables' words are the JAX package's too (its "compile" is the port's
CUDA-graph capture and first kernel build).
"""
from __future__ import annotations

import json
import sys
from typing import Any, Dict, List, Optional

# --json output schema: 2 added the schema stamp itself plus the per-file
# serving_stats / hlo_collectives entries (the multi-rank merge parity of
# the markdown report); 3 added the per-file device_profile entry (the
# obs/devprof.py attribution block embedded as a telemetry.summary event);
# 4 added the per-file model_quality entry (obs/model_quality.py tracker
# summary: per-feature cumulative gain, gain-decay curve)
REPORT_SCHEMA_VERSION = 4


def load_events(path: str) -> List[dict]:
    with open(path) as f:
        text = f.read()
    text = text.strip()
    if not text:
        return []
    if path.endswith(".jsonl") or "\n" in text and not text.startswith(("[", "{")):
        events = []
        for line in text.splitlines():
            line = line.strip().rstrip(",")
            if not line or line in ("[", "]"):
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                continue                  # tolerate a torn tail line
        return events
    obj = json.loads(text)
    if isinstance(obj, dict):
        return list(obj.get("traceEvents", []))
    return list(obj)


def load_events_ranked(paths: List[str]) -> List[tuple]:
    """Load several trace files as ``[(path, rank, events), ...]``.

    The rank is the ``proc`` stamp the events carry (multi-host traces);
    when the stamps do not distinguish the files (e.g. two single-host
    runs, both proc 0), file order does."""
    loaded = []
    for i, p in enumerate(paths):
        events = load_events(p)
        procs = {e["proc"] for e in events if "proc" in e}
        loaded.append([p, procs.pop() if len(procs) == 1 else i, events])
    if len({r for _, r, _ in loaded}) < len(loaded):
        for i, entry in enumerate(loaded):
            entry[1] = i
    return [tuple(entry) for entry in loaded]


def summary_payload(events: List[dict], kind: str) -> Optional[dict]:
    """Last embedded ``telemetry.summary`` payload of the given kind."""
    out = None
    for ev in events:
        if ev.get("name") == "telemetry.summary":
            args = ev.get("args", {})
            if args.get("kind") == kind:
                out = args.get("payload")
    return out


def phase_table(events: List[dict],
                traced: Optional[bool] = None) -> List[Dict[str, Any]]:
    """Aggregate complete ("X") spans by name: count/total/mean/max (ms).

    ``traced`` filters on the span's ``traced`` arg: True keeps only
    TRACE-TIME spans (emitted from inside jit — they fire once per
    compilation and their durations include tracing/compile work), False
    keeps only host wall-clock spans, None keeps everything (the --json
    CLI view).  Host rows additionally carry ``first_ms`` (the
    chronologically first firing) and ``steady_mean_ms`` (mean of the
    rest): a first firing that dwarfs the steady state is the compile —
    totals that mix the two mislead (observed: a ``score`` phase showing
    11.2 s total of which 10.8 s was the first, compile-inclusive
    firing)."""
    agg: Dict[str, List[tuple]] = {}
    peak: Dict[str, int] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        args = ev.get("args", {})
        is_traced = bool(args.get("traced"))
        if traced is not None and is_traced != traced:
            continue
        agg.setdefault(ev["name"], []).append(
            (float(ev.get("ts", 0)), float(ev.get("dur", 0)) / 1e3))
        if "peak_bytes" in args:    # memory monitor phase annotation
            peak[ev["name"]] = max(peak.get(ev["name"], 0),
                                   int(args["peak_bytes"]))
    rows = []
    for name, spans in agg.items():
        spans.sort()
        durs = [d for _, d in spans]
        row = {"span": name, "count": len(durs),
               "total_ms": sum(durs),
               "mean_ms": sum(durs) / len(durs),
               "max_ms": max(durs)}
        if name in peak:
            row["peak_bytes"] = peak[name]
        if traced is False:
            rest = durs[1:]
            row["first_ms"] = durs[0]
            row["steady_mean_ms"] = (sum(rest) / len(rest)) if rest \
                else durs[0]
            row["compile_skewed"] = bool(
                rest and durs[0] > 3 * row["steady_mean_ms"])
        rows.append(row)
    rows.sort(key=lambda r: -r["total_ms"])
    return rows


def _split_tags(key: str) -> Dict[str, str]:
    return dict(kv.split("=", 1) for kv in key.split(",") if "=" in kv)


def kernel_table(counters: Dict[str, Dict[str, float]]) -> List[Dict[str, Any]]:
    rows = []
    for name in ("hist_dispatch",):
        for key, v in sorted(counters.get(name, {}).items()):
            tags = _split_tags(key)
            rows.append({"counter": name,
                         "kernel": tags.get("method", tags.get("impl", "?")),
                         "site": tags.get("site", "-"),
                         "traced_calls": int(v)})
    return rows


def observed_kernel(counters: Dict[str, Dict[str, float]]) -> Optional[str]:
    per: Dict[str, float] = {}
    for key, v in counters.get("hist_dispatch", {}).items():
        m = _split_tags(key).get("method")
        if m:
            per[m] = per.get(m, 0) + v
    return max(per, key=per.get) if per else None


def _md_table(headers: List[str], rows: List[List[Any]]) -> List[str]:
    out = ["| " + " | ".join(headers) + " |",
           "|" + "|".join("---" for _ in headers) + "|"]
    for r in rows:
        out.append("| " + " | ".join(str(c) for c in r) + " |")
    return out


def _memory_lines(snap: dict) -> List[str]:
    """The report's Memory section: predicted/measured gauges, the
    pre-flight verdict, executable memory-analysis events, top residents."""
    gauges = snap.get("gauges", {})
    events = snap.get("events", [])
    mem_gauges = {k: v for k, v in gauges.items()
                  if k.startswith(("memory_", "hbm_")) or (
                      k.startswith("exec_") and k.endswith("_bytes"))}
    preflight = [e for e in events if e.get("event") == "hbm_preflight"]
    summaries = [e for e in events if e.get("event") == "memory_summary"]
    execs = [e for e in events if e.get("event") == "exec_memory"]
    if not (mem_gauges or preflight or summaries or execs):
        return []
    lines = ["", "## Memory", ""]
    for k in sorted(mem_gauges):
        lines.append(f"- `{k}` = {mem_gauges[k] / 1e6:.2f} MB")
    for e in preflight[-1:]:
        lines.append(f"- pre-flight: `{e.get('verdict')}` "
                     f"(predicted {e.get('predicted_peak_bytes', 0) / 1e9:.3f}"
                     f" GB, capacity {e.get('capacity_bytes')}, "
                     f"hbm_budget {e.get('hbm_budget')})")
    for e in summaries[-1:]:
        lines.append(f"- measured peak ({e.get('source')}): "
                     f"{e.get('measured_peak_bytes', 0) / 1e6:.2f} MB; "
                     f"top residents: {e.get('top_residents')}")
    for e in execs:
        lines.append(f"- executable `{e.get('label')}`: "
                     f"temp {e.get('temp_bytes', 0) / 1e6:.2f} MB, "
                     f"peak {e.get('peak_bytes', 0) / 1e6:.2f} MB")
    return lines


def _serving_lines(events: List[dict],
                   counters: Dict[str, Dict[str, float]],
                   gauges: Dict[str, Any],
                   rank: Optional[int] = None) -> List[str]:
    """The report's Serving section: predict-executable dispatch identity
    (batch bucket + executable tag), the ``predict_jit_entries`` recompile
    gauge, and the server's per-bucket latency histograms/percentiles
    (the ``serving stats`` summary the ModelServer flushes at stop).
    ``rank`` titles the per-rank section of a multi-trace merge."""
    dispatch = counters.get("predict_dispatch", {})
    stats = summary_payload(events, "serving stats")
    jit_gauge = {k: v for k, v in gauges.items()
                 if k.endswith("predict_jit_entries")}
    if not (dispatch or stats):
        return []
    title = "## Serving / predict" + \
        (f" — rank {rank}" if rank is not None else "")
    lines = ["", title, ""]
    for k, v in sorted(jit_gauge.items()):
        lines.append(f"- `{k}` = {int(v)} live per-bucket buffer set(s)")
    if dispatch:
        lines += ["", "Microbatch dispatches by (bucket, input path, "
                      "executable identity) — a warmed ladder must only "
                      "ever reuse these signatures:", ""]
        rows = []
        for key, v in sorted(dispatch.items(),
                             key=lambda kv: int(_split_tags(kv[0])
                                               .get("bucket", 0))):
            t = _split_tags(key)
            rows.append([t.get("bucket", "?"), t.get("path", "?"),
                         t.get("exec", "?"), int(v)])
        lines += _md_table(["bucket", "path", "executable", "dispatches"],
                           rows)
    if stats:
        lines += ["", f"Server totals: {stats.get('requests', 0)} requests "
                      f"/ {stats.get('rows', 0)} rows in "
                      f"{stats.get('batches', 0)} coalesced batches, "
                      f"{stats.get('qps', 0)} req/s, "
                      f"{stats.get('rows_per_s', 0)} rows/s, "
                      f"{stats.get('swaps', 0)} hot swap(s).", ""]
        rows = []
        hist_keys: List[str] = []
        for b, s in sorted(stats.get("buckets", {}).items(),
                           key=lambda kv: int(kv[0])):
            if not hist_keys:
                hist_keys = list(s.get("hist", {}))
            rows.append([b, s.get("count"), s.get("p50_ms"),
                         s.get("p99_ms"), s.get("max_ms")]
                        + [s.get("hist", {}).get(h, 0) for h in hist_keys])
        if rows:
            lines += _md_table(["bucket", "requests", "p50 ms", "p99 ms",
                                "max ms"] + hist_keys, rows)
    return lines


def _devprof_lines(events: List[dict],
                   rank: Optional[int] = None) -> List[str]:
    """The report's Device time section: the ``device_profile`` summary
    the devprof plane embeds (per-phase device ms, top ops, per-iteration
    host/device overlap) — the on-device answer the host span tables
    cannot give."""
    dp = summary_payload(events, "device_profile")
    if not dp:
        return []
    title = "## Device time (devprof attribution)" + \
        (f" — rank {rank}" if rank is not None else "")
    frac = dp.get("attributed_fraction")
    lines = ["", title, "",
             f"Captured {dp.get('captured_iterations', 0)} steady-state "
             f"iteration window(s) (first firing/compile excluded); "
             f"{dp.get('total_op_ms', 0):.1f} ms of device op time, "
             + (f"{frac:.1%} attributed to named phases."
                if isinstance(frac, (int, float))
                else "nothing attributable recorded."), ""]
    phases = dp.get("phase_device_ms", {})
    total = dp.get("total_op_ms") or 0
    if phases:
        lines += _md_table(
            ["phase", "device ms", "share"],
            [[p, f"{ms:.3f}", f"{ms / total:.1%}" if total else "-"]
             for p, ms in phases.items()])
    top = dp.get("top_ops", [])
    if top:
        lines += ["", "Top ops by device time:", ""]
        lines += _md_table(
            ["op", "phase", "ms", "count"],
            [[o.get("op"), o.get("phase"), f"{o.get('ms', 0):.3f}",
              o.get("count")] for o in top])
    iters = dp.get("iterations", [])
    if iters:
        lines += ["", "Per-iteration host↔device accounting (idle gap = "
                      "host window not covered by device work):", ""]
        lines += _md_table(
            ["iteration", "host ms", "device busy ms", "overlap",
             "idle gap"],
            [[it.get("iteration"), f"{it.get('host_ms', 0):.3f}",
              f"{it.get('device_busy_ms', 0):.3f}",
              f"{it.get('overlap_fraction', 0):.1%}",
              f"{it.get('idle_gap_fraction', 0):.1%}"] for it in iters])
    if dp.get("capture_failed"):
        lines += ["", "(capture failed mid-run — the table covers the "
                      "windows that completed)"]
    if dp.get("records_lost"):
        lines += ["", f"(the profiler lost {dp['records_lost']} kernel "
                      f"record(s) in {dp.get('lossy_windows', '?')} "
                      "window(s): the table undercounts those windows)"]
    return lines


def _model_quality_lines(events: List[dict],
                         rank: Optional[int] = None) -> List[str]:
    """The report's Model quality section: the ``model_quality`` summary
    the tracker embeds at teardown — per-feature cumulative split gain
    (the what-did-the-model-learn answer) and the gain-decay curve (is
    more boosting still buying anything)."""
    mq = summary_payload(events, "model_quality")
    if not mq:
        return []
    title = "## Model quality" + \
        (f" — rank {rank}" if rank is not None else "")
    lines = ["", title, "",
             f"{mq.get('trees_seen', 0)} tree(s) audited.  Top features "
             "by cumulative split gain:", ""]
    top = mq.get("top_features", [])
    if top:
        total = sum(float(t.get("gain", 0)) for t in top) or 1.0
        lines += _md_table(
            ["feature", "gain", "share of top-K", "splits"],
            [[t.get("feature"), f"{float(t.get('gain', 0)):.4g}",
              f"{float(t.get('gain', 0)) / total:.1%}",
              t.get("splits")] for t in top])
    else:
        lines.append("(no splits audited)")
    curve = mq.get("gain_curve", [])
    if len(curve) >= 2:
        # decay verdict: last-quartile gain vs first-quartile gain — a
        # ratio near zero says late iterations stopped learning
        gains = [float(g) for _, g in curve]
        q = max(len(gains) // 4, 1)
        head, tail = sum(gains[:q]) / q, sum(gains[-q:]) / q
        lines += ["", f"Gain decay over {len(curve)} iteration(s): "
                      f"first-quartile mean {head:.4g} → last-quartile "
                      f"mean {tail:.4g}"
                      + (f" ({tail / head:.1%} retained)." if head > 0
                         else ".")]
    return lines


def render(path) -> str:
    paths = [path] if isinstance(path, str) else list(path)
    ranked = load_events_ranked(paths)
    multi = len(ranked) > 1
    if multi:
        # rank-tag every SPAN so the merged tables stay attributable; the
        # embedded telemetry.summary payloads keep their names (they are
        # read per-file below, never from the merged stream)
        events = [dict(ev, name=f"[r{rank}] {ev['name']}")
                  if ev.get("ph") == "X" else ev
                  for _, rank, evs in ranked for ev in evs]
        snap = {}
        counters = {}
        for _, rank, evs in ranked:
            rsnap = summary_payload(evs, "counters") or {}
            for name, buckets in rsnap.get("counters", {}).items():
                merged = counters.setdefault(name, {})
                for key, v in buckets.items():
                    merged[f"proc={rank}," + key if key
                           else f"proc={rank}"] = v
            for e in rsnap.get("events", []):
                snap.setdefault("events", []).append(e)
            for k, v in rsnap.get("gauges", {}).items():
                snap.setdefault("gauges", {})[f"[r{rank}] {k}"] = v
            snap["events_dropped"] = (snap.get("events_dropped", 0)
                                      + rsnap.get("events_dropped", 0))
    else:
        events = ranked[0][2]
        snap = summary_payload(events, "counters") or {}
        counters = snap.get("counters", {})
    title = ", ".join(f"`{p}` (rank {r})" for p, r, _ in ranked) if multi \
        else f"`{paths[0]}`"
    lines = [f"# lightgbm_tpu telemetry report — {title}", ""]
    if multi:
        for p, rank, evs in ranked:
            rsnap = summary_payload(evs, "counters") or {}
            obs = observed_kernel(rsnap.get("counters", {}))
            if obs is not None:
                lines.append(f"**rank {rank}** (`{p}`) observed histogram "
                             f"kernel identity: `{obs}`")
        if lines[-1] != "":
            lines.append("")
    obs = observed_kernel(counters)
    if obs is not None:
        lines += [f"**Observed histogram kernel identity:** `{obs}`", ""]
    lines += ["## Per-phase spans", "",
              "Host wall-clock spans (Chrome-trace `X` events).  A span "
              "whose FIRST firing dwarfs its steady state (marked "
              "`compile⚠`) included jit compilation — judge throughput "
              "by `steady mean`, not `total`.", ""]
    prows = phase_table(events, traced=False)
    if prows:
        with_peak = any("peak_bytes" in r for r in prows)
        headers = ["span", "count", "total ms", "first ms",
                   "steady mean ms", "max ms"]
        headers += (["peak MB", ""] if with_peak else [""])
        lines += _md_table(
            headers,
            [[r["span"], r["count"], f"{r['total_ms']:.3f}",
              f"{r['first_ms']:.3f}", f"{r['steady_mean_ms']:.3f}",
              f"{r['max_ms']:.3f}"]
             + ([f"{r['peak_bytes'] / 1e6:.1f}" if "peak_bytes" in r
                 else "-"] if with_peak else [])
             + ["compile⚠" if r["compile_skewed"] else ""] for r in prows])
    else:
        lines.append("(no spans recorded)")
    trows = phase_table(events, traced=True)
    if trows:
        lines += ["", "## Trace-time spans (compile-inclusive)", "",
                  "Spans emitted from INSIDE jitted code fire once per "
                  "compilation — durations measure tracing/compile work, "
                  "never steady-state execution (the on-device twin is "
                  "the `jax.named_scope` XProf attribution).", ""]
        lines += _md_table(
            ["span", "count", "total ms", "mean ms", "max ms"],
            [[r["span"], r["count"], f"{r['total_ms']:.3f}",
              f"{r['mean_ms']:.3f}", f"{r['max_ms']:.3f}"] for r in trows])
    lines += ["", "## Per-kernel dispatch identity", ""]
    krows = kernel_table(counters)
    if krows:
        lines += _md_table(
            ["counter", "kernel", "site", "traced calls"],
            [[r["counter"], r["kernel"], r["site"], r["traced_calls"]]
             for r in krows])
    else:
        lines.append("(no kernel dispatches recorded)")
    coll = counters.get("collective_bytes", {})
    if coll:
        lines += ["", "## Collectives (trace-time payloads)", ""]
        lines += _md_table(
            ["op", "site", "bytes"],
            [[_split_tags(k).get("op", "?"), _split_tags(k).get("site", "-"),
              int(v)] for k, v in sorted(coll.items())])
    hlo_calls = counters.get("hlo_collective_calls", {})
    if hlo_calls:
        # compiler-inserted collectives (GSPMD): call-site counters can't
        # see these — the census reads the compiled executable
        # (obs/collectives.hlo_census, docs/DISTRIBUTED.md).  In a
        # multi-trace merge the counter keys carry the proc tag, so the
        # table keeps every rank's census attributable
        hlo_bytes = counters.get("hlo_collective_bytes", {})
        with_proc = any("proc=" in k for k in hlo_calls)
        lines += ["", "## Compiled-HLO collective census "
                  "(compiler-inserted)", ""]
        lines += _md_table(
            (["rank"] if with_proc else []) + ["op", "executable", "ops",
                                               "bytes"],
            [([_split_tags(k).get("proc", "-")] if with_proc else [])
             + [_split_tags(k).get("op", "?"),
                _split_tags(k).get("label", "-"), int(v),
                int(hlo_bytes.get(k, 0))]
             for k, v in sorted(hlo_calls.items())])
    if multi:
        # per-rank serving sections: the stats payload is per-file (one
        # serving process per trace), so it must never merge/overwrite
        for p, rank, evs in ranked:
            rsnap = summary_payload(evs, "counters") or {}
            lines += _serving_lines(evs, rsnap.get("counters", {}),
                                    rsnap.get("gauges", {}), rank=rank)
    else:
        lines += _serving_lines(events, counters, snap.get("gauges", {}))
    if multi:
        for p, rank, evs in ranked:
            lines += _devprof_lines(evs, rank=rank)
            lines += _model_quality_lines(evs, rank=rank)
    else:
        lines += _devprof_lines(events)
        lines += _model_quality_lines(events)
    lines += _memory_lines(snap)
    events_list = snap.get("events", [])
    if events_list:
        lines += ["", "## Structured events", ""]
        dropped = snap.get("events_dropped", 0)
        if dropped:
            lines += [f"(ring buffer overflowed: {dropped} oldest events "
                      "dropped)", ""]
        for e in events_list[-32:]:
            kind = e.get("event", "?")
            rest = {k: v for k, v in e.items() if k != "event"}
            lines.append(f"- `{kind}` {json.dumps(rest)}")
    gauges = snap.get("gauges", {})
    if gauges:
        lines += ["", "## Gauges", ""]
        for k, v in sorted(gauges.items()):
            lines.append(f"- `{k}` = {v}")
    lines.append("")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    as_json = "--json" in argv
    argv = [a for a in argv if a != "--json"]
    if not argv:
        sys.stderr.write(
            "usage: python -m lightgbm_tpu_torch.obs [--json] "
            "<trace.json[l]> [<trace2> ...]\n")
        return 2
    try:
        if as_json:
            # machine-readable: one entry per file (rank-tagged) so
            # tpu_capture_phase2.sh / decide_flips.py consume reports
            # without re-parsing markdown
            files = []
            for p, rank, events in load_events_ranked(argv):
                summary = summary_payload(events, "counters") or {}
                files.append({
                    "path": p, "rank": rank,
                    "phases": phase_table(events),
                    "observed_kernel": observed_kernel(
                        summary.get("counters", {})),
                    "memory": {
                        k: v for k, v in summary.get("gauges", {}).items()
                        if k.startswith(("memory_", "hbm_", "exec_"))},
                    # per-rank serving + census entries (the merged-report
                    # parity): one serving process per trace file
                    "serving_stats": summary_payload(events,
                                                     "serving stats"),
                    "device_profile": summary_payload(events,
                                                      "device_profile"),
                    "model_quality": summary_payload(events,
                                                     "model_quality"),
                    "hlo_collectives": summary.get("counters", {}).get(
                        "hlo_collective_calls", {}),
                    "events_dropped": summary.get("events_dropped", 0),
                    "summary": summary})
            doc = files[0] if len(files) == 1 else {"files": files}
            doc["schema_version"] = REPORT_SCHEMA_VERSION
            print(json.dumps(doc, indent=1))
        else:
            print(render(argv))
    except BrokenPipeError:      # `... | head` closing the pipe is fine
        try:
            sys.stdout.close()
        except Exception:
            pass
    return 0
