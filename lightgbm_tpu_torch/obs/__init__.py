"""Observability of the port (``lightgbm_tpu/obs/``, docs/OBSERVABILITY.md).

* :mod:`.trace`: the nested-span tracer (Chrome-trace JSON/JSONL,
  mirrored into ``torch.profiler.record_function``);
* :mod:`.counters`: process-wide counters, gauges and events;
* :mod:`.memory`: the device-memory model, its pre-flight, the census
  and the live memory monitor;
* :mod:`.collectives`: the collectives' counts;
* :mod:`.flight`: the per-rank flight recorder, and the supervisor's
  straggler verdicts over its streams;
* :mod:`.metrics`: the live Prometheus view and its exporter thread;
* :mod:`.devprof`: device-time attribution over ``torch.profiler``;
* :mod:`.model_quality`: the split audit, the training distribution and
  TreeSHAP;
* :mod:`.report`: ``python -m lightgbm_tpu_torch.obs <trace>...``.

Armed by ``trace_path``, ``telemetry``, ``device_profile``,
``obs_stream_path``, ``metrics_port`` and ``model_quality``
(``engine.train``).
"""
