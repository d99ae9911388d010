"""Observability layer: listener bus, spans, device-memory accounting,
metrics (the port of `spark_tpu/observability/`).

The reference splits observability across a typed listener event stream
(`SparkListener` / `EventLoggingListener.scala`), per-operator
`SQLMetrics`, the SQL UI status store (`SQLAppStatusListener`), and the
codahale-backed `MetricsSystem` with pluggable sinks. This package is
the engine-sized analog, organized as the JAX package's is, with its
module, class, event and field names and its event-log schema, so the
two packages' logs are read by the same tools:

- ``listener``: the typed event stream. ``QueryListener`` is the
  SparkListener seat (on_query_start / on_stage_completed / on_fault /
  on_query_end); ``ListenerBus`` delivers events so the event log, the
  Chrome-trace writer, the metrics sinks, and tests are all just
  subscribers. Eager torch compiles no stage, so no
  ``StageCompiledEvent`` is posted; the static analyzer
  (``analysis/``) posts ``on_analysis`` once per execution with
  findings.
- ``spans``: per-stage spans (parse -> analysis -> optimize -> plan ->
  ingest -> dispatch -> egress, an ``op:<PhysicalClass>`` span an
  operator, marks for AQE re-plans, retries and cancels), each a
  ``spark_tpu/`` torch.profiler range while a profiler is active, with
  one wall-clock anchor for the process, exportable as Chrome
  trace-event JSON (Perfetto-loadable); the mesh stream's per-shard
  telemetry.
- ``device_cost``: the counterpart of the JAX package's ``xla_cost``:
  the peak device memory an executed attempt allocated, its argument
  and output bytes, and the card's capacity.
- ``metrics``: the session's metrics registry (counters/gauges/timers/
  log-bucketed latency histograms) with JSONL + Prometheus
  text-exposition sinks, plus the registered per-operator metric name
  prefixes ``ExecContext.add_metric`` enforces.
- ``sinks``: the built-in bus subscribers (event-log writer with
  rotation, Chrome-trace writer, metrics-sink updater) a session
  installs at construction.
- ``status_store``: the ``AppStatusStore`` seat — bounded, typed,
  listener-bus-fed rolling view of engine health (queries in flight,
  cache hit rates, latency percentiles, SLO burn), heartbeat-sampled
  into ring time-series.
- ``flight_recorder``: always-on bounded rings of recent events per
  subsystem; dumps a self-contained diagnostic bundle (rings, plans,
  conf, metrics, thread stacks, event-log tail) on FATAL / OOM-ladder
  exhaustion / non-convergent recovery or on demand.
- ``straggler``: straggler detection over the per-shard telemetry.
"""

from .listener import (AnalysisEvent, FaultEvent, ListenerBus,
                       QueryEndEvent, QueryListener, QueryStartEvent,
                       ServiceEvent, ShardChunkEvent, StageCompiledEvent,
                       StageCompletedEvent, StragglerEvent)
from .flight_recorder import FlightRecorder
from .metrics import (METRIC_PREFIXES, Histogram, MetricsRegistry,
                      is_registered_metric)
from .spans import (ShardStreamTelemetry, Span, SpanRecorder,
                    current_shard_telemetry, to_chrome_trace,
                    use_shard_telemetry)
from .status_store import StatusStore
from .straggler import StragglerMonitor

__all__ = [
    "AnalysisEvent", "FaultEvent", "FlightRecorder", "Histogram",
    "ListenerBus", "MetricsRegistry", "METRIC_PREFIXES",
    "QueryEndEvent", "QueryListener", "QueryStartEvent", "ServiceEvent",
    "ShardChunkEvent", "ShardStreamTelemetry", "Span", "SpanRecorder",
    "StageCompiledEvent", "StageCompletedEvent", "StatusStore",
    "StragglerEvent", "StragglerMonitor", "current_shard_telemetry",
    "is_registered_metric", "to_chrome_trace", "use_shard_telemetry",
]
