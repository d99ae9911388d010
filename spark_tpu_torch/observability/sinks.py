"""Built-in listener-bus subscribers: event log, Chrome trace, metrics
(the port of `spark_tpu/observability/sinks.py`).

The port writes the JAX package's event-log schema
(`EVENT_LOG_SCHEMA_VERSION`), its file names and its field names, so
either package's `history.read_event_log` and
`scripts/events_tool.py` read the other's logs.

Installed by the session at construction; each checks conf AT EVENT
TIME, so flipping `eventLog.dir` / `trace.dir` / `metrics.sink`
mid-session takes effect on the next query (the tests' idiom). Every
subscriber is write-only observability: failures warn and the query
proceeds (the reference's EventLoggingListener logs and continues).
"""

from __future__ import annotations

import json
import os
import re
import warnings

import torch

from .listener import (QueryEndEvent, QueryListener,
                       StreamingBatchEvent, StreamingTriggerEvent)
from .metrics import rank_suffix
from .spans import to_chrome_trace

# v3: per-shard telemetry (`shards` records + `shards_dropped`), the
# runtime-annotated `plan_tree`, and `predictions` (analyzer
# self-grading). v4: the per-batch `streaming` record (micro-batch
# lifecycle: offsets, delta-vs-snapshot state bytes, quarantines).
# v5: the per-query `udf` record (lane mode, Arrow batch/row totals,
# exec ms, worker restarts). v6: the per-tick `trigger` record from
# the supervised streaming trigger loop (tick id, skew, batches run,
# supervisor restarts, source kind, reconnects). v7: the per-query
# `rule_trace` record (per-(batch, rule) optimizer application
# counters + optional before/after tree diffs from
# analysis/plan_integrity.py). Purely additive — older logs replay
# unchanged (scripts/events_tool.py validates every published
# version).
EVENT_LOG_SCHEMA_VERSION = 7


def json_default(o):
    """`json.dumps(default=)` hook covering the scalar types that leak
    into event dicts: numpy scalars and 0-d arrays, torch 0-d tensors
    (their value), numpy arrays and torch tensors (lists), `torch.dtype`
    (its name, as `str` prints it: "torch.int64"), sets. Anything else
    degrades to repr — an event line must never fail to serialize."""
    if isinstance(o, torch.dtype):
        return str(o)
    item = getattr(o, "item", None)
    if item is not None and getattr(o, "shape", None) in ((), None):
        try:
            return item()
        except Exception:  # noqa: BLE001
            pass
    tolist = getattr(o, "tolist", None)
    if tolist is not None:
        try:
            return tolist()
        except Exception:  # noqa: BLE001
            pass
    if isinstance(o, (set, frozenset)):
        return sorted(o)
    return repr(o)


class EventLogListener(QueryListener):
    """Appends one JSON line per query execution to
    `<eventLog.dir>/app-<app_id>.jsonl` (the EventLoggingListener.scala
    seat). `app_id` is session-unique (pid + random token): a bare pid
    collides across reruns on the same machine. An engine process of a
    cluster adds its rank (`app-<app_id>-r<rank>.jsonl`,
    `metrics.rank_suffix`), so processes that share the directory never
    write one file.

    Rotation: when `spark_tpu.sql.eventLog.maxBytes` > 0 and the live
    file has reached it, the live file rolls to `app-<app_id>.N.jsonl`
    (N monotonically increasing) and a fresh live file starts —
    `history.read_event_log` replays rolled files in N order, live
    file last."""

    #: built-in subscribers don't force event construction on their
    #: own (executor._events_enabled ignores them); conf does
    _builtin = True

    DIR_KEY = "spark_tpu.sql.eventLog.dir"
    MAX_BYTES_KEY = "spark_tpu.sql.eventLog.maxBytes"

    def __init__(self, session):
        import threading
        self._session = session
        #: serializes roll+append: concurrent query-end events from
        #: service worker threads must not interleave half-written
        #: JSON lines or double-roll the live file
        self._write_lock = threading.Lock()

    def _roll(self, log_dir: str, base: str, max_bytes: int) -> None:
        try:
            size = os.path.getsize(base)
        except OSError:
            return
        if size < max_bytes:
            return
        stem = self._stem()
        rx = re.compile(re.escape(f"app-{stem}.") + r"(\d+)\.jsonl$")
        n = 0
        for name in os.listdir(log_dir):
            m = rx.match(name)
            if m:
                n = max(n, int(m.group(1)))
        os.replace(base, os.path.join(log_dir, f"app-{stem}.{n + 1}.jsonl"))

    def _stem(self) -> str:
        return self._session.app_id + rank_suffix(self._session.conf)

    def on_query_end(self, event: QueryEndEvent) -> None:
        log_dir = str(self._session.conf.get(self.DIR_KEY))
        if not log_dir:
            return
        try:
            with self._write_lock:
                os.makedirs(log_dir, exist_ok=True)
                base = os.path.join(log_dir, f"app-{self._stem()}.jsonl")
                max_bytes = int(self._session.conf.get(self.MAX_BYTES_KEY))
                if max_bytes > 0 and os.path.exists(base):
                    self._roll(log_dir, base, max_bytes)
                line = json.dumps(event.event, default=json_default)
                with open(base, "a") as f:
                    f.write(line + "\n")
        except (OSError, TypeError, ValueError) as e:
            # never fail a completed query over observability I/O
            warnings.warn(f"event log write failed: {e}")

    def on_streaming_batch(self, event: StreamingBatchEvent) -> None:
        """One (schema v4) line per committed micro-batch: the
        `streaming` record next to the regular per-execution lines, so
        `history.streaming_summary` replays batch lifecycle from the
        same log."""
        log_dir = str(self._session.conf.get(self.DIR_KEY))
        if not log_dir:
            return
        line_event = {
            "ts": event.ts, "query_id": event.query_id, "status": "ok",
            "plan": event.plan,
            "schema_version": EVENT_LOG_SCHEMA_VERSION,
            "streaming": event.record,
        }
        self.on_query_end(QueryEndEvent(
            query_id=event.query_id, ts=event.ts, status="ok",
            event=line_event))

    def on_streaming_trigger(self,
                             event: StreamingTriggerEvent) -> None:
        """One (schema v6) line per trigger-loop tick that ran
        batches (plus the parking tick of a FAILED query): the
        `trigger` record — unattended-operation lifecycle next to the
        per-batch `streaming` lines."""
        log_dir = str(self._session.conf.get(self.DIR_KEY))
        if not log_dir:
            return
        line_event = {
            "ts": event.ts, "query_id": event.query_id, "status": "ok",
            "plan": event.plan,
            "schema_version": EVENT_LOG_SCHEMA_VERSION,
            "trigger": event.record,
        }
        self.on_query_end(QueryEndEvent(
            query_id=event.query_id, ts=event.ts, status="ok",
            event=line_event))


class ChromeTraceListener(QueryListener):
    """Writes `<trace.dir>/query-<app_id>-<id>.trace.json` per
    execution when `spark_tpu.sql.trace.dir` is set — Chrome
    trace-event JSON, load in Perfetto / chrome://tracing.
    Re-executing the same QueryExecution (bench warmups) rewrites the
    file with the accumulated spans."""

    _builtin = True

    DIR_KEY = "spark_tpu.sql.trace.dir"

    def __init__(self, session):
        self._session = session

    def on_query_end(self, event: QueryEndEvent) -> None:
        trace_dir = str(self._session.conf.get(self.DIR_KEY))
        if not trace_dir or event.spans is None:
            return
        try:
            os.makedirs(trace_dir, exist_ok=True)
            # app_id in the name: query ids restart at 1 per session,
            # so two sessions sharing trace.dir must not clobber
            path = os.path.join(
                trace_dir,
                f"query-{self._session.app_id}"
                f"{rank_suffix(self._session.conf)}"
                f"-{event.query_id:05d}.trace.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(to_chrome_trace(event.spans), f,
                          default=json_default)
            os.replace(tmp, path)
        except (OSError, TypeError, ValueError) as e:
            warnings.warn(f"chrome trace write failed: {e}")


class MetricsSinkListener(QueryListener):
    """Folds each execution's observables into the session metrics
    registry and flushes the configured sinks — engine-wide counters
    (queries, device cache, shuffle bytes, runtime
    filters, faults) live here, per-operator traced metrics stay in
    the event log."""

    _builtin = True

    #: SLO knob: 0 disables burn accounting
    SLO_KEY = "spark_tpu.service.slo.latencyMs"
    STATUS_KEY = "spark_tpu.sql.status.enabled"

    def __init__(self, session):
        self._session = session

    def on_query_end(self, event: QueryEndEvent) -> None:
        m = self._session.metrics
        m.counter("queries_total").inc()
        if event.status not in ("ok", "cancelled", "deadline_exceeded"):
            # lifecycle stops are not failures: they carry their own
            # query_cancelled / query_deadline_exceeded counters
            m.counter("queries_failed").inc()
        ev = event.event or {}
        phases = ev.get("phase_times_s") or {}
        if "execution" in phases:
            m.timer("query_execution").observe(float(phases["execution"]))
        metrics = ev.get("metrics") or {}
        for prefix, counter in (("exch_bytes_", "shuffle_bytes"),
                                ("exch_rows_", "shuffle_rows"),
                                ("rtf_tested_", "rtf_tested"),
                                ("rtf_pruned_", "rtf_pruned")):
            total = sum(int(v) for k, v in metrics.items()
                        if k.startswith(prefix))
            if total:
                m.counter(counter).inc(total)
        fault_summary = ev.get("fault_summary") or {}
        for action, count in fault_summary.items():
            # recovery-ACTION counts only: "events" is a record list
            # and retry_backoff_ms is a duration, not a count
            if action in ("events", "retry_backoff_ms"):
                continue
            if isinstance(count, (int, float)):
                m.counter(f"fault_{action}").inc(int(count))
        backoff_ms = fault_summary.get("retry_backoff_ms")
        if backoff_ms:
            m.timer("fault_retry_backoff").observe(
                float(backoff_ms) / 1e3)
        # device-cache state (pull model: the cache is process-global)
        try:
            from ..io.device_cache import CACHE
            for name, value in CACHE.stats().items():
                m.gauge(f"device_cache_{name}").set(value)
        except Exception:  # noqa: BLE001 — gauges are best-effort
            pass
        self._observe_latency(event, phases)
        m.flush(self._session.conf)

    def _observe_latency(self, event: QueryEndEvent, phases) -> None:
        """Log-bucketed latency histograms + SLO burn counters (the
        AppStatusStore's taskTime/SQL-metrics percentile seat):
        end-to-end and per-phase distributions, a per-query-class
        distribution keyed by the plan's root operator, and — when
        `service.slo.latencyMs` > 0 — attainment counters for the
        `/status` burn-rate line. Conf-gated at event time on
        `sql.status.enabled` (histograms off ⇒ zero cost here)."""
        if not phases:
            return  # streaming/trigger lines carry no phase data
        if not bool(self._session.conf.get(self.STATUS_KEY)):
            return
        m = self._session.metrics
        e2e_ms = sum(float(v) for v in phases.values()) * 1e3
        m.histogram("status_latency_ms").observe(e2e_ms)
        for phase, secs in phases.items():
            m.histogram(f"status_phase_ms_{phase}").observe(
                float(secs) * 1e3)
        cls = _query_class(event.event.get("plan"))
        if cls:
            m.histogram(f"status_class_ms_{cls}").observe(e2e_ms)
        # the service's SLO target (0: burn counting off)
        target_ms = int(self._session.conf.get(self.SLO_KEY) or 0)
        if target_ms > 0:
            m.counter("slo_queries_total").inc()
            if e2e_ms > target_ms:
                m.counter("slo_burned_total").inc()
                m.counter("slo_burn_ms_total").inc(
                    int(e2e_ms - target_ms))

    def on_streaming_batch(self, event: StreamingBatchEvent) -> None:
        # the streaming_* counters are incremented at the source
        # (StreamingQuery / StateStore); per-batch flush keeps the
        # exposition file current for long-running streams that never
        # execute a regular (query-end-posting) batch query
        self._session.metrics.flush(self._session.conf)

    def on_streaming_trigger(self,
                             event: StreamingTriggerEvent) -> None:
        # same rationale: an unattended stream's reconnect/spill
        # counters must reach the exposition file between query ends
        self._session.metrics.flush(self._session.conf)


_CLASS_TOKEN = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


def _query_class(plan) -> str:
    """Query-class label for per-class latency histograms: the plan's
    root operator name (first identifier of the plan string — stable
    across literal/column differences, bounded cardinality: one class
    per operator type, not per query)."""
    if not plan:
        return ""
    m = _CLASS_TOKEN.search(str(plan)[:80])
    return m.group(0)[:24].lower() if m else ""


def install_default_listeners(session) -> None:
    """Register the built-in subscribers on a session's bus (order
    matters only for determinism: event log, trace, metrics, flight
    recorder, straggler monitor, elastic rebalancer — the rebalancer
    after the monitor that feeds it)."""
    from ..parallel.elastic import ElasticRebalancer
    from .flight_recorder import FlightRecorder
    from .straggler import StragglerMonitor
    session.listeners.register(EventLogListener(session))
    session.listeners.register(ChromeTraceListener(session))
    session.listeners.register(MetricsSinkListener(session))
    session.listeners.register(FlightRecorder(session))
    session.listeners.register(StragglerMonitor(session))
    session.listeners.register(ElasticRebalancer())


def make_app_id() -> str:
    """Session-unique event-log identity: pid alone collides across
    reruns, so suffix a random token (the session's `app_id`)."""
    import uuid
    return f"{os.getpid()}-{uuid.uuid4().hex[:8]}"
