"""Typed query-lifecycle event stream + listener bus (the port of
`spark_tpu/observability/listener.py`: the same event classes, field
names and callback names, so a listener written for the JAX package
loads here).

Eager torch compiles no stage, so the port's executor never posts
`StageCompiledEvent` (`on_stage_compiled`); the class stays so that
such listeners load. The static analyzer (`analysis/`) posts
`on_analysis`, and the SQL service (`service/server.py`) posts its
`ServiceEvent`s (`on_service`) on its own bus; the bus delivers
whatever is posted.

The SparkListener analog (`SparkListenerBus` / `LiveListenerBus.scala`):
the executor posts typed events at query-lifecycle boundaries and every
subscriber — the event-log writer, the Chrome-trace writer, the metrics
sinks, user listeners, tests — observes the same stream. A listener
raising can never fail a query: the bus isolates callbacks, warns, and
counts the drop (the reference logs and continues likewise).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class QueryStartEvent:
    """Posted when execute_batch enters (once per execution, nested
    subquery executions included — query_id disambiguates)."""

    query_id: int
    ts: float
    plan: str


@dataclass
class StageCompiledEvent:
    """Posted on a compiled-stage cache MISS (the stage was actually
    jitted). `cost` carries the XLA cost/memory analysis when capture
    is on (observability.xlaCost), else None."""

    query_id: int
    ts: float
    stage_key: str
    key_hash: str
    mesh_n: int
    cost: Optional[Dict] = None


@dataclass
class StageCompletedEvent:
    """Posted after each successful stage dispatch (one per AQE
    capacity attempt; `overflow` lists the flags that forced another
    attempt, empty on the converged one)."""

    query_id: int
    ts: float
    stage_key: str
    key_hash: str
    attempt: int
    elapsed_ms: float
    metrics: Dict = field(default_factory=dict)
    overflow: List[str] = field(default_factory=list)


@dataclass
class AnalysisEvent:
    """Posted once per execution when the static analyzer (`analysis/`)
    ran and produced findings.
    `findings` is the event-log-serializable dict form
    (Finding.to_dict)."""

    query_id: int
    ts: float
    findings: List[Dict] = field(default_factory=list)


@dataclass
class FaultEvent:
    """Posted for every recovery action the failure ladder takes
    (transient retry, stage timeout, OOM rung, mesh fallback)."""

    query_id: int
    ts: float
    action: str
    error: str = ""
    site: Optional[str] = None


@dataclass
class ServiceEvent:
    """Posted by the SQL service (`service/` in the JAX package) for every
    admission/lifecycle transition of a submitted query: `action` is
    one of submitted / admitted / queued / rejected / queue_timeout /
    finished / failed / evicted. `query_id` is the SERVICE query id
    (the `GET /queries/<id>` handle), not a session-internal one."""

    query_id: str
    ts: float
    action: str
    session: str = ""
    detail: str = ""


@dataclass
class ShardChunkEvent:
    """Posted by the mesh chunk drivers' per-shard telemetry
    (ShardStreamTelemetry) at each chunk-boundary flush: one record per
    (shard, chunk) with rows/bytes and the per-shard completion wait.
    The StragglerMonitor consumes this stream."""

    query_id: int
    ts: float
    chunk: int
    records: List[Dict] = field(default_factory=list)


@dataclass
class StragglerEvent:
    """Posted by the StragglerMonitor when a shard's rolling median
    per-chunk wait exceeds `spark_tpu.sql.straggler.factor` x the
    all-shard baseline (after `straggler.minChunks` samples). The
    detection half of straggler mitigation — the elastic-mesh
    rebalancer subscribes here."""

    query_id: int
    ts: float
    shard: int
    host: int
    median_ms: float
    baseline_ms: float
    chunks: int
    factor: float


@dataclass
class StreamingBatchEvent:
    """Posted by the micro-batch loop (streaming.py) once per COMMITTED
    batch: `record` is the event-log `streaming` record — batch id,
    offset range, rows in/out, state persistence kind (delta vs
    snapshot) + bytes, quarantined files, sink parts. The event-log
    listener writes it as its own (schema v4, additive) line;
    `history.streaming_summary` replays it."""

    query_id: int
    ts: float
    plan: str
    record: Dict = field(default_factory=dict)


@dataclass
class StreamingTriggerEvent:
    """Posted by the supervised trigger loop (streaming.py): one per
    tick that ran batches, plus the parking tick of a FAILED query.
    `record` is the event-log `trigger` record — tick id, wall-clock
    skew, batches run, supervisor restarts, source kind, reconnects.
    The event-log listener writes it as its own (schema v6, additive)
    line; `history.streaming_summary` folds it in."""

    query_id: int
    ts: float
    plan: str
    record: Dict = field(default_factory=dict)


@dataclass
class QueryEndEvent:
    """Posted when an execution finishes (status 'ok') or fails past
    recovery (status 'error'). `event` is the full event-log record —
    plan, phase times, metrics, spans, stage costs, fault summary."""

    query_id: int
    ts: float
    status: str
    event: Dict
    spans: List = field(default_factory=list)


#: callback names the bus will deliver (anything else is a bug)
CALLBACKS = ("on_query_start", "on_analysis", "on_stage_compiled",
             "on_stage_completed", "on_fault", "on_query_end",
             "on_service", "on_shard_records", "on_straggler",
             "on_streaming_batch", "on_streaming_trigger")


class QueryListener:
    """Subscriber base class — override any subset of the callbacks.

    The SparkListener seat: `session.add_listener(MyListener())`.
    Callbacks run synchronously on the driver thread (the engine's
    driver is single-threaded; the reference's async bus exists to
    decouple executor heartbeats, which have no analog here).
    """

    def on_query_start(self, event: QueryStartEvent) -> None:
        pass

    def on_analysis(self, event: AnalysisEvent) -> None:
        pass

    def on_stage_compiled(self, event: StageCompiledEvent) -> None:
        pass

    def on_stage_completed(self, event: StageCompletedEvent) -> None:
        pass

    def on_fault(self, event: FaultEvent) -> None:
        pass

    def on_query_end(self, event: QueryEndEvent) -> None:
        pass

    def on_service(self, event: ServiceEvent) -> None:
        pass

    def on_shard_records(self, event: ShardChunkEvent) -> None:
        pass

    def on_straggler(self, event: StragglerEvent) -> None:
        pass

    def on_streaming_batch(self, event: StreamingBatchEvent) -> None:
        pass

    def on_streaming_trigger(self,
                             event: StreamingTriggerEvent) -> None:
        pass


class ListenerBus:
    """Synchronous delivery to registered listeners, failure-isolated.

    Lock-guarded (GUARDED_BY: obs.bus): the SQL service posts from
    concurrent worker threads while tests and the service (un)register
    listeners — the listener list and the drop counter are shared
    read-modify-write state. Delivery runs OUTSIDE the lock over a
    snapshot: listeners take their own locks (straggler monitor,
    event-log writer), and holding the bus lock across them would
    invert the registry's lock-order ranking."""

    def __init__(self):
        import threading
        self._lock = threading.Lock()
        self._listeners: List[QueryListener] = []
        #: callbacks dropped because a listener raised
        self.dropped = 0

    def register(self, listener: QueryListener) -> None:
        with self._lock:
            if listener not in self._listeners:
                self._listeners.append(listener)

    def unregister(self, listener: QueryListener) -> None:
        with self._lock:
            if listener in self._listeners:
                self._listeners.remove(listener)

    @property
    def listeners(self) -> List[QueryListener]:
        with self._lock:
            return list(self._listeners)

    def post(self, callback: str, event) -> None:
        assert callback in CALLBACKS, callback
        # snapshot: service threads may (un)register listeners while
        # another thread's query is mid-post
        for listener in self.listeners:
            fn = getattr(listener, callback, None)
            if fn is None:
                continue
            try:
                fn(event)
            except Exception as e:  # noqa: BLE001 — never fail the query
                with self._lock:
                    self.dropped += 1
                warnings.warn(
                    f"query listener {type(listener).__name__}.{callback} "
                    f"raised (dropped): {type(e).__name__}: {e}")
