"""Per-stage spans with Chrome-trace export (the port of
`spark_tpu/observability/spans.py`).

Each QueryExecution records named spans over its lifecycle phases
(parse -> analysis -> optimize -> plan -> ingest -> dispatch -> egress,
the host work between them, one `op:<PhysicalClass>` span per operator
a dispatch computes, and instant marks for AQE re-plans, overflows,
retries and cancels). Eager torch compiles no stage, so there is no
`compile` span; `egress`, the copy of the result to Arrow, is the
port's own. A phase is timed one way, `SpanRecorder.span(...)`: it
records the span, the phase time when it names one, and, while a
torch.profiler is active, a profiler range over the same interval named
`spark_tpu/<span>`, so spans and kernels share the profiler's clock.
Spans use `time.perf_counter` internally (cheap, monotonic); one
wall-clock anchor for the whole process maps them to epoch microseconds
— the Chrome trace-event "X" (complete-event) format, loadable in
Perfetto / chrome://tracing.
"""

from __future__ import annotations

import contextlib
import os
import time
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

#: the prefix of every program range in a torch.profiler trace, which
#: tells them from torch's own ops
RANGE_PREFIX = "spark_tpu/"

#: the process's one (epoch, perf_counter) anchor: every recorder maps
#: its spans onto the epoch clock through it, so the spans of different
#: queries line up in one trace
_ANCHOR_WALL, _ANCHOR_PERF = time.time(), time.perf_counter()


def _range(name: str):
    """A profiler range over a block: torch's C++ fast range (about a
    microsecond under a profiler, where `record_function` takes several
    and more under CUDA tracing)."""
    return torch._C._profiler._RecordFunctionFast(name)


class _Timed:
    """The context `SpanRecorder.span` and `program_range` return: the two
    clock reads of the span around a profiler range (the range only while
    a profiler is active: entering one with none active costs more than
    the span itself). `phase` and `attrs` may change inside the block;
    the span and phase time are recorded at its end when the block did
    not raise and `keep` is still true (the range closes either way)."""

    __slots__ = ("rec", "name", "phase", "attrs", "keep", "t0", "t1",
                 "_range")

    def __init__(self, rec: Optional["SpanRecorder"], name: str,
                 phase: Optional[str], attrs: Dict):
        self.rec, self.name, self.phase, self.attrs = rec, name, phase, attrs
        self.keep = True
        self.t1 = None

    def __enter__(self) -> "_Timed":
        self.t0 = time.perf_counter()
        self._range = None
        if torch.autograd._profiler_enabled():
            self._range = _range(RANGE_PREFIX + self.name)
            self._range.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._range is not None:
            self._range.__exit__(None, None, None)
        self.t1 = time.perf_counter()
        if self.rec is not None and exc_type is None and self.keep:
            self.rec.record(self.name, self.t0, self.t1, phase=self.phase,
                            **self.attrs)
        return False


def program_range(name: str) -> _Timed:
    """Time a block that runs before any recorder exists (`session.sql`'s
    parse): the profiler range while it runs, then `t0`/`t1` on the
    context for the recorder that takes the span later."""
    return _Timed(None, name, None, {})


@dataclass
class Span:
    name: str
    t0: float            # perf_counter seconds
    t1: float
    attrs: Dict = field(default_factory=dict)

    @property
    def dur_ms(self) -> float:
        return (self.t1 - self.t0) * 1e3


class SpanRecorder:
    """Bounded span list and phase times for one QueryExecution
    (query_id = trace tid). `t_origin`, the perf_counter time the
    event log's relative `t0_ms` count from, defaults to the recorder's
    construction; a query parsed before its execution existed starts
    there."""

    def __init__(self, query_id: int, max_spans: int = 1000,
                 max_shard_records: int = 4096,
                 t_origin: Optional[float] = None):
        self.query_id = query_id
        self.max_spans = max_spans
        self.spans: List[Span] = []
        #: seconds by phase (the event log's `phase_times_s`)
        self.phase_times: Dict[str, float] = {}
        #: spans dropped past the bound (surfaced so truncation is
        #: visible, never silent)
        self.dropped = 0
        #: per-shard telemetry records (mesh runs): dicts with shard,
        #: host, chunk, phase, rows, bytes, t0_ms, dur_ms, wait_ms,
        #: source — the event log's `shards` field (schema v3)
        self.shard_records: List[Dict] = []
        self.max_shard_records = max_shard_records
        self.shard_dropped = 0
        self._origin = time.perf_counter() if t_origin is None \
            else t_origin

    def add_shard_records(self, records: List[Dict]) -> None:
        room = self.max_shard_records - len(self.shard_records)
        if room < len(records):
            self.shard_dropped += len(records) - max(room, 0)
            records = records[:max(room, 0)]
        self.shard_records.extend(records)

    def rel_ms(self, t_perf: float) -> float:
        """Perf-counter time as milliseconds since the recorder anchor
        (the shared origin of span t0_ms and shard-record t0_ms)."""
        return round((t_perf - self._origin) * 1e3, 3)

    def record(self, name: str, t0: float, t1: Optional[float] = None,
               phase: Optional[str] = None, **attrs) -> None:
        """A span timed already (a block with no range of its own:
        `span` is the way to time one); `phase` also keeps its seconds
        as that phase's time."""
        if phase is not None:
            self.phase_times[phase] = t1 - t0
        if len(self.spans) >= self.max_spans:
            self.dropped += 1
            return
        self.spans.append(Span(name, t0, t1 if t1 is not None else t0,
                               attrs))

    def span(self, name: str, phase: Optional[str] = None,
             **attrs) -> _Timed:
        """Time a block as the span `name` (and the phase time `phase`
        when given), under a profiler range of the same name while a
        profiler is active."""
        return _Timed(self, name, phase, attrs)

    def mark(self, name: str, **attrs) -> None:
        """Zero-duration span (exported as a Chrome instant event)."""
        t = time.perf_counter()
        self.record(name, t, t, **attrs)

    def wall(self, t_perf: float) -> float:
        """Map a perf_counter time onto the epoch clock (the process's
        one anchor)."""
        return _ANCHOR_WALL + (t_perf - _ANCHOR_PERF)

    def to_dicts(self) -> List[Dict]:
        """Event-log form: relative start + duration in milliseconds."""
        out = []
        for s in self.spans:
            d = {"name": s.name,
                 "t0_ms": self.rel_ms(s.t0),
                 "dur_ms": round(s.dur_ms, 3)}
            if s.attrs:
                d["attrs"] = s.attrs
            out.append(d)
        return out


def to_chrome_trace(recorder: SpanRecorder,
                    pid: Optional[int] = None) -> Dict:
    """Chrome trace-event JSON ({"traceEvents": [...]}) from a
    recorder's spans. Zero-duration spans export as instant events
    (ph "i"), the rest as complete events (ph "X")."""
    pid = pid if pid is not None else os.getpid()
    events = []
    for s in recorder.spans:
        ts_us = recorder.wall(s.t0) * 1e6
        ev = {"name": s.name, "cat": "spark_tpu", "pid": pid,
              "tid": recorder.query_id, "ts": ts_us}
        dur_us = (s.t1 - s.t0) * 1e6
        if dur_us <= 0:
            ev["ph"] = "i"
            ev["s"] = "t"  # thread-scoped instant
        else:
            ev["ph"] = "X"
            ev["dur"] = dur_us
        if s.attrs:
            ev["args"] = {k: v for k, v in s.attrs.items()}
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# Per-shard telemetry (mesh chunk drivers)
# ---------------------------------------------------------------------------

#: the executor installs the current execution's telemetry here around
#: the streaming-materialization phase; the mesh chunk drivers read it
#: (the same context-threading pattern the arbiter's enter_query uses,
#: so driver signatures — which tests monkeypatch — stay unchanged)
_SHARD_TELEMETRY: ContextVar[Optional["ShardStreamTelemetry"]] = \
    ContextVar("spark_tpu_shard_telemetry", default=None)


def current_shard_telemetry() -> Optional["ShardStreamTelemetry"]:
    return _SHARD_TELEMETRY.get()


@contextlib.contextmanager
def use_shard_telemetry(telem: Optional["ShardStreamTelemetry"]):
    token = _SHARD_TELEMETRY.set(telem)
    try:
        yield telem
    finally:
        try:
            if telem is not None:
                telem.finish()
        finally:
            # the reset must survive a raising finish: a stale context
            # var would leak this query's telemetry into the next
            _SHARD_TELEMETRY.reset(token)


class ShardStreamTelemetry:
    """Per-shard/per-chunk flight recorder for the mesh stream
    (`streaming_agg.stream_scan_aggregate_mesh`, which finds it through
    `current_shard_telemetry`). Each chunk dispatch hands over the
    step's per-shard live-row counts — one 0-d (or [1]) int tensor per
    shard, on the shard's device, so appending them costs no copy —
    and the PREVIOUS chunk's counts are flushed at the next chunk
    boundary, where the driver is already doing host work. A flush
    walks the shards in mesh order, timing the wait for each shard's
    device work (a CUDA stream synchronise on the card that holds the
    count; nothing on the CPU, whose work is done when queued) — the
    per-shard completion profile: a straggling card inflates its own
    wait window while shards that kept up read back at once — then
    reads the counts and emits one record per (shard, chunk) plus a
    host-side ingest record. Records land on the SpanRecorder (event-log
    `shards`, schema v3) and are posted on the listener bus
    (`on_shard_records`) for the StragglerMonitor.

    The `shard_chunk` fault seam fires once per (chunk, shard) inside
    the timed wait window, so an injected `slow` fault models exactly
    one straggling shard (hit ordinal = chunk * n_shards + shard + 1).
    A shard's host is the rank of the engine process that drives it (0
    on a one-process mesh; `mesh.shard_hosts`). Shards
    pinned to one card share its stream: the first shard's wait holds
    every shard's work and the others read back at once, so there a
    straggler is only what an injected `slow` fault makes.

    On a mesh that spans engine processes a process times and records
    its own positions (the seam still fires once per global position, so
    the hit ordinals are the one-process mesh's), and each flush gathers
    every process's records (`gather`, an `all_gather_object`) before
    posting them, so every process's StragglerMonitor flags the same
    shard at the same chunk. Every process enters that gather at every
    flush the stream asks for, with its records or an empty list; it
    sits outside the flush's failure isolation and never runs on an
    unwind (`finish()` without `gather`). `active` is agreed by the
    stream's gate: a process whose shardSpans setting keeps it off
    still joins when a peer's is on.
    """

    def __init__(self, recorder: SpanRecorder, mesh, query_id: int,
                 bus=None, source: str = "stream_mesh"):
        self.recorder = recorder
        self.query_id = query_id
        self.bus = bus
        self.source = source
        self.devices = list(mesh.devices)
        self.n = len(self.devices)
        from ..parallel.mesh import shard_hosts
        self.hosts = shard_hosts(mesh)
        #: (chunk, per-shard row counts, row_width, t_dispatch0)
        self._pending: Optional[tuple] = None
        #: whether it records (set by the mesh stream's gate on a cluster)
        self.active = True

    # -- driver-facing hooks (hot path: no device sync) ---------------------

    def chunk_ingested(self, chunk: int, rows: int, nbytes: int,
                       t0: float, t1: float) -> None:
        """Host-side decode of one chunk (the ingest phase): recorded
        directly — it is already host wall-clock, nothing to flush."""
        from ..parallel.cluster import process_rank
        self.recorder.add_shard_records([{
            "shard": None, "host": process_rank(),
            "chunk": int(chunk), "phase": "ingest", "rows": int(rows),
            "bytes": int(nbytes), "t0_ms": self.recorder.rel_ms(t0),
            "dur_ms": round((t1 - t0) * 1e3, 3), "source": self.source}])

    def chunk_dispatched(self, chunk: int, shard_rows, row_width: int,
                         t_dispatch: float, gather=None) -> float:
        """Buffer one chunk's per-shard live-row counts (left on their
        devices; no sync) after flushing the previous chunk's buffer.
        Returns the seconds the flush's `gather` took."""
        if self._pending is not None and self._pending[0] == int(chunk):
            # retried attempt of the SAME chunk (ChunkRetrier replay):
            # discard the failed attempt's buffer — flushing it would
            # emit duplicate (shard, chunk) records (double-counting
            # row totals, skewing straggler medians) off counts the
            # failed dispatch may have poisoned
            self._pending = None
        gather_s = self._flush_pending(gather)
        self._pending = (int(chunk), list(shard_rows), int(row_width),
                         t_dispatch)
        return gather_s

    def finish(self, gather=None) -> None:
        """Flush the last chunk: with `gather` at a stream's normal end
        (every process of a cluster reaches it), without it on an unwind
        (this process's records alone)."""
        self._flush_pending(gather)

    # -- flush (chunk boundary / stream end) --------------------------------

    def _flush_pending(self, gather=None) -> float:
        """Flush the buffered chunk into records. The local flush is
        failure-isolated: a device error surfacing through the wait
        here must neither fail the query nor mask the stream's own
        exception (finish() runs on unwind paths) — the dispatch that
        owns the error re-raises it at the engine's own sync point,
        where the failure ladder classifies it. A raising fault
        injected at the shard_chunk seam is likewise swallowed: the
        seam models a SLOW shard, not a dead one. The gather across
        processes, when given, runs outside that isolation."""
        chunk, records = None, []
        if self._pending is not None:
            chunk = self._pending[0]
            try:
                records = self._flush_pending_inner()
            except Exception as e:  # noqa: BLE001 — never fail the query
                import warnings
                warnings.warn(f"per-shard telemetry flush failed (records "
                              f"dropped): {type(e).__name__}: {e}")
                if gather is None:
                    chunk = None  # nothing to post
        gather_s = 0.0
        if gather is not None:
            t0 = time.perf_counter()
            records = gather(records)
            gather_s = time.perf_counter() - t0
        if chunk is not None and self.bus is not None:
            from .listener import ShardChunkEvent
            self.bus.post("on_shard_records", ShardChunkEvent(
                query_id=self.query_id, ts=time.time(), chunk=chunk,
                records=records))
        return gather_s

    def _flush_pending_inner(self) -> list:
        import torch
        from ..testing import faults
        chunk, counts, row_width, t0 = self._pending
        self._pending = None
        waits = []
        for i in range(self.n):
            w0 = time.perf_counter()
            # fault seam INSIDE the timed window: `slow` on hit
            # chunk*n + shard + 1 models that one shard straggling
            faults.fire("shard_chunk")
            piece = counts[i] if i < len(counts) else None
            if isinstance(piece, torch.Tensor) \
                    and piece.device.type == "cuda":
                torch.cuda.current_stream(piece.device).synchronize()
            waits.append((time.perf_counter() - w0) * 1e3)
        t_done = time.perf_counter()
        rows = [None if i >= len(counts) or counts[i] is None
                else int(counts[i].reshape(-1)[0]) if isinstance(
                    counts[i], torch.Tensor) else int(counts[i])
                for i in range(self.n)]
        records = [{
            "shard": i, "host": self.hosts[i], "chunk": chunk,
            "phase": "compute", "rows": rows[i],
            "bytes": rows[i] * row_width,
            "t0_ms": self.recorder.rel_ms(t0),
            "dur_ms": round((t_done - t0) * 1e3, 3),
            "wait_ms": round(waits[i], 3), "source": self.source,
        } for i in range(self.n) if rows[i] is not None]
        self.recorder.add_shard_records(records)
        return records
