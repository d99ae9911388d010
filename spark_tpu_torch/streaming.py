"""Structured streaming: the micro-batch execution loop (the port of
`spark_tpu/streaming.py`; same names, same on-disk layout, eager torch
where the JAX package traces one program per trigger).

A scaled-to-this-engine implementation of the reference's structured
streaming core (`execution/streaming/MicroBatchExecution.scala:39`,
`StreamExecution.scala:69`): a host-driven loop that

1. polls sources for their latest offsets and WRITES THE PLANNED RANGE
   to the offset log BEFORE executing (`offsetLog:219`, an
   `HDFSMetadataLog` analog — JSON files named by batch id);
2. runs the query over exactly the logged range — stateless plans
   execute the batch slice through the normal engine; streaming
   aggregations fold the slice into versioned accumulator tables whose
   persistence is the incremental state store
   (`execution/state_store.py`: changed-group deltas between periodic
   snapshots, the RocksDBStateStoreProvider seat);
3. emits to the sink, then commits to the commit log (`commitLog:226`).

Exactly-once = offset log ∧ versioned state ∧ idempotent sinks: on
restart, a planned-but-uncommitted batch re-runs over the SAME logged
range against the last committed state version, and sinks are keyed by
batch id (the memory sink replaces a replayed batch's entry; the file
sink's atomic per-batch manifest makes a replay overwrite its own
parts), so replays change nothing. The in-memory state is only adopted
AFTER the commit-log write, so an in-process failure anywhere in the
batch leaves the query at the committed version — retrying
`process_available()` on the same object is as safe as a restart.

Crash seams: `stream_source_list`, `stream_offset_write`,
`stream_state_commit` and `stream_sink_emit` (testing/faults.py) each
fire before their boundary's action; the durability chaos matrix
(tests/test_streaming_durability.py) kills the loop at every seam and
proves a fresh query over the same checkpoint loses and duplicates
nothing.

Unattended operation: `query.start(trigger_ms=...)` runs the same
loop on a supervised daemon thread — a wall-clock trigger that
classifies batch failures through the execution/failures.py taxonomy
(TRANSIENT ticks retry under the bounded RetryPolicy backoff ladder;
FATAL errors park the query in a structured FAILED status instead of
wedging or dying silently), paces with skip-don't-queue overrun
semantics, and is cancellable/deadline-capped through the
execution/lifecycle.py token (`stop()` joins the thread bounded;
`live_queries()` lists the running loops, which the status store
samples). The socket source (io/network_source.py) extends exactly-once
over a network hop: frames are persisted before they become visible
as offsets, so the reconnect ladder replays nothing and loses
nothing. Event-time keyed state larger than
`spark_tpu.streaming.state.spillBytes` reroutes residency through the
hash-partitioned host backend (execution/external.py:
SpillableKeyedState); the persisted deltas/snapshots are identical,
so crash recovery is unchanged. The unattended seams —
`stream_net_connect`, `stream_net_recv`, `trigger_tick`,
`state_spill` — get their own chaos matrix in
tests/test_streaming_unattended.py.

Sources: `MemoryStream` (the deterministic test source) and
`FileStreamSource` (directory tailing with a persisted seen-file log;
corrupt files quarantine instead of wedging the stream). Sink:
in-memory results per batch, optionally tee'd to a `FileStreamSink`
(per-batch parquet parts + `_metadata` manifest — readers only see
manifested batches).

On the card: a stateful trigger ingests its slice onto the session's
device (`Batch.from_arrow`), replays the operators below the aggregate
and folds the rows into the carried accumulator tables with
`HashAggregateExec.direct_update_tables`, which sends the sums through
the hand-written dense group-by kernels (`execution/dense_groupby.py`:
`dense_sums_smem` up to 512 slots, `dense_sums_global` up to 2^20). The
update returns NEW tables and never writes into the committed ones, so a
failed save leaves the pre-update state alive for an exact replay.
Persistence copies the full tables to the host each trigger and diffs
there: the device-to-host copy is O(state), but only the CHANGED groups
reach disk (the delta). Every tensor names the session's device, also
on the trigger loop's thread, whose current CUDA device is cuda:0.

`last_times` holds the newest batch's phase times in host milliseconds
(slice decode, ingest, update, state copy, diff and write, finalize and
emit); with `sync_phases` set the loop synchronizes the device at each
phase boundary, so that a phase's time includes its device work.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import pandas as pd
import pyarrow as pa
import torch

from . import functions as F  # noqa: F401  (user convenience re-export)
from .columnar import Batch
from .plan import logical as L

FILE_STRICT_KEY = "spark_tpu.streaming.source.file.strict"
RETAIN_KEY = "spark_tpu.streaming.retainBatches"
TRIGGER_MAX_RESTARTS_KEY = "spark_tpu.streaming.trigger.maxRestarts"
TRIGGER_BACKOFF_KEY = "spark_tpu.streaming.trigger.backoffMs"
SPILL_BYTES_KEY = "spark_tpu.streaming.state.spillBytes"
SPILL_PARTS_KEY = "spark_tpu.streaming.state.spillPartitions"


def empty_table(schema_df) -> pa.Table:
    """The empty Arrow table of a source's schema: from a pandas frame
    (its columns' types, as in the JAX package) or, exactly, from an
    Arrow table or schema (decimal precisions and dictionary columns,
    which an empty pandas frame cannot carry)."""
    if isinstance(schema_df, pa.Schema):
        return schema_df.empty_table()
    if isinstance(schema_df, pa.Table):
        return schema_df.slice(0, 0)
    return pa.Table.from_pandas(schema_df.iloc[0:0], preserve_index=False)


class _MetadataLog:
    """Numbered JSON files with atomic rename — the
    `HDFSMetadataLog`/`CheckpointFileManager` contract in miniature.

    Durability: entries are flushed + fsync'd before the rename, so a
    power cut can tear at most the not-yet-renamed tmp file. A torn or
    empty NEWEST entry (crash mid-write on a filesystem that reordered
    the flush) is skipped by `latest()` with a warning and the
    `streaming_log_corrupt` counter — recovery falls back one entry
    instead of crashing the whole restart."""

    def __init__(self, path: str, metrics=None):
        self.path = path
        self.metrics = metrics
        os.makedirs(path, exist_ok=True)

    def _ids(self) -> List[int]:
        return sorted(int(f) for f in os.listdir(self.path)
                      if f.isdigit())

    def _read(self, i: int):
        with open(os.path.join(self.path, str(i))) as f:
            return json.load(f)

    def _note_corrupt(self, i: int, exc) -> None:
        warnings.warn(
            f"skipping corrupt metadata log entry "
            f"{os.path.join(self.path, str(i))} "
            f"({type(exc).__name__}: {exc}); falling back to the "
            f"previous entry")
        if self.metrics is not None:
            self.metrics.counter("streaming_log_corrupt").inc()

    def latest(self):
        for i in reversed(self._ids()):
            try:
                return i, self._read(i)
            except (ValueError, OSError) as e:
                # a torn/empty newest entry must not wedge recovery
                self._note_corrupt(i, e)
        return None, None

    def read_all(self) -> List[dict]:
        """Entries 0..n-1 in id order, stopping at the first gap or
        corrupt entry (entries are written in order, so anything past
        a tear is from a torn future, not the committed past)."""
        out: List[dict] = []
        for want, i in enumerate(self._ids()):
            if i != want:
                break
            try:
                out.append(self._read(i))
            except (ValueError, OSError) as e:
                self._note_corrupt(i, e)
                break
        return out

    def read_all_items(self) -> List[tuple]:
        """(id, payload) for every readable entry, id order — ids may
        be sparse (the file sink's manifest skips batches that emitted
        nothing)."""
        out = []
        for i in self._ids():
            try:
                out.append((i, self._read(i)))
            except (ValueError, OSError) as e:
                self._note_corrupt(i, e)
        return out

    def add(self, batch_id: int, payload: dict) -> None:
        from .execution.state_store import fsync_replace
        final = os.path.join(self.path, str(batch_id))
        tmp = final + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        fsync_replace(tmp, final)


class MemoryStream:
    """An appendable in-memory source (the reference's `MemoryStream` —
    the deterministic test source behind StreamTest.scala:342)."""

    source_kind = "memory"

    def __init__(self, session, schema_df: pd.DataFrame):
        self.session = session
        self._table = empty_table(schema_df)
        self._batches: List[pa.Table] = []

    def add_data(self, df: pd.DataFrame) -> None:
        self._batches.append(pa.Table.from_pandas(df, preserve_index=False))

    addData = add_data

    def attach_checkpoint(self, path: str) -> None:
        pass  # in-memory offsets need no persisted seen log

    def latest_offset(self) -> int:
        return len(self._batches)

    def slice(self, start: int, end: int) -> pa.Table:
        tables = self._batches[start:end]
        if not tables:
            return self._table
        return pa.concat_tables(tables)

    def to_df(self):
        """A DataFrame over a placeholder scan; the streaming loop swaps
        the placeholder for each micro-batch's slice (the reference's
        logical-plan rewrite in `MicroBatchExecution.runBatch:525`)."""
        from .dataframe import DataFrame
        return DataFrame(self.session, _StreamSource(self))


class FileStreamSource:
    """Directory-tailing source (the `FileStreamSource.scala:73`
    analog): offsets are indices into a PERSISTED seen-file log
    (`<checkpoint>/sources/0/`, one fsync'd JSON entry per discovered
    file, discovery ordered by (mtime, name)), so a restart replays
    exactly the files a planned batch covered.

    Corrupt/partial files: a file that fails to decode is QUARANTINED
    — the failure is recorded into its seen-log entry, the
    `streaming_files_quarantined` counter ticks, and the batch (and
    every replay of it) skips the file — unless
    `spark_tpu.streaming.source.file.strict` is set, in which case the
    batch fails instead."""

    source_kind = "file"

    def __init__(self, session, path: str,
                 schema_df: Optional[pd.DataFrame] = None,
                 format: str = "parquet"):
        from .io.sources import decode_stream_file, list_stream_files
        self.session = session
        self.path = path
        self.format = format
        os.makedirs(path, exist_ok=True)
        if schema_df is not None:
            self._table = empty_table(schema_df)
        else:
            entries = list_stream_files(path)
            if not entries:
                raise ValueError(
                    f"file stream over empty directory {path!r} needs "
                    f"an explicit schema_df (no file to infer from)")
            first = decode_stream_file(
                os.path.join(path, entries[0]["name"]), format)
            self._table = first.slice(0, 0)
        self._seen: List[dict] = []
        self._log: Optional[_MetadataLog] = None

    def attach_checkpoint(self, path: str) -> None:
        """Bind (or re-bind on restart) the persisted seen-file log;
        the log on disk is authoritative over any in-memory view."""
        self._log = _MetadataLog(path, metrics=self.session.metrics)
        self._seen = self._log.read_all()

    def _persist(self, idx: int) -> None:
        if self._log is not None:
            self._log.add(idx, self._seen[idx])

    def latest_offset(self) -> int:
        """Discover new files and append them to the seen log; the
        offset is simply how many files have ever been seen."""
        from .io.sources import list_stream_files
        known = {e["name"] for e in self._seen}
        for e in list_stream_files(self.path):
            if e["name"] in known:
                continue
            e["quarantined"] = None
            self._seen.append(e)
            self._persist(len(self._seen) - 1)
        return len(self._seen)

    def slice(self, start: int, end: int) -> pa.Table:
        from .io.sources import decode_stream_file
        if end > len(self._seen):
            # a torn seen-log tail lost entries a PLANNED offset range
            # covers. Discovery order is deterministic ((mtime, name),
            # already-seen names skipped), so re-discovering appends
            # the lost files back at their original indices — the
            # self-healing path. Still short afterwards = the files
            # themselves are gone: fail loudly rather than silently
            # committing a batch that skipped planned data.
            self.latest_offset()
        if end > len(self._seen):
            raise RuntimeError(
                f"seen-file log under {self.path!r} has "
                f"{len(self._seen)} entries but the planned offset "
                f"range is [{start}, {end}): files covered by a "
                f"planned batch vanished; cannot recover exactly-once")
        strict = bool(self.session.conf.get(FILE_STRICT_KEY))
        tables = []
        for i in range(start, end):
            entry = self._seen[i]
            if entry.get("quarantined"):
                continue  # quarantined on a previous attempt: stays out
            full = os.path.join(self.path, entry["name"])
            try:
                t = decode_stream_file(full, self.format)
                t = self._conform(t)
            except Exception as e:  # noqa: BLE001 — decode = quarantine
                if strict:
                    raise RuntimeError(
                        f"stream file {full!r} failed to decode under "
                        f"streaming.source.file.strict: "
                        f"{type(e).__name__}: {e}") from e
                entry["quarantined"] = f"{type(e).__name__}: {e}"[:200]
                self._persist(i)
                self.session.metrics.counter(
                    "streaming_files_quarantined").inc()
                warnings.warn(
                    f"quarantined corrupt stream file {full!r}: "
                    f"{entry['quarantined']}")
                continue
            if t.num_rows:
                tables.append(t)
        if not tables:
            return self._table
        return pa.concat_tables(tables)

    def _conform(self, t: pa.Table) -> pa.Table:
        """Project/cast a decoded file onto the stream schema; a file
        that cannot conform is as corrupt as one that cannot parse."""
        if t.schema == self._table.schema:
            return t
        return t.select(self._table.column_names).cast(self._table.schema)

    def quarantined(self) -> List[dict]:
        """The quarantined seen-log entries (path + failure reason)."""
        return [dict(e, path=os.path.join(self.path, e["name"]))
                for e in self._seen if e.get("quarantined")]

    def to_df(self):
        from .dataframe import DataFrame
        return DataFrame(self.session, _StreamSource(self))


class _StreamSource(L.LeafPlan):
    """Logical placeholder for a streaming source."""

    def __init__(self, stream):
        self.stream = stream
        self.children = ()

    def schema(self):
        from .io.sources import ArrowTableSource
        return ArrowTableSource("__stream__", self.stream._table).schema()

    def simple_string(self):
        return f"StreamSource({getattr(self.stream, 'source_kind', '?')})"


class FileStreamSink:
    """Per-batch parquet parts committed by an atomic batch manifest —
    the `FileStreamSink.scala` / `_spark_metadata` contract: a part
    file only exists for readers once its batch's manifest entry
    landed (fsync + atomic rename), and a REPLAYED batch rewrites its
    own deterministically-named parts, so crash-replay can neither
    lose nor duplicate sink rows."""

    def __init__(self, session, path: str, output_mode: str):
        self.session = session
        self.path = path
        self.output_mode = output_mode
        os.makedirs(path, exist_ok=True)
        self._manifest = _MetadataLog(os.path.join(path, "_metadata"),
                                      metrics=session.metrics)

    def emit(self, batch_id: int, pdf: pd.DataFrame) -> int:
        import pyarrow.parquet as pq
        from .execution.state_store import fsync_replace
        name = f"part-{batch_id:05d}.parquet"
        full = os.path.join(self.path, name)
        tmp = full + ".tmp"
        pq.write_table(pa.Table.from_pandas(pdf, preserve_index=False),
                       tmp)
        fsync_replace(tmp, full)
        self._manifest.add(batch_id, {"parts": [name],
                                      "rows": int(len(pdf)),
                                      "mode": self.output_mode})
        return 1

    def prune(self, committed: int, retain: int) -> None:
        """Complete-mode garbage collection: every batch rewrites the
        FULL result, so parts superseded by more than the retention
        window are dead weight — retire their manifest entries and
        files. Append-mode parts ARE the data and are never pruned."""
        if self.output_mode != "complete":
            return
        floor = committed - int(retain)
        for batch_id, payload in self._manifest.read_all_items():
            if batch_id >= floor:
                continue
            try:
                os.remove(os.path.join(self._manifest.path,
                                       str(batch_id)))
            except OSError:
                pass
            for part in payload.get("parts", []):
                try:
                    os.remove(os.path.join(self.path, part))
                except OSError:
                    pass

    @staticmethod
    def read(path: str) -> pd.DataFrame:
        """Manifested rows only (unmanifested parts are invisible —
        they belong to a batch that never committed). Append-mode
        output concatenates every manifested batch; complete-mode
        output is the LATEST manifested batch (each batch rewrites the
        whole result)."""
        log = _MetadataLog(os.path.join(path, "_metadata"))
        items = log.read_all_items()
        if not items:
            return pd.DataFrame()
        mode = items[-1][1].get("mode", "append")
        if mode == "complete":
            items = items[-1:]
        frames = []
        for _, payload in items:
            for part in payload.get("parts", []):
                frames.append(pd.read_parquet(os.path.join(path, part)))
        if not frames:
            return pd.DataFrame()
        return pd.concat(frames, ignore_index=True)


def read_sink(path: str) -> pd.DataFrame:
    """Module-level alias of FileStreamSink.read (the reader side of
    the manifest contract)."""
    return FileStreamSink.read(path)


# ---------------------------------------------------------------------------
# Live-query registry + supervised trigger status
# ---------------------------------------------------------------------------

#: queries with a RUNNING trigger loop, keyed by the "stream-<n>" live
#: id (`live_queries()` lists them, `get_live(id).stop()` stops
#: one). Registered in start(),
#: unregistered by the loop's finally (and again, idempotently, by
#: stop()). The lock is taken alone, never with a query's
#: _TriggerStatus lock.
_LIVE_LOCK = threading.Lock()
_LIVE: Dict[str, "StreamingQuery"] = {}
_LIVE_SEQ = 0


def _register_live(q: "StreamingQuery") -> str:
    global _LIVE_SEQ
    with _LIVE_LOCK:
        _LIVE_SEQ += 1
        live_id = f"stream-{_LIVE_SEQ}"
        _LIVE[live_id] = q
    return live_id


def _unregister_live(live_id: Optional[str]) -> None:
    if live_id is None:
        return
    with _LIVE_LOCK:
        _LIVE.pop(live_id, None)


def get_live(live_id: str) -> Optional["StreamingQuery"]:
    with _LIVE_LOCK:
        return _LIVE.get(live_id)


def live_queries() -> List[dict]:
    """Status rows for every live trigger loop. Snapshot the registry
    under its lock, build the rows OUTSIDE it: each row takes that
    query's _TriggerStatus lock, and the two locks are never held
    together."""
    with _LIVE_LOCK:
        items = sorted(_LIVE.items())
    return [dict(q.state(), id=live_id) for live_id, q in items]


class _TriggerStatus:
    """The CROSS-THREAD slice of a supervised streaming query: the
    trigger-loop thread writes it; `status`/`state()`, the live listing
    and `stop()` read it. Kept in its own tiny class so the
    cross-thread fields are exactly these — everything else on
    StreamingQuery stays confined to whichever thread currently
    drives the loop (start() hands the whole object to the trigger
    thread; the manual-trigger path never starts one)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.status = "INITIALIZED"
        self.error: Optional[str] = None
        self.ticks = 0
        self.skipped_ticks = 0
        self.restarts = 0
        self.last_skew_ms = 0.0
        self.trigger_ms: Optional[float] = None

    def snapshot(self) -> dict:
        with self._lock:
            return {"status": self.status, "error": self.error,
                    "ticks": self.ticks,
                    "skipped_ticks": self.skipped_ticks,
                    "restarts": self.restarts,
                    "last_skew_ms": self.last_skew_ms,
                    "trigger_ms": self.trigger_ms}

    def set_running(self, trigger_ms: float) -> None:
        with self._lock:
            self.status = "RUNNING"
            self.error = None
            self.trigger_ms = float(trigger_ms)

    def finish(self, status: str, error: Optional[str]) -> None:
        with self._lock:
            self.status = status
            self.error = error

    def tick(self, skew_ms: float) -> int:
        with self._lock:
            self.ticks += 1
            self.last_skew_ms = float(skew_ms)
            return self.ticks

    def skip(self, n: int) -> None:
        with self._lock:
            self.skipped_ticks += int(n)

    def restart(self) -> int:
        with self._lock:
            self.restarts += 1
            return self.restarts


class StreamingQuery:
    """One micro-batch query (reference: StreamExecution). Trigger is
    manual (`process_available()`) — the deterministic single-step mode
    StreamTest uses — or the supervised wall-clock loop behind
    `start(trigger_ms=...)`."""

    def __init__(self, session, plan: L.LogicalPlan, stream,
                 checkpoint_dir: str, output_mode: str = "complete",
                 sink_path: Optional[str] = None):
        if output_mode not in ("complete", "append"):
            raise ValueError(f"unsupported outputMode {output_mode!r}")
        self.session = session
        self.plan = plan
        self.stream = stream
        self.output_mode = output_mode
        self.offset_log = _MetadataLog(
            os.path.join(checkpoint_dir, "offsets"),
            metrics=session.metrics)
        self.commit_log = _MetadataLog(
            os.path.join(checkpoint_dir, "commits"),
            metrics=session.metrics)
        from .execution.state_store import StateStore
        self._state_dir = os.path.join(checkpoint_dir, "state")
        self._store = StateStore(self._state_dir, session.conf,
                                 metrics=session.metrics)
        stream.attach_checkpoint(
            os.path.join(checkpoint_dir, "sources", "0"))
        self._agg = self._find_aggregate(plan)
        self._watermark = self._find_watermark(plan)
        self._event_time = (self._agg is not None
                            and self._watermark is not None)
        if self._agg is not None and output_mode == "append" \
                and not self._event_time:
            # the reference rejects append-without-watermark for
            # aggregations at analysis time; silently re-emitting every
            # group each trigger would duplicate sink rows
            raise ValueError(
                "outputMode='append' on a streaming aggregation needs "
                "a watermark (with_watermark) so closed windows can be "
                "emitted exactly once; use 'complete' otherwise")
        #: memory sink keyed by BATCH ID: a replayed batch REPLACES its
        #: own entry instead of appending a duplicate (exactly-once at
        #: the sink, not just the state)
        self._sink_results: Dict[int, pd.DataFrame] = {}
        self._file_sink = (FileStreamSink(session, sink_path, output_mode)
                           if sink_path else None)
        self._tables = None      # committed aggregate state (device)
        self._flat = None        # committed aggregate state (host copy)
        self._prep = None
        self._pending = None     # post-batch state awaiting commit
        # event-time path: host state table + watermark (us)
        self._evstate: Optional[pd.DataFrame] = None
        self._wm: int = -(1 << 62)
        # host-spillable keyed state (engages lazily when the resident
        # event-time frame exceeds streaming.state.spillBytes)
        self._spill = None
        self._spill_dir = os.path.join(checkpoint_dir, "state", "spill")
        # supervised trigger loop (start()/stop())
        self._trigger = _TriggerStatus()
        self._loop_thread: Optional[threading.Thread] = None
        self._token = None
        self._live_id: Optional[str] = None
        #: phase times (host ms) of the batch being run and of the newest
        #: committed one; sync_phases synchronizes the device at each
        #: phase boundary (a measuring aid, off by default)
        self._times: Dict[str, float] = {}
        self.last_times: Optional[Dict[str, float]] = None
        self.sync_phases = False
        self._recover()

    # -- plan shape ---------------------------------------------------------

    @staticmethod
    def _find_aggregate(plan: L.LogicalPlan) -> Optional[L.Aggregate]:
        """The single streaming aggregate, if any (stateless otherwise).
        Nested/multiple aggregates are out of scope, as in the
        reference's UnsupportedOperationChecker."""
        aggs: List[L.Aggregate] = []

        def walk(n):
            if isinstance(n, L.Aggregate):
                aggs.append(n)
            for c in n.children:
                walk(c)

        walk(plan)
        if len(aggs) > 1:
            raise ValueError("multiple streaming aggregates unsupported")
        return aggs[0] if aggs else None

    @staticmethod
    def _find_watermark(plan: L.LogicalPlan):
        """(col_name, delay_us) of the single Watermark node, if any."""
        found = []

        def walk(n):
            if isinstance(n, L.Watermark):
                found.append((n.col_name, n.delay_us))
            for c in n.children:
                walk(c)

        walk(plan)
        return found[0] if found else None

    def _shape(self) -> str:
        if self._event_time:
            return "event_time"
        return "stateful" if self._agg is not None else "stateless"

    # -- recovery -----------------------------------------------------------

    def _recover(self) -> None:
        """Restart semantics: resume state at the last COMMITTED batch;
        a planned-but-uncommitted offset entry will re-run over its
        logged range (idempotent because state is versioned and sinks
        are batch-id keyed)."""
        t0 = time.perf_counter()
        last_commit, payload = self.commit_log.latest()
        self._committed_batch = -1 if last_commit is None else last_commit
        # the committed batch's END offset: the floor for the next
        # planned range. Guards the asymmetric-corruption case — the
        # offset log's newest entry torn while its commit survived —
        # where falling back one OFFSET entry would re-plan (and
        # double-fold) a range the committed state already contains.
        self._committed_end = int((payload or {}).get("end", 0)) \
            if last_commit is not None else 0
        if self._agg is not None and last_commit is not None:
            if self._event_time:
                self._wm = int((payload or {}).get("wm", self._wm))
                self._evstate = self._store.load_frame(last_commit)
            else:
                self._load_state(last_commit)
            self.session.metrics.counter("streaming_restore_ms").inc(
                round((time.perf_counter() - t0) * 1e3, 3))

    def _save_state(self, batch_id: int, tables) -> dict:
        """Persist the POST-batch accumulator tables as version
        `batch_id` through the incremental state store (delta of the
        changed groups, or a snapshot on the cadence)."""
        cnt, accs = tables
        t0 = time.perf_counter()
        flat = {"cnt": cnt.cpu().numpy()}
        for i, row in enumerate(accs):
            for j, a in enumerate(row):
                flat[f"acc_{i}_{j}"] = a.cpu().numpy()
        self._times["state_copy"] = (time.perf_counter() - t0) * 1e3
        info = self._store.commit_tables(batch_id, flat, self._flat)
        self._times["state_diff"] = info.get("diff_ms", 0.0)
        self._times["state_write"] = info.get("write_ms", 0.0)
        self._pending = {"tables": tables, "flat": flat}
        return info

    def _load_state(self, batch_id: int) -> None:
        self._ensure_prep()
        flat = self._store.load_tables(batch_id)
        device = self.session.device
        cnt = torch.from_numpy(flat["cnt"]).to(device)
        accs = []
        i = 0
        while f"acc_{i}_0" in flat:
            row = []
            j = 0
            while f"acc_{i}_{j}" in flat:
                row.append(torch.from_numpy(flat[f"acc_{i}_{j}"]).to(device))
                j += 1
            accs.append(row)
            i += 1
        self._tables = (cnt, accs)
        self._flat = flat

    def _adopt_pending(self) -> None:
        """Adopt the post-batch state AFTER the commit-log write: an
        in-process failure anywhere in the batch leaves the query at
        the committed version, so re-calling process_available() on
        the same object replays exactly like a fresh restart."""
        p, self._pending = self._pending, None
        if p is None:
            return
        if "tables" in p:
            self._tables = p["tables"]
            self._flat = p["flat"]
        if "evstate" in p:
            if p.get("spilled"):
                # the spill partitions only move AFTER the commit-log
                # write, and only the partitions this batch touched; a
                # no-change batch rewrites nothing
                if p.get("touched"):
                    self._spill.adopt(p["evstate"], p["touched"])
                self._evstate = None
            else:
                self._evstate = p["evstate"]
            self._wm = p["wm"]

    # -- event-time (watermark) path ----------------------------------------

    def _ensure_event_prep(self):
        """Build the per-trigger PARTIAL-aggregate program: chain replay
        + partial-mode compute (sort path, no domain bound needed). The
        state store is a HOST table of group keys + raw accumulator
        columns, merged per trigger with each accumulator's reduce op —
        the versioned StateStore:101 analog with host RAM as the
        backing tier."""
        if getattr(self, "_ev_update", None) is not None:
            return
        self._ensure_prep_common()
        import copy
        from .plan.physical import ExecContext
        agg = self._agg_exec
        partial = copy.copy(agg)
        partial.mode = "partial"
        partial.est_groups = None
        base = agg._base_schema()
        self._ev_specs = [a.func.accumulators(base)
                          for a in agg.agg_exprs]
        self._ev_acc_cols = [
            [agg._acc_col_name(i, j, spec)
             for j, spec in enumerate(self._ev_specs[i])]
            for i, a in enumerate(agg.agg_exprs)]
        self._ev_group_cols = [g.name() for g in agg.group_exprs]
        self._ev_base = base
        # window duration for eviction (group key must include window())
        from .expr_fns import TumbleWindow
        from . import types as T
        self._ev_window = None
        for g in agg.group_exprs:
            e = g
            from .expr import Alias
            while isinstance(e, Alias):
                e = e.child
            if isinstance(e, TumbleWindow):
                self._ev_window = (g.name(), e.duration_us,
                                   isinstance(e.dtype(base),
                                              T.TimestampType))
        if self.output_mode == "append" and self._ev_window is None:
            raise ValueError(
                "append mode needs an event-time window() group key so "
                "closed windows can be emitted exactly once")

        if any(a.func.uses_row_base for a in agg.agg_exprs):
            raise ValueError(
                "first/last are not supported in event-time streaming "
                "aggregations (host-merged partials have no global row "
                "order)")

        def update(b):
            ctx = ExecContext(self.session.conf, self.session.device)
            for op in reversed(self._chain):
                b = op.compute(ctx, [b])
            return partial.compute(ctx, [b])

        self._ev_update = update

    def _event_merge(self, state: Optional[pd.DataFrame],
                     partial_pdf: pd.DataFrame) -> pd.DataFrame:
        """Fold a trigger's partial table into the state with each
        accumulator's reduce op (pure — replay safety)."""
        if state is None or not len(state):
            return partial_pdf
        both = pd.concat([state, partial_pdf], ignore_index=True)
        ops = {}
        for specs, cols in zip(self._ev_specs, self._ev_acc_cols):
            for spec, c in zip(specs, cols):
                ops[c] = spec.reduce
        return (both.groupby(self._ev_group_cols, dropna=False,
                             sort=False, as_index=False).agg(ops))

    def _event_finalize(self, state: pd.DataFrame) -> pd.DataFrame:
        """Host finalize of (a subset of) the state table. Each output
        column takes its aggregate's result type, as the stateful path's
        egress gives it: a decimal sum or average comes back as
        decimals (the JAX package leaves their unscaled integers)."""
        from .columnar import Column, _column_to_arrow
        agg = self._agg_exec
        out = {c: state[c].to_numpy() for c in self._ev_group_cols}
        for i, a in enumerate(agg.agg_exprs):
            accs = [state[c].to_numpy() for c in self._ev_acc_cols[i]]
            data, validity = a.func.finalize(accs, self._ev_base)
            col = Column(None, a.func.result_type(self._ev_base), None,
                         None)
            out[a.out_name] = _column_to_arrow(
                col, np.asarray(data),
                None if validity is None else np.asarray(validity)) \
                .to_numpy(zero_copy_only=False)
        return pd.DataFrame(out)

    def _maybe_engage_spill(self) -> None:
        """Reroute event-time state residency through the host spill
        backend once the resident frame exceeds its byte budget
        (streaming.state.spillBytes; 0 = never). The persisted
        deltas/snapshots are identical either way, so crash recovery
        never notices — after a restart the store hands back a
        resident frame and the very next trigger re-engages here."""
        budget = int(self.session.conf.get(SPILL_BYTES_KEY))
        if not budget or self._spill is not None \
                or self._evstate is None:
            return
        if self._frame_bytes(self._evstate) <= budget:
            return
        from .execution.external import SpillableKeyedState
        self._spill = SpillableKeyedState(
            self._spill_dir, self._ev_group_cols,
            int(self.session.conf.get(SPILL_PARTS_KEY)),
            metrics=self.session.metrics)
        self._spill.reset(self._evstate)
        self._evstate = None

    @staticmethod
    def _frame_bytes(pdf: pd.DataFrame) -> int:
        return int(pdf.memory_usage(index=False, deep=True).sum())

    def _run_batch_event(self, batch_id: int, table: pa.Table):
        import pyarrow.compute as pc
        self._ensure_event_prep()
        self._maybe_engage_spill()
        spilled = self._spill is not None
        state0 = self._spill.materialize() if spilled else self._evstate
        col, delay = self._watermark
        wm = self._wm
        new_state = state0
        touched: List[int] = []
        batch_max = None
        if table.num_rows:
            ts = table.column(col)
            if pa.types.is_timestamp(ts.type):
                ts_us = ts.cast(pa.timestamp("us")).cast(pa.int64())
            else:
                ts_us = ts.cast(pa.int64())
            batch_max = pc.max(ts_us).as_py()
            # late-data drop: strictly older than the CURRENT watermark
            keep = pc.greater_equal(ts_us, pa.scalar(wm, pa.int64()))
            table = table.filter(pc.fill_null(keep, False))
        if table.num_rows:
            pb = self._ev_update(self._batch_for(table))
            partial_pdf = pb.to_arrow().to_pandas()
            # normalize window keys to int64 microseconds for the host
            # merge + eviction arithmetic
            if self._ev_window is not None:
                wcol = self._ev_window[0]
                if str(partial_pdf[wcol].dtype).startswith("datetime"):
                    partial_pdf[wcol] = pd.to_datetime(
                        partial_pdf[wcol]).astype("datetime64[us]") \
                        .astype("int64")
            if spilled:
                new_state, touched = self._spill.merge(
                    partial_pdf, self._event_merge)
            else:
                new_state = self._event_merge(new_state, partial_pdf)
        if batch_max is not None:
            wm = max(wm, batch_max - delay)

        emitted = None
        if self.output_mode == "append" and new_state is not None \
                and len(new_state):
            wcol, dur, _ = self._ev_window
            closed = (new_state[wcol] + dur) <= wm
            if closed.any():
                emitted = new_state[closed]
                new_state = new_state[~closed].reset_index(drop=True)
                if spilled:
                    # evicted groups SHRANK their partitions: those
                    # must rewrite at adoption too
                    touched = sorted(
                        set(touched) | set(
                            self._spill.touched_by(emitted)))

        # persist BEFORE emitting/adopting (exactly-once on replay):
        # the store diffs against the COMMITTED state and writes a
        # changed-rows delta (or a snapshot on the cadence)
        info = self._store.commit_frame(batch_id, new_state, state0,
                                        self._ev_group_cols)
        self._pending = {"evstate": new_state, "wm": wm,
                         "spilled": spilled, "touched": touched}

        out = None
        if self.output_mode == "complete":
            if new_state is not None and len(new_state):
                out = self._apply_above(self._event_finalize(new_state))
            else:
                out = pd.DataFrame()
        elif emitted is not None and len(emitted):
            out = self._apply_above(self._event_finalize(emitted))
        return out, info

    def _apply_above(self, pdf: pd.DataFrame) -> pd.DataFrame:
        """Re-apply operators above the aggregate (HAVING/ORDER BY/...)
        to a finalized host table."""
        if not self._above or not len(pdf):
            return self._restore_window_type(pdf)
        from .plan.physical import ExecContext
        out = self._batch_for(pa.Table.from_pandas(pdf,
                                                   preserve_index=False))
        ctx = ExecContext(self.session.conf, self.session.device)
        for op in reversed(self._above):
            out = op.compute(ctx, [out])
        return self._restore_window_type(out.to_arrow().to_pandas())

    def _restore_window_type(self, pdf: pd.DataFrame) -> pd.DataFrame:
        # only TIMESTAMP event-time keys round-trip through int64 us
        # (integer event-time columns stay integers)
        if self._ev_window is not None and len(pdf) \
                and self._ev_window[2]:
            wcol = self._ev_window[0]
            if wcol in pdf.columns and \
                    np.issubdtype(pdf[wcol].dtype, np.integer):
                pdf = pdf.assign(**{wcol: pd.to_datetime(
                    pdf[wcol], unit="us")})
        return pdf

    # -- execution ----------------------------------------------------------

    def _ensure_prep_common(self):
        """Plan surgery shared by the device-table and event-time
        paths: plan the swapped batch query, locate the aggregate, and
        split the operator chain below/above it."""
        if getattr(self, "_agg_exec", None) is not None:
            return
        from .io.sources import ArrowTableSource
        from .plan.planner import plan_physical
        from .plan import physical as P

        def swap(n):
            if isinstance(n, _StreamSource):
                return L.Scan(ArrowTableSource("__stream_probe__",
                                               self.stream._table))
            return None

        phys = plan_physical(self.plan.transform_down(swap),
                             self.session.conf)

        agg_exec = None

        def walk(n):
            nonlocal agg_exec
            if isinstance(n, P.HashAggregateExec) and agg_exec is None:
                agg_exec = n
            for c in n.children:
                walk(c)

        walk(phys)
        if agg_exec is None:
            raise ValueError("aggregate lost during planning")
        self._agg_exec = agg_exec

        def unary_path(root, target):
            """Operators from (under) `root` down to `target`, refusing
            non-unary nodes (stream-static joins are unsupported — fail
            with a named error, not an unpack crash)."""
            path = []
            node = root
            while node is not target:
                if len(node.children) != 1:
                    from .expr import AnalysisError
                    raise AnalysisError(
                        f"streaming aggregation supports a single unary "
                        f"operator chain; {type(node).__name__} "
                        f"(e.g. a stream-static join) is not supported")
                path.append(node)
                node = node.children[0]
            return path

        # operators ABOVE the aggregate (HAVING filters, projections,
        # sort/limit) re-apply to each trigger's finalized table;
        # operators BELOW replay per micro-batch slice
        self._above = unary_path(phys, agg_exec)
        chain = []
        node = agg_exec.children[0]
        while node.children:
            if len(node.children) != 1:
                from .expr import AnalysisError
                raise AnalysisError(
                    f"streaming aggregation supports a single unary "
                    f"operator chain below the aggregate; "
                    f"{type(node).__name__} is not supported")
            chain.append(node)
            node = node.children[0]
        self._chain = chain

    def _ensure_prep(self):
        if self._prep is not None or self._agg is None:
            return
        self._ensure_prep_common()
        agg_exec = self._agg_exec
        from .plan.physical import ExecContext
        probe = self._batch_for(self.stream.slice(0, 0))
        ctx = ExecContext(self.session.conf, self.session.device)
        replayed = probe
        for op in reversed(self._chain):
            replayed = op.compute(ctx, [replayed])
        from . import types as T
        base = agg_exec.child.schema()
        for g in agg_exec.group_exprs:
            if isinstance(g.dtype(base), T.StringType):
                # the prep is built from an empty probe slice, so
                # per-batch dictionary codes would never share an
                # encoding across triggers — unsupported, not broken
                raise ValueError(
                    "string group keys are not supported in streaming "
                    "aggregations (per-batch dictionaries have no "
                    "stable shared encoding)")
        prep = agg_exec.prepare_direct(replayed, self.session.conf)
        if prep is None:
            raise ValueError(
                "streaming aggregation requires a statically-bounded "
                "integer group domain (e.g. pmod keys)")
        self._prep = prep

        if getattr(self.stream, "source_kind", "memory") == "file" \
                and any(a.func.uses_row_base
                        for a in agg_exec.agg_exprs):
            raise ValueError(
                "first/last are not supported over file stream sources "
                "(file offsets are file indices, not row positions, so "
                "packed positions would collide across batches)")

        def update(tables, b, row_base):
            ctx = ExecContext(self.session.conf, self.session.device)
            for op in reversed(self._chain):
                b = op.compute(ctx, [b])
            # row_base = the trigger's stream offset: packed First/Last
            # positions stay globally unique across triggers (and exact
            # replays of a logged range reuse the same base, keeping
            # recovery idempotent)
            return self._agg_exec.direct_update_tables(
                tables, b, prep, self.session.conf, row_base=row_base)

        # one eager step per trigger; it returns new tables (a save
        # failure must leave the PRE-update tables alive for an exact
        # replay)
        self._update = update

    def _batch_for(self, table: pa.Table) -> Batch:
        return Batch.from_arrow(table, self.session.device)

    def _phase_end(self, name: str, t0: float) -> float:
        """Close phase `name` begun at perf-counter time `t0` (after a
        device synchronize under `sync_phases`); returns the end time."""
        if self.sync_phases and self.session.device.type == "cuda":
            torch.cuda.synchronize(self.session.device)
        t1 = time.perf_counter()
        self._times[name] = (t1 - t0) * 1e3
        return t1

    def process_available(self) -> None:
        """Run micro-batches until the source is drained (the
        `Trigger.AvailableNow` analog; each iteration = one batch of the
        `MicroBatchExecution` loop). Loop order per batch: source list
        -> offset write -> run (state commit) -> sink emit -> commit
        log -> adopt state -> prune; the stream_* chaos seams fire
        before each persistent action."""
        from .execution import lifecycle
        from .testing import faults
        faults.arm(self.session.conf)
        while True:
            # cooperative cancellation boundary once per trigger: a
            # cancel/deadline between micro-batches stops the loop
            # with the durable state at the last COMMITTED batch, so
            # a fresh query over the same checkpoint resumes
            # exactly-once (execution/lifecycle.py)
            lifecycle.checkpoint("stream_trigger")
            self._pending = None
            self._times = {}
            batch_id = self._committed_batch + 1
            # chaos seam: a crash before the loop even polls the source
            faults.fire("stream_source_list")
            planned_id, planned = self.offset_log.latest()
            if planned_id is not None and planned_id == batch_id:
                # planned but not committed (crash between the logs):
                # replay exactly the logged range
                start, end = planned["start"], planned["end"]
            else:
                start = planned["end"] if planned is not None else 0
                # never re-plan below the committed watermark: a torn
                # newest OFFSET entry whose commit survived would
                # otherwise hand back an already-folded range
                start = max(start, self._committed_end)
                end = self.stream.latest_offset()
                if end <= start:
                    return  # drained
                # chaos seam: crash before the planned range persists
                faults.fire("stream_offset_write")
                self.offset_log.add(batch_id, {"start": start,
                                               "end": end})
            t0 = time.perf_counter()
            q0 = self.session.metrics.counter(
                "streaming_files_quarantined").value
            out, info = self._run_batch(batch_id, start, end)
            # chaos seam: state committed, sink not yet emitted
            faults.fire("stream_sink_emit")
            t_emit = time.perf_counter()
            sink_parts = self._emit(batch_id, out)
            self._times["emit"] = (time.perf_counter() - t_emit) * 1e3
            # `end` rides the commit entry: recovery floors the next
            # planned range at it (see _recover)
            payload = {"ok": True, "end": int(end)}
            if self._event_time:
                payload["wm"] = int(self._pending["wm"])
            self.commit_log.add(batch_id, payload)
            self._committed_batch = batch_id
            self._committed_end = int(end)
            self._adopt_pending()
            self.last_times = dict(self._times)
            self._record_batch(
                batch_id, start, end, out, info,
                wall_ms=(time.perf_counter() - t0) * 1e3,
                quarantined=int(self.session.metrics.counter(
                    "streaming_files_quarantined").value - q0),
                sink_parts=sink_parts)
            self._prune(batch_id)

    def _prune(self, committed: int) -> None:
        """Drop log entries older than the retained window (the
        reference's minBatchesToRetain) and let the state store
        compact deltas/snapshots no retained restore needs; recovery
        only ever reads the last committed version."""
        retain = int(self.session.conf.get(RETAIN_KEY))
        floor = committed - retain
        for log in (self.offset_log, self.commit_log):
            for f in os.listdir(log.path):
                if f.isdigit() and int(f) < floor:
                    os.remove(os.path.join(log.path, f))
        self._store.prune(committed, retain)
        if self._file_sink is not None:
            self._file_sink.prune(committed, retain)
        if self.output_mode == "complete":
            # complete mode rewrites the FULL result per batch: memory
            # -sink entries outside the window are superseded dead
            # weight on a long-running stream (append entries ARE the
            # data and stay)
            for k in [k for k in self._sink_results if k < floor]:
                del self._sink_results[k]

    processAllAvailable = process_available

    def _run_batch(self, batch_id: int, start: int, end: int):
        t0 = time.perf_counter()
        table = self.stream.slice(start, end)
        self._times["decode"] = (time.perf_counter() - t0) * 1e3
        if self._event_time:
            out, info = self._run_batch_event(batch_id, table)
            info["rows_in"] = int(table.num_rows)
            return out, info
        if self._agg is None:
            # stateless: swap the stream placeholder for this slice and
            # run the normal engine
            from .execution.executor import QueryExecution
            from .io.device_cache import CACHE
            from .io.sources import ArrowTableSource
            source = ArrowTableSource("__microbatch__", table)

            def swap(n):
                if isinstance(n, _StreamSource):
                    return L.Scan(source)
                return None

            try:
                out = QueryExecution(
                    self.session, self.plan.transform_down(swap)).collect()
            finally:
                # each trigger's source has a fresh cache stamp: free its
                # device-resident batches, which no later key can reach
                CACHE.invalidate_token(source.cache_token())
            return out.to_pandas(), {"kind": "stateless", "bytes": None,
                                     "changed": None,
                                     "rows_in": int(table.num_rows)}
        # stateful: fold the slice into carried accumulator tables
        self._ensure_prep()
        if self._tables is None:
            self._tables = self._agg_exec.direct_init_tables(self._prep)
            self._flat = None
        new_tables = self._tables
        if table.num_rows:
            t0 = time.perf_counter()
            b = self._batch_for(table)
            t0 = self._phase_end("ingest", t0)
            if start + b.capacity >= (1 << 30) and any(
                    a.func.uses_row_base
                    for a in self._agg_exec.agg_exprs):
                raise RuntimeError(
                    "first/last over a stream exceeds the 2^30 "
                    "packed-position bound")
            # row_base = the trigger's stream offset, a host int (the
            # position packing adds it to a tensor on the batch's device)
            new_tables = self._update(self._tables, b, int(start))
            self._phase_end("update", t0)
        # persist BEFORE emitting/adopting: the incremental store
        # diffs the host copies against the committed version and
        # writes only the changed groups (or a snapshot on cadence)
        info = self._save_state(batch_id, new_tables)
        info["rows_in"] = int(table.num_rows)
        t0 = time.perf_counter()
        out = self._agg_exec.direct_finalize_tables(new_tables,
                                                    self._prep)
        from .plan.physical import ExecContext
        ctx = ExecContext(self.session.conf, self.session.device)
        for op in reversed(self._above):
            out = op.compute(ctx, [out])
        pdf = out.to_arrow().to_pandas()
        self._phase_end("finalize", t0)
        return pdf, info

    # -- sink ---------------------------------------------------------------

    def _emit(self, batch_id: int, out: Optional[pd.DataFrame]) -> int:
        """Route a batch's output to the sinks, KEYED BY BATCH ID: a
        replayed batch replaces its own memory-sink entry, and the file
        sink's manifest makes the part overwrite invisible until
        re-manifested."""
        if out is None:
            return 0
        self._sink_results[batch_id] = out
        if self._file_sink is not None:
            return self._file_sink.emit(batch_id, out)
        return 0

    def _record_batch(self, batch_id: int, start: int, end: int, out,
                      info: dict, wall_ms: float, quarantined: int,
                      sink_parts: int) -> None:
        m = self.session.metrics
        m.counter("streaming_batches").inc()
        m.counter("streaming_rows").inc(int(info.get("rows_in") or 0))
        record = {
            "batch_id": int(batch_id),
            "start": int(start), "end": int(end),
            "rows_in": int(info.get("rows_in") or 0),
            "rows_out": int(len(out)) if out is not None else 0,
            "kind": str(info.get("kind") or "stateless"),
            "state_bytes": info.get("bytes"),
            "changed_groups": info.get("changed"),
            "quarantined": int(quarantined),
            "sink_parts": int(sink_parts),
            "source": str(getattr(self.stream, "source_kind", "memory")),
            "wall_ms": round(float(wall_ms), 3),
        }
        from .observability.listener import StreamingBatchEvent
        self.session.listeners.post(
            "on_streaming_batch",
            StreamingBatchEvent(
                query_id=self.session._next_query_id(), ts=time.time(),
                plan=f"StreamingQuery[{self._shape()},"
                     f"{self.output_mode}]",
                record=record))

    def latest(self) -> Optional[pd.DataFrame]:
        """Memory sink: the latest batch's result table (complete mode)
        or the last appended slice."""
        if not self._sink_results:
            return None
        return self._sink_results[max(self._sink_results)]

    def results(self) -> List[pd.DataFrame]:
        """Every emitted batch's table in batch order (replays
        replaced, never duplicated)."""
        return [self._sink_results[k]
                for k in sorted(self._sink_results)]

    # -- supervised trigger loop --------------------------------------------

    @property
    def status(self) -> str:
        """INITIALIZED | RUNNING | STOPPED | FAILED."""
        return self._trigger.snapshot()["status"]

    def exception(self) -> Optional[str]:
        """The parking error of a FAILED query (None otherwise)."""
        return self._trigger.snapshot()["error"]

    def state(self) -> dict:
        """Structured status — the `live_queries()` row of a stream:
        trigger counters plus the committed frontier."""
        s = self._trigger.snapshot()
        s.update({
            "shape": self._shape(),
            "output_mode": self.output_mode,
            "source": str(getattr(self.stream, "source_kind",
                                  "memory")),
            "committed_batch": int(self._committed_batch),
        })
        return s

    def start(self, trigger_ms: float = 100.0, clock=None, sleep=None,
              rng=None) -> "StreamingQuery":
        """Run the micro-batch loop unattended: a daemon thread calls
        `process_available()` every `trigger_ms` of wall clock under a
        restart supervisor. TRANSIENT/TIMEOUT tick failures (the
        execution/failures.py taxonomy — network resets classify
        TRANSIENT) retry under one bounded RetryPolicy ladder
        (trigger.{maxRestarts,backoffMs}); any successful tick resets
        the streak; FATAL errors (and an exhausted ladder) park the
        query in FAILED status with the error preserved. A tick slower
        than the interval SKIPS the missed ticks — wall-clock pacing
        never queues a backlog. The loop runs under a fresh lifecycle
        token (deadline from execution.queryDeadlineMs when set):
        `stop()` cancels it, a deadline parks FAILED; either
        way the durable state stays at the last committed batch, so a
        restart resumes exactly-once.

        `clock`/`sleep`/`rng` are test seams (injected monotonic
        clock, pacing+backoff sleep, backoff jitter)."""
        if self._loop_thread is not None \
                and self._loop_thread.is_alive():
            raise RuntimeError("trigger loop already running")
        from .execution import lifecycle
        deadline_ms = int(self.session.conf.get(lifecycle.DEADLINE_KEY))
        self._token = lifecycle.CancelToken(
            deadline_ms=deadline_ms if deadline_ms > 0 else None)
        self._trigger.set_running(trigger_ms)
        self._live_id = _register_live(self)
        t = threading.Thread(
            target=self._trigger_loop,
            args=(float(trigger_ms) / 1e3, clock or time.monotonic,
                  sleep, rng),
            daemon=True,
            name=f"spark-tpu-stream-trigger-{self._live_id}")
        self._loop_thread = t
        try:
            t.start()
        except BaseException:
            # thread exhaustion: undo the registration or the listing
            # would list a stream nothing is running
            self._trigger.finish("FAILED",
                                 "trigger thread failed to start")
            _unregister_live(self._live_id)
            self._loop_thread = None
            raise
        return self

    def _trigger_loop(self, trigger_s: float, clock, sleep_fn, rng):
        from .execution import failures, lifecycle
        from .testing import faults
        ctx_token = lifecycle.install(self._token)
        status, error = "STOPPED", None
        policy = None
        nominal = clock()  # when the CURRENT tick was scheduled
        try:
            try:
                while True:
                    skew_ms = max(0.0, (clock() - nominal) * 1e3)
                    before = self._committed_batch
                    rc0 = int(self.session.metrics.counter(
                        "streaming_reconnects").value)
                    try:
                        faults.arm(self.session.conf)
                        # chaos seam: a crash at the very top of a tick
                        faults.fire("trigger_tick")
                        lifecycle.checkpoint("trigger_tick")
                        self.process_available()
                    except (lifecycle.QueryCancelledError,
                            lifecycle.QueryDeadlineError):
                        # a stop() landing after this tick committed a
                        # batch (process_available's next trigger
                        # checkpoint raises) still posts the tick's
                        # record: one trigger record per committing tick
                        batches = int(self._committed_batch - before)
                        if batches > 0:
                            self._record_trigger(
                                self._trigger.tick(skew_ms), skew_ms,
                                batches,
                                int(self.session.metrics.counter(
                                    "streaming_reconnects").value - rc0))
                        raise  # the outer handlers own these
                    except Exception as e:  # noqa: BLE001 — supervised
                        kind = failures.classify(e)
                        if kind in (failures.FailureClass.TRANSIENT,
                                    failures.FailureClass.TIMEOUT):
                            if policy is None:
                                policy = failures.RetryPolicy(
                                    int(self.session.conf.get(
                                        TRIGGER_MAX_RESTARTS_KEY)),
                                    int(self.session.conf.get(
                                        TRIGGER_BACKOFF_KEY)),
                                    sleep=sleep_fn, rng=rng)
                            if policy.attempt_retry() is not None:
                                self._trigger.restart()
                                continue  # re-tick now, no pacing wait
                        # FATAL (or ladder exhausted): park, visibly
                        status = "FAILED"
                        error = f"{type(e).__name__}: {e}"[:400]
                        snap = self._trigger.snapshot()
                        self._record_trigger(
                            snap["ticks"] + 1, skew_ms,
                            int(self._committed_batch - before),
                            int(self.session.metrics.counter(
                                "streaming_reconnects").value - rc0),
                            restarts=snap["restarts"])
                        return
                    policy = None  # a clean tick resets the streak
                    tick = self._trigger.tick(skew_ms)
                    batches = int(self._committed_batch - before)
                    if batches > 0:
                        self._record_trigger(
                            tick, skew_ms, batches,
                            int(self.session.metrics.counter(
                                "streaming_reconnects").value - rc0))
                    # pacing: skip missed ticks, never queue them
                    now = clock()
                    k = max(1, int(math.floor((now - nominal)
                                              / trigger_s)) + 1)
                    if k > 1:
                        self._trigger.skip(k - 1)
                    nominal += k * trigger_s
                    wait = nominal - now
                    if wait > 0:
                        if sleep_fn is not None:
                            self._token.check("trigger_sleep")
                            sleep_fn(wait)
                        else:
                            lifecycle.sleep(wait)  # interruptible
            except lifecycle.QueryCancelledError:
                status, error = "STOPPED", None
            except lifecycle.QueryDeadlineError as e:
                status, error = "FAILED", \
                    f"{type(e).__name__}: {e}"[:400]
        finally:
            self._trigger.finish(status, error)
            _unregister_live(self._live_id)
            lifecycle.uninstall(ctx_token)

    def _record_trigger(self, tick: int, skew_ms: float,
                        batches_run: int, reconnects: int,
                        restarts: Optional[int] = None) -> None:
        """Post the schema-v6 `trigger` observability record (one per
        tick that ran batches, plus the parking tick of a FAILED
        query)."""
        if restarts is None:
            restarts = self._trigger.snapshot()["restarts"]
        record = {
            "tick": int(tick),
            "skew_ms": round(float(skew_ms), 3),
            "batches_run": int(batches_run),
            "restarts": int(restarts),
            "source": str(getattr(self.stream, "source_kind",
                                  "memory")),
            "reconnects": int(reconnects),
        }
        from .observability.listener import StreamingTriggerEvent
        self.session.listeners.post(
            "on_streaming_trigger",
            StreamingTriggerEvent(
                query_id=self.session._next_query_id(), ts=time.time(),
                plan=f"StreamingQuery[{self._shape()},"
                     f"{self.output_mode}]",
                record=record))

    def stop(self, timeout_s: float = 10.0) -> None:
        """Stop the trigger loop (a no-op for manual-trigger queries):
        cancel the lifecycle token — which interrupts a pacing or
        backoff sleep immediately — and join the thread BOUNDED.
        Idempotent. The durable state stays at the last committed
        batch, so a later start() or a fresh query resumes
        exactly-once."""
        t, self._loop_thread = self._loop_thread, None
        if t is None:
            return
        if self._token is not None:
            self._token.cancel()
        t.join(timeout=timeout_s)
        if t.is_alive():
            self._loop_thread = t  # keep it stoppable again
            raise RuntimeError(
                f"trigger loop failed to stop within {timeout_s}s")
        # the loop's finally normally unregisters; stay safe against a
        # thread that died before reaching it
        _unregister_live(self._live_id)
