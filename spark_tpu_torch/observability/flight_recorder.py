"""Crash-time flight recorder: bounded rings + diagnostic bundles (the
port of `spark_tpu/observability/flight_recorder.py`; the bundle layout
and MANIFEST are the JAX package's).

The black-box seat the reference lacks a single analog for (its
diagnosability is spread over event logs, thread-dump endpoints and
heap histograms): an always-armed, bounded ring of recent
events/spans/metric deltas per subsystem, costing one dict append
under a short lock per event — and, at the moment something
unrecoverable happens, a self-contained diagnostic bundle dumped to a
versioned directory so the post-mortem does not depend on the process
surviving long enough to be asked.

Dump triggers:

- the executor's surfaced-failure path (execute_batch): OOM-ladder
  exhaustion (`StageOOMError`), non-convergent recovery, and any other
  FATAL — reasons "oom" / "recovery_nonconvergent" / "fatal";
- on demand: `FlightRecorder.of(session).dump("reason")`, which the
  SQL service's `GET /debug/bundle` runs for each pooled session.

Bundle layout (`bundle-<app_id>-<seq>-<reason>/`, versioned by
MANIFEST.json `bundle_version`):

- ``MANIFEST.json``  — version, reason, ts, app id, trigger error,
  caller extras, and the file list (written LAST: its presence marks
  the bundle complete);
- ``rings.jsonl``    — ring contents, one record per line with its
  subsystem;
- ``plans.json``     — recent logical plans + runtime-annotated plan
  trees;
- ``spans.json``     — recent queries' span dicts (phase timelines);
- ``conf.json``      — effective conf snapshot (every registered key);
- ``metrics.json``   — full metrics-registry snapshot;
- ``threads.txt``    — live thread stacks (sys._current_frames);
- ``lockwatch.json`` — lock stats/edges when a lockwatch is installed
  (`{"installed": false}` until the port has one);
- ``eventlog_tail.jsonl`` — last N lines of the session's live event
  log (`spark_tpu.sql.flightRecorder.eventLogTail`).

Recording rides the listener bus (a `_builtin` subscriber, installed
by every session), so it observes exactly the event stream other
subscribers see and can never fail a query. Gating is conf-at-event-
time (`spark_tpu.sql.flightRecorder.enabled`, default on). Ring
capacity is `spark_tpu.sql.flightRecorder.ringSize` records per
subsystem. Dumping never raises — a failed dump warns and returns
None — and the recorder never perturbs results: it only observes, so
query output is byte-identical recorder-on vs recorder-off.

Locking: `_lock` ("obs.flightrec", rank 46) guards the rings and the
retained plan/span maps; file I/O, conf/metrics snapshots and thread
stack capture all run OUTSIDE it over copies.
"""

from __future__ import annotations

import json
import os
import re
import sys
import threading
import time
import traceback
import warnings
from collections import OrderedDict, deque
from typing import Dict, List, Optional

from .listener import QueryListener

ENABLED_KEY = "spark_tpu.sql.flightRecorder.enabled"
DIR_KEY = "spark_tpu.sql.flightRecorder.dir"
RING_KEY = "spark_tpu.sql.flightRecorder.ringSize"
TAIL_KEY = "spark_tpu.sql.flightRecorder.eventLogTail"

#: bundle layout version, carried in MANIFEST.json
BUNDLE_VERSION = 1

#: recent queries whose full plan strings / runtime trees / span dicts
#: are retained for plans.json + spans.json (rings keep truncated
#: copies of everything else)
_DETAIL_BOUND = 8

_SLUG = re.compile(r"[^a-zA-Z0-9_.-]+")


def _default_dir() -> str:
    import tempfile
    return os.path.join(tempfile.gettempdir(), "spark-tpu-flightrec")


class FlightRecorder(QueryListener):
    """Built-in bus subscriber: per-subsystem rings + `dump()`."""

    _builtin = True

    def __init__(self, session):
        self._session = session
        self._lock = threading.Lock()
        #: subsystem -> deque of recent records (fixed capacity)
        self._rings: Dict[str, deque] = {}
        #: query_id -> logical plan string (bounded)
        self._plans: "OrderedDict[int, str]" = OrderedDict()
        #: query_id -> runtime-annotated plan tree (bounded)
        self._trees: "OrderedDict[int, object]" = OrderedDict()
        #: query_id -> span dict list from the query-end event (bounded)
        self._spans: "OrderedDict[int, List]" = OrderedDict()
        #: bundle sequence within this session (names stay unique)
        self._seq = 0

    @staticmethod
    def of(session) -> Optional["FlightRecorder"]:
        for li in session.listeners.listeners:
            if isinstance(li, FlightRecorder):
                return li
        return None

    def _enabled(self) -> bool:
        return bool(self._session.conf.get(ENABLED_KEY))

    # -- recording (hot path) -----------------------------------------------

    def _record(self, subsystem: str, kind: str, **fields) -> None:
        if not self._enabled():
            return
        rec = {"ts": fields.pop("ts", None) or time.time(),
               "kind": kind}
        rec.update(fields)
        # conf read OUTSIDE _lock: the conf registry has its own lock
        # and the recorder's must stay a leaf-ish short section
        cap = max(8, int(self._session.conf.get(RING_KEY)))
        with self._lock:
            ring = self._rings.get(subsystem)
            if ring is None:
                ring = self._rings[subsystem] = deque(maxlen=cap)
            ring.append(rec)

    def _retain(self, store: OrderedDict, key, value) -> None:
        with self._lock:
            store[key] = value
            while len(store) > _DETAIL_BOUND:
                store.popitem(last=False)

    def on_query_start(self, event) -> None:
        self._record("query", "start", ts=event.ts,
                     query_id=event.query_id,
                     plan=str(event.plan)[:400])
        if self._enabled():
            self._retain(self._plans, event.query_id, str(event.plan))

    def on_analysis(self, event) -> None:
        self._record("analysis", "findings", ts=event.ts,
                     query_id=event.query_id,
                     codes=[f.get("code") for f in event.findings][:16])

    def on_stage_compiled(self, event) -> None:
        self._record("stage", "compiled", ts=event.ts,
                     query_id=event.query_id, stage=event.key_hash,
                     mesh_n=event.mesh_n)

    def on_stage_completed(self, event) -> None:
        self._record("stage", "completed", ts=event.ts,
                     query_id=event.query_id, stage=event.key_hash,
                     attempt=event.attempt,
                     elapsed_ms=round(event.elapsed_ms, 3),
                     overflow=list(event.overflow or ()))

    def on_fault(self, event) -> None:
        self._record("fault", event.action, ts=event.ts,
                     query_id=event.query_id,
                     error=str(event.error)[:200], site=event.site)

    def on_service(self, event) -> None:
        self._record("service", event.action, ts=event.ts,
                     query_id=event.query_id, session=event.session,
                     detail=str(event.detail)[:120])

    def on_shard_records(self, event) -> None:
        # chunk-boundary hot path: ring a summary, never the records
        self._record("shards", "chunk", ts=event.ts,
                     query_id=event.query_id, chunk=event.chunk,
                     n_records=len(event.records))

    def on_straggler(self, event) -> None:
        self._record("straggler", "flagged", ts=event.ts,
                     query_id=event.query_id, shard=event.shard,
                     median_ms=event.median_ms,
                     baseline_ms=event.baseline_ms)

    def on_streaming_batch(self, event) -> None:
        r = event.record or {}
        self._record("streaming", "batch", ts=event.ts,
                     query_id=event.query_id,
                     batch_id=r.get("batch_id"),
                     rows_in=r.get("rows_in"),
                     rows_out=r.get("rows_out"), shape=r.get("kind"))

    def on_streaming_trigger(self, event) -> None:
        r = event.record or {}
        self._record("streaming", "trigger", ts=event.ts,
                     query_id=event.query_id, tick=r.get("tick"),
                     skew_ms=r.get("skew_ms"),
                     batches_run=r.get("batches_run"))

    def on_query_end(self, event) -> None:
        ev = event.event or {}
        phases = ev.get("phase_times_s") or {}
        err = ev.get("error")
        self._record("query", "end", ts=event.ts,
                     query_id=event.query_id, status=event.status,
                     phase_times_s={k: round(float(v), 4)
                                    for k, v in phases.items()},
                     error=str(err)[:200] if err else None)
        if not self._enabled():
            return
        spans = ev.get("spans")
        if isinstance(spans, list):
            self._retain(self._spans, event.query_id, spans)
        tree = ev.get("plan_tree")
        if tree is not None:
            self._retain(self._trees, event.query_id, tree)

    # -- dumping ------------------------------------------------------------

    def dump(self, reason: str, extra: Optional[Dict] = None,
             error: Optional[BaseException] = None) -> Optional[str]:
        """Write a diagnostic bundle; returns its directory path, or
        None when disabled or the dump itself failed (never raises —
        diagnostics must not compound the failure being diagnosed)."""
        if not self._enabled():
            return None
        try:
            return self._dump(reason, extra, error)
        except Exception as e:  # noqa: BLE001 — diagnostics only
            warnings.warn(f"flight-recorder dump failed: "
                          f"{type(e).__name__}: {e}")
            return None

    def _dump(self, reason: str, extra: Optional[Dict],
              error: Optional[BaseException]) -> str:
        from .sinks import json_default
        conf = self._session.conf
        base = str(conf.get(DIR_KEY)) or _default_dir()
        with self._lock:
            self._seq += 1
            seq = self._seq
            rings = {k: list(d) for k, d in self._rings.items()}
            plans = dict(self._plans)
            trees = dict(self._trees)
            spans = dict(self._spans)
        slug = _SLUG.sub("_", str(reason))[:40] or "unknown"
        name = f"bundle-{self._session.app_id}-{seq:03d}-{slug}"
        path = os.path.join(base, name)
        os.makedirs(path, exist_ok=True)

        def write_json(fname: str, payload) -> str:
            with open(os.path.join(path, fname), "w") as f:
                json.dump(payload, f, default=json_default, indent=1)
            return fname

        files = []
        with open(os.path.join(path, "rings.jsonl"), "w") as f:
            for subsystem in sorted(rings):
                for rec in rings[subsystem]:
                    f.write(json.dumps(dict(rec, subsystem=subsystem),
                                       default=json_default) + "\n")
        files.append("rings.jsonl")
        files.append(write_json("plans.json", {
            "plans": {str(q): p for q, p in plans.items()},
            "plan_trees": {str(q): t for q, t in trees.items()}}))
        files.append(write_json("spans.json", {
            "spans": {str(q): s for q, s in spans.items()}}))
        files.append(write_json("conf.json", self._conf_snapshot()))
        files.append(write_json("metrics.json",
                                self._session.metrics.snapshot()))
        with open(os.path.join(path, "threads.txt"), "w") as f:
            f.write(self._thread_stacks())
        files.append("threads.txt")
        files.append(write_json("lockwatch.json",
                                self._lockwatch_report()))
        tail = self._event_log_tail()
        if tail is not None:
            with open(os.path.join(path,
                                   "eventlog_tail.jsonl"), "w") as f:
                f.writelines(tail)
            files.append("eventlog_tail.jsonl")
        manifest = {
            "bundle_version": BUNDLE_VERSION,
            "reason": str(reason),
            "ts": time.time(),
            "app_id": self._session.app_id,
            "pid": os.getpid(),
            "error": (f"{type(error).__name__}: {error}"[:400]
                      if error is not None else None),
            "extra": extra or {},
            "files": files,
        }
        # MANIFEST last: its presence marks the bundle complete
        write_json("MANIFEST.json", manifest)
        self._session.metrics.counter("flightrec_bundles").inc()
        return path

    def _conf_snapshot(self) -> Dict:
        """Effective value of every registered conf key (+ which were
        explicitly set) — the 'what was this process actually running
        with' half of a post-mortem."""
        from ..config import registry
        conf = self._session.conf
        effective = {}
        explicit = []
        for key in sorted(registry()):
            try:
                effective[key] = conf.get(key)
                if conf.is_explicitly_set(key):
                    explicit.append(key)
            except Exception:  # noqa: BLE001 — partial > nothing
                effective[key] = "<unreadable>"
        return {"effective": effective, "explicitly_set": explicit}

    @staticmethod
    def _thread_stacks() -> str:
        """Every live thread's stack, flight-data-recorder style (the
        reference's /threadDump endpoint, as a file)."""
        frames = sys._current_frames()
        names = {t.ident: t for t in threading.enumerate()}
        out = []
        for ident, frame in sorted(frames.items()):
            t = names.get(ident)
            label = (f"{t.name} (daemon={t.daemon})"
                     if t is not None else "<unknown>")
            out.append(f'Thread {ident} "{label}":\n')
            out.extend(traceback.format_stack(frame))
            out.append("\n")
        return "".join(out)

    @staticmethod
    def _lockwatch_report() -> Dict:
        """The installed lock watch's report (`testing/lockwatch.py`;
        test-only, so a production bundle says none is installed)."""
        from ..testing.lockwatch import current_watch
        w = current_watch()
        if w is None:
            return {"installed": False}
        return dict(w.report(), installed=True)

    def _event_log_tail(self) -> Optional[List[str]]:
        """Last N lines of the session's LIVE event-log file (rolled
        files are already durable; the live tail is what a crashed
        process would otherwise lose context around)."""
        conf = self._session.conf
        n = int(conf.get(TAIL_KEY))
        log_dir = str(conf.get("spark_tpu.sql.eventLog.dir"))
        if n <= 0 or not log_dir:
            return None
        base = os.path.join(log_dir,
                            f"app-{self._session.app_id}.jsonl")
        try:
            with open(base) as f:
                return list(deque(f, maxlen=n))
        except OSError:
            return None
