"""The long-lived SQL service: HTTP JSON endpoint over a session pool
(the port of `spark_tpu/service/server.py`).

The `HiveThriftServer2.scala:44` analog, sized to this engine: a
threading stdlib HTTP server (no new dependencies) in front of the
session pool, admission controller and device-memory arbiter. Every
pooled session runs on the service's device: the current CUDA card
unless `SqlService(device=...)` names another (the tests pass "cpu");
with neither a device nor CUDA, constructing the service raises, as
building a session does.

Endpoints:

- ``POST /sql``: submit a query. JSON body
  ``{"sql": "...", "session": "name", "conf": {...}, "mode":
  "sync"|"async", "format": "json"|"arrow"}`` (all but ``sql``
  optional). Sync returns the result (JSON columns/rows, or an Arrow
  IPC stream with ``format=arrow``) plus the service query id; async
  returns 202 with the id immediately. Admission rejections are HTTP
  429 and queue timeouts 503, both with structured JSON bodies.
- ``GET /queries``: paginated listing of the query registry (newest
  first; ``?offset=&limit=&status=&session=``) — the live history UI
  seat, no JSONL scraping required.
- ``GET /queries/<id>``: the query's status record, fed by the
  listener bus (engine query id, phase times, fault events, status).
- ``GET /queries/<id>/timeline``: post-execution detail from the
  bounded QueryHistoryStore — per-phase spans, per-attempt device
  memory records (`peak_hbm_bytes` from the CUDA caching allocator),
  per-shard flight-recorder records.
- ``GET /queries/<id>/plan``: the submitted SQL plus the describe()
  fingerprint and the runtime-annotated physical tree.
- ``DELETE /queries/<id>``: cancel a submitted/running query
  (execution/lifecycle.py). A running query stops at its next
  cooperative boundary (chunk, stage attempt, backoff, queue/lease
  wait) with a structured ``QUERY_CANCELLED`` error; a queued async
  request leaves the admission queue without ever executing. 200 with
  ``cancel_requested``; 404 (structured) for an unknown id; 409 for a
  query that already finished. Idempotent: a second DELETE of a
  still-stopping query is another 200.
- ``GET /metrics``: the shared metrics registry in Prometheus text
  exposition (queries, admission, arbiter, result cache, latency
  histograms with native ``_bucket``/``_sum``/``_count``).
- ``GET /healthz``: combined health + pool/admission/arbiter/quota
  stats (with ``ready``/``draining``). ``GET /healthz/live`` and
  ``GET /healthz/ready`` split liveness from readiness. The JAX
  package's service is live-but-not-ready while it replays its
  compile-cache manifest; the port has no compile cache, so it is ready
  as soon as it starts (a warm start comes with the fleet, if at all).
- ``GET /status``: the status store's live health snapshot — queries
  in flight and per-phase outcomes per session, admission queue
  depth, arbiter lease occupancy, cache hit rates, p50/p95/p99 query
  latency per phase and query class, SLO burn rate.
- ``GET /status/timeseries``: the heartbeat-sampled ring time-series
  behind the snapshot (``?series=a,b&limit=N`` to filter/trim).
- ``GET /debug/bundle``: dump an on-demand flight-recorder diagnostic
  bundle per pooled session; returns the bundle directory paths.

Per-request deadline: ``POST /sql`` honors
``spark_tpu.execution.queryDeadlineMs`` from the request's ``conf``
map (or the service conf), armed at SUBMIT entry so admission-queue
and session waits count against the end-to-end budget; a blown
deadline surfaces as a structured ``QUERY_DEADLINE_EXCEEDED`` error.

Per-session quotas: ``spark_tpu.service.session.maxConcurrent`` bounds
one session name's in-flight submissions (SESSION_QUOTA_EXCEEDED, 429)
and ``spark_tpu.service.session.hbmShare`` caps one session's arbiter
leases — a greedy session degrades to out-of-core paths instead of
starving the pool.

Device memory: ``spark_tpu.service.hbmBudget`` is a byte count of the
card's memory as ``torch.cuda.get_device_properties(i).total_memory``
reports it (80 GB on an H100 80GB HBM3); the arbiter leases estimated
scan footprints against it. ``session.hbmShare`` is a fraction of that
budget.
"""

from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from ..columnar import resolve_device
from ..config import Conf
from ..execution import lifecycle
from ..expr import AnalysisError
from ..observability import ListenerBus, MetricsRegistry, QueryListener
from ..observability.flight_recorder import FlightRecorder
from ..observability.listener import ServiceEvent
from ..observability.sinks import json_default
from ..observability.status_store import StatusStore
from ..sql.lexer import ParseError
from ..udf_worker import UdfError
from .admission import (SESSION_MAX_CONCURRENT_KEY, AdmissionController,
                        AdmissionError, AdmissionRejected,
                        AdmissionTimeout, ServiceDraining, SessionQuota)
from .arbiter import (DeviceResourceArbiter, get_arbiter, install_arbiter)
from .pool import PoolExhausted, SessionPool
from .query_history import (HISTORY_SIZE_KEY, QueryHistoryStore,
                            detail_from_event)

MAX_CONCURRENT_KEY = "spark_tpu.service.maxConcurrent"
QUEUE_DEPTH_KEY = "spark_tpu.service.queueDepth"
QUEUE_TIMEOUT_KEY = "spark_tpu.service.queueTimeoutMs"
HOST_KEY = "spark_tpu.service.host"
PORT_KEY = "spark_tpu.service.port"
HBM_BUDGET_KEY = "spark_tpu.service.hbmBudget"
RESULT_CACHE_KEY = "spark_tpu.service.resultCacheBytes"
QUERY_LOG_KEY = "spark_tpu.service.queryLogSize"
ID_PREFIX_KEY = "spark_tpu.service.idPrefix"
DRAIN_TIMEOUT_KEY = "spark_tpu.service.fleet.drainTimeoutMs"


class _StatusListener(QueryListener):
    """Pooled-session subscriber feeding `GET /queries/<id>`: engine
    lifecycle events resolve against the service record currently
    leased onto that session (sessions execute one query at a time).
    At query end the full detail record (spans, stage costs, per-shard
    records, runtime plan tree) lands in the service's
    QueryHistoryStore for `GET /queries/<id>/{timeline,plan}`."""

    def __init__(self, entry, history: Optional[QueryHistoryStore] = None):
        self._entry = entry
        self._history = history

    def _record(self):
        return self._entry.current_record

    def on_query_start(self, event) -> None:
        r = self._record()
        # first start only: a cached-subtree materialization (WITH
        # clause) spawns a NESTED QueryExecution whose start event must
        # not overwrite the outer query's engine id
        if r is not None and "engine_query_id" not in r:
            r["engine_query_id"] = event.query_id

    def on_fault(self, event) -> None:
        r = self._record()
        if r is not None and len(r.setdefault("fault_events", [])) < 16:
            r["fault_events"].append(
                {"action": event.action, "error": event.error[:160]})

    def on_query_end(self, event) -> None:
        r = self._record()
        if r is None:
            return
        ev = event.event or {}
        # OUTER execution only: nested subquery/CTE executions post
        # their own end events, which must not overwrite the detail of
        # the query the client submitted
        if event.query_id == r.get("engine_query_id"):
            r["phase_times_s"] = ev.get("phase_times_s")
            if ev.get("fault_summary"):
                r["fault_summary"] = {
                    k: v for k, v in ev["fault_summary"].items()
                    if isinstance(v, (int, float))}
            if self._history is not None:
                self._history.put(r["id"], detail_from_event(event))


class SqlService:
    """Session pool + admission + arbiter + HTTP front end. Usable
    embedded (`submit()`) or served (`start()`/`stop()`)."""

    def __init__(self, conf: Optional[Conf] = None,
                 init_session=None, device=None):
        self.conf = conf or Conf()
        #: the device of every pooled session; resolving it here makes a
        #: service with no device and no CUDA raise at construction
        self.device = resolve_device(device)
        self.metrics = MetricsRegistry()
        #: service event stream (ServiceEvent per admission/lifecycle
        #: transition) — tests and user hooks subscribe here
        self.bus = ListenerBus()
        self.arbiter = DeviceResourceArbiter(
            int(self.conf.get(HBM_BUDGET_KEY)), metrics=self.metrics,
            result_cache_bytes=int(self.conf.get(RESULT_CACHE_KEY)))
        self._installed_arbiter = False
        #: per-query detail store behind GET /queries/<id>/{timeline,
        #: plan}, fed by the pooled sessions' status listener
        self.history = QueryHistoryStore(
            int(self.conf.get(HISTORY_SIZE_KEY)))
        self.pool = SessionPool(
            self.conf, self.metrics, self.arbiter,
            init_session=init_session,
            make_listener=self._make_listener, device=device)
        self.admission = AdmissionController(
            int(self.conf.get(MAX_CONCURRENT_KEY)),
            int(self.conf.get(QUEUE_DEPTH_KEY)),
            float(self.conf.get(QUEUE_TIMEOUT_KEY)),
            metrics=self.metrics, on_event=self._post)
        #: per-session in-flight quota (session.maxConcurrent): one
        #: greedy session cannot consume every admission slot
        self.session_quota = SessionQuota(
            int(self.conf.get(SESSION_MAX_CONCURRENT_KEY)),
            metrics=self.metrics)
        #: heartbeat-sampled engine-health store behind GET /status —
        #: providers run OUTSIDE its lock (each takes its own), so the
        #: status seat never extends any provider's critical section
        self.status_store = StatusStore(self.conf, self.metrics, {
            "admission": self.admission.stats,
            "quota": self.session_quota.stats,
            "arbiter": self.arbiter.stats,
            "pool": lambda: {"sessions": len(self.pool)},
            "udf": self._udf_stats,
        })
        self._records: "OrderedDict[str, Dict]" = OrderedDict()
        self._records_lock = threading.Lock()
        #: cancel tokens of submitted/running queries, by service query
        #: id (DELETE /queries/<id> reaches them cross-thread); entries
        #: are dropped when their query finishes
        self._tokens: Dict[str, "lifecycle.CancelToken"] = {}
        #: in-flight async submissions (each is a worker thread):
        #: bounded at maxConcurrent + queueDepth so an async burst
        #: sheds at the front door like sync traffic does, instead of
        #: accumulating one blocked thread per request
        self._async_inflight = 0
        self._async_lock = threading.Lock()
        #: serializes lazy arbiter installation: two first-submits
        #: racing _ensure_arbiter could both observe "not installed"
        #: and one would leak _installed_arbiter=True over the other's
        #: install (stop() would then uninstall an arbiter a second
        #: service had installed meanwhile)
        self._install_lock = threading.Lock()
        self._record_bound = int(self.conf.get(QUERY_LOG_KEY))
        self._seq = 0
        self._id_prefix = str(self.conf.get(ID_PREFIX_KEY) or "")
        self._started_ts = time.time()
        #: readiness gate behind GET /healthz/ready: set by start()
        #: (the port has no compile-cache manifest to replay first)
        self._ready = threading.Event()
        #: serializes stop() (idempotent, signal-safe: a SIGTERM's
        #: drain thread and an explicit stop() must not both tear the
        #: httpd down) and guards the _stopped/_draining flags
        self._stop_lock = threading.Lock()
        self._stopped = False
        #: draining: new submissions shed with SERVICE_DRAINING (503)
        #: while in-flight queries finish under the drain budget
        self._draining = False
        #: set by stop() AFTER teardown completes (never by the signal
        #: handler directly): worker mains park on wait_for_shutdown()
        #: and must not wake until the drain has run
        self._shutdown_event = threading.Event()
        # lifecycle attrs (guarded-by waiver): written only by the
        # owning control thread in start()/stop(), not on the request
        # path
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._serve_thread: Optional[threading.Thread] = None

    def _make_listener(self, entry) -> QueryListener:
        """Per-pooled-session listener wiring (runs in pool._create):
        bind the status store's per-session feed, then hand back the
        /queries status listener the pool registers."""
        self.status_store.bind(entry.session, entry.name)
        return _StatusListener(entry, self.history)

    def _udf_stats(self) -> Dict:
        """Status-store provider: live UDF workers across the pool
        (GIL-atomic reads of each pool's `_live`; 0 when no session
        has spawned a worker pool)."""
        live = 0
        for s in self.pool.sessions().values():
            pool = getattr(s, "_udf_pool", None)
            if pool is not None:
                live += int(pool._live)
        return {"workers_live": live}

    # -- service event stream ----------------------------------------------

    def _post(self, action: str, query_id: str, detail: str = "",
              session: str = "") -> None:
        rec = self.get_query(query_id)
        if rec is not None and len(rec.setdefault("events", [])) < 32:
            rec["events"].append({"ts": time.time(), "action": action})
        self.bus.post("on_service", ServiceEvent(
            query_id=query_id, ts=time.time(), action=action,
            session=session, detail=detail))

    # -- query registry -----------------------------------------------------

    def _new_record(self, sql: str, session: str,
                    conf: Optional[Dict] = None) -> Dict:
        """Create the status record AND its cancel token in ONE
        critical section: the moment a record is visible to
        DELETE /queries/<id>, its token is reachable too — no window
        where a submitted query reads as 'already finished'. The
        deadline arms HERE (submit entry, per-request conf override
        falling back to the service conf): queryDeadlineMs is
        end-to-end, so admission-queue and busy-session waits count
        against it."""
        v = (conf or {}).get(lifecycle.DEADLINE_KEY)
        if v is None:
            v = self.conf.get(lifecycle.DEADLINE_KEY)
        ms = float(v or 0)
        tok = lifecycle.CancelToken(deadline_ms=ms if ms > 0 else None)
        with self._records_lock:
            self._seq += 1
            rid = f"q-{self._id_prefix}{self._seq}"
            record = {"id": rid, "sql": sql[:500], "session": session,
                      "status": "submitted", "submitted_ts": time.time()}
            self._records[rid] = record
            self._tokens[rid] = tok
            # bound the registry by evicting oldest FINISHED records
            # only: a running/async record is a client's only handle to
            # its query — dropping it would 404 the status poll and
            # orphan later lifecycle transitions. Unfinished records
            # are themselves bounded by admission (maxConcurrent +
            # queueDepth), so the registry stays near the bound.
            if len(self._records) > self._record_bound:
                for old_id in list(self._records):
                    if len(self._records) <= self._record_bound:
                        break
                    if self._records[old_id]["status"] not in (
                            "submitted", "running"):
                        del self._records[old_id]
        return record

    def get_query(self, query_id: str) -> Optional[Dict]:
        with self._records_lock:
            return self._records.get(query_id)

    def query_snapshot(self, query_id: str) -> Optional[Dict]:
        """Serialization-safe copy of a record: GET /queries/<id> must
        not json-iterate the live dict a worker thread is mutating
        (dict-changed-size mid-dump)."""
        rec = self.get_query(query_id)
        if rec is None:
            return None
        snap = dict(rec)  # C-level copy: atomic under the GIL
        for k in ("events", "fault_events"):
            if k in snap:
                snap[k] = list(snap[k])
        return snap

    # -- submission ---------------------------------------------------------

    def _check_draining(self) -> None:
        """Front-door shed while draining: a new submission gets a
        structured SERVICE_DRAINING 503 before it creates a record or
        touches a quota slot (a router retries on another worker).
        GIL-atomic flag read; writes are serialized under _stop_lock."""
        if self._draining:
            self.metrics.counter("service_drain_rejected").inc()
            raise ServiceDraining(
                "service is draining; not admitting new queries")

    def _ensure_arbiter(self) -> None:
        """Install the shared arbiter (when service.hbmBudget > 0) on
        first use — submit() must arbitrate HBM whether the service is
        embedded or start()ed; stop() uninstalls what we installed.
        Lock-guarded: concurrent first submissions must resolve to
        exactly one install (and one owner for stop() to undo)."""
        with self._install_lock:
            if (not self._installed_arbiter and self.arbiter.total > 0
                    and get_arbiter() is None):
                install_arbiter(self.arbiter)
                self._installed_arbiter = True

    def _lock_session(self, entry, session: str, query_id: str) -> None:
        """Lease the named session (its execution is serialized),
        bounded by the queueTimeoutMs discipline so a request stuck
        behind a long-running query sheds with a structured 503
        instead of waiting forever. Cancellable: the wait runs in
        token-capped slices (execution/lifecycle.py), so a DELETE or
        a blown queryDeadlineMs releases the waiter promptly."""
        timeout_ms = self.admission.queue_timeout_ms
        deadline = (time.monotonic() + timeout_ms / 1e3
                    if timeout_ms > 0 else None)
        while True:
            remaining = None if deadline is None \
                else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                break
            s = lifecycle.wait_slice(remaining)
            if entry.lock.acquire(timeout=s if s is not None else -1):
                return
            lifecycle.checkpoint("session_wait")
        self.metrics.counter("service_queue_timeout").inc()
        self._post("queue_timeout", query_id,
                   detail=f"session={session} busy", session=session)
        raise AdmissionTimeout(
            f"session '{session}' still busy after {timeout_ms:g}ms",
            session=session, queue_timeout_ms=timeout_ms)

    def _get_token(self, rid: str) -> Optional["lifecycle.CancelToken"]:
        with self._records_lock:
            return self._tokens.get(rid)

    def _drop_token(self, rid: str) -> None:
        with self._records_lock:
            self._tokens.pop(rid, None)

    def _finish_lifecycle(self, record: Dict, e: Exception,
                          session: str) -> None:
        """Record a cancelled/deadlined outcome: structured error body,
        terminal status, lifecycle counter (only when the query never
        reached the engine — executions that started already counted
        in the executor), and the service event."""
        cancelled = isinstance(e, lifecycle.QueryCancelledError)
        status = "cancelled" if cancelled else "deadline_exceeded"
        record["status"] = status
        record["error"] = {
            "error": ("QUERY_CANCELLED" if cancelled
                      else "QUERY_DEADLINE_EXCEEDED"),
            "message": f"{type(e).__name__}: {e}"[:400],
            "query_id": record["id"]}
        record["finished_ts"] = time.time()
        if "started_ts" not in record:
            self.metrics.counter(
                "query_cancelled" if cancelled
                else "query_deadline_exceeded").inc()
        self._post(status, record["id"], session=session)

    def submit(self, sql: str, session: str = "default",
               conf: Optional[Dict] = None):
        """Run `sql` on the named pooled session under admission
        control. Returns (record, Arrow table). Raises AdmissionError /
        PoolExhausted / the structured lifecycle errors, or whatever
        the engine raised; the record reflects the outcome either
        way."""
        self._check_draining()
        record = self._new_record(sql, session, conf)
        rid = record["id"]
        self._ensure_arbiter()
        self.metrics.counter("service_queries_submitted").inc()
        self._post("submitted", rid, session=session)
        ctx_token = lifecycle.install(self._get_token(rid))
        try:
            # per-session quota FIRST: a greedy session sheds at its
            # own bound before consuming a pool-wide queue slot
            self.session_quota.acquire(session)
            try:
                # session serialization next, admission slot second: a
                # request blocked behind a busy session must not hold
                # one of the maxConcurrent execution slots while doing
                # no work (it would starve other sessions' requests
                # into 429/503)
                entry = self.pool.get_or_create(session)
                self._lock_session(entry, session, rid)
                try:
                    # overrides land inside the same lock window the
                    # query executes in: sticky per-session SET
                    # semantics, and a concurrent request can neither
                    # clobber them before this query runs nor land its
                    # own mid-query
                    if conf:
                        for k, v in conf.items():
                            entry.session.conf.set(k, v)
                    with self.admission.slot(rid):
                        entry.current_record = record
                        record["status"] = "running"
                        record["started_ts"] = time.time()
                        try:
                            with entry.session.as_active():
                                qe = entry.session.sql(sql)._qe()
                                table = qe.collect()
                        finally:
                            entry.current_record = None
                finally:
                    entry.lock.release()
            finally:
                self.session_quota.release(session)
            # success bookkeeping INSIDE the try: the record must read
            # terminal before the finally drops the token, so a racing
            # DELETE never sees (running, no token) mid-transition
            record["status"] = "ok"
            record["row_count"] = int(table.num_rows)
            record["finished_ts"] = time.time()
            record["elapsed_ms"] = round(
                (record["finished_ts"] - record["started_ts"]) * 1e3, 1)
            self.metrics.counter("service_completed").inc()
            self._post("finished", rid, session=session)
        except AdmissionError as e:
            record["status"] = ("queue_timeout"
                                if e.code == "ADMISSION_TIMEOUT"
                                else "rejected")
            e.detail.setdefault("query_id", rid)
            record["error"] = e.to_dict()
            record["finished_ts"] = time.time()
            if e.code == "SESSION_QUOTA_EXCEEDED":
                # the AdmissionController counts its own rejections;
                # quota rejections get the same service-level
                # bookkeeping here (submit_async's quota catch does)
                self.metrics.counter("service_rejected").inc()
                self._post("rejected", rid, detail="sessionQuota",
                           session=session)
            raise
        except PoolExhausted as e:
            # capacity rejection, not an engine failure: must not count
            # into service_failed or read as EXECUTION_ERROR in the
            # record (the HTTP layer returns 429 for it)
            record["status"] = "rejected"
            record["error"] = e.to_dict()
            record["finished_ts"] = time.time()
            self.metrics.counter("service_rejected").inc()
            self._post("rejected", rid, detail="maxSessions",
                       session=session)
            raise
        except (lifecycle.QueryCancelledError,
                lifecycle.QueryDeadlineError) as e:
            self._finish_lifecycle(record, e, session)
            raise
        except Exception as e:  # noqa: BLE001 — recorded, then surfaced
            record["status"] = "error"
            code = ("INVALID_SQL"
                    if isinstance(e, (ParseError, AnalysisError))
                    else "UDF_ERROR" if isinstance(e, UdfError)
                    else "EXECUTION_ERROR")
            record["error"] = {"error": code,
                               "message": f"{type(e).__name__}: {e}"[:400]}
            if isinstance(e, UdfError):
                # the USER traceback captured inside the worker child —
                # the client debugs their lambda, not our pool framing
                record["error"]["traceback"] = e.worker_traceback
            record["finished_ts"] = time.time()
            self.metrics.counter("service_failed").inc()
            self._post("failed", rid, detail=type(e).__name__,
                       session=session)
            raise
        finally:
            lifecycle.uninstall(ctx_token)
            self._drop_token(rid)
        return record, table

    def submit_async(self, sql: str, session: str = "default",
                     conf: Optional[Dict] = None) -> Dict:
        """Fire-and-poll submission: returns the record immediately;
        progress lands on it (GET /queries/<id>). The worker thread
        holds no result — async is for effects/status, sync for data.
        Raises AdmissionRejected (structured, HTTP 429) when
        maxConcurrent + queueDepth async submissions are already in
        flight, or SessionQuotaExceeded at the per-session bound.

        The cancel token is created WITH the record, before the worker
        spawns: a DELETE arriving while the request is still queued
        cancels it out of the admission queue without it ever
        executing."""
        self._check_draining()
        record = self._new_record(sql, session, conf)
        try:
            self.session_quota.acquire(session)
        except AdmissionError as err:
            record["status"] = "rejected"
            err.detail.setdefault("query_id", record["id"])
            record["error"] = err.to_dict()
            record["finished_ts"] = time.time()
            self._drop_token(record["id"])
            self.metrics.counter("service_rejected").inc()
            self._post("rejected", record["id"],
                       detail="sessionQuota", session=session)
            raise
        bound = (self.admission.max_concurrent
                 + self.admission.queue_depth)
        # the bound check-and-increment is the only atomic part; the
        # rejection bookkeeping runs OUTSIDE the lock — _post takes
        # _records_lock, and holding _async_lock across it inverted
        # the registry's lock-order ranking (lock-order lint LO202)
        with self._async_lock:
            in_flight = self._async_inflight
            rejected = in_flight >= bound
            if not rejected:
                self._async_inflight += 1
        if rejected:
            self.session_quota.release(session)
            err = AdmissionRejected(
                f"async submissions in flight at bound "
                f"({in_flight}/{bound})",
                in_flight=in_flight, bound=bound,
                query_id=record["id"])
            record["status"] = "rejected"
            record["error"] = err.to_dict()
            record["finished_ts"] = time.time()
            self._drop_token(record["id"])
            self.metrics.counter("service_rejected").inc()
            self._post("rejected", record["id"],
                       detail="asyncInFlight", session=session)
            raise err

        tok = self._get_token(record["id"])

        def run():
            # re-drive through submit's machinery minus re-registration
            # (same ordering as submit: session lease, then slot). The
            # token installs on THIS worker thread: a cancel delivered
            # while queued raises out of the admission/session waits
            # and the request never executes (slot math intact).
            ctx_token = lifecycle.install(tok)
            try:
                entry = self.pool.get_or_create(session)
                self._lock_session(entry, session, record["id"])
                try:
                    if conf:
                        for k, v in conf.items():
                            entry.session.conf.set(k, v)
                    with self.admission.slot(record["id"]):
                        entry.current_record = record
                        record["status"] = "running"
                        record["started_ts"] = time.time()
                        try:
                            with entry.session.as_active():
                                t = entry.session.sql(sql)._qe().collect()
                            record["row_count"] = int(t.num_rows)
                            record["status"] = "ok"
                            self.metrics.counter(
                                "service_completed").inc()
                            self._post("finished", record["id"],
                                       session=session)
                        finally:
                            entry.current_record = None
                finally:
                    entry.lock.release()
            except AdmissionError as e:
                record["status"] = ("queue_timeout"
                                    if e.code == "ADMISSION_TIMEOUT"
                                    else "rejected")
                record["error"] = e.to_dict()
            except PoolExhausted as e:
                record["status"] = "rejected"
                record["error"] = e.to_dict()
                self.metrics.counter("service_rejected").inc()
                self._post("rejected", record["id"],
                           detail="maxSessions", session=session)
            except (lifecycle.QueryCancelledError,
                    lifecycle.QueryDeadlineError) as e:
                self._finish_lifecycle(record, e, session)
            except Exception as e:  # noqa: BLE001 — poll-visible
                record["status"] = "error"
                code = ("INVALID_SQL"
                        if isinstance(e, (ParseError, AnalysisError))
                        else "UDF_ERROR" if isinstance(e, UdfError)
                        else "EXECUTION_ERROR")
                record["error"] = {
                    "error": code,
                    "message": f"{type(e).__name__}: {e}"[:400]}
                if isinstance(e, UdfError):
                    record["error"]["traceback"] = e.worker_traceback
                self.metrics.counter("service_failed").inc()
                self._post("failed", record["id"], session=session)
            finally:
                lifecycle.uninstall(ctx_token)
                self._drop_token(record["id"])
                self.session_quota.release(session)
                with self._async_lock:
                    self._async_inflight -= 1
            record["finished_ts"] = time.time()

        try:
            self._ensure_arbiter()
            self.metrics.counter("service_queries_submitted").inc()
            self._post("submitted", record["id"], session=session)
            threading.Thread(target=run, daemon=True,
                             name=f"sql-{record['id']}").start()
        except BaseException as e:
            # Thread.start() can fail under thread exhaustion — the
            # exact overload quotas exist for. run()'s finally (the
            # only release path) never executes, so undo its
            # bookkeeping here or the session permanently loses a
            # quota slot (and the record reads 'submitted' forever,
            # unevictable)
            self.session_quota.release(session)
            with self._async_lock:
                self._async_inflight -= 1
            self._drop_token(record["id"])
            record["status"] = "error"
            record["error"] = {"error": "EXECUTION_ERROR",
                               "message": f"{type(e).__name__}: "
                                          f"{e}"[:400]}
            record["finished_ts"] = time.time()
            raise
        return record

    # -- endpoints' data ----------------------------------------------------

    #: status-record fields exposed in the GET /queries listing (the
    #: full record stays behind GET /queries/<id>)
    _LIST_FIELDS = ("id", "sql", "session", "status", "submitted_ts",
                    "started_ts", "finished_ts", "elapsed_ms",
                    "row_count", "engine_query_id")

    def query_listing(self, offset: int = 0, limit: int = 50,
                      status: Optional[str] = None,
                      session: Optional[str] = None) -> Dict:
        """Paginated query listing, newest first, optionally filtered
        by status / session name. Bounded by the same queryLogSize
        registry GET /queries/<id> reads from. Live streaming trigger
        loops (streaming.live_queries) ride along under `streams` —
        unpaginated; there are at most a handful per process."""
        from ..streaming import live_queries
        offset = max(0, int(offset))
        limit = max(1, min(int(limit), 500))
        with self._records_lock:
            # C-level copies under the lock: worker threads mutate the
            # live record dicts mid-listing
            records = [dict(r) for r in self._records.values()]
        records.reverse()  # insertion order == submission order
        if status is not None:
            records = [r for r in records if r.get("status") == status]
        if session is not None:
            records = [r for r in records if r.get("session") == session]
        page = records[offset:offset + limit]
        out = {"queries": [{k: r.get(k) for k in self._LIST_FIELDS
                            if k in r} for r in page],
               "total": len(records), "offset": offset, "limit": limit,
               # outside _records_lock by construction (this line runs
               # after the with block): live_queries takes its own
               # registry + per-query status locks
               "streams": live_queries()}
        if offset + limit < len(records):
            out["next_offset"] = offset + limit
        return out

    def query_timeline(self, query_id: str) -> Optional[Dict]:
        """Per-query flight-recorder view: phase spans + per-attempt
        device memory + per-shard records, from the history
        store (None when the id is unknown; a known-but-still-running
        query serves its status record with empty detail)."""
        rec = self.query_snapshot(query_id)
        if rec is None:
            return None
        detail = self.history.get(query_id) or {}
        return {"query_id": query_id,
                "status": rec.get("status"),
                "session": rec.get("session"),
                "engine_query_id": (rec.get("engine_query_id")
                                    or detail.get("engine_query_id")),
                "elapsed_ms": rec.get("elapsed_ms"),
                "phase_times_s": detail.get("phase_times_s")
                or rec.get("phase_times_s"),
                "spans": detail.get("spans") or [],
                "stages": detail.get("stages") or [],
                "shards": detail.get("shards") or [],
                "metrics": detail.get("metrics") or {},
                "predictions": detail.get("predictions") or [],
                "fault_summary": (detail.get("fault_summary")
                                  or rec.get("fault_summary"))}

    def query_plan(self, query_id: str) -> Optional[Dict]:
        """Explain view: the submitted SQL, the describe() fingerprint
        and the runtime-annotated physical tree."""
        rec = self.query_snapshot(query_id)
        if rec is None:
            return None
        detail = self.history.get(query_id) or {}
        reorder = detail.get("reorder") or {}
        return {"query_id": query_id,
                "status": rec.get("status"),
                "sql": rec.get("sql"),
                "plan": detail.get("plan"),
                "physical": detail.get("plan_tree"),
                # cost-based join-reorder verdict: yes/no + per-region
                # chosen order with per-join estimated rows, so a wrong
                # reorder is debuggable straight from the history API
                "reorder": ("yes" if reorder.get("changed") else "no")
                if reorder else None,
                "reorder_regions": reorder.get("regions") or [],
                "analysis_findings": detail.get("analysis_findings")
                or [],
                # per-rule optimizer application trace (schema v7):
                # which rules fired, how often, and (under
                # planChangeLog) the first effective tree diff
                "rule_trace": detail.get("rule_trace") or []}

    def cancel_query(self, query_id: str):
        """Request cooperative cancellation of a submitted/running
        query (the DELETE /queries/<id> seat). Returns (http_status,
        json_body) — 200 cancel_requested, 404 unknown id (structured,
        same error shape as 429/503), 409 already finished.
        Idempotent: a second DELETE of a still-stopping query returns
        another 200; cancel-after-finish is the 409.

        `stream-<n>` ids are live streaming trigger loops
        (streaming.live_queries): DELETE stops the loop — cancel the
        lifecycle token, join the thread bounded — leaving zero orphan
        threads and the checkpoint at its last committed batch."""
        if query_id.startswith("stream-"):
            from ..streaming import get_live
            q = get_live(query_id)
            if q is None:
                return 404, {"error": "NOT_FOUND",
                             "message": f"no live streaming query "
                                        f"{query_id!r}",
                             "query_id": query_id}
            q.stop()
            return 200, {"query_id": query_id, "status": "stopped",
                         "query_status": q.status}
        rec = self.get_query(query_id)
        if rec is None:
            return 404, {"error": "NOT_FOUND",
                         "message": f"unknown query id {query_id!r}",
                         "query_id": query_id}
        with self._records_lock:
            tok = self._tokens.get(query_id)
        status = rec.get("status")
        if tok is None or status not in ("submitted", "running"):
            return 409, {"error": "QUERY_FINISHED",
                         "message": f"query {query_id} already "
                                    f"finished (status={status})",
                         "query_id": query_id, "status": status}
        tok.cancel()
        self._post("cancel_requested", query_id,
                   session=rec.get("session", ""))
        return 200, {"query_id": query_id, "status": "cancel_requested"}

    def metrics_text(self) -> str:
        from ..observability.metrics import prometheus_text
        return prometheus_text(self.metrics.snapshot())

    @property
    def ready(self) -> bool:
        """Readiness: set once start() has bound the socket."""
        return self._ready.is_set()

    def health(self) -> Dict:
        return {"status": "ok",
                "ready": self.ready,
                "draining": self._draining,
                "uptime_s": round(time.time() - self._started_ts, 1),
                "sessions": len(self.pool),
                "admission": self.admission.stats(),
                "session_quota": self.session_quota.stats(),
                "arbiter": self.arbiter.stats()
                if self._installed_arbiter else None}

    def debug_bundles(self) -> Dict:
        """On-demand flight-recorder dump, one bundle per pooled
        session (the GET /debug/bundle seat)."""
        bundles = []
        for name, session in self.pool.sessions().items():
            rec = FlightRecorder.of(session)
            if rec is None:
                continue
            path = rec.dump("on_demand", extra={"session": name})
            if path is not None:
                bundles.append({"session": name, "path": path})
        return {"bundles": bundles}

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "SqlService":
        """Install the arbiter (when hbmBudget > 0), start the status
        store's heartbeat and serve HTTP on service.{host,port} from a
        daemon thread. Ready at once: the JAX package's compile-cache
        warm start has no counterpart in the eager port.

        Runs under _stop_lock, so a stop() racing it waits for a whole
        start and then tears all of it down; a start() after stop() is
        a no-op (a stopped service stays stopped). The JAX package's
        start does not take the lock: there a stop() landing mid-start
        can join a heartbeat thread not yet started (RuntimeError) and
        return while start() goes on to serve."""
        with self._stop_lock:
            if self._stopped:
                return self
            self._ensure_arbiter()
            self.status_store.start()
            handler = _make_handler(self)
            self._httpd = ThreadingHTTPServer(
                (str(self.conf.get(HOST_KEY)),
                 int(self.conf.get(PORT_KEY))), handler)
            self._httpd.daemon_threads = True
            self._serve_thread = threading.Thread(
                target=self._httpd.serve_forever, daemon=True,
                name="sql-service-http")
            self._serve_thread.start()
            self._ready.set()
        return self

    @property
    def port(self) -> Optional[int]:
        return None if self._httpd is None \
            else self._httpd.server_address[1]

    def drain(self, timeout_ms: Optional[float] = None) -> bool:
        """Stop admitting (new submissions shed with a structured
        SERVICE_DRAINING 503) and wait — bounded by `timeout_ms`,
        default fleet.drainTimeoutMs — for in-flight work (running +
        queued + async threads) to finish. In-flight queries keep
        their own queryDeadlineMs budgets, so the wait is doubly
        bounded. Returns True when the service drained dry within the
        budget. Idempotent; safe before start()."""
        with self._stop_lock:
            self._draining = True
        if timeout_ms is None:
            timeout_ms = float(self.conf.get(DRAIN_TIMEOUT_KEY))
        deadline = time.monotonic() + float(timeout_ms) / 1e3
        while True:
            stats = self.admission.stats()
            with self._async_lock:
                n_async = self._async_inflight
            if (not stats.get("running") and not stats.get("queued")
                    and n_async == 0):
                self.metrics.counter("service_drains").inc()
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.02)

    def stop(self) -> None:
        """Clean shutdown: stop accepting, close the socket, join the
        status-store heartbeat, uninstall the arbiter if this service
        installed it. Idempotent and signal-safe: _stop_lock
        serializes concurrent stops (a SIGTERM shutdown thread racing
        an explicit stop(), or a double-stop) — the second caller
        blocks on the bounded joins, then returns having torn nothing
        down twice."""
        with self._stop_lock:
            if self._stopped:
                return
            self._stopped = True
            self._draining = True
            self.status_store.stop()
            if self._httpd is not None:
                self._httpd.shutdown()
                self._httpd.server_close()
                self._httpd = None
            if self._serve_thread is not None:
                self._serve_thread.join(timeout=10)
                self._serve_thread = None
            with self._install_lock:
                if self._installed_arbiter:
                    install_arbiter(None)
                    self._installed_arbiter = False
        self._shutdown_event.set()

    def shutdown(self) -> None:
        """The drain path: shed new work, bounded-wait in-flight, then
        stop. What the SIGTERM/SIGINT handlers run (on a normal
        thread) and what a fleet worker does when its supervisor
        terminates it."""
        self.drain()
        self.stop()

    def install_signal_handlers(self) -> None:
        """Wire SIGTERM/SIGINT to the drain path. Handler-safe by
        construction: the handler only spawns a normal thread for
        shutdown() — stop() joins threads and takes locks, neither
        legal inside a signal frame. The handler deliberately does NOT
        set _shutdown_event: stop() sets it after teardown, so a
        worker main parked on wait_for_shutdown() stays parked until
        the drain has actually run (waking it early let the worker
        exit with in-flight queries — async ones especially — still
        running, silently skipping the bounded-drain guarantee).
        Double delivery (or a signal racing an explicit stop())
        serializes on _stop_lock and is a no-op the second time. Call
        from the main thread (CPython restricts signal.signal to
        it)."""
        import signal

        def _handler(signum, frame):
            threading.Thread(target=self.shutdown, daemon=True,
                             name="sql-service-shutdown").start()

        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, _handler)

    def wait_for_shutdown(self,
                          timeout: Optional[float] = None) -> bool:
        """Park until stop() has completed — including the
        signal-driven drain path, which only sets the event once the
        drain ran and the service tore down (worker mains block here).
        Returns whether the event fired."""
        return self._shutdown_event.wait(timeout)


# ---------------------------------------------------------------------------
# HTTP plumbing
# ---------------------------------------------------------------------------


def _table_rows(table) -> list:
    """Arrow table -> JSON-friendly row dicts: decimals to float, dates
    and timestamps to ISO strings (repr-degrading them through the
    event-log encoder would leak Python syntax to HTTP clients)."""
    import datetime
    import decimal
    rows = table.to_pylist()
    for row in rows:
        for k, v in row.items():
            if isinstance(v, decimal.Decimal):
                row[k] = float(v)
            elif isinstance(v, (datetime.date, datetime.datetime)):
                row[k] = v.isoformat()
    return rows


def _make_handler(service: SqlService):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet: metrics cover it
            pass

        def _send_json(self, status: int, payload: Dict) -> None:
            body = json.dumps(payload, default=json_default).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_text(self, status: int, text: str,
                       content_type: str) -> None:
            body = text.encode()
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
            from urllib.parse import parse_qs
            path, _, query = self.path.partition("?")
            if path == "/healthz":
                self._send_json(200, service.health())
            elif path == "/healthz/live":
                # liveness: the socket answers — distinct from ready
                self._send_json(200, {"live": True,
                                      "ready": service.ready})
            elif path == "/healthz/ready":
                if service.ready:
                    self._send_json(200, {"ready": True})
                else:
                    self._send_json(503, {
                        "error": "NOT_READY",
                        "message": "service not started",
                        "ready": False})
            elif path == "/status":
                self._send_json(200, service.status_store.snapshot())
            elif path == "/status/timeseries":
                qs = parse_qs(query)
                names = None
                if qs.get("series"):
                    names = [s for s in qs["series"][0].split(",") if s]
                try:
                    limit = (int(qs["limit"][0])
                             if qs.get("limit") else None)
                except (TypeError, ValueError) as e:
                    self._send_json(400, {"error": "BAD_REQUEST",
                                          "message": str(e)[:200]})
                    return
                self._send_json(200, service.status_store.timeseries(
                    names=names, limit=limit))
            elif path == "/debug/bundle":
                self._send_json(200, service.debug_bundles())
            elif path == "/metrics":
                self._send_text(
                    200, service.metrics_text(),
                    "text/plain; version=0.0.4; charset=utf-8")
            elif path in ("/queries", "/queries/"):
                qs = parse_qs(query)

                def arg(name, default=None):
                    v = qs.get(name)
                    return v[0] if v else default

                try:
                    listing = service.query_listing(
                        offset=int(arg("offset", 0)),
                        limit=int(arg("limit", 50)),
                        status=arg("status"), session=arg("session"))
                except (TypeError, ValueError) as e:
                    self._send_json(400, {"error": "BAD_REQUEST",
                                          "message": str(e)[:200]})
                    return
                self._send_json(200, listing)
            elif path.startswith("/queries/"):
                rest = path[len("/queries/"):]
                qid = rest
                if rest.endswith("/timeline"):
                    qid = rest[:-len("/timeline")]
                    payload = service.query_timeline(qid)
                elif rest.endswith("/plan"):
                    qid = rest[:-len("/plan")]
                    payload = service.query_plan(qid)
                else:
                    payload = service.query_snapshot(rest)
                if payload is None:
                    # structured 404: same error shape as the 429/503
                    # admission bodies (error + message + detail)
                    self._send_json(404, {
                        "error": "NOT_FOUND",
                        "message": f"unknown query id {qid!r}",
                        "query_id": qid})
                else:
                    self._send_json(200, payload)
            else:
                self._send_json(404, {"error": "NOT_FOUND",
                                      "message": path})

        def do_DELETE(self):  # noqa: N802 — BaseHTTPRequestHandler API
            path = self.path.split("?", 1)[0]
            if path.startswith("/queries/"):
                qid = path[len("/queries/"):]
                status, payload = service.cancel_query(qid)
                self._send_json(status, payload)
            else:
                self._send_json(404, {"error": "NOT_FOUND",
                                      "message": path})

        def do_POST(self):  # noqa: N802 — BaseHTTPRequestHandler API
            path = self.path.split("?", 1)[0]
            if path != "/sql":
                # drain the body first: on an HTTP/1.1 keep-alive
                # connection unread body bytes would be parsed as the
                # start of the NEXT request (stream desync)
                n = int(self.headers.get("Content-Length") or 0)
                if n:
                    self.rfile.read(n)
                self._send_json(404, {"error": "NOT_FOUND",
                                      "message": path})
                return
            try:
                n = int(self.headers.get("Content-Length") or 0)
                req = json.loads(self.rfile.read(n) or b"{}")
                sql = req.get("sql")
                if not sql or not isinstance(sql, str):
                    self._send_json(400, {
                        "error": "BAD_REQUEST",
                        "message": "body must be JSON with a 'sql' "
                                   "string"})
                    return
            except (ValueError, TypeError) as e:
                self._send_json(400, {"error": "BAD_REQUEST",
                                      "message": str(e)[:200]})
                return
            session = str(req.get("session") or "default")
            conf = req.get("conf") or None
            if req.get("mode") == "async":
                try:
                    record = service.submit_async(sql, session, conf)
                except AdmissionError as e:
                    self._send_json(e.http_status, e.to_dict())
                    return
                self._send_json(202, {"query_id": record["id"],
                                      "status": record["status"]})
                return
            try:
                record, table = service.submit(sql, session, conf)
            except AdmissionError as e:
                self._send_json(e.http_status, e.to_dict())
                return
            except PoolExhausted as e:
                self._send_json(429, e.to_dict())
                return
            except (ParseError, AnalysisError) as e:
                self._send_json(400, {
                    "error": "INVALID_SQL",
                    "message": f"{type(e).__name__}: {e}"[:400]})
                return
            except lifecycle.QueryCancelledError as e:
                # the sync request's query was DELETEd mid-flight:
                # structured body, 409 (the request conflicts with an
                # explicit cancel of its own resource)
                self._send_json(409, {
                    "error": "QUERY_CANCELLED",
                    "message": f"{type(e).__name__}: {e}"[:400]})
                return
            except lifecycle.QueryDeadlineError as e:
                self._send_json(504, {
                    "error": "QUERY_DEADLINE_EXCEEDED",
                    "message": f"{type(e).__name__}: {e}"[:400]})
                return
            except UdfError as e:
                # user code raised inside a UDF worker: the query is at
                # fault, not the engine — 400-class, with the worker-
                # captured USER traceback in the structured body
                self._send_json(400, {
                    "error": "UDF_ERROR",
                    "message": f"{type(e).__name__}: {e}"[:400],
                    "traceback": e.worker_traceback})
                return
            except Exception as e:  # noqa: BLE001 — structured surface
                self._send_json(500, {
                    "error": "EXECUTION_ERROR",
                    "message": f"{type(e).__name__}: {e}"[:400]})
                return
            if req.get("format") == "arrow":
                import io
                import pyarrow as pa
                buf = io.BytesIO()
                with pa.ipc.new_stream(buf, table.schema) as w:
                    w.write_table(table)
                body = buf.getvalue()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "application/vnd.apache.arrow.stream")
                self.send_header("Content-Length", str(len(body)))
                self.send_header("X-Query-Id", record["id"])
                self.end_headers()
                self.wfile.write(body)
                return
            self._send_json(200, {
                "query_id": record["id"], "status": record["status"],
                "columns": table.column_names,
                "rows": _table_rows(table),
                "row_count": record.get("row_count"),
                "elapsed_ms": record.get("elapsed_ms")})

    return Handler
