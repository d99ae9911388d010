"""Engine status store: live health behind `GET /status` (the port of
`spark_tpu/observability/status_store.py`; the SQL service serves it,
`service/server.py`, and a session can run one standalone).

The `AppStatusStore` seat (reference: `AppStatusListener` folding the
event stream into a kvstore served by `status/api/v1`, sampled by the
driver's `Heartbeater`), sized to this engine: one process-level
`StatusStore` fed two ways —

- **listener-bus feeds** (`bind(session, label)`): a tiny per-session
  subscriber counts queries in flight and folds every query end into
  per-status outcome counts, per-phase cumulative seconds and
  per-session attribution (the AppStatusListener half);
- **a heartbeat thread** (`start()`/`stop()`, the `Heartbeater`
  analog): every `spark_tpu.sql.status.heartbeatMs` it samples the
  wired providers (admission queue depth, arbiter device-memory lease occupancy,
  session-pool size, UDF pool size), derives cache hit rates from the
  shared metrics registry, reads streaming trigger lag, and appends
  each value into a fixed-capacity ring time-series
  (`spark_tpu.sql.status.ringSize` points per series) served by
  `GET /status/timeseries`.

Latency distributions are NOT kept here: the metrics sink listener
(sinks.py) records them into the registry's `status_latency_ms` /
`status_phase_ms_<phase>` / `status_class_ms_<class>` histograms
(metrics.Histogram), and `snapshot()` reads p50/p95/p99 back out — so
standalone sessions and the pooled service share one distribution and
one Prometheus exposition.

Offline, the same health summary is replayable from the event log via
`history.status_summary` (no live process required).

Locking: `_lock` ("obs.status", rank 45) guards the rings and the
fold-in counters only. Providers, registry reads and listener posts
all run OUTSIDE it — providers take service-layer locks (admission cv,
arbiter cv, pool lock) that rank BELOW this one.
"""

from __future__ import annotations

import threading
import time
import warnings
from collections import deque
from typing import Callable, Dict, List, Optional

from .listener import QueryEndEvent, QueryListener, QueryStartEvent

ENABLED_KEY = "spark_tpu.sql.status.enabled"
HEARTBEAT_KEY = "spark_tpu.sql.status.heartbeatMs"
RING_KEY = "spark_tpu.sql.status.ringSize"
SLO_KEY = "spark_tpu.service.slo.latencyMs"

#: terminal query statuses folded into outcome counts (anything else
#: lands under "other" so a new status can never be silently dropped)
STATUSES = ("ok", "error", "cancelled", "deadline_exceeded")

#: (hits metric, misses metric, series name) pairs the heartbeat
#: derives rolling hit rates from — counters first, gauges as fallback
_HIT_RATES = (
    ("compile_cache_hits", "compile_cache_misses",
     "compile_cache_hit_rate"),
    ("compile_cache_disk_hits", "compile_cache_disk_misses",
     "compile_cache_disk_hit_rate"),
    ("device_cache_hits", "device_cache_misses",
     "device_cache_hit_rate"),
    ("service_result_cache_hits", "service_result_cache_misses",
     "result_cache_hit_rate"),
)


class _SessionFeed(QueryListener):
    """Per-session bus subscriber: attributes lifecycle events to the
    store under the session's label. Registered by `bind()`; checks
    nothing itself — the store gates on conf at event time."""

    def __init__(self, store: "StatusStore", label: str):
        self._store = store
        self._label = label

    def on_query_start(self, event: QueryStartEvent) -> None:
        self._store._on_start(self._label, event)

    def on_query_end(self, event: QueryEndEvent) -> None:
        self._store._on_end(self._label, event)


class StatusStore:
    """Bounded, typed rolling store of engine health. Providers are
    callables returning flat(ish) stats dicts; every numeric leaf is
    sampled into its own ring series as `<provider>_<key>`."""

    def __init__(self, conf, metrics,
                 providers: Optional[Dict[str, Callable]] = None):
        self._conf = conf
        self._metrics = metrics
        self._providers: Dict[str, Callable] = dict(providers or {})
        self._lock = threading.Lock()
        self._ring_cap = max(2, int(conf.get(RING_KEY)))
        #: series name -> deque[(ts, value)] (fixed capacity)
        self._series: Dict[str, deque] = {}
        #: session label -> queries currently in flight (nested
        #: subquery executions start/end in pairs, so they balance)
        self._inflight: Dict[str, int] = {}
        #: session label -> outcome attribution
        self._sessions: Dict[str, Dict] = {}
        #: terminal status -> count, across every bound session
        self._status_counts: Dict[str, int] = {}
        #: phase name -> cumulative seconds (the per-phase outcome view)
        self._phase_totals: Dict[str, float] = {}
        self._queries_total = 0
        self._heartbeats = 0
        self._started_ts = time.time()
        self._stop_event = threading.Event()
        #: heartbeat thread handle; written by the owning control
        #: thread in start()/stop() only (guarded-by waiver)
        self._thread: Optional[threading.Thread] = None

    # -- wiring -------------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return bool(self._conf.get(ENABLED_KEY))

    def add_provider(self, name: str, fn: Callable) -> None:
        with self._lock:
            self._providers[name] = fn

    def bind(self, session, label: str) -> _SessionFeed:
        """Subscribe a per-session feed on `session`'s bus, attributed
        to `label`. Returns the feed (tests unregister it)."""
        with self._lock:
            self._sessions.setdefault(
                label, {"queries": 0, "last_ts": None})
            self._inflight.setdefault(label, 0)
        feed = _SessionFeed(self, label)
        session.add_listener(feed)
        return feed

    # -- listener fold-in ---------------------------------------------------

    def _on_start(self, label: str, event: QueryStartEvent) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._inflight[label] = self._inflight.get(label, 0) + 1
            total = sum(self._inflight.values())
        self._metrics.gauge("status_queries_inflight").set(total)

    def _on_end(self, label: str, event: QueryEndEvent) -> None:
        if not self.enabled:
            return
        status = event.status if event.status in STATUSES else "other"
        phases = (event.event or {}).get("phase_times_s") or {}
        with self._lock:
            n = self._inflight.get(label, 0)
            self._inflight[label] = max(0, n - 1)
            total = sum(self._inflight.values())
            self._queries_total += 1
            self._status_counts[status] = \
                self._status_counts.get(status, 0) + 1
            sess = self._sessions.setdefault(
                label, {"queries": 0, "last_ts": None})
            sess["queries"] = int(sess.get("queries", 0)) + 1
            sess[status] = int(sess.get(status, 0)) + 1
            sess["last_ts"] = event.ts
            for phase, s in phases.items():
                try:
                    self._phase_totals[phase] = \
                        self._phase_totals.get(phase, 0.0) + float(s)
                except (TypeError, ValueError):
                    continue
        self._metrics.gauge("status_queries_inflight").set(total)

    # -- heartbeat ----------------------------------------------------------

    def start(self) -> None:
        """Spawn the heartbeat thread (no-op when disabled or already
        running). The thread is named so lockwatch's no-thread-leak
        assertion can find a leaked one by prefix."""
        if self._thread is not None or not self.enabled:
            return
        self._stop_event.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name="spark-tpu-status-heartbeat")
        self._thread.start()

    def stop(self) -> None:
        """Stop and JOIN the heartbeat thread (bounded): stop() must
        leave no thread behind."""
        self._stop_event.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10)
        self._thread = None

    def _run(self) -> None:
        period = max(0.01, float(self._conf.get(HEARTBEAT_KEY)) / 1e3)
        while not self._stop_event.wait(period):
            try:
                self.sample()
            except Exception as e:  # noqa: BLE001 — heartbeat survives
                warnings.warn(f"status heartbeat sample failed: {e}")
            # re-read the period each tick: heartbeatMs is
            # runtime-settable like every conf (the sinks idiom)
            period = max(0.01,
                         float(self._conf.get(HEARTBEAT_KEY)) / 1e3)

    def sample(self) -> Dict[str, float]:
        """One heartbeat: gather every numeric observable OUTSIDE the
        store lock (providers take service-layer locks), then append
        the whole tick into the rings under ONE lock acquisition.
        Public so tests and embedded callers can tick deterministically
        without the thread."""
        ts = time.time()
        vals: Dict[str, float] = {}
        with self._lock:
            providers = list(self._providers.items())
        for pname, fn in providers:
            try:
                stats = fn() or {}
            except Exception:  # noqa: BLE001 — a provider never kills
                continue      # the heartbeat
            for k, v in stats.items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                vals[f"{pname}_{k}"] = float(v)
        snap = self._metrics.snapshot()
        counters = snap.get("counters", {})
        gauges = snap.get("gauges", {})
        for hit_k, miss_k, series in _HIT_RATES:
            hits = counters.get(hit_k, gauges.get(hit_k))
            misses = counters.get(miss_k, gauges.get(miss_k))
            if hits is None and misses is None:
                continue
            total = float(hits or 0) + float(misses or 0)
            if total > 0:
                vals[series] = round(float(hits or 0) / total, 4)
        vals.update(self._streaming_lag())
        with self._lock:
            vals["queries_inflight"] = float(
                sum(self._inflight.values()))
            vals["queries_total"] = float(self._queries_total)
            for name, v in vals.items():
                ring = self._series.get(name)
                if ring is None:
                    ring = self._series[name] = deque(
                        maxlen=self._ring_cap)
                ring.append((ts, v))
            self._heartbeats += 1
        self._metrics.counter("status_heartbeats").inc()
        return vals

    @staticmethod
    def _streaming_lag() -> Dict[str, float]:
        """Live streaming health: trigger-loop count and the worst
        last-tick wall-clock skew (the batch-lag signal of the
        supervised trigger loop)."""
        try:
            from ..streaming import live_queries
            rows = live_queries()
        except Exception:  # noqa: BLE001 — best-effort observable
            return {}
        out = {"streams_live": float(len(rows))}
        skews = [float(r["last_skew_ms"]) for r in rows
                 if isinstance(r.get("last_skew_ms"), (int, float))]
        if skews:
            out["streams_max_skew_ms"] = round(max(skews), 3)
        return out

    # -- serving ------------------------------------------------------------

    def _latency(self) -> Dict:
        """p50/p95/p99 views over the registry's status histograms
        (fed by the metrics sink listener at every query end)."""
        e2e = self._metrics.histogram("status_latency_ms")
        out = {"e2e_ms": dict(e2e.percentiles(),
                              count=e2e.snapshot()["count"]),
               "phases_ms": {}, "classes_ms": {}}
        for name in self._metrics.histogram_names():
            if name.startswith("status_phase_ms_"):
                out["phases_ms"][name[len("status_phase_ms_"):]] = \
                    self._metrics.histogram(name).percentiles()
            elif name.startswith("status_class_ms_"):
                out["classes_ms"][name[len("status_class_ms_"):]] = \
                    self._metrics.histogram(name).percentiles()
        return out

    def _slo(self) -> Dict:
        snap = self._metrics.snapshot().get("counters", {})
        target = float(self._conf.get(SLO_KEY) or 0)
        queries = int(snap.get("slo_queries_total", 0))
        burned = int(snap.get("slo_burned_total", 0))
        return {"target_ms": target,
                "queries": queries,
                "burned": burned,
                "burn_ms": int(snap.get("slo_burn_ms_total", 0)),
                "burn_rate": (round(burned / queries, 4)
                              if queries else 0.0)}

    def snapshot(self) -> Dict:
        """The `GET /status` payload: live health, one dict."""
        providers_live: Dict[str, Dict] = {}
        with self._lock:
            providers = list(self._providers.items())
        for pname, fn in providers:
            try:
                providers_live[pname] = fn() or {}
            except Exception as e:  # noqa: BLE001 — partial > nothing
                providers_live[pname] = {"error": str(e)[:120]}
        latency = self._latency()
        slo = self._slo()
        with self._lock:
            return {
                "enabled": self.enabled,
                "uptime_s": round(time.time() - self._started_ts, 1),
                "heartbeats": self._heartbeats,
                "heartbeat_ms": float(self._conf.get(HEARTBEAT_KEY)),
                "ring_capacity": self._ring_cap,
                "queries_inflight": dict(self._inflight),
                "queries_inflight_total": sum(self._inflight.values()),
                "queries_total": self._queries_total,
                "statuses": dict(self._status_counts),
                "phase_seconds": {k: round(v, 4) for k, v in
                                  sorted(self._phase_totals.items())},
                "sessions": {k: dict(v) for k, v in
                             sorted(self._sessions.items())},
                "latency": latency,
                "slo": slo,
                "providers": providers_live,
            }

    def timeseries(self, names: Optional[List[str]] = None,
                   limit: Optional[int] = None) -> Dict:
        """The `GET /status/timeseries` payload: ring contents per
        series as [ts, value] pairs (newest last), optionally filtered
        to `names` and trimmed to the last `limit` points."""
        with self._lock:
            data = {k: list(d) for k, d in sorted(self._series.items())
                    if names is None or k in names}
            cap = self._ring_cap
            beats = self._heartbeats
        if limit is not None:
            limit = max(1, int(limit))
            data = {k: pts[-limit:] for k, pts in data.items()}
        return {"ring_capacity": cap,
                "heartbeats": beats,
                "series": {k: [[round(ts, 3), v] for ts, v in pts]
                           for k, pts in data.items()}}
