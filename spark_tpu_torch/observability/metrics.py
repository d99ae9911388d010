"""Process metrics registry with JSONL + Prometheus sinks (the port of
`spark_tpu/observability/metrics.py`, which it copies; it also takes
the place of the port's earlier bare counter registry: a session has
one registry).

The MetricsSystem/`metrics.properties` analog, sized to this engine:
one registry of counters/gauges/timers/histograms per session, flushed
to configured sinks at query end by the metrics listener (sinks.py).
Sink selection is conf-driven (`spark_tpu.sql.metrics.sink` =
"jsonl", "prometheus", or both comma-separated;
`spark_tpu.sql.metrics.dir` is the output directory):

- jsonl: one snapshot line appended per flush to `metrics.jsonl`
  (replayable next to the event log);
- prometheus: text exposition format atomically rewritten to
  `metrics.prom` on every flush — point node_exporter's textfile
  collector (or any scraper of files) at the directory.

The series names are the JAX package's (`spark_tpu_<name>`), so one
scraper reads both engines.

`METRIC_PREFIXES` is the registered namespace for per-operator metrics
(`ctx.add_metric`). `ExecContext.add_metric` rejects an unregistered
name, so history summaries can never silently miss columns. The port
emits two names the JAX package does not (the hash join's insert and
probe step counts); their prefixes are registered below, each with the
history consumer that reads it.

The recovery layer (replayed chunks, reused stages), the lifecycle
layer (cancelled and deadlined queries), the prefetcher (stall and
overlap) and the UDF lanes (`UDF_COUNTERS`) count into the same
registry.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import threading
import time
from typing import Dict, List

# ---------------------------------------------------------------------------
# Traced-metric name registry (the SQLMetrics naming discipline)
# ---------------------------------------------------------------------------

#: every ctx.add_metric name must start with one of these. Extending the
#: engine with a new traced metric means adding its prefix HERE (and a
#: history/summary consumer), not just emitting it.
METRIC_PREFIXES = (
    "rows_",           # per-operator output rows (executor replay wrapper)
    "join_rows_",      # join true output-row total (AQE capacity channel)
    "exch_max_",       # exchange max per-(src,dst) bucket count
    "exch_rows_",      # exchange routed live rows
    "exch_bytes_",     # exchange routed payload bytes (shuffle volume)
    "agg_groups",      # aggregate distinct-group counts (+ _<tag> forms)
    "gen_rows_",       # generate/explode output rows
    "rtf_tested_",     # runtime-filter probe rows tested
    "rtf_pruned_",     # runtime-filter probe rows pruned
    "rtf_build_ms_",   # runtime-filter trace-time build cost
    "join_build_ms_",  # hash-join table build cost (trace-time, pmax)
    "join_probe_ms_",  # hash-join probe-program build cost
    "join_table_slots_",  # hash-join open-addressing table capacity
    # the port's hash join (execution/hash_join.py): insert and probe
    # steps of the open-addressing table, per join tag. The JAX package
    # has no counterpart; history.read_event_log flattens them into
    # columns and history.compare_runs diffs them between two logs
    "join_build_steps_",  # hash-join build (insert) steps
    "join_probe_steps_",  # hash-join probe steps
    # per-shard telemetry ([n] arrays: one slot per mesh position, the
    # executor unpacks them into event-log `shards` records; consumer:
    # history.shard_summary / straggler_report)
    "shard_rows_",     # per-shard routed/processed live rows
    "shard_bytes_",    # per-shard routed payload bytes
    # ingest pipeline (PrefetchChunkIterator): REGISTRY counters, not
    # traced per-operator metrics — listed here so the namespace is
    # closed in one place (consumers key on the prefixes)
    "ingest_stall_",   # consumer time blocked waiting on host decode
    "ingest_overlap_",  # host decode time hidden behind device compute
    # straggler detection (observability/straggler.py): REGISTRY
    # counter, listed for namespace closure like the ingest pair
    "straggler_",      # straggler_flagged: shards flagged this process
    # elastic mesh (parallel/elastic.py): REGISTRY counters, listed
    # for namespace closure — gang restarts applied and live rows the
    # straggler rebalancer shifted off flagged shards
    "mesh_restart_",   # mesh_restart_attempts: gang restarts applied
    "rebalance_",      # rebalance_rows: rows shifted off flagged shards
    # durable streaming (streaming.py + execution/state_store.py):
    # REGISTRY counters, listed for namespace closure — micro-batches
    # committed / input rows, incremental state-store bytes (delta vs
    # snapshot), restore wall-clock, quarantined source files and
    # corrupt metadata-log entries skipped
    "streaming_",      # streaming_batches/_rows/_state_delta_bytes/
                       # _state_snapshot_bytes/_restore_ms/
                       # _files_quarantined/_log_corrupt
    # compiled-stage caches (executor + execution/compile_cache.py):
    # REGISTRY counters, listed for namespace closure — in-memory
    # hits/misses plus the persistent cross-process seat's disk
    # hits/misses, deserialize wall-clock, bytes written, corrupt
    # entries recovered from, and warm-start entries installed
    "compile_cache_",  # compile_cache_hits/_misses/_disk_hits/
                       # _disk_misses/_deser_ms/_write_bytes/
                       # _corrupt/_warm_entries
    # query lifecycle control (execution/lifecycle.py + service/):
    # REGISTRY counters, listed for namespace closure — cancelled and
    # deadline-exceeded query totals (counted once per query: at the
    # executor when the engine saw the query, at the service when it
    # was cancelled out of the admission queue before executing) and
    # per-session quota rejections (admission maxConcurrent bound +
    # arbiter hbmShare lease denials)
    "query_cancelled",       # queries stopped by cancel()/DELETE
    "query_deadline_",       # query_deadline_exceeded: blown budgets
    "session_quota_",        # session_quota_rejections
    # out-of-process python UDF lane (udf_worker/ +
    # execution/python_eval.py worker mode): REGISTRY counters, listed
    # for namespace closure — batches/rows streamed through the pool,
    # cumulative in-worker wall-clock, workers killed+replaced after a
    # crash/timeout, and spawn+handshake wall-clock
    "udf_",            # udf_batches/udf_rows/udf_exec_ms/
                       # udf_worker_restarts/udf_worker_spawn_ms
    # serving fleet (service/fleet.py): REGISTRY counters/gauges on
    # the SUPERVISOR's registry, listed for namespace closure —
    # worker spawns/restarts/losses, quarantines, proxied and shed
    # requests, transparent read failovers, drains, death bundles
    "fleet_",          # fleet_workers_ready/fleet_spawns/
                       # fleet_restarts/fleet_worker_lost/
                       # fleet_quarantined/fleet_requests_proxied/
                       # fleet_requests_shed/fleet_failovers/
                       # fleet_drains/fleet_bundles
    # engine status store (observability/status_store.py + the metrics
    # sink listener): REGISTRY histograms/counters/gauges, listed for
    # namespace closure — end-to-end and per-phase latency
    # distributions, heartbeat samples, queries in flight
    "status_",         # status_latency_ms (e2e histogram)/
                       # status_phase_ms_<phase>/status_class_ms_<cls>/
                       # status_heartbeats/status_queries_inflight
    # SLO burn tracking against spark_tpu.service.slo.latencyMs:
    # REGISTRY counters a fleet router sheds on
    "slo_",            # slo_queries_total/slo_burned_total/
                       # slo_burn_ms_total
    # flight recorder (observability/flight_recorder.py): REGISTRY
    # counters, listed for namespace closure
    "flightrec_",      # flightrec_bundles: diagnostic bundles dumped
)


#: the UDF lanes' counters (execution/python_eval.py,
#: udf_worker/pool.py); the session creates them at start, so a reader
#: sees 0 before the first UDF runs
UDF_COUNTERS = ("udf_batches", "udf_rows", "udf_exec_ms",
                "udf_worker_spawn_ms", "udf_worker_restarts")


def is_registered_metric(name: str) -> bool:
    return name.startswith(METRIC_PREFIXES)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

class Counter:
    """Monotonic counter. `inc` is lock-guarded: under the concurrent
    SQL service, multiple query threads increment the same (shared-
    registry) counters, and `value += n` is a read-modify-write that
    loses updates un-locked."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n=1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def set(self, v) -> None:
        self.value = v  # single attribute store: atomic under the GIL


class Timer:
    __slots__ = ("count", "total_s", "min_s", "max_s", "_lock")

    def __init__(self):
        self.count = 0
        self.total_s = 0.0
        self.min_s = float("inf")
        self.max_s = 0.0
        self._lock = threading.Lock()

    def observe(self, seconds: float) -> None:
        with self._lock:
            self.count += 1
            self.total_s += seconds
            self.min_s = min(self.min_s, seconds)
            self.max_s = max(self.max_s, seconds)


class Histogram:
    """Log-bucketed value distribution (the latency-SLO metric type).

    Fixed power-of-two bucket boundaries (0.25 ms .. ~17.5 min for the
    default ms domain) so two processes' histograms are always
    mergeable and the Prometheus exposition is stable. `observe` is a
    bisect + one lock-guarded increment — cheap enough for every query
    end under the concurrent service. Quantiles interpolate linearly
    inside the landing bucket (the classic log-histogram estimate),
    clamped by the observed min/max so tiny-count histograms don't
    report a bucket bound nobody measured."""

    __slots__ = ("bounds", "counts", "count", "total", "min_v", "max_v",
                 "_lock")

    #: upper bounds, 2^-2 .. 2^20 — in ms: 0.25ms up to ~17.5 minutes
    DEFAULT_BOUNDS = tuple(2.0 ** i for i in range(-2, 21))

    def __init__(self):
        self.bounds = self.DEFAULT_BOUNDS
        #: one slot per bound + the overflow bucket
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.min_v = float("inf")
        self.max_v = 0.0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        i = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.total += value
            if value < self.min_v:
                self.min_v = value
            if value > self.max_v:
                self.max_v = value

    def _quantile_locked(self, q: float) -> float:
        if self.count == 0:
            return 0.0
        target = q * self.count
        cum = 0
        for i, n in enumerate(self.counts):
            if n == 0:
                continue
            if cum + n >= target:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) \
                    else self.max_v
                frac = (target - cum) / n
                est = lo + (hi - lo) * frac
                return min(max(est, self.min_v), self.max_v)
            cum += n
        return self.max_v

    def quantile(self, q: float) -> float:
        with self._lock:
            return self._quantile_locked(q)

    def percentiles(self) -> Dict[str, float]:
        """{p50, p95, p99} in one lock acquisition (the /status shape)."""
        with self._lock:
            return {"p50": round(self._quantile_locked(0.50), 3),
                    "p95": round(self._quantile_locked(0.95), 3),
                    "p99": round(self._quantile_locked(0.99), 3)}

    def snapshot(self) -> Dict:
        with self._lock:
            return {"count": self.count,
                    "sum": round(self.total, 6),
                    "min": round(self.min_v, 6) if self.count else 0.0,
                    "max": round(self.max_v, 6),
                    "bounds": list(self.bounds),
                    "counts": list(self.counts)}


class MetricsRegistry:
    """Named counters/gauges/timers/histograms, created on first use."""

    def __init__(self):
        self._lock = threading.Lock()
        #: serializes sink writes (concurrent query-end flushes from
        #: service worker threads must not interleave JSONL lines)
        self._flush_lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._timers: Dict[str, Timer] = {}
        self._histograms: Dict[str, Histogram] = {}

    def _get(self, store, name, cls):
        with self._lock:
            m = store.get(name)
            if m is None:
                m = store[name] = cls()
            return m

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, name, Gauge)

    def timer(self, name: str) -> Timer:
        return self._get(self._timers, name, Timer)

    def histogram(self, name: str) -> Histogram:
        return self._get(self._histograms, name, Histogram)

    def histogram_names(self) -> List[str]:
        with self._lock:
            return sorted(self._histograms)

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "counters": {k: c.value for k, c in self._counters.items()},
                "gauges": {k: g.value for k, g in self._gauges.items()},
                "timers": {k: {"count": t.count,
                               "total_s": round(t.total_s, 6),
                               "min_s": (round(t.min_s, 6)
                                         if t.count else 0.0),
                               "max_s": round(t.max_s, 6)}
                           for k, t in self._timers.items()},
                "histograms": {k: h.snapshot()
                               for k, h in self._histograms.items()},
            }

    # -- sinks --------------------------------------------------------------

    SINK_KEY = "spark_tpu.sql.metrics.sink"
    DIR_KEY = "spark_tpu.sql.metrics.dir"

    def flush(self, conf) -> None:
        """Write every configured sink; a sink failing warns, never
        raises (observability must not fail the query)."""
        sinks = [s.strip() for s in
                 str(conf.get(self.SINK_KEY) or "").split(",") if s.strip()]
        if not sinks:
            return
        out_dir = str(conf.get(self.DIR_KEY))
        snap = self.snapshot()
        try:
            with self._flush_lock:
                os.makedirs(out_dir, exist_ok=True)
                rank = rank_suffix(conf)
                if "jsonl" in sinks:
                    line = json.dumps(dict(snap, ts=time.time()))
                    with open(os.path.join(out_dir, f"metrics{rank}.jsonl"),
                              "a") as f:
                        f.write(line + "\n")
                if "prometheus" in sinks:
                    write_prometheus(os.path.join(
                        out_dir, f"metrics{rank}.prom"), snap)
        except OSError as e:
            import warnings
            warnings.warn(f"metrics sink write failed: {e}")


def rank_suffix(conf) -> str:
    """"-r<rank>" in the name of every file an engine process of a
    cluster writes to a directory its peers share (the event log, the
    traces, the metrics sinks), so that no process's file is another's;
    "" outside a cluster."""
    if not str(conf.get("spark_tpu.sql.cluster.coordinator") or ""):
        return ""
    return f"-r{int(conf.get('spark_tpu.sql.cluster.processId'))}"


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return "spark_tpu_" + _PROM_BAD.sub("_", name)


def prometheus_text(snapshot: Dict) -> str:
    """Render a registry snapshot as Prometheus text exposition format
    0.0.4 (shared by the textfile sink below and the SQL service's
    live `GET /metrics` endpoint)."""
    lines = []
    for name, v in sorted(snapshot.get("counters", {}).items()):
        p = _prom_name(name)
        lines += [f"# TYPE {p} counter", f"{p} {v}"]
    for name, v in sorted(snapshot.get("gauges", {}).items()):
        p = _prom_name(name)
        lines += [f"# TYPE {p} gauge", f"{p} {v}"]
    for name, t in sorted(snapshot.get("timers", {}).items()):
        p = _prom_name(name)
        # legacy pair kept for existing scrapers, plus the native
        # summary form (`_sum`/`_count`) the round-trip contract names
        lines += [f"# TYPE {p}_count counter", f"{p}_count {t['count']}",
                  f"# TYPE {p}_seconds_total counter",
                  f"{p}_seconds_total {t['total_s']}",
                  f"# TYPE {p}_seconds summary",
                  f"{p}_seconds_sum {t['total_s']}",
                  f"{p}_seconds_count {t['count']}"]
    for name, h in sorted(snapshot.get("histograms", {}).items()):
        p = _prom_name(name)
        lines.append(f"# TYPE {p} histogram")
        cum = 0
        for le, n in zip(h["bounds"], h["counts"]):
            cum += n
            lines.append(f'{p}_bucket{{le="{le:g}"}} {cum}')
        cum += h["counts"][-1]
        lines += [f'{p}_bucket{{le="+Inf"}} {cum}',
                  f"{p}_sum {h['sum']}", f"{p}_count {h['count']}"]
    return "\n".join(lines) + "\n"


def write_prometheus(path: str, snapshot: Dict) -> None:
    """Atomic rewrite in Prometheus text exposition format 0.0.4."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(prometheus_text(snapshot))
    os.replace(tmp, path)


#: one exposition sample: `name value` or `name{label="v",...} value`
#: (the labeled form is what histogram `_bucket{le="..."}` series use)
_PROM_SAMPLE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'((?:\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"'
    r'(?:,[a-zA-Z_][a-zA-Z0-9_]*="[^"]*")*\})?)'
    r'\s+(\S+)$')


def parse_prometheus_text(text: str) -> Dict[str, float]:
    """Scrape-parse text exposition back to {series: value} (tests and
    the preflight smokes prove the output is consumable this way).
    Labeled samples keep their label set in the key — a histogram
    bucket round-trips as e.g. `spark_tpu_status_latency_ms_bucket`
    `{le="4"}`; unlabeled series keep the bare name, so every consumer
    written against the counter/gauge/timer output keeps working."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _PROM_SAMPLE.match(line)
        if not m:
            raise ValueError(f"unparseable exposition line: {line!r}")
        name, labels, value = m.groups()
        try:
            out[name + labels] = float(value)
        except ValueError:
            raise ValueError(
                f"non-numeric sample value in line: {line!r}")
    return out


def parse_prometheus(path: str) -> Dict[str, float]:
    """`parse_prometheus_text` over a textfile-sink file."""
    with open(path) as f:
        return parse_prometheus_text(f.read())
