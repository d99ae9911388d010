"""THE declarative concurrency registry of the port: locks, guards,
waivers (the port of `spark_tpu/analysis/concurrency/registry.py`).

One table of record for the port's thread-shared state, mirroring
`testing.faults.KNOWN_SITES` for chaos seams: the guarded-by and
lock-order passes check the DECLARATIONS here against the CODE three
ways (declaration <-> lock object <-> use sites), and the runtime
lockwatch (`testing/lockwatch.py`) asserts observed acquisition order
against the same ranks.

Thread roots (what makes state here "shared"):

- user threads running queries on one session (the executor registers
  cancel tokens, counts launches, posts on the session's bus);
- the mesh's shard threads (`parallel/mesh.run_on_shards`), one per
  shard, which launch kernels, copy between cards and post per-shard
  telemetry; on a mesh that spans processes the shard thread that
  completes a local rendezvous makes the cross-process call
  (`parallel/cluster.py`) for all of them;
- a cluster process's heartbeat thread (`parallel/cluster.py`), which
  writes only to its own store client;
- the ingest-prefetch daemon (`io/sources.PrefetchChunkIterator`),
  which fires fault seams and counts registry metrics;
- the SQL service's request threads (`service/server.py`: one per HTTP
  connection, one per async submission), each running its query on a
  pooled session under that session's lease;
- a supervised streaming query's trigger thread (`streaming.py`);
- the status store's heartbeat thread;
- the listener bus delivering to the event-log / metrics / straggler /
  flight-recorder subscribers (synchronously, on whichever thread
  posts).

RANKS define the canonical acquisition order: a thread holding a lock
may only acquire locks of STRICTLY HIGHER rank. A lock that is the JAX
package's keeps that package's id and rank; a lock of the port's own
takes a new id and a rank of its own (`dense_groupby`'s build and
launch locks, the mesh's copy counters and shard-error list, the
session's query-id counter). The SQL service's and the fleet's locks
(`service.*`) are the JAX package's. To register a new lock: create it,
add a LockDecl with a rank consistent with every nesting it takes part in, declare the
attributes it guards (GuardDecl) or waive them with a reason, and -- if
it can nest with other locks in code the static extractor cannot
resolve -- add the edge to EXTRA_EDGES with a comment. The guarded-by
pass fails until all three are done.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class LockDecl:
    """One registered lock: where it lives, what it is, and its rank
    in the canonical acquisition order (lower = acquired first)."""

    lock_id: str
    relpath: str
    cls: str            # "" = module-level global (or a function local)
    attr: str
    kind: str           # "lock" | "rlock" | "condition"
    rank: int
    doc: str = ""


@dataclass(frozen=True)
class GuardDecl:
    """One shared mutable attribute and the lock that guards it (the
    lock attr must be a LockDecl on the same class/module)."""

    relpath: str
    cls: str            # "" = module-level global name in `attr`
    attr: str
    lock: str           # lock ATTRIBUTE name (e.g. "_lock"), not id


@dataclass(frozen=True)
class Waiver:
    """An intentionally-unguarded write site, with the reason the race
    is benign. Printed in the lint's notes."""

    relpath: str
    cls: str
    attr: str
    reason: str


@dataclass(frozen=True)
class ConfinedDecl:
    """A class in a shared module whose instances never cross threads
    (ContextVar-installed / single-consumer): write checks skipped."""

    relpath: str
    cls: str
    reason: str


_PKG = "spark_tpu_torch/"
_OBS = _PKG + "observability/"
_EXE = _PKG + "execution/"
_SVC = _PKG + "service/"

#: every threading.Lock/RLock/Condition in spark_tpu_torch/ must appear
#: here (the guarded-by pass fails both on an unregistered lock object
#: and on a stale declaration). Ranks: see the module docstring.
LOCKS: Tuple[LockDecl, ...] = (
    LockDecl("service.stop", _SVC + "server.py", "SqlService",
             "_stop_lock", "lock", 8,
             "serializes start() and stop() (idempotent, signal-safe) "
             "and guards the _stopped/_draining flags; ranked below "
             "everything they set up and tear down (both nest "
             "service.install inside)"),
    LockDecl("service.session", _SVC + "pool.py", "_Entry", "lock",
             "lock", 10,
             "per-session execution lease; held across the whole query "
             "(outermost -- everything below may nest inside it)"),
    LockDecl("service.fleet_inflight", _SVC + "fleet.py",
             "FleetSupervisor", "_cv", "condition", 12,
             "router in-flight proxied-request count + drain flag "
             "(cv: drain waits here for in-flight to reach zero); "
             "counter/flag ops only inside -- proxy I/O, routing and "
             "metrics run OUTSIDE it"),
    LockDecl("service.fleet_worker", _SVC + "fleet.py", "_Worker",
             "_lock", "lock", 13,
             "per-worker lifecycle slice (state/port/proc/generation/"
             "restart bookkeeping), the streaming _TriggerStatus "
             "pattern: field ops only inside -- spawn I/O, health "
             "probes, bundle dumps and metrics all run OUTSIDE it"),
    LockDecl("service.pool", _SVC + "pool.py", "SessionPool", "_lock",
             "lock", 14, "session-pool entry map"),
    LockDecl("service.quota", _SVC + "admission.py", "SessionQuota",
             "_lock", "lock", 16,
             "per-session in-flight quota counters; check-and-inc "
             "only, rejection bookkeeping runs outside it"),
    LockDecl("service.admission", _SVC + "admission.py",
             "AdmissionController", "_cv", "condition", 18,
             "execution-slot gate (cv: queued requests wait here)"),
    LockDecl("service.records", _SVC + "server.py", "SqlService",
             "_records_lock", "lock", 22, "service query registry"),
    LockDecl("service.async", _SVC + "server.py", "SqlService",
             "_async_lock", "lock", 23, "async in-flight bound"),
    LockDecl("service.install", _SVC + "server.py", "SqlService",
             "_install_lock", "lock", 24,
             "one-shot arbiter installation guard"),
    LockDecl("streaming.live", _PKG + "streaming.py", "", "_LIVE_LOCK",
             "lock", 25,
             "live trigger-loop registry (stream-<n> -> query): "
             "registered in start(), dropped by the loop's finally / "
             "stop(); dict ops only inside"),
    LockDecl("execution.lifecycle", _EXE + "lifecycle.py", "",
             "_TOKENS_LOCK", "lock", 26,
             "cancel-token registry ((app_id, query_id) -> token): "
             "registered by the executor, cancelled from any thread; "
             "dict ops only inside -- token.cancel() (an Event.set) "
             "runs outside it"),
    LockDecl("streaming.trigger", _PKG + "streaming.py", "_TriggerStatus",
             "_lock", "lock", 27,
             "cross-thread status slice of a supervised streaming query "
             "(loop thread writes, stop() and the live listing read); "
             "field ops only inside -- seams, metrics and listener "
             "posts all fire OUTSIDE it"),
    LockDecl("service.arbiter", _SVC + "arbiter.py",
             "DeviceResourceArbiter", "_cv", "condition", 30,
             "device-memory lease pool (cv: denied leases wait for "
             "releases)"),
    LockDecl("service.result_cache", _PKG + "result_cache.py",
             "ResultCache", "_lock", "lock", 34,
             "plan-fingerprint result LRU (a standalone session's, or "
             "the one the service's pooled sessions share); counters "
             "inc outside it"),
    LockDecl("service.history", _SVC + "query_history.py",
             "QueryHistoryStore", "_lock", "lock", 36,
             "per-query detail store"),
    LockDecl("io.device_cache", _PKG + "io/device_cache.py",
             "DeviceTableCache", "_lock", "rlock", 40,
             "device table cache (rlock: eviction inside a load may "
             "reenter)"),
    LockDecl("obs.straggler", _OBS + "straggler.py", "StragglerMonitor",
             "_lock", "lock", 44, "rolling per-shard wait windows"),
    LockDecl("obs.status", _OBS + "status_store.py", "StatusStore",
             "_lock", "lock", 45,
             "status-store rings + session attribution; providers and "
             "metrics calls run OUTSIDE it, so only dict/deque ops sit "
             "inside"),
    LockDecl("obs.flightrec", _OBS + "flight_recorder.py",
             "FlightRecorder", "_lock", "lock", 46,
             "flight-recorder rings + retained plan/span maps; dump "
             "file I/O and conf/metrics snapshots run OUTSIDE it over "
             "copies"),
    LockDecl("obs.bus", _OBS + "listener.py", "ListenerBus", "_lock",
             "lock", 48,
             "listener list + drop counter (delivery runs OUTSIDE it)"),
    LockDecl("obs.event_log", _OBS + "sinks.py", "EventLogListener",
             "_write_lock", "lock", 52, "event-log roll+append"),
    LockDecl("faults.plan", _PKG + "testing/faults.py", "FaultPlan",
             "_lock", "lock", 56,
             "hit counters (fault effects run OUTSIDE it)"),
    LockDecl("udf.pool", _PKG + "udf_worker/pool.py", "UdfWorkerPool",
             "_cv", "condition", 59,
             "UDF worker checkout/checkin (cv: checkouts beyond "
             "maxWorkers wait for a checkin); list/counter ops only "
             "inside -- spawns, kills, chaos seams and lifecycle "
             "checkpoints all run OUTSIDE it"),
    LockDecl("metrics.registry", _OBS + "metrics.py", "MetricsRegistry",
             "_lock", "lock", 60, "metric instrument map"),
    LockDecl("metrics.flush", _OBS + "metrics.py", "MetricsRegistry",
             "_flush_lock", "lock", 62, "sink write serialization"),
    LockDecl("dense_groupby.build", _EXE + "dense_groupby.py", "",
             "_lib_lock", "lock", 64,
             "port-only: the one nvcc build and ctypes load of "
             "csrc/dense_groupby.cu per process; the build's subprocess "
             "runs inside it and nothing else is taken under it"),
    LockDecl("dense_groupby.launch", _EXE + "dense_groupby.py", "",
             "_LAUNCH_LOCK", "lock", 66,
             "port-only: the launch counters and each launch call (the "
             "shared-memory attribute dense_sums_smem sets is per "
             "device, and the mesh's shards launch from their own "
             "threads); a leaf"),
    LockDecl("config.registry", _PKG + "config.py", "",
             "_REGISTRY_LOCK", "lock", 70, "conf-entry registration"),
    LockDecl("metrics.counter", _OBS + "metrics.py", "Counter", "_lock",
             "lock", 80, "per-counter read-modify-write (leaf)"),
    LockDecl("metrics.timer", _OBS + "metrics.py", "Timer", "_lock",
             "lock", 81, "per-timer observation (leaf)"),
    LockDecl("metrics.histogram", _OBS + "metrics.py", "Histogram",
             "_lock", "lock", 82,
             "per-histogram bucket counters (leaf; bucket index is "
             "computed before acquiring it)"),
    LockDecl("session.query_seq", _PKG + "session.py", "SparkTpuSession",
             "_query_seq_lock", "lock", 83,
             "port-only: the session's query-id counter (queries start "
             "on user threads and the trigger thread at once); a leaf"),
    LockDecl("mesh.copy_stats", _PKG + "parallel/mesh.py", "",
             "_COPY_LOCK", "lock", 84,
             "port-only: COPY_STATS, the bytes the collectives copied "
             "between cards, added to from every shard thread; a leaf"),
    LockDecl("mesh.shard_errors", _PKG + "parallel/mesh.py", "", "lock",
             "lock", 85,
             "port-only: run_on_shards' per-run error list (a function "
             "local, one per mesh run), appended to by a failing shard "
             "thread before it aborts the group's barrier; a leaf"),
    LockDecl("cluster.run", _PKG + "parallel/cluster.py", "Cluster",
             "run_lock", "rlock", 28,
             "port-only: one execution at a time of this process uses "
             "the cluster's process groups (Executor._execute_batch, "
             "from get_mesh to the last agreement), so its collectives "
             "keep the order every peer process keeps; held by the "
             "query's thread across the execution (re-entered by a "
             "scalar subquery or cached subtree run inside it), while "
             "the shard threads take their own locks"),
    LockDecl("cluster.init", _PKG + "parallel/cluster.py", "",
             "_INIT_LOCK", "lock", 86,
             "port-only: the process's one init_process_group call and "
             "_CLUSTER; a leaf"),
    LockDecl("cluster.stats", _PKG + "parallel/cluster.py", "",
             "_STATS_LOCK", "lock", 87,
             "port-only: CLUSTER_STATS, the bytes that crossed processes, "
             "added to by the shard thread that makes a collective; a "
             "leaf"),
    LockDecl("testing.lockwatch", _PKG + "testing/lockwatch.py",
             "LockWatch", "_mu", "lock", 95,
             "lockwatch's own recorder lock: acquired inside every "
             "watched acquire, so it ranks above everything and is "
             "never itself wrapped"),
)

#: shared mutable attribute -> its guarding lock. Every write site
#: outside __init__ must sit inside `with self.<lock>` (guarded-by
#: pass); every lock-owning class must cover ALL its mutated attrs
#: here or in WAIVERS.
GUARDED_BY: Tuple[GuardDecl, ...] = (
    # metrics
    GuardDecl(_OBS + "metrics.py", "Counter", "value", "_lock"),
    GuardDecl(_OBS + "metrics.py", "Timer", "count", "_lock"),
    GuardDecl(_OBS + "metrics.py", "Timer", "total_s", "_lock"),
    GuardDecl(_OBS + "metrics.py", "Timer", "min_s", "_lock"),
    GuardDecl(_OBS + "metrics.py", "Timer", "max_s", "_lock"),
    GuardDecl(_OBS + "metrics.py", "MetricsRegistry", "_counters",
              "_lock"),
    GuardDecl(_OBS + "metrics.py", "MetricsRegistry", "_gauges",
              "_lock"),
    GuardDecl(_OBS + "metrics.py", "MetricsRegistry", "_timers",
              "_lock"),
    GuardDecl(_OBS + "metrics.py", "MetricsRegistry", "_histograms",
              "_lock"),
    GuardDecl(_OBS + "metrics.py", "Histogram", "counts", "_lock"),
    GuardDecl(_OBS + "metrics.py", "Histogram", "count", "_lock"),
    GuardDecl(_OBS + "metrics.py", "Histogram", "total", "_lock"),
    GuardDecl(_OBS + "metrics.py", "Histogram", "min_v", "_lock"),
    GuardDecl(_OBS + "metrics.py", "Histogram", "max_v", "_lock"),
    # device cache
    GuardDecl(_PKG + "io/device_cache.py", "DeviceTableCache",
              "_entries", "_lock"),
    GuardDecl(_PKG + "io/device_cache.py", "DeviceTableCache",
              "_pins", "_lock"),
    GuardDecl(_PKG + "io/device_cache.py", "DeviceTableCache",
              "_bytes", "_lock"),
    GuardDecl(_PKG + "io/device_cache.py", "DeviceTableCache",
              "hits", "_lock"),
    GuardDecl(_PKG + "io/device_cache.py", "DeviceTableCache",
              "misses", "_lock"),
    GuardDecl(_PKG + "io/device_cache.py", "DeviceTableCache",
              "evictions", "_lock"),
    # arbiter + result cache
    GuardDecl(_SVC + "arbiter.py", "DeviceResourceArbiter", "_leases",
              "_cv"),
    GuardDecl(_SVC + "arbiter.py", "DeviceResourceArbiter", "_denied",
              "_cv"),
    GuardDecl(_SVC + "arbiter.py", "DeviceResourceArbiter", "_pins",
              "_cv"),
    GuardDecl(_PKG + "result_cache.py", "ResultCache", "_entries",
              "_lock"),
    GuardDecl(_PKG + "result_cache.py", "ResultCache", "_bytes", "_lock"),
    GuardDecl(_PKG + "result_cache.py", "ResultCache", "evictions",
              "_lock"),
    GuardDecl(_PKG + "result_cache.py", "ResultCache", "rejected",
              "_lock"),
    # admission
    GuardDecl(_SVC + "admission.py", "AdmissionController", "running",
              "_cv"),
    GuardDecl(_SVC + "admission.py", "AdmissionController", "queued",
              "_cv"),
    GuardDecl(_SVC + "admission.py", "SessionQuota", "_inflight",
              "_lock"),
    # pool / server / history
    GuardDecl(_SVC + "pool.py", "SessionPool", "_entries", "_lock"),
    GuardDecl(_SVC + "server.py", "SqlService", "_records",
              "_records_lock"),
    GuardDecl(_SVC + "server.py", "SqlService", "_seq", "_records_lock"),
    GuardDecl(_SVC + "server.py", "SqlService", "_tokens",
              "_records_lock"),
    GuardDecl(_SVC + "server.py", "SqlService", "_async_inflight",
              "_async_lock"),
    GuardDecl(_SVC + "server.py", "SqlService", "_installed_arbiter",
              "_install_lock"),
    GuardDecl(_SVC + "server.py", "SqlService", "_stopped",
              "_stop_lock"),
    GuardDecl(_SVC + "server.py", "SqlService", "_draining",
              "_stop_lock"),
    # fleet supervisor + per-worker slices
    GuardDecl(_SVC + "fleet.py", "FleetSupervisor", "_inflight", "_cv"),
    GuardDecl(_SVC + "fleet.py", "FleetSupervisor", "_draining", "_cv"),
    GuardDecl(_SVC + "fleet.py", "FleetSupervisor", "_stopped", "_cv"),
    GuardDecl(_SVC + "fleet.py", "FleetSupervisor", "_seq", "_cv"),
    GuardDecl(_SVC + "fleet.py", "_Worker", "state", "_lock"),
    GuardDecl(_SVC + "fleet.py", "_Worker", "port", "_lock"),
    GuardDecl(_SVC + "fleet.py", "_Worker", "pid", "_lock"),
    GuardDecl(_SVC + "fleet.py", "_Worker", "proc", "_lock"),
    GuardDecl(_SVC + "fleet.py", "_Worker", "generation", "_lock"),
    GuardDecl(_SVC + "fleet.py", "_Worker", "policy", "_lock"),
    GuardDecl(_SVC + "fleet.py", "_Worker", "next_spawn_ts", "_lock"),
    GuardDecl(_SVC + "fleet.py", "_Worker", "spawn_deadline_ts",
              "_lock"),
    GuardDecl(_SVC + "fleet.py", "_Worker", "ping_failures", "_lock"),
    GuardDecl(_SVC + "fleet.py", "_Worker", "crash_times", "_lock"),
    GuardDecl(_SVC + "query_history.py", "QueryHistoryStore",
              "_entries", "_lock"),
    # observability
    GuardDecl(_OBS + "straggler.py", "StragglerMonitor", "_waits",
              "_lock"),
    GuardDecl(_OBS + "straggler.py", "StragglerMonitor", "_hosts",
              "_lock"),
    GuardDecl(_OBS + "straggler.py", "StragglerMonitor", "_flagged",
              "_lock"),
    GuardDecl(_OBS + "listener.py", "ListenerBus", "_listeners",
              "_lock"),
    GuardDecl(_OBS + "listener.py", "ListenerBus", "dropped", "_lock"),
    # status store
    GuardDecl(_OBS + "status_store.py", "StatusStore", "_series",
              "_lock"),
    GuardDecl(_OBS + "status_store.py", "StatusStore", "_inflight",
              "_lock"),
    GuardDecl(_OBS + "status_store.py", "StatusStore", "_sessions",
              "_lock"),
    GuardDecl(_OBS + "status_store.py", "StatusStore",
              "_status_counts", "_lock"),
    GuardDecl(_OBS + "status_store.py", "StatusStore", "_phase_totals",
              "_lock"),
    GuardDecl(_OBS + "status_store.py", "StatusStore", "_queries_total",
              "_lock"),
    GuardDecl(_OBS + "status_store.py", "StatusStore", "_heartbeats",
              "_lock"),
    GuardDecl(_OBS + "status_store.py", "StatusStore", "_providers",
              "_lock"),
    # flight recorder
    GuardDecl(_OBS + "flight_recorder.py", "FlightRecorder", "_rings",
              "_lock"),
    GuardDecl(_OBS + "flight_recorder.py", "FlightRecorder", "_plans",
              "_lock"),
    GuardDecl(_OBS + "flight_recorder.py", "FlightRecorder", "_trees",
              "_lock"),
    GuardDecl(_OBS + "flight_recorder.py", "FlightRecorder", "_spans",
              "_lock"),
    GuardDecl(_OBS + "flight_recorder.py", "FlightRecorder", "_seq",
              "_lock"),
    # udf worker pool
    GuardDecl(_PKG + "udf_worker/pool.py", "UdfWorkerPool", "_idle",
              "_cv"),
    GuardDecl(_PKG + "udf_worker/pool.py", "UdfWorkerPool", "_live",
              "_cv"),
    GuardDecl(_PKG + "udf_worker/pool.py", "UdfWorkerPool", "_all",
              "_cv"),
    # faults
    GuardDecl(_PKG + "testing/faults.py", "FaultPlan", "hits", "_lock"),
    GuardDecl(_PKG + "testing/faults.py", "FaultPlan", "fired_log",
              "_lock"),
    # lockwatch recorder
    GuardDecl(_PKG + "testing/lockwatch.py", "LockWatch",
              "edge_counts", "_mu"),
    GuardDecl(_PKG + "testing/lockwatch.py", "LockWatch",
              "lock_stats", "_mu"),
    # config (module-level global)
    GuardDecl(_PKG + "config.py", "", "_REGISTRY", "_REGISTRY_LOCK"),
    # lifecycle token registry (module-level global)
    GuardDecl(_EXE + "lifecycle.py", "", "_TOKENS", "_TOKENS_LOCK"),
    # streaming live registry (module-level globals) + trigger status
    GuardDecl(_PKG + "streaming.py", "", "_LIVE", "_LIVE_LOCK"),
    GuardDecl(_PKG + "streaming.py", "", "_LIVE_SEQ", "_LIVE_LOCK"),
    GuardDecl(_PKG + "streaming.py", "_TriggerStatus", "status",
              "_lock"),
    GuardDecl(_PKG + "streaming.py", "_TriggerStatus", "error",
              "_lock"),
    GuardDecl(_PKG + "streaming.py", "_TriggerStatus", "ticks",
              "_lock"),
    GuardDecl(_PKG + "streaming.py", "_TriggerStatus",
              "skipped_ticks", "_lock"),
    GuardDecl(_PKG + "streaming.py", "_TriggerStatus", "restarts",
              "_lock"),
    GuardDecl(_PKG + "streaming.py", "_TriggerStatus",
              "last_skew_ms", "_lock"),
    GuardDecl(_PKG + "streaming.py", "_TriggerStatus", "trigger_ms",
              "_lock"),
    # port-only locks
    GuardDecl(_EXE + "dense_groupby.py", "", "LAUNCHES", "_LAUNCH_LOCK"),
    GuardDecl(_EXE + "dense_groupby.py", "", "DEVICE_LAUNCHES",
              "_LAUNCH_LOCK"),
    GuardDecl(_EXE + "dense_groupby.py", "", "_lib", "_lib_lock"),
    GuardDecl(_PKG + "session.py", "SparkTpuSession", "_query_seq",
              "_query_seq_lock"),
    GuardDecl(_PKG + "parallel/mesh.py", "", "COPY_STATS", "_COPY_LOCK"),
    GuardDecl(_PKG + "parallel/cluster.py", "", "_CLUSTER", "_INIT_LOCK"),
    GuardDecl(_PKG + "parallel/cluster.py", "", "CLUSTER_STATS",
              "_STATS_LOCK"),
)

#: intentionally-unguarded state, each with the reason the race is
#: benign. The lint prints this list verbatim in its notes.
WAIVERS: Tuple[Waiver, ...] = (
    *(Waiver(_PKG + "parallel/cluster.py", "Cluster", attr,
             "written only by the thread that makes this process's "
             "cluster collective: one execution at a time holds "
             "run_lock, and within it the local rendezvous hands each "
             "collective to one shard thread, its barrier ordering "
             "one leader after the next")
      for attr in ("gen", "_groups", "_abandoned", "_doomed", "_beats",
                   "_aborted", "_lost", "backends_used")),
    Waiver(_PKG + "parallel/cluster.py", "Cluster", "_peer_store",
           "assigned once, by cluster.init under _INIT_LOCK, before the "
           "cluster is published to any other thread"),
    Waiver(_OBS + "metrics.py", "Gauge", "value",
           "single attribute store, atomic under the GIL; readers "
           "tolerate a stale point-in-time value"),
    Waiver(_SVC + "pool.py", "_Entry", "current_record",
           "written by the server only while holding this entry's "
           "session lease (service.session): single writer per leased "
           "session; the status listener reads on the same thread"),
    Waiver(_SVC + "pool.py", "_Entry", "init_error",
           "happens-before via the ready Event: written before "
           "ready.set(), read only after ready.wait()"),
    Waiver(_SVC + "server.py", "SqlService", "_httpd",
           "lifecycle attr written by the owning control thread in "
           "start()/stop(), not on the request path"),
    Waiver(_SVC + "server.py", "SqlService", "_serve_thread",
           "lifecycle attr written by the owning control thread in "
           "start()/stop(), not on the request path"),
    Waiver(_SVC + "fleet.py", "FleetSupervisor", "_httpd",
           "lifecycle attr written by the owning control thread in "
           "start()/stop(), not on the request path (the "
           "SqlService._httpd precedent)"),
    Waiver(_SVC + "fleet.py", "FleetSupervisor", "_serve_thread",
           "lifecycle attr written by the owning control thread in "
           "start()/stop(), not on the request path"),
    Waiver(_SVC + "fleet.py", "FleetSupervisor", "_health_thread",
           "lifecycle attr written by the owning control thread in "
           "start()/stop(), not on the request path"),
    Waiver(_SVC + "fleet.py", "FleetSupervisor", "_hbm_share",
           "written once by the owning control thread in start(), "
           "before the first spawn and before the health thread (which "
           "respawns) is started; read-only afterwards"),
    Waiver(_SVC + "arbiter.py", "", "_ARBITER",
           "atomic reference rebind at service start/stop, before "
           "worker threads exist / after they drained"),
    Waiver(_OBS + "status_store.py", "StatusStore", "_thread",
           "lifecycle attr written by the owning control thread in "
           "start()/stop(), not on the query path"),
    Waiver(_OBS + "status_store.py", "StatusStore", "_stop_event",
           "threading.Event is internally synchronized; clear() runs "
           "in start() before the heartbeat thread exists, set() in "
           "stop() is the cross-thread signal it exists for"),
    # the session's catalog and data-cache maps: one session may run
    # queries on several threads (the lockwatch stress does), but these
    # change only on the thread that registers a table or runs a
    # cache()/WITH statement
    Waiver(_PKG + "session.py", "SparkTpuSession", "catalog",
           "table registration and DDL run on the thread that sets the "
           "session up or runs the statement; concurrent queries only "
           "read entries, and a dict item store is GIL-atomic, so a "
           "reader sees the old source or the new one"),
    Waiver(_PKG + "session.py", "SparkTpuSession", "_cache_requests",
           "cache marks change on the thread running cache()/WITH/DDL; "
           "GIL-atomic dict item ops, and a query that misses a mark "
           "plans the subtree uncached (the same result)"),
    Waiver(_PKG + "session.py", "SparkTpuSession", "_data_cache",
           "the reference is rebound once, by the SQL service's pool "
           "right after construction (to the arbiter's shared cache), "
           "before the session runs a query; the cache's own state is "
           "guarded by service.result_cache, and a query whose entry "
           "another thread evicted recomputes it from its mark"),
    Waiver(_PKG + "session.py", "SparkTpuSession", "_implicit_cache_fps",
           "statement-scoped view marks: GIL-atomic set add/discard on "
           "the statement's thread; _evict_implicit_caches iterates a "
           "copy, so a concurrent mark cannot break the iteration"),
    # module-level globals (cls="" and attr=global name)
    Waiver(_PKG + "testing/faults.py", "", "_PLAN",
           "atomic reference rebind at execute_batch entry / test "
           "reset; the armed plan's mutable state is lock-guarded "
           "(FaultPlan._lock) and per-thread suppression is a "
           "ContextVar, not a plan swap"),
    Waiver(_PKG + "testing/faults.py", "", "_EXTRA_SITES",
           "test-only registration seam: mutated at test setup before "
           "the seams it names run concurrently"),
    Waiver(_PKG + "testing/lockwatch.py", "LockWatch", "_installed",
           "mutated only by the test harness thread during "
           "install()/uninstall(), before/after the watched "
           "concurrency runs"),
    Waiver(_PKG + "testing/lockwatch.py", "", "_CURRENT",
           "GIL-atomic reference rebind by the test harness thread in "
           "watch_attr()/uninstall(); the flight recorder's dump only "
           "reads a point-in-time reference"),
    Waiver(_PKG + "udf_worker/pool.py", "UdfWorkerPool",
           "max_workers",
           "GIL-atomic scalar refresh from conf at each worker-mode "
           "evaluation entry (python_eval.session_pool); checkout "
           "reads a point-in-time bound"),
    Waiver(_PKG + "udf_worker/pool.py", "UdfWorkerPool",
           "idle_timeout_ms",
           "GIL-atomic scalar refresh from conf, same discipline as "
           "max_workers"),
)

#: classes in shared modules whose instances are thread-confined --
#: ContextVar-installed per execution or single-consumer by design.
CONFINED: Tuple[ConfinedDecl, ...] = (
    ConfinedDecl(_PKG + "io/sources.py", "PrefetchChunkIterator",
                 "consumer-thread confined: the worker receives plain "
                 "args; the only cross-thread channels are the size-1 "
                 "Queue and the stop Event"),
    ConfinedDecl(_OBS + "spans.py", "SpanRecorder",
                 "per-execution recorder owned by the thread running "
                 "its query"),
    ConfinedDecl(_OBS + "spans.py", "ShardStreamTelemetry",
                 "ContextVar-installed per execution; buffered and "
                 "flushed on the thread running the query"),
    ConfinedDecl(_PKG + "parallel/elastic.py", "RebalanceState",
                 "ContextVar-installed per stream; on_straggler posts "
                 "synchronously on the thread running the query"),
    ConfinedDecl(_PKG + "udf_worker/pool.py", "WorkerHandle",
                 "checked out to exactly one query thread at a time; "
                 "the hand-off back into the pool's idle list happens "
                 "under the pool cv, which orders the threads"),
)

#: module-level global waivers live in WAIVERS with cls="". This alias
#: keeps call sites explicit about which kind they consult.
MODULE_WAIVERS = tuple(w for w in WAIVERS if w.cls == "")


# ---------------------------------------------------------------------------
# Call-resolution tables for the static lock-order extractor
# ---------------------------------------------------------------------------

#: bare local/module names the extractor may treat as instances of a
#: known class (kept deliberately tiny: every entry is an idiomatic,
#: unambiguous name in the scanned modules)
RECEIVER_NAMES: Dict[str, str] = {
    "CACHE": "DeviceTableCache",     # io.device_cache module singleton
    "entry": "_Entry",               # pool/server session-entry idiom
}

#: attribute names (the final `.attr` of a receiver chain) resolved to
#: a known class -- `self.metrics.counter(...)`, `session.listeners...`
RECEIVER_ATTRS: Dict[str, str] = {
    "metrics": "MetricsRegistry",
    "_metrics": "MetricsRegistry",
    "admission": "AdmissionController",
    "_ctl": "AdmissionController",
    "session_quota": "SessionQuota",
    "arbiter": "DeviceResourceArbiter",
    "result_cache": "ResultCache",
    "history": "QueryHistoryStore",
    "_history": "QueryHistoryStore",
    "pool": "SessionPool",
    "bus": "ListenerBus",
    "listeners": "ListenerBus",
    "status_store": "StatusStore",
    "_store": "StatusStore",
}

#: factory methods whose RETURN value is an instance of another known
#: class (`self.metrics.counter(name).inc(...)` chains)
FACTORY_RETURNS: Dict[Tuple[str, str], str] = {
    ("MetricsRegistry", "counter"): "Counter",
    ("MetricsRegistry", "timer"): "Timer",
    ("MetricsRegistry", "gauge"): "Gauge",
    ("MetricsRegistry", "histogram"): "Histogram",
}

#: `with <recv>.<method>(...):` context managers that hold a
#: registered lock over their body
CONTEXT_MANAGERS: Dict[Tuple[str, str], str] = {
    ("AdmissionController", "slot"): "service.admission",
}

#: helper methods whose CONTRACT is "called with this lock held" (the
#: lexical `with` lives in the caller). The guarded-by pass treats the
#: lock as held throughout; the lock-order pass charges the callee's
#: acquisitions against it. Keyed (relpath, cls, method) -> lock attr.
CALLED_WITH_LOCK_HELD: Dict[Tuple[str, str, str], str] = {
    (_OBS + "straggler.py", "StragglerMonitor", "_evaluate"): "_lock",
    # checkout's reap step: the lexical `with self._cv` lives in
    # checkout; _reap_locked only mutates _idle/_live under it
    (_PKG + "udf_worker/pool.py", "UdfWorkerPool",
     "_reap_locked"): "_cv",
}

#: acquisition-order edges the lexical extractor cannot see (locks
#: held across function boundaries, unresolvable indirect calls).
#: Each entry asserts "the left lock may be held while the right one
#: is acquired" and must ascend in rank like any extracted edge.
EXTRA_EDGES: Tuple[Tuple[str, str, str], ...] = (
    # the session lease is held across the entire submit body
    # (acquired in SqlService._lock_session, released in the caller's
    # finally) -- everything the engine takes nests inside it
    ("service.session", "service.admission", "submit holds the lease "
     "while entering the admission slot"),
    ("service.session", "service.records", "admission on_event -> "
     "SqlService._post -> get_query, under the lease"),
    ("service.session", "service.arbiter", "engine execution leases "
     "device memory under the session lease"),
    ("service.session", "service.result_cache", "result-cache "
     "fill/probe during execution"),
    ("service.session", "service.history", "status listener stores "
     "detail at query end"),
    ("service.session", "io.device_cache", "scan loads fill the "
     "device cache during execution"),
    ("service.session", "obs.straggler", "mesh telemetry posts "
     "on_shard_records during execution"),
    ("service.session", "obs.bus", "lifecycle events post on the "
     "session bus during execution"),
    ("service.session", "obs.event_log", "event-log append at query "
     "end"),
    ("service.session", "faults.plan", "chaos seams fire during "
     "execution"),
    ("service.session", "metrics.registry", "metric lookups during "
     "execution"),
    ("service.session", "metrics.flush", "sink flush at query end"),
    ("service.session", "metrics.counter", "counter incs during "
     "execution"),
    ("service.session", "metrics.timer", "timer observations at query "
     "end"),
    ("service.session", "config.registry", "late conf registration "
     "on first import of an engine module"),
    # the port's own leaves, taken while a pooled session's query runs
    ("service.session", "session.query_seq", "each execution takes "
     "its query id under the lease"),
    ("service.session", "dense_groupby.build", "the first launch "
     "builds and loads the kernel library under the lease"),
    ("service.session", "dense_groupby.launch", "kernel launches "
     "count under the lease"),
    ("service.session", "mesh.copy_stats", "a mesh query's "
     "collectives count copied bytes under the lease"),
    ("service.session", "mesh.shard_errors", "a mesh query's failing "
     "shard records its error under the lease"),
    ("service.session", "cluster.run", "a cluster mesh attempt runs "
     "under the lease"),
    ("cluster.run", "service.arbiter", "the scans of a cluster "
     "execution lease device memory inside it"),
    ("cluster.run", "io.device_cache", "load_shards reads the device "
     "cache inside the cluster execution"),
    ("cluster.run", "faults.plan", "the stage_run and mesh seams fire "
     "inside the cluster execution"),
    ("cluster.run", "mesh.copy_stats", "the result gather counts its "
     "copies inside the cluster execution"),
    ("cluster.run", "mesh.shard_errors", "run_on_shards inside the "
     "cluster execution"),
    ("cluster.run", "cluster.stats", "the agreement and the result "
     "gather count crossed bytes inside the cluster execution"),
    ("service.session", "streaming.live", "the stream listing reads "
     "the live registry"),
    # admission's on_event callback is an opaque callable statically;
    # at runtime it is SqlService._post (registry + bus)
    ("service.admission", "service.records", "on_event -> "
     "SqlService._post -> get_query while holding the slot cv"),
    ("service.admission", "obs.bus", "on_event -> bus.post snapshot "
     "while holding the slot cv"),
    # pool._create constructs a session, whose default listeners
    # register on its (new) bus
    ("service.pool", "obs.bus", "SessionPool._create -> "
     "session.add_listener under the pool lock"),
    # the executor registers its cancel token while the session lease
    # is held (lifecycle.enter_query_scope from execute_batch)
    ("service.session", "execution.lifecycle", "executor registers "
     "the query's cancel token under the lease"),
    # admission/arbiter cv waits run lifecycle.checkpoint each wakeup,
    # which fires the cancel_point chaos seam (faults.plan counting)
    ("service.admission", "faults.plan", "queue-wait wakeups fire the "
     "cancel_point seam while holding the slot cv"),
    ("service.arbiter", "faults.plan", "lease-wait wakeups fire the "
     "cancel_point seam while holding the lease cv"),
    # the out-of-process UDF lane checks workers out while the query
    # runs under its session lease (execution/python_eval.py)
    ("service.session", "udf.pool", "worker checkout/checkin during "
     "UDF evaluation under the lease"),
    # status-store per-session feed: the bus delivers query start/end
    # synchronously on the worker thread holding the session lease
    ("service.session", "obs.status", "status-store feed folds "
     "query start/end attribution under the lease"),
    # flight recorder: same synchronous delivery, plus the executor's
    # crash-dump trigger runs inside the lease
    ("service.session", "obs.flightrec", "flight-recorder ring "
     "appends and crash dumps under the lease"),
    ("service.session", "metrics.histogram", "latency histogram "
     "observations at query end under the lease"),
    # pool._create wires the status-store feed while holding the pool
    # lock (SqlService._make_listener -> status_store.bind)
    ("service.pool", "obs.status", "session creation binds the "
     "status-store feed under the pool lock"),
    # registry.snapshot() serializes each histogram under its own leaf
    # lock while holding the instrument-map lock
    ("metrics.registry", "metrics.histogram", "MetricsRegistry."
     "snapshot reads histogram snapshots under the registry lock"),
)


# ---------------------------------------------------------------------------
# Lookup helpers
# ---------------------------------------------------------------------------

_BY_ID = {d.lock_id: d for d in LOCKS}


def lock_ids() -> Tuple[str, ...]:
    return tuple(d.lock_id for d in LOCKS)


def rank_of(lock_id: str) -> Optional[int]:
    d = _BY_ID.get(lock_id)
    return None if d is None else d.rank


def kind_of(lock_id: str) -> Optional[str]:
    d = _BY_ID.get(lock_id)
    return None if d is None else d.kind


def lock_id_for(relpath: str, cls: str, attr: str) -> Optional[str]:
    for d in LOCKS:
        if (d.relpath, d.cls, d.attr) == (relpath, cls, attr):
            return d.lock_id
    return None


def class_locks(relpath: str, cls: str) -> Dict[str, str]:
    """{lock attr name: lock_id} for one class (or module, cls='')."""
    return {d.attr: d.lock_id for d in LOCKS
            if d.relpath == relpath and d.cls == cls}
