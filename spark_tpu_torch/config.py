"""Declarative configuration registry (the port's copy of the
`spark_tpu/config.py` registry, holding the keys this engine reads).

A single module-level registry of typed entries with defaults/docs/
validators, overlaid by a per-session mutable map that is runtime-
settable (reference: `SparkConf.scala:54` + `ConfigEntry.scala:74` +
`SQLConf.scala:56`). Key names match the JAX package, so a conf set in a
test means the same thing in both engines.
"""

from __future__ import annotations

import os as _os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional


@dataclass(frozen=True)
class ConfigEntry:
    """A typed config declaration (reference: ConfigEntry.scala:74)."""

    key: str
    default: Any
    type_: type
    doc: str = ""
    validator: Optional[Callable[[Any], bool]] = None
    version: str = "0.1.0"

    def coerce(self, value: Any) -> Any:
        if self.type_ is bool and isinstance(value, str):
            return value.strip().lower() in ("true", "1", "yes")
        return self.type_(value)


_REGISTRY: Dict[str, ConfigEntry] = {}
_REGISTRY_LOCK = threading.Lock()


def register(key: str, default: Any, doc: str = "",
             validator: Optional[Callable[[Any], bool]] = None,
             type_: Optional[type] = None) -> ConfigEntry:
    entry = ConfigEntry(key=key, default=default,
                        type_=type_ or type(default), doc=doc,
                        validator=validator)
    with _REGISTRY_LOCK:
        if key in _REGISTRY:
            raise ValueError(f"duplicate config entry: {key}")
        _REGISTRY[key] = entry
    return entry


def registry() -> Dict[str, ConfigEntry]:
    return dict(_REGISTRY)


class Conf:
    """Session-scoped overlay over the registry (reference: SQLConf.scala:56).

    Unknown keys are allowed (string passthrough) to mirror SparkConf's
    open string map; known keys are validated and coerced. A key the JAX
    package registers for a slice this port has not reached
    (`UNPORTED_KEYS`) may only be set to its default: anything else
    raises `UnportedConfError`, since the port would ignore it.
    """

    def __init__(self, parent: Optional["Conf"] = None):
        self._settings: Dict[str, Any] = {}
        self._parent = parent

    def set(self, key: str, value: Any) -> "Conf":
        entry = _REGISTRY.get(key)
        if entry is not None:
            value = entry.coerce(value)
            if entry.validator is not None and not entry.validator(value):
                raise ValueError(f"invalid value for {key}: {value!r}")
        elif key in UNPORTED_KEYS:
            check_unported(key, value)
        self._settings[key] = value
        return self

    def unset(self, key: str) -> None:
        self._settings.pop(key, None)

    def get(self, key: str, default: Any = None) -> Any:
        if key in self._settings:
            return self._settings[key]
        if self._parent is not None and self._parent.contains(key):
            return self._parent.get(key)
        entry = _REGISTRY.get(key)
        if entry is not None:
            return entry.default
        return default

    def contains(self, key: str) -> bool:
        return (key in self._settings
                or (self._parent is not None and self._parent.contains(key))
                or key in _REGISTRY)

    def is_explicitly_set(self, key: str) -> bool:
        """True when the key was set on this conf or a parent overlay,
        as opposed to merely having a registry default."""
        return (key in self._settings
                or (self._parent is not None
                    and self._parent.is_explicitly_set(key)))

    def copy(self) -> "Conf":
        c = Conf(parent=self._parent)
        c._settings.update(self._settings)
        return c


# ---------------------------------------------------------------------------
# Entries read by the port (same keys, defaults and validators as
# spark_tpu/config.py)
# ---------------------------------------------------------------------------

AGG_SORT_FALLBACK = register(
    "spark_tpu.sql.aggregate.maxDirectDomain", 1 << 22,
    doc="Max combined integer key domain for the direct (dense-table) "
        "aggregate path; larger domains need the sort-based aggregate.")

AGG_KERNEL_MODE = register(
    "spark_tpu.sql.aggregate.kernelMode", "auto",
    doc="Dense-domain aggregate update kernel: 'auto' and 'matmul' run "
        "the hand-written CUDA group-by kernel on CUDA tensors and its "
        "plain index_add_ version on CPU tensors ('matmul' is the JAX "
        "package's name for forcing the kernel); 'scatter' forces the "
        "plain index_add_ path.",
    validator=lambda v: v in ("auto", "matmul", "scatter"))

AGG_TABLE_SIZE = register(
    "spark_tpu.sql.aggregate.estimatedGroups", 1 << 16,
    doc="Estimated distinct group count used to size hash-aggregate output "
        "when no tighter bound can be inferred.")

CASE_SENSITIVE = register(
    "spark_tpu.sql.caseSensitive", False,
    doc="Whether column resolution is case sensitive (analog of "
        "spark.sql.caseSensitive).")

EXCLUDED_RULES = register(
    "spark_tpu.sql.optimizer.excludedRules", "",
    doc="Comma-separated optimizer rule names to skip (the reference's "
        "spark.sql.optimizer.excludedRules); '*' disables every rule.")

ANALYSIS_ENABLED = register(
    "spark_tpu.sql.analysis.enabled", True,
    doc="Run the static plan analyzer (analysis/plan_analyzer.py): "
        "after planning and before any ingest or launch, walk the "
        "physical plan for dtype-overflow, host-sync, recompile, "
        "hash-table, mesh and x64 hazards and emit typed findings "
        "(listener bus on_analysis -> event log; "
        "explain(analysis=True)). The walk is a host-side tree "
        "traversal that touches no tensor; findings never change "
        "results.")

ANALYSIS_STRICT = register(
    "spark_tpu.sql.analysis.strict", False,
    doc="Fail fast on analysis: raise a structured AnalysisFindingError "
        "BEFORE any ingest or kernel launch when the analyzer produced "
        "error-severity findings (accumulator overflow, x64 "
        "truncation) -- the CheckAnalysis seat. Warn/info findings "
        "never raise.")

PLAN_VALIDATION = register(
    "spark_tpu.sql.planChangeValidation", _os.environ.get(
        "SPARK_TPU_PLAN_VALIDATION", "off"),
    doc="Verify plan integrity after every effective optimizer-rule "
        "application (analysis/plan_integrity.py; the reference's "
        "spark.sql.planChangeValidation + LogicalPlanIntegrity): "
        "column-reference resolution with unique origins, output-schema "
        "preservation against the Rule.schema_preserving contract, "
        "duplicate output names, aggregate coherence, join-key dtype "
        "compatibility, and per-batch determinism (a replay over a "
        "cloned input must reproduce the plan). 'full' raises a typed "
        "PlanIntegrityError naming the rule/batch/node; 'lite' surfaces "
        "PLAN_INTEGRITY findings through the analyzer flow instead; "
        "'off' skips verification. The default honors the "
        "SPARK_TPU_PLAN_VALIDATION environment variable (the test "
        "suite pins it to 'full').",
    validator=lambda v: v in ("off", "lite", "full"))

PLAN_CHANGE_LOG = register(
    "spark_tpu.sql.planChangeLog", False,
    doc="Capture a unified before/after tree diff of each rule's first "
        "effective application into the rule_trace records "
        "(analysis/plan_integrity.py PlanChangeTracer; the reference's "
        "spark.sql.planChangeLog.level). Off keeps rule_trace to "
        "per-rule counters/timings only.")

JOIN_KERNEL_MODE = register(
    "spark_tpu.sql.join.kernelMode", "auto",
    doc="Equi-join match kernel (execution/hash_join.py vs the sorted-"
        "build binary search in execution/join.py): 'hash' builds a "
        "power-of-two open-addressing table over the (sorted) build "
        "keys and probes it with a bounded vectorized loop; 'sort' "
        "keeps the binary-search path; 'auto' picks hash only for large "
        "probes over comparatively small builds (join.hashMinProbeRows / "
        "hashProbeBuildRatio). Results are byte-identical across modes "
        "(both kernels emit matches in the same sorted-build order).",
    validator=lambda v: v in ("auto", "hash", "sort"))

JOIN_HASH_LOAD_FACTOR = register(
    "spark_tpu.sql.join.hashLoadFactor", 0.5,
    doc="Target load factor for the hash-join table: slots = the "
        "smallest power of two >= build capacity / loadFactor (clamped "
        "by join.hashMaxTableSlots). Lower = fewer probe steps, more "
        "device memory.",
    validator=lambda v: 0.0 < v <= 0.9)

JOIN_HASH_MAX_PROBE = register(
    "spark_tpu.sql.join.hashMaxProbe", 64,
    doc="Bound on linear-probe steps for hash-join build inserts and "
        "probes. A build whose longest collision cluster exceeds it "
        "raises the join_hashsat_<tag> flag and the executor runs that "
        "join again on the sort kernel (correctness never depends on "
        "the bound).",
    validator=lambda v: v >= 1)

JOIN_HASH_MAX_SLOTS = register(
    "spark_tpu.sql.join.hashMaxTableSlots", 1 << 26,
    doc="Upper bound on hash-join table slots (a device-memory guard: "
        "~16 bytes per slot). A build capacity that would push the "
        "effective load factor past 0.7 under this clamp falls back to "
        "the sort kernel.",
    validator=lambda v: v >= 16)

JOIN_HASH_MIN_PROBE_ROWS = register(
    "spark_tpu.sql.join.hashMinProbeRows", 1 << 19,
    doc="kernelMode=auto: minimum probe-side capacity for the hash "
        "kernel. Below it the sorted-build binary search wins.")

JOIN_HASH_PROBE_BUILD_RATIO = register(
    "spark_tpu.sql.join.hashProbeBuildRatio", 4.0,
    doc="kernelMode=auto: minimum probe/build capacity ratio for the "
        "hash kernel. The hash table amortizes its build cost over "
        "probe rows; near-square joins keep the sort path.",
    validator=lambda v: v >= 0)

RUNTIME_FILTER_ENABLED = register(
    "spark_tpu.sql.runtimeFilter.enabled", True,
    doc="Inject runtime join filters: when a join's build side is "
        "selective, build a device Bloom filter (+ min/max key bounds "
        "for ordered keys) from the build-side join keys and prune "
        "probe rows before the join (the InjectRuntimeFilter.scala:1 "
        "analog). Results are identical on/off.")

RUNTIME_FILTER_CREATION_THRESHOLD = register(
    "spark_tpu.sql.runtimeFilter.creationSideThreshold", 256 << 20,
    doc="Max estimated creation-side bytes (rows x 8 x columns, "
        "pre-filter upper bound) for building a runtime filter; larger "
        "build sides skip injection.")

RUNTIME_FILTER_SEMI_AWARE = register(
    "spark_tpu.sql.runtimeFilter.semiAwareCreation", True,
    doc="When a creation-side descent passes through an equi-join whose "
        "OTHER side is selective and cheap to recompute, synthesize a "
        "left-semi join in the creation chain instead of dropping the "
        "other side's effect (Q5: customer inherits the nation-region "
        "semi). The synthesized semi only ever NARROWS the creation "
        "keys toward the true build keys — pruning stays sound. One "
        "device only: under a mesh the creation scans are sharded, and "
        "a per-shard semi could drop keys whose partner rows live on "
        "another shard.")

RUNTIME_FILTER_FPP = register(
    "spark_tpu.sql.runtimeFilter.expectedFpp", 0.03,
    doc="Expected false-positive probability for runtime-filter Bloom "
        "sketches (sizing follows BloomFilter.optimalNumOfBits). False "
        "positives only reduce pruning, never correctness.",
    validator=lambda v: 0.0 < v < 1.0)

ADAPTIVE_ENABLED = register(
    "spark_tpu.sql.adaptive.enabled", True,
    doc="Enable the re-plan loop for join and aggregate capacity "
        "overflows (analog of spark.sql.adaptive.enabled). Disabled, an "
        "overflow raises instead of re-planning; the unique-build and "
        "hash-saturation fallbacks run either way.")

CBO_JOIN_REORDER = register(
    "spark_tpu.sql.cbo.joinReorder", True,
    doc="Cost-based join reorder (plan/join_reorder.py, the "
        "CostBasedJoinReorder.scala analog): re-sequence maximal "
        "regions of inner equi-joins by estimated cost — source row "
        "counts x filter selectivities (Parquet-footer min/max "
        "interpolation for ranges when stats.parquetFooter is on), "
        "left-deep DP minimizing the sum of intermediate sizes. "
        "Results are identical on/off (only join order changes); off "
        "restores the frontend order.")

CBO_MAX_RELATIONS = register(
    "spark_tpu.sql.cbo.maxReorderRelations", 8,
    doc="Upper bound on relations per reordered join region: the "
        "left-deep DP enumerates connected subsets (2^n states), so "
        "larger regions keep the frontend order. The "
        "spark.sql.cbo.joinReorder.dp.threshold seat.",
    validator=lambda v: 2 <= v <= 14)

STATS_PARQUET_FOOTER = register(
    "spark_tpu.sql.stats.parquetFooter", True,
    doc="Read per-column min/max (and row-group counts) from Parquet "
        "footers (io/sources.py column_stats), cached per source, for "
        "the reorder cost model's range selectivities. Reading footers "
        "touches no row data.")

DEVICE_CACHE_BYTES = register(
    "spark_tpu.sql.io.deviceCacheBytes", 6 << 30,
    doc="Byte budget for the device-resident table cache "
        "(io/device_cache.py): loaded scans (post column-prune/filter-"
        "pushdown) stay in device memory and are reused across queries, "
        "LRU-evicted past the budget. 0 disables. The storage-memory-"
        "pool analog of UnifiedMemoryManager.scala:49 + "
        "CacheManager.scala.")

FUZZ_SEEDS = register(
    "spark_tpu.sql.fuzz.seeds", 64,
    doc="Default seed count for the differential plan fuzzer "
        "(testing/plan_fuzz.py): each seed generates one random "
        "table set + query and runs it optimizer-on vs -off vs "
        "per-rule-ablated.",
    validator=lambda v: v > 0)

FUZZ_MAX_ROWS = register(
    "spark_tpu.sql.fuzz.maxRows", 40,
    doc="Max rows per generated fuzz table (testing/plan_fuzz.py); "
        "small tables keep a CPU campaign tractable while still "
        "covering nulls, NaN/-0.0 floats, decimals and dictionary "
        "strings.",
    validator=lambda v: v > 0)

WAREHOUSE_DIR = register(
    "spark_tpu.sql.warehouse.dir", "spark-warehouse",
    doc="Directory for persistent tables (CREATE TABLE / INSERT INTO): "
        "one subdirectory of parquet parts + a JSON metadata sidecar per "
        "table. The metastore seat of SessionCatalog.scala:1, minus the "
        "Hive process: a fresh session over the same dir sees every "
        "table.")

CHECKPOINT_DIR = register(
    "spark_tpu.sql.checkpoint.dir", "",
    doc="Directory for df.checkpoint(): when set, checkpoints write "
        "Parquet (survive the process, ReliableCheckpointRDD analog); "
        "otherwise they materialize in memory (localCheckpoint).")

RESULT_CACHE_BYTES = register(
    "spark_tpu.service.resultCacheBytes", 256 << 20,
    doc="Byte bound for the plan-fingerprint result cache (the "
        "CacheManager/InMemoryRelation seat): materialized Arrow tables "
        "for cache()-marked plans, LRU-evicted past the bound. The SQL "
        "service's arbiter keeps one such cache that every pooled "
        "session shares; a standalone session keeps an unbounded cache "
        "unless this key is set explicitly. 0 disables bounding.")

# -- out-of-core execution and recovery --------------------------------------

STREAMING_CHUNK_ROWS = register(
    "spark_tpu.sql.execution.streamingChunkRows", 1 << 24,
    doc="Chunk size (rows) for streaming large scans through aggregates "
        "with carried accumulator tables (execution/streaming_agg.py) and "
        "through external collect (execution/external.py); bounds the "
        "device residency of a scan the way the reference's row-iterator "
        "pipeline does.")

INGEST_PREFETCH = register(
    "spark_tpu.sql.ingest.prefetch", True,
    doc="Double-buffered chunk ingest for the streaming loops: a "
        "background thread decodes and dictionary-unifies chunk N+1 into "
        "HOST buffers while chunk N computes on the device. Bounded to "
        "one chunk in flight; the copy to the device stays on the "
        "consuming thread. Results are identical on and off.")

DEVICE_MEMORY_BUDGET = register(
    "spark_tpu.sql.memory.deviceBudget", 0,
    doc="Device byte budget for a single query's resident working set. "
        "Scans whose estimated post-prune footprint exceeds it run "
        "out-of-core: chunked through device-resident build sides, with "
        "partial-aggregate spill to host Arrow buffers or external "
        "collect (host RAM plays the role of executor disk). 0 = "
        "unbounded (whole-input residency).")

TASK_MAX_FAILURES = register(
    "spark_tpu.sql.execution.maxTaskFailures", 2,
    doc="DEPRECATED alias of spark_tpu.execution.maxRetries: when "
        "explicitly set, it overrides maxRetries.")

EXEC_MAX_RETRIES = register(
    "spark_tpu.execution.maxRetries", 3,
    doc="Retry budget per query execution for TRANSIENT failures "
        "(UNAVAILABLE, DEADLINE_EXCEEDED) and stage wall-clock timeouts, "
        "with exponential backoff and jitter (execution/failures.py).")

EXEC_BACKOFF_MS = register(
    "spark_tpu.execution.backoffMs", 50.0,
    doc="Base backoff for stage-failure retries: attempt n sleeps "
        "backoffMs * 2^n * uniform(0.5, 1.0) milliseconds.",
    validator=lambda v: v >= 0)

EXEC_STAGE_TIMEOUT_MS = register(
    "spark_tpu.execution.stageTimeoutMs", 0,
    doc="Per-stage wall-clock deadline (run + wait for the device of one "
        "attempt), checked after the attempt's host sync. A blown "
        "deadline raises StageTimeoutError and retries under the "
        "maxRetries budget. 0 disables.")

EXEC_QUERY_DEADLINE_MS = register(
    "spark_tpu.execution.queryDeadlineMs", 0.0,
    doc="End-to-end query deadline in milliseconds, armed on the "
        "cooperative cancel token (execution/lifecycle.py) at execution "
        "entry. Every wait — stage attempts, retry backoff, chunk "
        "boundaries, the wait for the device — is capped by the "
        "remaining budget; a blown deadline raises QueryDeadlineError, "
        "which stops the recovery ladder. 0 disables.",
    validator=lambda v: v >= 0)

EXEC_DISPATCH_POLL_MS = register(
    "spark_tpu.execution.dispatchPollMs", 25,
    doc="Cancellable wait for a stage's device work: with a cancel "
        "token installed, the executor polls a CUDA event recorded after "
        "the stage instead of blocking; the tick is an eighth of the "
        "time waited so far, from 50 us up to this cap, so a cancel or "
        "a blown queryDeadlineMs lands within about one tick and a "
        "stage's end is seen at most an eighth of its wait late. 0 "
        "restores the blocking wait.",
    validator=lambda v: v >= 0)

CHUNK_RETRY_ENABLED = register(
    "spark_tpu.execution.chunkRetry.enabled", True,
    doc="Chunk-granular retry inside the streaming loops "
        "(execution/recovery.py): a TRANSIENT/TIMEOUT failure replays "
        "only the failed chunk against the carried state, recorded as a "
        "`chunk_retry` action and the `rec_chunks_replayed` counter.")

CHUNK_RETRY_MAX = register(
    "spark_tpu.execution.chunkRetry.maxRetries", 2,
    doc="Per-chunk retry budget for the streaming loops (a fresh "
        "backoff RetryPolicy per chunk). 0 disables chunk retry.",
    validator=lambda v: v >= 0)

CHECKPOINT_EVERY_CHUNKS = register(
    "spark_tpu.execution.checkpoint.everyChunks", 8,
    doc="Mesh streaming checkpoint cadence: every N consumed chunks, "
        "snapshot the per-shard accumulator state device->host as a "
        "partial-aggregate Arrow table (bytes counted in "
        "rec_ckpt_bytes). A gang restart resumes the mesh stream at the "
        "last checkpointed chunk cursor, and so does the single-device "
        "fallback, instead of chunk 0 (recorded as "
        "`checkpoint_restore`). 0 disables checkpointing (recovery "
        "restarts the stream from scratch).",
    validator=lambda v: v >= 0)

MESH_RESTART_ENABLED = register(
    "spark_tpu.execution.meshRestart.enabled", True,
    doc="Gang restart (parallel/elastic.py): on a mesh/collective "
        "failure, re-execute the query still mesh-planned — up to "
        "meshRestart.maxRestarts attempts with exponential backoff — "
        "before degrading to the single-device fallback. The mesh "
        "stream resumes at its last checkpoint "
        "(checkpoint.everyChunks), so a shard lost mid-stream replays "
        "at most one checkpoint interval on the mesh. Restarts are "
        "recorded as `mesh_restart` actions (mesh_restart_attempts "
        "counter); disabled, a mesh failure degrades straight to one "
        "device.")

MESH_RESTART_MAX = register(
    "spark_tpu.execution.meshRestart.maxRestarts", 2,
    doc="Gang-restart budget per query execution: mesh failures past "
        "it fall through to the single-device fallback rung. Backoff "
        "follows spark_tpu.execution.backoffMs (exponential, "
        "jittered).",
    validator=lambda v: v >= 0)

DECOMMISSION_SHARDS = register(
    "spark_tpu.execution.decommission.shards", "",
    doc="Graceful-decommission drain request (comma-separated mesh "
        "positions, e.g. '3' or '3,5'; session.decommission_shards() "
        "sets it): a running mesh stream drains at its next chunk "
        "boundary — checkpoint forced at the current cursor, "
        "`decommission` recorded, the shards' device ids excluded at "
        "session level (spark_tpu.sql.mesh.excludeDevices) — and the "
        "query continues on the reduced gang from the checkpoint. The "
        "BlockManagerDecommissioner analog. One-shot: cleared once "
        "applied; a request with no position valid for the next mesh "
        "query's gang is discarded with a warning (never left armed "
        "for a future larger mesh).")

OOM_SPILL_ENABLED = register(
    "spark_tpu.execution.oom.spillOnExhausted", True,
    doc="Rung 2 of the device-memory degradation ladder: after a "
        "device-cache eviction retry still runs out of memory, re-plan "
        "under a 1-byte device budget so the chunked host-spill paths "
        "take over. Disabled, the ladder goes from eviction to the "
        "diagnostic.")

FAULT_INJECT = register(
    "spark_tpu.faults.inject", "",
    doc="Deterministic fault injection for chaos testing "
        "(testing/faults.py): comma-separated `site:fault:nth[:arg]` "
        "rules, each firing once. Empty disables.")

UDF_MODE = register(
    "spark_tpu.sql.udf.mode", "inprocess",
    doc="Where Python UDFs evaluate. 'inprocess': the original lane — "
        "user code runs in the engine process over the whole "
        "materialized table (fast for tiny inputs; a hung or crashing "
        "UDF takes the serving process with it). 'worker': the "
        "ArrowEvalPythonExec/PythonRunner seat — input is sliced by "
        "udf.arrow.maxRecordsPerBatch and pipelined through a pool of "
        "reusable subprocess workers (udf_worker/), each batch "
        "individually retryable (udf_batch fault site), cancellable "
        "between and DURING batches, and a worker crash replays only "
        "the in-flight batch. Results are byte-identical across "
        "modes.",
    validator=lambda v: v in ("inprocess", "worker"))

UDF_MAX_RECORDS_PER_BATCH = register(
    "spark_tpu.sql.udf.arrow.maxRecordsPerBatch", 10000,
    doc="Rows per Arrow batch streamed to a UDF worker (the "
        "spark.sql.execution.arrow.maxRecordsPerBatch seat). Smaller "
        "batches mean finer retry/cancel granularity and lower "
        "per-batch replay cost; larger batches amortize pipe framing "
        "and pandas call overhead. Worker mode only.",
    validator=lambda v: v >= 1)

UDF_POOL_MAX_WORKERS = register(
    "spark_tpu.sql.udf.pool.maxWorkers", 2,
    doc="Upper bound on live UDF worker subprocesses per session pool. "
        "Checkouts beyond the bound wait (cooperatively — cancel and "
        "deadline land within ~50ms) for a checkin. Workers are "
        "reused across queries; the spawn cost (interpreter + "
        "numpy/pandas/pyarrow import, udf_worker_spawn_ms) is paid "
        "once per worker, not per query.",
    validator=lambda v: v >= 1)

UDF_BATCH_TIMEOUT_MS = register(
    "spark_tpu.sql.udf.batchTimeoutMs", 0,
    doc="Per-batch wall-clock deadline for one worker EVAL round-trip. "
        "A wedged worker (infinite loop in user code, stuck import) "
        "is killed at the deadline and the batch replays on a fresh "
        "worker under the TIMEOUT retry budget. 0 disables. Worker "
        "mode only.",
    validator=lambda v: v >= 0)

UDF_POOL_IDLE_TIMEOUT_MS = register(
    "spark_tpu.sql.udf.pool.idleTimeoutMs", 60000,
    doc="Idle reap: a pooled worker unused this long is killed at the "
        "next checkout (lazily — no reaper thread). 0 keeps idle "
        "workers forever. Dead idle workers are always reaped at "
        "checkout regardless of this bound, so a worker that died "
        "between queries never surfaces as a stale-pipe error.",
    validator=lambda v: v >= 0)


# -- the mesh (parallel/), with the JAX package's defaults and docs ---------

SHUFFLE_PARTITIONS = register(
    "spark_tpu.sql.shuffle.partitions", 8,
    doc="Number of logical shuffle partitions (mesh data axis size).")

BROADCAST_THRESHOLD = register(
    "spark_tpu.sql.autoBroadcastJoinThreshold", 64 << 20,
    doc="Max estimated build-side bytes for broadcast (all_gather) joins; "
        "analog of spark.sql.autoBroadcastJoinThreshold.")

MESH_SIZE = register(
    "spark_tpu.sql.mesh.size", 0,
    doc="Number of shards on the data axis of the mesh. 0 or 1 runs on "
        "one device; >1 shards leaves over the mesh and lowers exchanges "
        "to collectives among the shards (all_to_all/all_gather/psum). "
        "A session built without a device takes cuda:0..N-1; one built "
        "with a device places every shard there. The analog of "
        "spark.default.parallelism.")

MESH_EXCLUDE_DEVICES = register(
    "spark_tpu.sql.mesh.excludeDevices", "",
    doc="Comma-separated device ids never meshed over (written by the "
        "decommission drain; settable directly to pin out a bad card). "
        "A card's id is its CUDA ordinal; a session built with one "
        "device gives its mesh positions the virtual ids 0..P-1 (P the "
        "largest mesh.size it ran). get_mesh builds the mesh over the "
        "surviving pool, shrinking below mesh.size instead of failing; "
        "a pool of <= 1 survivors runs on the session's device.")

CLUSTER_COORDINATOR = register(
    "spark_tpu.sql.cluster.coordinator", "",
    doc="host:port of the coordinator of a mesh that spans engine "
        "processes (empty = one process). Every process runs the same "
        "engine program; parallel.mesh.init_distributed dials in "
        "(torch.distributed over tcp://host:port, parallel/cluster.py) "
        "and mesh.size then counts every process's devices, ordered by "
        "process, then by local device.")

CLUSTER_NUM_PROCESSES = register(
    "spark_tpu.sql.cluster.numProcesses", 1,
    doc="Number of engine processes (hosts) in the cluster.")

CLUSTER_PROCESS_ID = register(
    "spark_tpu.sql.cluster.processId", 0,
    doc="This process's rank within the cluster.")

MESH_FALLBACK_ENABLED = register(
    "spark_tpu.execution.meshFallback.enabled", True,
    doc="When a distributed run fails inside the mesh/collective path "
        "(a broken rendezvous, a collective's peer copy), re-plan the "
        "query single-device and retry instead of failing. The fallback "
        "is recorded as a `mesh_fallback` metric and in fault_summary. "
        "The last rung of the mesh ladder, after the gang restarts "
        "(execution.meshRestart.*); each rung has its own key.")

SKEW_JOIN_ENABLED = register(
    "spark_tpu.sql.adaptive.skewJoin.enabled", True,
    doc="When a shuffle join's exchange overflows with one receive "
        "bucket holding more than skewJoin.factor x the mean rows per "
        "shard, re-plan the join as broadcast (all_gather the build "
        "side) instead of growing buckets (the OptimizeSkewedJoin.scala:56 "
        "+ DynamicJoinSelection.scala:1 analog).")

SKEW_JOIN_FACTOR = register(
    "spark_tpu.sql.adaptive.skewJoin.factor", 4.0,
    doc="Skew threshold: max-bucket rows / (total rows / shards) above "
        "which a shuffle join re-plans (skewJoin.enabled).")

SKEW_BROADCAST_BYTES = register(
    "spark_tpu.sql.adaptive.skewJoin.broadcastThreshold", 256 << 20,
    doc="Max measured build-side bytes for the skew-triggered broadcast "
        "re-plan (larger than autoBroadcastJoinThreshold).")


# -- observability (observability/), with the JAX package's defaults ------

METRICS_ENABLED = register(
    "spark_tpu.sql.metrics.enabled", True,
    doc="Record per-operator output row counts during execution "
        "(surfaced by explain(runtime=True); analog of SQLMetrics).")

PROFILE_DIR = register(
    "spark_tpu.sql.profile.dir", "",
    doc="When set, wrap query execution in a torch.profiler trace "
        "written to this directory as Chrome trace-event JSON (one trace "
        "per execute; the JAX package writes a jax.profiler trace).")

EVENT_LOG_DIR = register(
    "spark_tpu.sql.eventLog.dir", "",
    doc="When set, append one JSON line per query execution (plan "
        "fingerprint, phase timings, per-operator metrics, spans, stage "
        "device-memory costs, fault summary) to <dir>/app-<session>.jsonl "
        "— the EventLoggingListener analog; read back with "
        "spark_tpu_torch.history.read_event_log.")

EVENT_LOG_MAX_BYTES = register(
    "spark_tpu.sql.eventLog.maxBytes", 0,
    doc="Event-log rotation threshold: when the live app-<session>.jsonl "
        "reaches this size, it rolls to app-<session>.N.jsonl and a "
        "fresh live file starts (read_event_log replays rolled files in "
        "N order). 0 disables rotation (unbounded file, the reference's "
        "spark.eventLog.rolling.enabled=false default).")

TRACE_DIR = register(
    "spark_tpu.sql.trace.dir", "",
    doc="When set, write one Chrome-trace-event JSON per query "
        "execution (<dir>/query-<session>-<id>.trace.json) covering the "
        "per-stage spans: analysis -> optimize -> plan -> ingest -> "
        "dispatch -> egress, AQE re-plans and retries. Load in Perfetto "
        "or chrome://tracing.")

METRICS_SINK = register(
    "spark_tpu.sql.metrics.sink", "",
    doc="Comma-separated metrics sinks flushed at every query end: "
        "'jsonl' (snapshot lines appended to metrics.jsonl) and/or "
        "'prometheus' (text exposition atomically rewritten to "
        "metrics.prom, scrapeable via a textfile collector). Empty "
        "disables. The MetricsSystem/sink-configuration analog.",
    validator=lambda v: all(
        s.strip() in ("jsonl", "prometheus")
        for s in str(v).split(",") if s.strip()))

METRICS_DIR = register(
    "spark_tpu.sql.metrics.dir", "spark-metrics",
    doc="Output directory for the metrics sinks "
        "(spark_tpu.sql.metrics.sink).")

XLA_COST_MODE = register(
    "spark_tpu.sql.observability.xlaCost", "auto",
    doc="Capture each executed attempt's device-memory cost "
        "(observability/device_cost.py: the peak bytes the CUDA "
        "allocator held above the attempt's start, the loaded scans' "
        "and the result's bytes; the JAX package's XLA cost/memory "
        "analysis has no eager counterpart). 'auto' captures only when "
        "an observability output is configured (eventLog.dir, "
        "trace.dir, metrics.sink) or the OOM ladder is descending; "
        "'on' always; 'off' never. The key keeps the JAX package's name "
        "and meaning.",
    validator=lambda v: v in ("auto", "on", "off"))

MAX_SPANS = register(
    "spark_tpu.sql.observability.maxSpans", 1000,
    doc="Per-query bound on recorded lifecycle spans (a pathological "
        "retry loop must not grow the trace unboundedly; the recorder "
        "counts what it drops).")

SHARD_SPANS = register(
    "spark_tpu.sql.observability.shardSpans", "auto",
    doc="Per-shard telemetry for mesh runs: each exchange's per-shard "
        "routed rows and bytes become transfer-phase records, and the "
        "mesh stream's per-(shard, chunk) compute records. Records "
        "land in the event log ('shards', schema v3), feed the "
        "StragglerMonitor and the history.shard_summary()/"
        "straggler_report() views. 'auto' records only when an "
        "observability output or a user listener is active; 'on' "
        "always; 'off' never.",
    validator=lambda v: v in ("auto", "on", "off"))

MAX_SHARD_RECORDS = register(
    "spark_tpu.sql.observability.maxShardRecords", 4096,
    doc="Per-query bound on buffered per-shard telemetry records (a "
        "long mesh stream over many chunks must not grow the event "
        "line unboundedly; the recorder counts what it drops).",
    validator=lambda v: v >= 0)

STRAGGLER_FACTOR = register(
    "spark_tpu.sql.straggler.factor", 3.0,
    doc="Straggler detection threshold for the StragglerMonitor "
        "(observability/straggler.py): a shard whose rolling median "
        "per-chunk latency exceeds factor x the median of all shards' "
        "medians is flagged (straggler_flagged counter + on_straggler "
        "listener event). The speculation-threshold seat of "
        "spark.speculation.multiplier; the ElasticRebalancer acts on "
        "the flag (straggler.rebalance.*). <= 0 disables detection.",
    type_=float)

STRAGGLER_MIN_CHUNKS = register(
    "spark_tpu.sql.straggler.minChunks", 4,
    doc="Minimum per-shard chunk-latency samples before the "
        "StragglerMonitor may flag a shard (spark.speculation.quantile "
        "seat: early chunks are warmup-noisy).",
    validator=lambda v: v >= 1)

STRAGGLER_MIN_LATENCY_MS = register(
    "spark_tpu.sql.straggler.minLatencyMs", 10.0,
    doc="Noise floor for straggler flagging: a shard is only flagged "
        "when its median per-chunk wait is at least this many "
        "milliseconds — near-zero medians (every shard keeping up) "
        "must not flag on ratio alone.",
    validator=lambda v: v >= 0)

STRAGGLER_REBALANCE_ENABLED = register(
    "spark_tpu.sql.straggler.rebalance.enabled", True,
    doc="Straggler mitigation (parallel/elastic.py): when the "
        "StragglerMonitor flags a shard mid-stream, re-assign "
        "subsequent chunks' rows away from it — the flagged shard's "
        "live-row share drops by straggler.rebalance.maxSkew, spread "
        "over the healthy shards. Partial aggregation is "
        "row-assignment independent: integer/decimal results are "
        "bit-exact; float sums may move in the last ulp (summation "
        "order), as with any mesh-size change. Recorded as "
        "`shard_rebalance` with the rebalance_rows counter.")

STRAGGLER_REBALANCE_MAX_SKEW = register(
    "spark_tpu.sql.straggler.rebalance.maxSkew", 0.5,
    doc="How much of a flagged shard's fair row share the rebalancer "
        "may shift to healthy shards (0.5 = the straggler steps over "
        "half its fair share). Bounds the skew so one bad detection "
        "cannot starve a shard entirely; 0 disables movement.",
    validator=lambda v: 0.0 <= v < 1.0,
    type_=float)

STRAGGLER_REBALANCE_DECAY_CHUNKS = register(
    "spark_tpu.sql.straggler.rebalance.decayChunks", 0,
    doc="Straggler rebalance weight decay: a flagged shard's skew "
        "penalty fades linearly back to zero over this many healthy "
        "chunks after the flag, so a recovered shard earns its fair "
        "row share back instead of staying penalized for the rest of "
        "the stream. Per-shard slot capacity stays sized for the "
        "full-penalty trajectory (shapes stay stable mid-decay); when "
        "every penalty reaches zero the zero-cost unflagged path "
        "resumes. A re-flag mid-decay resets that shard's penalty to "
        "full. 0 keeps a flagged shard penalized until the stream "
        "ends.",
    validator=lambda v: v >= 0)

STATUS_ENABLED = register(
    "spark_tpu.sql.status.enabled", True,
    doc="Feed the engine status store: record end-to-end and per-phase "
        "query latency histograms (status_latency_ms / "
        "status_phase_ms_*) and SLO burn counters at every query end, "
        "and let the status heartbeat sample health gauges into its "
        "ring time-series. Off silences the recording, not the readers "
        "(they return whatever was recorded).")

STATUS_HEARTBEAT_MS = register(
    "spark_tpu.sql.status.heartbeatMs", 1000,
    doc="Interval of the status store's heartbeat thread (the "
        "Heartbeater analog): every tick samples queries in flight, "
        "cache hit rates and the wired providers into the fixed-"
        "capacity ring time-series.",
    validator=lambda v: v >= 10)

STATUS_RING_SIZE = register(
    "spark_tpu.sql.status.ringSize", 360,
    doc="Capacity of each status-store ring time-series (oldest "
        "samples drop past it); 360 x the 1s default heartbeat = a "
        "rolling 6-minute window per series.",
    validator=lambda v: v >= 2)

FLIGHTREC_ENABLED = register(
    "spark_tpu.sql.flightRecorder.enabled", True,
    doc="Keep the always-on flight recorder ring (recent events/spans/"
        "fault records per subsystem, bounded, near-zero hot-path "
        "cost) and dump a diagnostic bundle on FATAL errors, OOM-"
        "ladder exhaustion, non-convergent recovery, or on demand. Off "
        "disables both ring and dumps.")

FLIGHTREC_DIR = register(
    "spark_tpu.sql.flightRecorder.dir", "",
    doc="Directory diagnostic bundles are dumped under (one versioned "
        "bundle-<app>-<n>-<reason>/ per dump). Empty uses "
        "<tmpdir>/spark-tpu-flightrec.")

FLIGHTREC_RING_SIZE = register(
    "spark_tpu.sql.flightRecorder.ringSize", 256,
    doc="Per-subsystem bound on flight-recorder ring records (oldest "
        "drop past it).",
    validator=lambda v: v >= 8)

FLIGHTREC_EVENT_TAIL = register(
    "spark_tpu.sql.flightRecorder.eventLogTail", 200,
    doc="How many trailing event-log lines a diagnostic bundle "
        "includes (when eventLog.dir is set).",
    validator=lambda v: v >= 0)


# -- structured streaming (streaming.py, slice 11) ----------------------

STREAMING_SNAPSHOT_EVERY = register(
    "spark_tpu.streaming.stateStore.snapshotEveryDeltas", 10,
    doc="Incremental streaming state store "
        "(execution/state_store.py): write a FULL state snapshot "
        "every N versions; the versions between persist as deltas "
        "(only the groups whose accumulators changed that batch). "
        "Restore = newest snapshot <= the committed version + replay "
        "of at most N-1 deltas. 1 snapshots every version (the "
        "pre-incremental behavior).",
    validator=lambda v: v >= 1)

STREAMING_RETAIN = register(
    "spark_tpu.streaming.retainBatches", 2,
    doc="Streaming checkpoint retention window (the "
        "minBatchesToRetain seat): offset/commit log entries and "
        "state files needed only by versions older than "
        "committed - retain are compacted away. Recovery reads only "
        "the last committed version; the window exists so a torn "
        "newest log entry can fall back one version.",
    validator=lambda v: v >= 1)

STREAMING_FILE_STRICT = register(
    "spark_tpu.streaming.source.file.strict", False,
    doc="File stream source corrupt-file policy: by default a file "
        "that fails to decode (torn write, wrong schema, not the "
        "source's format) is QUARANTINED — marked in the source's "
        "seen-file log, counted in streaming_files_quarantined, "
        "skipped by the batch and by every replay — so one bad file "
        "cannot wedge the stream. true fails the batch instead "
        "(at-least-once delivery of every file byte wins over "
        "availability).")

STREAMING_NET_MAX_RECONNECTS = register(
    "spark_tpu.streaming.source.network.maxReconnects", 8,
    doc="Network stream source (io/network_source.py) reconnect "
        "ladder: maximum reconnect attempts per poll after the peer "
        "dies mid-stream (EOF, reset, or a mid-frame stall), under "
        "exponential backoff + jitter (failures.RetryPolicy over "
        "source.network.backoffMs). Every successful reconnect "
        "handshakes the durable frame offset back to the producer, so "
        "the stream resumes with zero loss and zero duplication. "
        "Exhausting the ladder fails the poll with a TRANSIENT "
        "connection error for the trigger supervisor to classify.",
    validator=lambda v: v >= 0)

STREAMING_NET_CONNECT_TIMEOUT_MS = register(
    "spark_tpu.streaming.source.network.connectTimeoutMs", 2000,
    doc="Network stream source: milliseconds each socket connect "
        "attempt may take before counting as a failed "
        "reconnect-ladder rung.",
    validator=lambda v: v >= 1)

STREAMING_NET_IDLE_TIMEOUT_MS = register(
    "spark_tpu.streaming.source.network.idleTimeoutMs", 50,
    doc="Network stream source idle/stall discriminator: a read that "
        "times out while waiting for the FIRST byte of a new frame "
        "means a quiet producer — the poll returns the offsets drained "
        "so far and keeps the connection. The same timeout landing "
        "MID-frame (header or payload partially read) means a dead or "
        "wedged peer and takes the reconnect ladder instead.",
    validator=lambda v: v >= 1)

STREAMING_NET_BACKOFF_MS = register(
    "spark_tpu.streaming.source.network.backoffMs", 50,
    doc="Network stream source: base backoff milliseconds for the "
        "reconnect ladder; attempt k sleeps backoffMs * 2^k with "
        "+/-50% jitter on the interruptible lifecycle wait.",
    validator=lambda v: v >= 0)

STREAMING_TRIGGER_MAX_RESTARTS = register(
    "spark_tpu.streaming.trigger.maxRestarts", 3,
    doc="Supervised trigger loop (StreamingQuery.start): how many "
        "times a TRANSIENT batch failure may restart within one "
        "failure streak before the query parks in FAILED status. The "
        "streak resets after any successful tick; FATAL failures park "
        "immediately without consuming restarts.",
    validator=lambda v: v >= 0)

STREAMING_TRIGGER_BACKOFF_MS = register(
    "spark_tpu.streaming.trigger.backoffMs", 100,
    doc="Supervised trigger loop: base backoff milliseconds between "
        "TRANSIENT-failure restarts (exponential + jitter via "
        "failures.RetryPolicy, slept on the interruptible lifecycle "
        "wait so stop()/cancel interrupts a parked backoff "
        "immediately).",
    validator=lambda v: v >= 0)

STREAMING_STATE_SPILL_BYTES = register(
    "spark_tpu.streaming.state.spillBytes", 0,
    doc="Host-spill threshold for event-time streaming-aggregate "
        "state: when the committed keyed state exceeds this many "
        "bytes it stops being held resident between triggers and "
        "reroutes through the external keyed backend "
        "(execution/external.py SpillableKeyedState) — hash-"
        "partitioned parquet spill files under the query checkpoint; "
        "each trigger's MERGE touches only the partitions its batch's "
        "keys hash to, and only the touched partitions rewrite at "
        "adoption. Persistence is unchanged (the same delta/snapshot "
        "store commits the same full frames), so crash recovery is "
        "identical; spilled bytes count in streaming_spill_bytes. "
        "0 disables spill (state stays resident).",
    validator=lambda v: v >= 0)

STREAMING_STATE_SPILL_PARTITIONS = register(
    "spark_tpu.streaming.state.spillPartitions", 16,
    doc="Partition count for the host-spill keyed state backend: "
        "state rows hash-route by key to this many parquet spill "
        "files; a trigger rewrites only the partitions its batch's "
        "keys (or evicted windows) touch.",
    validator=lambda v: v >= 1)


# -- the SQL service (service/) ---------------------------------------------

SERVICE_MAX_CONCURRENT = register(
    "spark_tpu.service.maxConcurrent", 2,
    doc="Admission control: maximum queries executing simultaneously in "
        "the SQL service (spark_tpu_torch/service/). Further submissions "
        "queue up to service.queueDepth, then reject with a structured "
        "ADMISSION_REJECTED error. The hive-thriftserver async-pool-size "
        "seat.",
    validator=lambda v: v >= 1)

SERVICE_QUEUE_DEPTH = register(
    "spark_tpu.service.queueDepth", 16,
    doc="Admission control: maximum queries waiting for an execution "
        "slot. A submission arriving with the queue full is rejected "
        "immediately (HTTP 429 / AdmissionRejected) instead of growing "
        "an unbounded backlog.",
    validator=lambda v: v >= 0)

SERVICE_QUEUE_TIMEOUT_MS = register(
    "spark_tpu.service.queueTimeoutMs", 30000,
    doc="Admission control: maximum milliseconds a queued query waits "
        "for an execution slot (or for its busy session) before failing "
        "with a structured ADMISSION_TIMEOUT error. 0 waits forever.",
    validator=lambda v: v >= 0)

SERVICE_HOST = register(
    "spark_tpu.service.host", "127.0.0.1",
    doc="Bind address for the SQL service HTTP endpoint "
        "(spark_tpu_torch/service/server.py).")

SERVICE_PORT = register(
    "spark_tpu.service.port", 0,
    doc="Bind port for the SQL service HTTP endpoint. 0 picks an "
        "ephemeral port (exposed as SqlService.port after start).")

SERVICE_HBM_BUDGET = register(
    "spark_tpu.service.hbmBudget", 0,
    doc="Shared device-memory byte budget the cross-query arbiter "
        "(service/arbiter.py) hands out as per-scan residency leases "
        "across all concurrent queries of the service, in bytes of the "
        "device memory torch.cuda reports for the card (total_memory), "
        "replacing the per-query spark_tpu.sql.memory.deviceBudget read. "
        "A scan that cannot lease its estimated footprint takes the "
        "out-of-core spill/streaming paths instead of running out of "
        "memory; lease pressure first evicts the device table cache. 0 "
        "disables the arbiter. An explicitly set per-query deviceBudget "
        "(the OOM ladder's second-rung overlay) still takes precedence.")

SERVICE_MAX_SESSIONS = register(
    "spark_tpu.service.maxSessions", 16,
    doc="Maximum pooled sessions the SQL service keeps (one per "
        "distinct `session` name in POST /sql). A request naming a new "
        "session past the bound is rejected with a structured error.",
    validator=lambda v: v >= 1)

SERVICE_SESSION_MAX_CONCURRENT = register(
    "spark_tpu.service.session.maxConcurrent", 0,
    doc="Per-session admission quota: maximum in-flight submissions "
        "(running + waiting, sync and async) one session name may hold "
        "at once. Exceeding it rejects with a structured "
        "SESSION_QUOTA_EXCEEDED error (HTTP 429) and counts "
        "session_quota_rejections. 0 disables (service-wide "
        "maxConcurrent/queueDepth still bound totals).",
    validator=lambda v: v >= 0)

SERVICE_SESSION_HBM_SHARE = register(
    "spark_tpu.service.session.hbmShare", 0.0,
    doc="Per-session share of the service.hbmBudget arbiter pool "
        "(fraction, 0 < share <= 1): one session's residency leases may "
        "not exceed share * hbmBudget bytes in total. A scan whose lease "
        "would push its session past the share is denied at once "
        "(counted in session_quota_rejections) and streams or spills; "
        "the rest of the pool stays available to other sessions. 0 "
        "disables the share cap.",
    validator=lambda v: 0 <= v <= 1)

SERVICE_ID_PREFIX = register(
    "spark_tpu.service.idPrefix", "",
    doc="Namespace prefix for service query ids (q-<prefix><seq>). "
        "Empty for a standalone service; the fleet supervisor "
        "(service/fleet.py) sets 'w<idx>g<gen>-' per worker so the "
        "router can map an id back to the worker (and generation) "
        "that owns its record.")

FLEET_WORKERS = register(
    "spark_tpu.service.fleet.workers", 2,
    doc="Number of SqlService worker subprocesses the fleet "
        "supervisor (service/fleet.py) runs. Each worker binds an "
        "ephemeral loopback port and holds its own CUDA context on the "
        "fleet's device; a respawned worker is ready as soon as its "
        "service starts (the port has no compile cache to replay).",
    validator=lambda v: v >= 1)

FLEET_RESTART_MAX_PER_WINDOW = register(
    "spark_tpu.service.fleet.restartMaxPerWindow", 3,
    doc="Flap breaker: a worker crashing this many times within "
        "fleet.restartWindowMs is QUARANTINED -- no further restarts, "
        "its ring share re-homes to the surviving workers and excess "
        "load sheds through their admission 429/503 bounds (graceful "
        "degradation, never a hang).",
    validator=lambda v: v >= 1)

FLEET_RESTART_WINDOW_MS = register(
    "spark_tpu.service.fleet.restartWindowMs", 60000,
    doc="Flap-breaker crash-counting window (milliseconds) for "
        "fleet.restartMaxPerWindow.",
    validator=lambda v: v >= 1)

FLEET_RESTART_BACKOFF_MS = register(
    "spark_tpu.service.fleet.restartBackoffMs", 200,
    doc="Base delay of the worker-restart exponential-backoff ladder "
        "(the execution RetryPolicy reused supervisor-side): crash n "
        "within a window waits ~backoff * 2^n (jittered) before the "
        "respawn.",
    validator=lambda v: v >= 0)

FLEET_DRAIN_TIMEOUT_MS = register(
    "spark_tpu.service.fleet.drainTimeoutMs", 10000,
    doc="Bounded drain budget (milliseconds): on SIGTERM the fleet "
        "supervisor stops admitting (structured FLEET_DRAINING 503), "
        "waits this long for in-flight proxied requests, SIGTERMs the "
        "workers (each drains its own in-flight queries under the "
        "same bound, on top of their queryDeadlineMs budgets), then "
        "SIGKILLs stragglers. Also the default budget of "
        "SqlService.drain(), which sheds with SERVICE_DRAINING 503.",
    validator=lambda v: v >= 0)

FLEET_FAILOVER_READS = register(
    "spark_tpu.service.fleet.failoverReads", True,
    doc="Transparently retry an idempotent read query (SELECT / WITH "
        "/ VALUES / EXPLAIN / SHOW / DESCRIBE) exactly once on the "
        "re-homed worker when its worker dies mid-request -- byte "
        "parity holds because the engine is deterministic and every "
        "worker reads the same sources. Off (and for every non-read), "
        "the client gets a structured 503 WORKER_LOST instead.")

FLEET_HEALTH_INTERVAL_MS = register(
    "spark_tpu.service.fleet.healthIntervalMs", 250,
    doc="Supervisor health-check cadence (milliseconds): each tick "
        "polls worker liveness (subprocess exit + HTTP ping) and "
        "readiness (GET /healthz/ready), re-homes traffic off "
        "non-ready workers, and runs the restart ladder for due "
        "respawns.",
    validator=lambda v: v >= 10)

FLEET_SPAWN_TIMEOUT_MS = register(
    "spark_tpu.service.fleet.spawnTimeoutMs", 90000,
    doc="Budget (milliseconds) for a spawned worker to hand its port "
        "back and report ready (a CUDA context's start included); a "
        "worker exceeding it is killed and counts as a crash in the "
        "flap-breaker window.",
    validator=lambda v: v >= 1)

FLEET_PROXY_TIMEOUT_MS = register(
    "spark_tpu.service.fleet.proxyTimeoutMs", 600000,
    doc="Socket timeout (milliseconds) on one proxied worker request; "
        "queries bound their own wall-clock via queryDeadlineMs, so "
        "this is the backstop against a wedged worker socket.",
    validator=lambda v: v >= 1)

FLEET_DIR = register(
    "spark_tpu.service.fleet.dir", "",
    doc="Directory for fleet runtime artifacts: worker-death "
        "diagnostic bundles (MANIFEST.json + stderr tail per "
        "bundles/w<idx>-g<gen>-<seq>-<reason>/). Empty uses "
        "<tmpdir>/spark-tpu-fleet-<pid>.")

FLEET_INIT = register(
    "spark_tpu.service.fleet.init", "",
    doc="Worker session-init hook as an import spec "
        "('module:function'); each worker resolves it and passes the "
        "callable to SqlService(init_session=...) -- table "
        "registration must survive respawn, so it ships as a spec, "
        "not a closure. Empty for no init hook.")

SERVICE_QUERY_LOG_SIZE = register(
    "spark_tpu.service.queryLogSize", 512,
    doc="Bound on the service's in-memory query status registry "
        "(GET /queries/<id> and the GET /queries listing): oldest "
        "finished records are dropped past it.",
    validator=lambda v: v >= 1)

SERVICE_SLO_LATENCY_MS = register(
    "spark_tpu.service.slo.latencyMs", 0,
    doc="End-to-end query latency SLO target in ms. When > 0, every "
        "query end counts slo_queries_total and a query slower than the "
        "target burns slo_burned_total / slo_burn_ms_total. 0 disables "
        "burn counting (the latency histograms record regardless).",
    validator=lambda v: v >= 0)

SERVICE_HISTORY_SIZE = register(
    "spark_tpu.service.historySize", 128,
    doc="Bound on the service's in-memory per-query detail store "
        "(QueryHistoryStore, fed by the listener bus at query end): "
        "spans, stage device costs and the runtime plan tree behind GET "
        "/queries/<id>/{timeline,plan}; oldest entries drop past it.",
    validator=lambda v: v >= 1)


# -- keys of slices not yet ported ------------------------------------------

#: slice 12b ported the analyzer but not its jaxpr half (ROADMAP)
_JAXPR = ("slice 12b, whose jaxpr analyzer the eager port leaves out: no "
          "stage program exists to walk before dispatch, and the plan "
          "analyzer finds the hazards it confirms")
#: slice 12c part 2 ported the fleet and decided the compiled-stage cache
#: (`execution/compile_cache.py`): left out, as service/fleet.py says
_COMPILE_CACHE = (
    "slice 12c part 2, which leaves the compiled-stage cache out by choice: "
    "the port runs eagerly and compiles no stages; its one compiled "
    "artifact, the kernel library, is kept on disk by mtime and replaced "
    "atomically")

#: the JAX package's registered keys this port does not register yet:
#: key -> (the slice that brings it, its default there). Each slice
#: takes its own keys off this list as it registers them.
UNPORTED_KEYS: Dict[str, tuple] = {
    # only the compiled-stage cache's keys read bucketGrowth
    # (spark_tpu/execution/streaming_agg.py:45)
    "spark_tpu.sql.execution.bucketGrowth": (_COMPILE_CACHE, 2.0),
    "spark_tpu.sql.analysis.jaxpr": (_JAXPR, "auto"),
    "spark_tpu.sql.compileCache.enabled": (_COMPILE_CACHE, False),
    "spark_tpu.sql.compileCache.dir": (_COMPILE_CACHE, "spark-compile-cache"),
    "spark_tpu.sql.compileCache.maxBytes": (_COMPILE_CACHE, 1 << 30),
    "spark_tpu.sql.compileCache.warmStart": (_COMPILE_CACHE, True),
}


class UnportedConfError(ValueError):
    """A key of a slice this port has not reached (or of a part a slice
    left out) was set to a value other than its default: the port would
    ignore it, so it refuses."""


def check_unported(key: str, value: Any) -> None:
    """Raise `UnportedConfError` unless `value` is the default of the
    unported `key` (coerced to the default's type)."""
    part, default = UNPORTED_KEYS[key]
    ty = type(default)
    try:
        if ty is bool and isinstance(value, str):
            same = (value.strip().lower() in ("true", "1", "yes")) == default
        else:
            same = ty(value) == default
    except (TypeError, ValueError):
        same = False
    if not same:
        raise UnportedConfError(
            f"{key}={value!r}: this key belongs to {part}; "
            f"spark_tpu_torch does not act on it, so only its default "
            f"{default!r} may be set")
