"""Declarative configuration registry (the port's copy of the
`spark_tpu/config.py` registry, holding the keys this engine reads).

A single module-level registry of typed entries with defaults/docs/
validators, overlaid by a per-session mutable map that is runtime-
settable (reference: `SparkConf.scala:54` + `ConfigEntry.scala:74` +
`SQLConf.scala:56`). Key names match the JAX package, so a conf set in a
test means the same thing in both engines.
"""

from __future__ import annotations

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
    open string map; known keys are validated and coerced.
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
        self._settings[key] = value
        return self

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
        "keys toward the true build keys — pruning stays sound.")

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
        "for cache()-marked plans, LRU-evicted past the bound. A session "
        "keeps an unbounded cache unless this key is set explicitly.")
