"""SparkSession analog: catalog + conf + device + entry points (the port
of `spark_tpu/session.py`; reference: `SparkSession.scala:83`).

A session runs on one device: the current CUDA card unless the builder
asks for another (`SparkTpuSession.builder().device("cpu")`). Without a
device and without CUDA, building a session raises. At
`spark_tpu.sql.mesh.size` N > 1 a query runs on a mesh of N shards: on
cards cuda:0 to cuda:N-1 when the session was built without a device
(fewer cards raise "devices visible"), or all on the device it was built
with — the counterpart of the JAX package's virtual CPU devices. With
the `spark_tpu.sql.cluster.*` keys set, N counts every engine process's
devices (`parallel/mesh.init_distributed`): a session built without a
device brings this process's visible cards, one built with a device its
share of N virtual devices on it.

`sql(text)` parses and lowers one statement (`sql/parser.py`) to the
same logical plans the DataFrame API builds; a DDL/DML command runs at
parse time against the catalog (`catalog.py`: temp views over a
persistent Parquet warehouse under `spark_tpu.sql.warehouse.dir`).

The data cache (`result_cache.ResultCache`, keyed by plan
fingerprint) holds materialized results. `DataFrame.cache()` marks a
plan: its first action fills the cache, and later queries containing
an equal subtree read the cached table until `unpersist()`. A
WITH-clause view is marked `implicit`: the first query that reaches it
computes it once, later references in the same statement read the
result, and the data is dropped when the outermost execution ends (the
mark stays, so the statement run again computes the view once again).

Every QueryExecution takes the next query id of its session
(`df._qe().query_id`); `session.cancel(query_id)` stops that query,
running on another thread, at its next cooperative boundary
(`execution/lifecycle.py`). `session.metrics` is the session's metrics
registry (`observability/metrics.py`: replayed chunks, reused stages,
cancelled queries, prefetch stall, UDF batches, rows and worker spawns,
query counts and latency histograms). `session.listeners` is its
listener bus (`observability/listener.py`): the executor posts each
query's lifecycle events there, and the built-in subscribers — the
event log, the Chrome trace, the metrics sinks, the flight recorder
and the straggler monitor — act on them when the conf asks
(`spark_tpu.sql.eventLog.dir`, `trace.dir`, `metrics.sink`,
`flightRecorder.*`); `add_listener` subscribes a user's
`QueryListener`.

A session built with `register_active=True` (the default) becomes the
active session of the context that built it (`SparkTpuSession._active`);
`with session.as_active():` pins one for a block, and only a pinned
session is what `builder().get_or_create()` returns. Outside
`as_active()` the builder builds a new session, where the JAX package's
returns its active one. The SQL service builds its pooled sessions with
`register_active=False` and runs each query under `as_active()`, so no
pooled session becomes, or replaces, another thread's active session.

`session.udf.register(name, fn, returnType)` makes a Python function
callable from SQL (`udf.py`); `session._udf_pool` is the session's pool
of UDF worker subprocesses (`udf_worker/`), used under
`spark_tpu.sql.udf.mode=worker`.
"""

from __future__ import annotations

import contextlib
import threading
from contextvars import ContextVar
from typing import Dict, Optional, Set

import pandas as pd
import pyarrow as pa

from .catalog import Catalog
from .columnar import resolve_device
from .config import RESULT_CACHE_BYTES, Conf
from .dataframe import DataFrame
from .io.sources import ArrowTableSource, ParquetSource, TableSource
from .observability import ListenerBus, MetricsRegistry
from .observability.metrics import UDF_COUNTERS
from .observability.sinks import install_default_listeners, make_app_id
from .plan import logical as L
from .result_cache import ResultCache

#: the context-local active session: (session, pinned). A session built
#: with register_active=True becomes its context's active session
#: (unpinned); `as_active()` pins one for a block, and only a pinned
#: session is what `builder().get_or_create()` returns. Each thread
#: starts with an empty context, so no thread sees another's session.
_ACTIVE: ContextVar[Optional[tuple]] = ContextVar(
    "spark_tpu_torch_active_session", default=None)


class _ActiveSessionMeta(type):
    """`SparkTpuSession._active` reads and writes the context-local
    active session, as the JAX package's class attribute does. The port
    keeps no process-global fallback: a session one thread built is
    never another thread's active session."""

    @property
    def _active(cls) -> Optional["SparkTpuSession"]:
        cur = _ACTIVE.get()
        return None if cur is None else cur[0]

    @_active.setter
    def _active(cls, value: Optional["SparkTpuSession"]) -> None:
        _ACTIVE.set(None if value is None else (value, False))


class SparkTpuSession(metaclass=_ActiveSessionMeta):
    def __init__(self, conf: Optional[Conf] = None, device=None,
                 register_active: bool = True):
        self.conf = conf or Conf()
        self.device = resolve_device(device)
        #: built with an explicit device: a mesh then places every shard
        #: on it; without one a mesh takes cuda:0..N-1 (parallel/mesh.py)
        self.device_pinned = device is not None
        #: a pinned session's mesh pool: its mesh positions are the
        #: virtual device ids 0..mesh_pool-1, mesh_pool the largest
        #: mesh.size it ran (parallel/mesh.py)
        self.mesh_pool = 0
        self.catalog: Catalog = Catalog(self)
        # plan-fingerprint data cache (reference: CacheManager.scala):
        # the marked plans, and (below) the tables materialized for them
        self._cache_requests: Dict[str, L.LogicalPlan] = {}
        # marks whose data lives for one statement (WITH-clause views)
        self._implicit_cache_fps: Set[str] = set()
        #: subtrees replaced by a cached table (`_apply_cache`)
        self.result_cache_hits = 0
        # nesting depth of running executions (subqueries and
        # materializations run their own); the outermost one's end ends
        # the statement
        self._exec_depth = 0
        # plan + source stamps -> {kind:tag -> capacity} a converged run
        # settled on; the next execution of the plan starts from them
        self._aqe_caps: Dict[str, Dict[str, int]] = {}
        #: the session's identity in the cancel registry and the event
        #: log's file names (pid plus a random token: pid alone repeats
        #: across runs)
        self.app_id = make_app_id()
        self._query_seq = 0
        self._query_seq_lock = threading.Lock()
        # observability spine (observability/): the listener bus every
        # event-log line, trace file and metrics flush hangs off, and
        # the session's metrics registry
        self.listeners = ListenerBus()
        self.metrics = MetricsRegistry()
        # a standalone session's data cache is unbounded unless the
        # bound is set explicitly; a pooled session's is replaced by
        # the service arbiter's shared, conf-bounded one
        key = RESULT_CACHE_BYTES.key
        self._data_cache = ResultCache(
            int(self.conf.get(key)) if self.conf.is_explicitly_set(key)
            else 0, metrics=self.metrics)
        install_default_listeners(self)
        # the UDF counters (execution/python_eval.py) exist from the start,
        # so a reader sees 0 before the first UDF runs
        for name in UDF_COUNTERS:
            self.metrics.counter(name)
        from .udf import UDFRegistration
        self.udf = UDFRegistration(self)
        # out-of-process UDF worker pool (udf_worker/pool.py): created
        # eagerly (a pool object spawns nothing until first checkout);
        # bounds are refreshed from conf at each worker-mode evaluation.
        # Workers are reused across this session's queries; idle ones
        # reap after udf.pool.idleTimeoutMs, and a worker's stdin EOF
        # on process exit ends the child, so none outlives the engine.
        from .udf_worker.pool import UdfWorkerPool
        self._udf_pool = UdfWorkerPool(
            int(self.conf.get("spark_tpu.sql.udf.pool.maxWorkers")),
            float(self.conf.get("spark_tpu.sql.udf.pool.idleTimeoutMs")),
            metrics=self.metrics)
        if register_active:
            SparkTpuSession._active = self

    @contextlib.contextmanager
    def as_active(self):
        """Pin this session as the context-local active session (what
        `builder().get_or_create()` returns) for the enclosed block: the
        SQL service wraps each query in it, so a pooled session never
        becomes, or replaces, another thread's active session."""
        token = _ACTIVE.set((self, True))
        try:
            yield self
        finally:
            _ACTIVE.reset(token)

    def _next_query_id(self) -> int:
        with self._query_seq_lock:
            self._query_seq += 1
            return self._query_seq

    def add_listener(self, listener) -> None:
        """Register a QueryListener on the session bus (the
        SparkContext.addSparkListener seat)."""
        self.listeners.register(listener)

    def remove_listener(self, listener) -> None:
        self.listeners.unregister(listener)

    addListener = add_listener
    removeListener = remove_listener

    def warmup(self) -> int:
        """The JAX package's warm start replays its compile cache's
        manifest into the stage cache and returns the entries installed.
        The port compiles no stages (the compiled-stage cache is left
        out by choice, service/fleet.py), so this returns 0; on a CUDA
        session it first loads the kernel library (building it when the
        one on disk is stale), so a caller may pay that before the first
        query."""
        if self.device.type == "cuda":
            from .execution import dense_groupby
            dense_groupby._load()
        return 0

    def cancel(self, query_id: int) -> bool:
        """Request cooperative cancellation of a query executing on this
        session (the SparkContext.cancelJobGroup seat): the execution
        raises QueryCancelledError at its next boundary — a chunk, a
        stage attempt, a retry backoff, the wait for the device — and
        joins its prefetch worker. False when no execution with that id
        is registered (finished, or never started). Callable from any
        thread."""
        from .execution import lifecycle
        return lifecycle.cancel(self.app_id, query_id)

    def decommission_shards(self, shards) -> None:
        """Drain the given mesh positions gracefully (parallel/elastic.py):
        a running mesh stream checkpoints at its next chunk boundary and
        continues on the reduced gang; the drained device ids stay
        excluded for later queries. The BlockManagerDecommissioner
        seat."""
        from .parallel.elastic import decommission_shards
        decommission_shards(self, shards)

    # -- data cache -------------------------------------------------------

    @staticmethod
    def _plan_fingerprint(plan: L.LogicalPlan) -> str:
        """tree_string + each scan source's identity stamp: a Parquet
        rewrite or a re-registered table changes the fingerprint, so a
        materialization never matches stale data."""
        tokens = [s.source.cache_token() for s in L.iter_scans(plan)]
        return plan.tree_string() + f"#src{tokens!r}"

    def mark_cache(self, plan: L.LogicalPlan, implicit: bool = False) -> None:
        """Materialize `plan` wherever a query reaches it (the
        executor's `_apply_cache`). `implicit` scopes the data to one
        statement (WITH-clause views): evicted when the outermost
        execution finishes."""
        fp = self._plan_fingerprint(plan)
        self._cache_requests[fp] = plan
        if implicit:
            self._implicit_cache_fps.add(fp)

    def uncache(self, plan: L.LogicalPlan) -> None:
        fp = self._plan_fingerprint(plan)
        self._cache_requests.pop(fp, None)
        self._data_cache.pop(fp, None)
        self._implicit_cache_fps.discard(fp)

    def _evict_implicit_caches(self) -> None:
        """Statement-scoped data lifetime: drop the materialized tables
        but keep the marks, so running the same statement again still
        computes a multiply-referenced view once."""
        # over a copy: a statement on another thread may mark a view
        # meanwhile, and a set must not change size while iterated
        for fp in list(self._implicit_cache_fps):
            self._data_cache.pop(fp, None)

    # -- builder ------------------------------------------------------------

    class Builder:
        def __init__(self):
            self._conf = Conf()
            self._device = None

        def config(self, key: str, value) -> "SparkTpuSession.Builder":
            self._conf.set(key, value)
            return self

        def device(self, device) -> "SparkTpuSession.Builder":
            """'cuda', 'cuda:1', 'cpu' or a torch.device; default: the
            current CUDA card."""
            self._device = device
            return self

        def get_or_create(self) -> "SparkTpuSession":
            """The session `as_active()` pinned in this context, else a
            new session. The JAX package's builder returns its active
            session, which any session built before becomes; the port's
            builds a new one outside `as_active()`, since its tests and
            entry points build CPU and CUDA sessions side by side."""
            cur = _ACTIVE.get()
            if cur is not None and cur[1]:
                return cur[0]
            return SparkTpuSession(self._conf, self._device)

        getOrCreate = get_or_create

    @classmethod
    def builder(cls) -> "SparkTpuSession.Builder":
        return cls.Builder()

    # -- entry points -------------------------------------------------------

    def range(self, start: int, end: Optional[int] = None,
              step: int = 1) -> DataFrame:
        if end is None:
            start, end = 0, start
        return DataFrame(self, L.Range(int(start), int(end), int(step)))

    def create_dataframe(self, data, name: str = "df") -> DataFrame:
        if isinstance(data, pd.DataFrame):
            table = pa.Table.from_pandas(data, preserve_index=False)
        elif isinstance(data, pa.Table):
            table = data
        elif isinstance(data, dict):
            table = pa.table(data)
        else:
            raise TypeError(f"cannot create DataFrame from {type(data)}")
        return DataFrame(self, L.Scan(ArrowTableSource(name, table)))

    createDataFrame = create_dataframe

    def register_table(self, name: str, source_or_table) -> None:
        # marks over the replaced table can never match again (its
        # source stamp is gone): drop them and their data
        for fp, plan in list(self._cache_requests.items()):
            if any(s.source.name == name for s in L.iter_scans(plan)):
                del self._cache_requests[fp]
                self._data_cache.pop(fp, None)
                self._implicit_cache_fps.discard(fp)
        # free the replaced source's device-resident batches: no key can
        # reach them under the new source's stamp
        old = self.catalog.get(name)
        if old is not None:
            token = old.cache_token()
            if token is not None:
                from .io.device_cache import CACHE
                CACHE.invalidate_token(token)
        if isinstance(source_or_table, TableSource):
            self.catalog[name] = source_or_table
        elif isinstance(source_or_table, pa.Table):
            self.catalog[name] = ArrowTableSource(name, source_or_table)
        elif isinstance(source_or_table, pd.DataFrame):
            self.catalog[name] = ArrowTableSource(
                name, pa.Table.from_pandas(source_or_table,
                                           preserve_index=False))
        elif isinstance(source_or_table, DataFrame):
            self.catalog[name] = ArrowTableSource(
                name, source_or_table.collect())
        else:
            raise TypeError(f"cannot register {type(source_or_table)}")

    def table(self, name: str) -> DataFrame:
        if name not in self.catalog:
            raise KeyError(f"table {name!r} not found; "
                           f"known: {sorted(self.catalog)}")
        return DataFrame(self, L.Scan(self.catalog[name]))

    def read_parquet(self, path: str, name: Optional[str] = None) -> DataFrame:
        return DataFrame(self, L.Scan(ParquetSource(path, name)))

    def read_csv(self, path: str, name: Optional[str] = None,
                 **options) -> DataFrame:
        from .io.sources import CsvSource
        return DataFrame(self, L.Scan(CsvSource(path, name, **options)))

    def read_json(self, path: str, name: Optional[str] = None) -> DataFrame:
        from .io.sources import JsonSource
        return DataFrame(self, L.Scan(JsonSource(path, name)))

    def file_stream(self, path: str, schema_df=None,
                    format: str = "parquet"):
        """Directory-tailing streaming source (the readStream analog):
        returns a FileStreamSource whose `.to_df()` feeds
        `DataFrame.write_stream`. Offsets are a persisted seen-file
        log under the query's checkpoint; corrupt files quarantine
        instead of wedging the stream (see
        spark_tpu.streaming.source.file.strict)."""
        from .streaming import FileStreamSource
        return FileStreamSource(self, path, schema_df=schema_df,
                                format=format)

    def network_stream(self, host: str, port: int, schema_df):
        """Socket streaming source (io/network_source.py): length-
        framed Arrow-IPC record batches over TCP, each frame persisted
        under the query's checkpoint BEFORE it becomes a visible
        offset, with a reconnect/backoff ladder (see the
        spark_tpu.streaming.source.network.* keys). `schema_df` is a
        pandas frame or an Arrow schema or table
        (`streaming.empty_table`). Returns a NetworkStreamSource whose
        `.to_df()` feeds `DataFrame.write_stream`."""
        from .io.network_source import NetworkStreamSource
        return NetworkStreamSource(self, host, port, schema_df)

    def long_accumulator(self, name: str = "acc") -> "Accumulator":
        return Accumulator(name, 0)

    def double_accumulator(self, name: str = "acc") -> "Accumulator":
        return Accumulator(name, 0.0)

    longAccumulator = long_accumulator
    doubleAccumulator = double_accumulator

    def sql(self, query: str) -> DataFrame:
        """Parse and lower one SQL statement against the catalog (the
        reference's `SparkSession.sql:613`). The parse is the `parse`
        span and phase time of the DataFrame's first execution (and a
        profiler range while it runs)."""
        from .observability.spans import program_range
        from .sql.parser import parse_sql
        with program_range("parse") as parse:
            plan = parse_sql(query, self)
        df = DataFrame(self, plan)
        df._parsed = (parse.t0, parse.t1)
        return df


class Accumulator:
    """Host-side mergeable counter (reference: AccumulatorV2.scala:44):
    updates are plain in-process adds."""

    def __init__(self, name: str, value=0):
        self.name = name
        self._value = value

    def add(self, v) -> None:
        self._value += v

    @property
    def value(self):
        return self._value

    def reset(self) -> None:
        self._value = type(self._value)()

    def __repr__(self):
        return f"Accumulator({self.name}={self._value!r})"
