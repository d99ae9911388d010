"""Table sources: the host -> device ingest edge.

The port of the whole-table half of `spark_tpu/io/sources.py`
(reference: DataSource V2 `ScanBuilder` with `SupportsPushDownFilters` /
`SupportsPushDownRequiredColumns`, and `VectorizedParquetRecordReader.java:54`):
the C++ Arrow/Parquet reader does columnar decode plus predicate and
column pushdown on the host, then `Batch.from_arrow` dictionary-encodes,
pads and copies the columns to the device. CSV and line-delimited JSON
are read eagerly into Arrow tables. A scan loads whole (`load`), or in
chunks (`load_chunks`) for the out-of-core loops
(`execution/streaming_agg.py`, `execution/external.py`): a
`ChunkIterator` cuts the record-batch stream into chunks of one bucketed
capacity, a `DictUnifier` grows one dictionary per string column across
them, and `PrefetchChunkIterator` decodes chunk N+1 on a worker thread
while chunk N computes (`spark_tpu.sql.ingest.prefetch`). The worker
only decodes on the host; the copy to the device stays on the consuming
thread. `list_stream_files` and `decode_stream_file` are the file
stream source's IO half (streaming.py holds its offsets).

Sources also report statistics without loading rows: a row estimate,
per-column min/max (`column_stats`, from Parquet footers, which the join
reorder's cost model reads) and an identity stamp (`cache_token`, which
keys statement-scoped materializations, the device table cache and the
capacities kept across executions).
"""

from __future__ import annotations

import itertools
import os
import time
from typing import List, Optional, Sequence

import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.dataset as pa_dataset

from .. import types as T
from ..columnar import Batch
from ..expr import (And, BinaryComparison, ColumnRef, EQ, Expression, GE, GT,
                    In, IsNull, LE, LT, Literal, NE, Not, Or)


def _decimal_literal_scalar(col_field: pa.Field, value):
    """Coerce a numeric literal to the column's decimal type for a pushed
    comparison — pyarrow cannot compare decimal to float64. Returns None
    when the value is not exactly representable at the column's scale
    (the conjunct then stays residual-only)."""
    import decimal as D
    if not isinstance(value, (int, float)) or isinstance(value, bool):
        return None
    d = D.Decimal(str(value))
    q = d.quantize(D.Decimal(1).scaleb(-col_field.type.scale))
    if q != d:
        return None  # rounding would change the predicate
    return pa.scalar(q, type=col_field.type)


def expr_to_arrow(e: Expression, schema: Optional[pa.Schema] = None):
    """Convert a pushable predicate to a pyarrow.dataset expression.
    Returns None when not convertible (the conjunct stays residual)."""
    if isinstance(e, ColumnRef):
        return pc.field(e._name)
    if isinstance(e, Literal):
        v = e.value
        if isinstance(e._dtype, T.DateType):
            import datetime
            # date literals carry epoch days or a datetime.date
            if not isinstance(v, datetime.date):
                v = datetime.date(1970, 1, 1) + \
                    datetime.timedelta(days=int(v))
        return pa.scalar(v) if not isinstance(v, Expression) else None
    if isinstance(e, BinaryComparison):
        le, re = e.children
        l = expr_to_arrow(le, schema)
        r = expr_to_arrow(re, schema)
        if l is None or r is None:
            return None
        # decimal column vs numeric literal: coerce the literal
        if schema is not None:
            for col_e, is_left in ((le, True), (re, False)):
                lit_e = re if is_left else le
                if isinstance(col_e, ColumnRef) and isinstance(lit_e, Literal):
                    idx = schema.get_field_index(col_e._name)
                    if idx >= 0 and pa.types.is_decimal(schema.field(idx).type):
                        s = _decimal_literal_scalar(schema.field(idx),
                                                    lit_e.value)
                        if s is None:
                            return None
                        if is_left:
                            r = s
                        else:
                            l = s
        ops = {EQ: lambda a, b: a == b, NE: lambda a, b: a != b,
               LT: lambda a, b: a < b, LE: lambda a, b: a <= b,
               GT: lambda a, b: a > b, GE: lambda a, b: a >= b}
        return ops[type(e)](l, r)
    if isinstance(e, And):
        l, r = (expr_to_arrow(c, schema) for c in e.children)
        return None if l is None or r is None else l & r
    if isinstance(e, Or):
        l, r = (expr_to_arrow(c, schema) for c in e.children)
        return None if l is None or r is None else l | r
    if isinstance(e, Not):
        c = expr_to_arrow(e.children[0], schema)
        return None if c is None else ~c
    if isinstance(e, In):
        c = expr_to_arrow(e.children[0], schema)
        return None if c is None else c.isin(list(e.values))
    if isinstance(e, IsNull):
        c = expr_to_arrow(e.children[0], schema)
        return None if c is None else c.is_null()
    return None


class TableSource:
    name: str = "<source>"

    def schema(self) -> T.Schema:
        raise NotImplementedError

    def can_push(self, e: Expression) -> bool:
        return False

    def load(self, required_columns: Optional[Sequence[str]],
             pushed_filters: Sequence[Expression], device) -> Batch:
        raise NotImplementedError

    def estimated_rows(self) -> Optional[int]:
        return None

    def column_stats(self) -> Optional[dict]:
        """Per-column statistics, `{name: {"min", "max", "null_count",
        "row_groups"}}`, or None when unavailable. Advisory only: min/max
        bound the whole dataset, so consumers may use them to narrow
        estimates, never for correctness."""
        return None

    def cache_token(self):
        """Identity stamp of the data; None = unknown. Changes whenever
        the underlying data can differ."""
        return None


def _cached_schema(source, data) -> T.Schema:
    """The engine schema of `data` (an Arrow table or dataset), kept on
    the source while it holds the same object: planning asks a scan for
    its schema at every node above it, and the plan-integrity validator
    asks again after every rule, so converting each time dominated
    validated planning."""
    kept = getattr(source, "_engine_schema", None)
    if kept is None or kept[0] is not data:
        kept = source._engine_schema = (
            data, _arrow_schema_to_engine(data.schema))
    return kept[1]


def _arrow_schema_to_engine(schema: pa.Schema) -> T.Schema:
    from ..columnar import _ARROW_TO_DTYPE
    fields = []
    for f in schema:
        at = f.type
        if pa.types.is_string(at) or pa.types.is_large_string(at) or \
                pa.types.is_dictionary(at) or pa.types.is_null(at):
            dt: T.DataType = T.STRING
        elif pa.types.is_decimal(at):
            dt = T.DecimalType(at.precision, at.scale)
        elif pa.types.is_timestamp(at):
            dt = T.TIMESTAMP
        elif at == pa.date32():
            dt = T.DATE
        elif pa.types.is_list(at) or pa.types.is_large_list(at):
            elem = _arrow_schema_to_engine(
                pa.schema([pa.field("e", at.value_type)])).fields[0]
            dt = T.ArrayType(elem.dtype)
        else:
            dt = _ARROW_TO_DTYPE.get(at)
            if dt is None:
                raise TypeError(f"unsupported arrow type {at} ({f.name})")
        fields.append(T.Field(f.name, dt, f.nullable))
    return T.Schema(fields)


def _pushed_expression(pushed_filters, schema: pa.Schema):
    ae = None
    for f in pushed_filters:
        e = expr_to_arrow(f, schema)
        if e is not None:
            ae = e if ae is None else (ae & e)
    return ae


class DictUnifier:
    """Grows one global dictionary per string column across chunks so
    device codes are comparable between chunks (append-only: codes handed
    out earlier stay valid). The analog of the reference's per-column
    dictionary pages resolved to one dictionary at read time."""

    def __init__(self):
        self.dicts = {}

    def unify(self, table: pa.Table, stop=None) -> pa.Table:
        """`table` with every string column coded against the global
        dictionaries. `stop`, an Event, ends the work between columns
        (a prefetcher's close())."""
        if table.num_columns == 0:
            return table  # pa.table([]) would drop the row count
        cols = []
        for name, col in zip(table.column_names, table.columns):
            if stop is not None and stop.is_set():
                raise RuntimeError("chunk ingest stopped by close()")
            arr = col.combine_chunks() if isinstance(col, pa.ChunkedArray) \
                else col
            at = arr.type
            if pa.types.is_string(at) or pa.types.is_large_string(at):
                arr = arr.cast(pa.string()).dictionary_encode()
                at = arr.type
            if pa.types.is_dictionary(at):
                chunk_dict = arr.dictionary.cast(pa.string())
                glob = self.dicts.get(name)
                if glob is None:
                    glob = chunk_dict
                else:
                    present = pc.index_in(chunk_dict, value_set=glob)
                    new_mask = pc.is_null(present)
                    if pc.any(new_mask).as_py():
                        new_vals = pc.filter(chunk_dict, new_mask)
                        glob = pa.concat_arrays([glob, new_vals])
                self.dicts[name] = glob
                mapping = pc.index_in(chunk_dict, value_set=glob) \
                    .cast(pa.int32())
                codes = mapping.take(arr.indices)
                arr = pa.DictionaryArray.from_arrays(codes, glob)
            cols.append(arr)
        return pa.table(cols, names=table.column_names)


class ChunkIterator:
    """Single-pass iterator of uniform-capacity Batches on `device` over a
    record-batch stream; `.dictionaries` holds the global dictionaries.
    Every chunk gets the capacity `bucket_capacity(chunk_rows)`, so the
    loops see one shape. `decode_s` and `copy_s` keep each chunk's host
    decode (read, slice, dictionary unify) and copy-to-device seconds."""

    def __init__(self, batches_iter, chunk_rows: int, device):
        self._batches = batches_iter
        self._chunk_rows = chunk_rows
        self._device = device
        self._capacity = None
        self._pending = []
        self._pending_rows = 0
        self._done = False
        self._failed: Optional[BaseException] = None
        self._unifier = DictUnifier()
        self.decode_s: List[float] = []
        self.copy_s: List[float] = []
        #: set by a prefetcher's close(): its worker stops at the next
        #: record batch or column instead of decoding the chunk to its end
        self.stop = None

    @property
    def dictionaries(self):
        return self._unifier.dicts

    def __iter__(self):
        return self

    def _fill(self) -> None:
        if self._failed is not None:
            # the reader raised mid-stream, and a generator dies when an
            # exception passes through it: reading on would see the
            # buffered prefix as the whole stream. Poison the iterator
            # instead, so the whole-query ladder restarts the stream.
            raise self._failed
        while not self._done and self._pending_rows < self._chunk_rows:
            if self.stop is not None and self.stop.is_set():
                raise RuntimeError("chunk ingest stopped by close()")
            try:
                rb = next(self._batches)
            except StopIteration:
                self._done = True
                break
            except Exception as e:
                self._failed = e
                raise
            self._pending.append(rb)
            self._pending_rows += rb.num_rows

    def _take_chunk(self) -> Optional[pa.Table]:
        """One chunk's Arrow slice off the stream (shared by __next__ and
        skip_chunks, so both cut the same boundaries), or None at the end
        of the stream."""
        self._fill()
        if self._pending_rows == 0:
            return None
        take = min(self._pending_rows, self._chunk_rows)
        if all(rb.num_columns == 0 for rb in self._pending):
            # a scan that prunes every column (count(*)): pyarrow drops
            # the row count of column-less batches it combines, so the
            # rows are counted here
            self._pending = []
            self._pending_rows -= take
            return pa.table({"_": pa.nulls(take)}).select([])
        table = pa.Table.from_batches(self._pending)
        chunk = table.slice(0, take)
        rest = table.slice(take)
        self._pending = rest.to_batches() if rest.num_rows else []
        self._pending_rows = rest.num_rows
        return chunk

    def skip_chunks(self, n: int) -> int:
        """Advance past the next `n` chunks without unifying
        dictionaries or copying to the device; returns how many chunks
        were skipped (fewer when the stream ends first)."""
        skipped = 0
        while skipped < int(n):
            if self._take_chunk() is None:
                break
            skipped += 1
        return skipped

    def _host_next(self) -> Optional[pa.Table]:
        """One decoded, dictionary-unified host chunk, or None at the end
        of the stream: all the per-chunk host work (what the prefetcher
        overlaps with device compute)."""
        t0 = time.perf_counter()
        chunk = self._take_chunk()
        if chunk is None:
            return None
        if self._capacity is None:
            from ..columnar import bucket_capacity
            self._capacity = bucket_capacity(self._chunk_rows)
        out = self._unifier.unify(chunk, self.stop)
        self.decode_s.append(time.perf_counter() - t0)
        return out

    def _to_device(self, chunk: pa.Table) -> Batch:
        from ..execution import lifecycle
        tok = lifecycle.current_token()
        # the token is checked directly, not through lifecycle.checkpoint,
        # whose cancel_point seam counts chunk boundaries only
        check = None if tok is None else (lambda: tok.check("chunk_copy"))
        t0 = time.perf_counter()
        b = Batch.from_arrow(chunk, self._device, capacity=self._capacity,
                             check=check)
        self.copy_s.append(time.perf_counter() - t0)
        return b

    def __next__(self) -> Batch:
        chunk = self._host_next()
        if chunk is None:
            raise StopIteration
        return self._to_device(chunk)


_SOURCE_TOKENS = itertools.count()


class ArrowTableSource(TableSource):
    """In-memory table (the reference's LocalRelation / InMemoryRelation)."""

    #: row bound above which in-memory stats are skipped: unlike a
    #: Parquet footer read, computing them scans whole columns
    _STATS_MAX_ROWS = 1 << 22

    def __init__(self, name: str, table: pa.Table):
        self.name = name
        self.table = table
        # fresh per-source stamp: re-registering a name builds a new
        # source object
        self._cache_token = ("arrow", next(_SOURCE_TOKENS))
        self._column_stats: Optional[dict] = None

    def cache_token(self):
        return self._cache_token

    def column_stats(self) -> Optional[dict]:
        """In-memory analog of the Parquet footer read: one min/max pass
        per numeric or date column, cached per source; none past
        _STATS_MAX_ROWS rows."""
        if self._column_stats is not None:
            return self._column_stats
        stats: dict = {}
        if self.table.num_rows <= self._STATS_MAX_ROWS:
            for name, col in zip(self.table.column_names,
                                 self.table.columns):
                at = col.type
                if not (pa.types.is_integer(at) or pa.types.is_floating(at)
                        or pa.types.is_decimal(at) or at == pa.date32()):
                    continue
                try:
                    mm = pc.min_max(col)
                    lo, hi = mm["min"].as_py(), mm["max"].as_py()
                except Exception:  # noqa: BLE001 — stats are advisory
                    continue
                if lo is None or hi is None:
                    continue
                stats[name] = {"min": lo, "max": hi,
                               "null_count": col.null_count,
                               "row_groups": 1}
        self._column_stats = stats
        return stats

    def schema(self) -> T.Schema:
        return _cached_schema(self, self.table)

    def can_push(self, e: Expression) -> bool:
        return expr_to_arrow(e, self.table.schema) is not None

    def estimated_rows(self):
        return self.table.num_rows

    def _pruned(self, required_columns, pushed_filters) -> pa.Table:
        t = self.table
        ae = _pushed_expression(pushed_filters, self.table.schema)
        if ae is not None:
            t = t.filter(ae)
        if required_columns is not None:
            t = t.select(list(required_columns))
        return t

    def load(self, required_columns, pushed_filters, device) -> Batch:
        from ..testing import faults
        faults.fire("scan_load")  # fault seam: host -> device ingest edge
        return Batch.from_arrow(
            self._pruned(required_columns, pushed_filters), device)

    def load_chunks(self, required_columns, pushed_filters,
                    chunk_rows: int, device) -> ChunkIterator:
        t = self._pruned(required_columns, pushed_filters)
        return ChunkIterator(iter(t.to_batches()), chunk_rows, device)


class CsvSource(ArrowTableSource):
    """CSV via the C++ Arrow reader (reference: csv/CSVFileFormat +
    UnivocityParser; here native decode + dictionary-encoding happen
    before any bytes reach the device). Eagerly read: CSV has no
    row-group skipping, so pushdown happens post-parse in Arrow."""

    def __init__(self, path: str, name: Optional[str] = None, **options):
        import pyarrow.csv as pa_csv
        parse = pa_csv.ParseOptions(
            delimiter=options.get("sep", options.get("delimiter", ",")))
        read = pa_csv.ReadOptions(
            autogenerate_column_names=not options.get("header", True))
        table = pa_csv.read_csv(path, parse_options=parse,
                                read_options=read)
        super().__init__(name or os.path.basename(path).split(".")[0],
                         table)


class JsonSource(ArrowTableSource):
    """Line-delimited JSON via the C++ Arrow reader (reference:
    json/JsonFileFormat + JacksonParser)."""

    def __init__(self, path: str, name: Optional[str] = None):
        import pyarrow.json as pa_json
        table = pa_json.read_json(path)
        super().__init__(name or os.path.basename(path).split(".")[0],
                         table)


class ParquetSource(TableSource):
    """Parquet directory/file via the C++ Arrow dataset reader: column
    pruning and row-group predicate skipping happen in native code before
    any bytes reach the device."""

    def __init__(self, path: str, name: Optional[str] = None):
        self.path = path
        self.name = name or os.path.basename(path).split(".")[0]
        self._dataset = pa_dataset.dataset(path, format="parquet")
        self._column_stats: Optional[dict] = None

    def schema(self) -> T.Schema:
        return _cached_schema(self, self._dataset)

    def can_push(self, e: Expression) -> bool:
        return expr_to_arrow(e, self._dataset.schema) is not None

    def estimated_rows(self):
        try:
            return sum(f.metadata.num_rows for f in self._dataset.get_fragments())
        except Exception:
            return None

    def column_stats(self) -> Optional[dict]:
        """Per-column min/max and null/row-group counts merged across
        every fragment's footer row-group statistics (no row data is
        read). Cached per source. A column missing min/max in any row
        group is omitted (a partial bound is not a bound)."""
        if self._column_stats is not None:
            return self._column_stats
        stats: dict = {}
        dropped = set()
        n_groups = 0
        try:
            for frag in self._dataset.get_fragments():
                md = frag.metadata
                for rg in range(md.num_row_groups):
                    n_groups += 1
                    rgm = md.row_group(rg)
                    for ci in range(rgm.num_columns):
                        col = rgm.column(ci)
                        name = col.path_in_schema
                        st = col.statistics
                        if name in dropped:
                            continue
                        if st is None or not st.has_min_max:
                            dropped.add(name)
                            stats.pop(name, None)
                            continue
                        cur = stats.get(name)
                        nulls = st.null_count if st.has_null_count \
                            else None
                        if cur is None:
                            stats[name] = {"min": st.min, "max": st.max,
                                           "null_count": nulls,
                                           "row_groups": 1}
                        else:
                            cur["min"] = min(cur["min"], st.min)
                            cur["max"] = max(cur["max"], st.max)
                            if nulls is None:
                                cur["null_count"] = None
                            elif cur["null_count"] is not None:
                                cur["null_count"] += nulls
                            cur["row_groups"] += 1
        except Exception:  # noqa: BLE001 — stats are advisory
            self._column_stats = {}
            return self._column_stats
        # a column absent from some row group has no dataset-wide bound
        self._column_stats = {name: st for name, st in stats.items()
                              if st["row_groups"] == n_groups}
        return self._column_stats

    def cache_token(self):
        """(path, per-file (size, mtime_ns)) stamp: rewriting any file in
        the dataset changes it."""
        stamps = []
        try:
            for f in self._dataset.files:
                st = os.stat(f)
                stamps.append((f, st.st_size, st.st_mtime_ns))
        except OSError:
            return None
        return ("parquet", self.path, tuple(stamps))

    def load(self, required_columns, pushed_filters, device) -> Batch:
        from ..testing import faults
        faults.fire("scan_load")  # fault seam: host -> device ingest edge
        t = self._dataset.to_table(
            columns=list(required_columns) if required_columns is not None else None,
            filter=_pushed_expression(pushed_filters, self._dataset.schema))
        return Batch.from_arrow(t, device)

    def load_chunks(self, required_columns, pushed_filters,
                    chunk_rows: int, device) -> ChunkIterator:
        scanner = self._dataset.scanner(
            columns=list(required_columns) if required_columns is not None else None,
            filter=_pushed_expression(pushed_filters, self._dataset.schema),
            batch_size=min(chunk_rows, 1 << 20))
        return ChunkIterator(scanner.to_batches(), chunk_rows, device)


# ---------------------------------------------------------------------------
# Double-buffered ingest: host decode of chunk N+1 overlaps chunk N's
# device compute
# ---------------------------------------------------------------------------

INGEST_PREFETCH_KEY = "spark_tpu.sql.ingest.prefetch"


class PrefetchChunkIterator:
    """Double-buffered wrapper over a ChunkIterator: a worker thread
    decodes and dictionary-unifies chunk N+1 into host buffers
    (`ChunkIterator._host_next`; pyarrow releases the GIL, so the decode
    overlaps the consumer) while the consumer computes chunk N. One chunk
    in flight (a size-1 queue). The copy to the device stays on the
    consuming thread, so the CUDA stream, device residency and the
    per-chunk retry semantics are those of the plain iterator.

    The worker runs each decode under the per-chunk retry path of the
    compute steps (`ChunkRetrier` with the `ingest_prefetch` seam): a
    transient fault replays one chunk's decode; a real reader failure
    poisons the inner iterator and surfaces on the consumer thread.
    `close()` joins the worker, and every chunk loop calls it on every exit
    (end, fallback, fault, cancel); the worker then stops at its next
    record batch, and a consumer waiting for a chunk checks the cancel
    token as it waits. `wait_s` keeps the consumer's wait for each
    decoded chunk (its stall); the session counters `ingest_stall_ms`
    and `ingest_overlap_ms` sum the stall and the decode time it hid."""

    def __init__(self, inner: ChunkIterator, conf, recovery=None,
                 metrics=None):
        import queue as _queue
        import threading
        import weakref
        from ..execution.recovery import ChunkRetrier
        self._inner = inner
        self._retrier = ChunkRetrier(conf, recovery, site="ingest_prefetch")
        self._metrics = metrics
        self._started = False
        self._closed = False
        self._queue: "_queue.Queue" = _queue.Queue(maxsize=1)
        # the worker gets this event, never `self`: an iterator dropped
        # without close() becomes unreachable, the finalizer fires and
        # the worker exits instead of spinning on its full queue
        self._stop = threading.Event()
        self._finalizer = weakref.finalize(self, self._stop.set)
        inner.stop = self._stop
        self._thread: "threading.Thread | None" = None
        self.wait_s: List[float] = []
        #: the chunk index the worker starts at (past skipped chunks)
        self._chunk = 0

    @property
    def dictionaries(self):
        return self._inner.dictionaries

    @property
    def decode_s(self) -> List[float]:
        return self._inner.decode_s

    @property
    def copy_s(self) -> List[float]:
        return self._inner.copy_s

    def skip_chunks(self, n: int) -> int:
        """The checkpoint restore's cursor advance: valid only before the
        worker starts (the loops skip right after opening the stream);
        afterwards the worker may hold a decoded chunk, so it raises."""
        if self._started:
            raise RuntimeError("skip_chunks after prefetch started")
        skipped = self._inner.skip_chunks(n)
        self._chunk += skipped
        return skipped

    def __iter__(self):
        return self

    @staticmethod
    def _worker(host_next, retrier, q, stop, chunk) -> None:
        # a staticmethod over plain arguments: a reference to the
        # iterator would keep it reachable and its finalizer could never
        # fire
        import queue as _queue
        while not stop.is_set():
            t0 = time.perf_counter()
            try:
                item = ("ok", retrier.run(host_next, chunk=chunk),
                        time.perf_counter() - t0)
            except BaseException as e:  # noqa: BLE001 — relayed verbatim
                item = ("err", e, 0.0)
            # a bounded put that notices close(): the worker must not
            # strand on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    break
                except _queue.Full:
                    continue
            if item[0] == "err" or item[1] is None:
                return
            chunk += 1

    def _get(self):
        """The next queue item. With a cancel token installed the wait
        runs in short slices, each checking the token, so a cancel or a
        deadline lands while the consumer waits for a decode."""
        import queue as _queue
        from ..execution import lifecycle
        tok = lifecycle.current_token()
        if tok is None:
            return self._queue.get()
        while True:
            try:
                return self._queue.get(timeout=lifecycle.wait_slice(None))
            except _queue.Empty:
                tok.check("prefetch_wait")

    def __next__(self) -> Batch:
        import threading
        if self._closed:
            raise StopIteration
        if not self._started:
            self._started = True
            self._thread = threading.Thread(
                target=self._worker, daemon=True,
                name="spark-tpu-torch-ingest-prefetch",
                args=(self._inner._host_next, self._retrier,
                      self._queue, self._stop, self._chunk))
            self._thread.start()
        t0 = time.perf_counter()
        kind, payload, decode_s = self._get()
        stall_s = time.perf_counter() - t0
        if kind == "err":
            self._closed = True
            raise payload
        if payload is None:
            self._closed = True
            raise StopIteration
        self.wait_s.append(stall_s)
        if self._metrics is not None:
            self._metrics.counter("ingest_stall_ms").inc(
                round(stall_s * 1e3, 3))
            self._metrics.counter("ingest_overlap_ms").inc(
                round(max(0.0, decode_s - stall_s) * 1e3, 3))
        return self._inner._to_device(payload)

    def close(self, timeout_s: float = 5.0) -> None:
        """Stop the worker and join it (bounded). The queue is drained
        first, so a worker blocked mid-put wakes at once."""
        self._closed = True
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            import queue as _queue
            try:
                while True:
                    self._queue.get_nowait()
            except _queue.Empty:
                pass
            t.join(timeout_s)
            if t.is_alive():
                import warnings
                warnings.warn(
                    f"ingest-prefetch worker failed to exit within "
                    f"{timeout_s}s of close()")
        self._thread = None


def maybe_prefetch(chunks, conf, recovery=None):
    """Wrap a chunk stream in the double-buffered prefetcher when
    `spark_tpu.sql.ingest.prefetch` is on: the one entry every chunk
    loop routes its `load_chunks` result through."""
    if not isinstance(chunks, ChunkIterator):
        return chunks
    if not bool(conf.get(INGEST_PREFETCH_KEY)):
        return chunks
    metrics = getattr(recovery, "metrics", None)
    return PrefetchChunkIterator(chunks, conf, recovery=recovery,
                                 metrics=metrics)


# ---------------------------------------------------------------------------
# File stream source helpers (the FileStreamSource half that belongs to
# the IO layer: directory listing + per-file decode; the offset/seen-log
# machinery lives with the micro-batch loop in streaming.py)
# ---------------------------------------------------------------------------


def list_stream_files(path: str) -> list:
    """Data files under `path` ordered by (mtime_ns, name) — the
    FileStreamSource discovery order (the reference sorts its seen-map
    candidates by modification time too, `FileStreamSource.scala`).
    Hidden files, `_`-prefixed metadata (the sink's `_metadata/`
    manifest dir, `_SUCCESS` markers) and `.tmp`/`.crc` in-flight
    names are not data."""
    entries = []
    try:
        names = os.listdir(path)
    except OSError:
        return entries
    for name in names:
        if name.startswith((".", "_")) or \
                name.endswith((".tmp", ".crc")):
            continue
        full = os.path.join(path, name)
        try:
            st = os.stat(full)
        except OSError:
            continue  # vanished between listdir and stat
        if not os.path.isfile(full):
            continue
        entries.append({"name": name, "mtime_ns": int(st.st_mtime_ns),
                        "size": int(st.st_size)})
    entries.sort(key=lambda e: (e["mtime_ns"], e["name"]))
    return entries


def decode_stream_file(path: str, fmt: str) -> pa.Table:
    """One stream file -> Arrow table via the native readers. Raises on
    any decode failure (torn/partial writes, wrong format) — the
    caller quarantines or fails per
    spark_tpu.streaming.source.file.strict."""
    if fmt == "parquet":
        import pyarrow.parquet as pq
        return pq.read_table(path)
    if fmt == "csv":
        import pyarrow.csv as pa_csv
        return pa_csv.read_csv(path)
    if fmt == "json":
        import pyarrow.json as pa_json
        return pa_json.read_json(path)
    raise ValueError(f"unsupported stream file format {fmt!r} "
                     f"(parquet, csv, json)")
