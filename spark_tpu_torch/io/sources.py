"""Table sources: the host -> device ingest edge.

The port of the whole-table half of `spark_tpu/io/sources.py`
(reference: DataSource V2 `ScanBuilder` with `SupportsPushDownFilters` /
`SupportsPushDownRequiredColumns`, and `VectorizedParquetRecordReader.java:54`):
the C++ Arrow/Parquet reader does columnar decode plus predicate and
column pushdown on the host, then `Batch.from_arrow` dictionary-encodes,
pads and copies the columns to the device. CSV and line-delimited JSON
are read eagerly into Arrow tables. Tables load whole; the chunked
iterator is not ported yet.

Sources also report statistics without loading rows: a row estimate,
per-column min/max (`column_stats`, from Parquet footers, which the join
reorder's cost model reads) and an identity stamp (`cache_token`, which
keys statement-scoped materializations, the device table cache and the
capacities kept across executions).
"""

from __future__ import annotations

import itertools
import os
from typing import Optional, Sequence

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
        return _arrow_schema_to_engine(self.table.schema)

    def can_push(self, e: Expression) -> bool:
        return expr_to_arrow(e, self.table.schema) is not None

    def estimated_rows(self):
        return self.table.num_rows

    def load(self, required_columns, pushed_filters, device) -> Batch:
        t = self.table
        ae = _pushed_expression(pushed_filters, self.table.schema)
        if ae is not None:
            t = t.filter(ae)
        if required_columns is not None:
            t = t.select(list(required_columns))
        return Batch.from_arrow(t, device)


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
        return _arrow_schema_to_engine(self._dataset.schema)

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
        t = self._dataset.to_table(
            columns=list(required_columns) if required_columns is not None else None,
            filter=_pushed_expression(pushed_filters, self._dataset.schema))
        return Batch.from_arrow(t, device)
