"""DataFrame API: a lazy logical-plan holder (the port of
`spark_tpu/dataframe.py`; reference: `Dataset.scala:191`). Every method
builds a new logical plan; actions (`collect`, `to_pandas`, `count`,
`show`, `write`, `stat`) run the QueryExecution pipeline, and
`write_stream` starts a micro-batch query over a plan with one streaming
source (`streaming.py`). Window functions in `select`/`with_column`
become Window nodes below the projection, and an `explode()` a Generate
node; INTERSECT and EXCEPT are a tagged union plus a group-by
(`set_op_plan`). `cache()` marks the plan in the session's data cache,
`checkpoint()` materializes it and truncates the lineage."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import pyarrow as pa

from . import types as T
from .expr import Alias, AnalysisError, ColumnRef, Expression, SortOrder
from .expr_agg import AggExpr, AggregateFunction, Count
from .plan import logical as L


def _expr(e) -> Expression:
    from .functions import _expr as f
    return f(e)


class DataFrame:
    #: the perf_counter interval `session.sql` parsed this DataFrame's
    #: statement in, until its first execution takes it as its `parse`
    #: span
    _parsed: Optional[Tuple[float, float]] = None

    def __init__(self, session, plan: L.LogicalPlan):
        self.session = session
        self.plan = plan

    # -- transformations ----------------------------------------------------

    def _with(self, plan: L.LogicalPlan) -> "DataFrame":
        return DataFrame(self.session, plan)

    def select(self, *exprs) -> "DataFrame":
        plan, es = self._extract_windows([_expr(e) for e in exprs])
        from .expr_array import contains_explode, extract_generators
        if any(contains_explode(e) for e in es):
            plan, es = extract_generators(plan, es)
        return self._with(L.Project(plan, es))

    def _extract_windows(self, exprs: List[Expression]):
        """Pull WindowExpr nodes out into Window plan nodes below the
        projection (the reference's ExtractWindowExpressions analog); the
        projection then references their output columns. Functions
        sharing a spec land in ONE Window node (one sort), and output
        names never collide with existing columns (the projection
        re-aliases)."""
        from .window import extract_window_exprs
        return extract_window_exprs(self.plan, exprs)

    def with_column(self, name: str, e: Expression) -> "DataFrame":
        exprs: List[Expression] = []
        replaced = False
        for n in self.plan.schema().names:
            if n == name:
                exprs.append(Alias(_expr(e), name))
                replaced = True
            else:
                exprs.append(ColumnRef(n))
        if not replaced:
            exprs.append(Alias(_expr(e), name))
        plan, exprs = self._extract_windows(exprs)
        return self._with(L.Project(plan, exprs))

    withColumn = with_column

    def with_watermark(self, col_name: str, delay: str) -> "DataFrame":
        """Event-time watermark (reference: Dataset.withWatermark +
        WatermarkTracker.scala:1): rows older than max(event_time) -
        delay drop; closed windows evict/emit in append mode."""
        from .expr_fns import parse_duration_us
        return self._with(L.Watermark(self.plan, col_name,
                                      parse_duration_us(delay)))

    withWatermark = with_watermark

    def filter(self, condition: Expression) -> "DataFrame":
        return self._with(L.Filter(self.plan, condition))

    where = filter

    def group_by(self, *group_exprs) -> "GroupedData":
        return GroupedData(self, [_expr(g) for g in group_exprs])

    groupBy = group_by

    def agg(self, *aggs) -> "DataFrame":
        return GroupedData(self, []).agg(*aggs)

    _JOIN_ALIASES = {
        "outer": "full", "full_outer": "full", "fullouter": "full",
        "left_outer": "left", "leftouter": "left",
        "right_outer": "right", "rightouter": "right",
        "semi": "left_semi", "leftsemi": "left_semi",
        "anti": "left_anti", "leftanti": "left_anti",
    }

    def cross_join(self, other: "DataFrame",
                   condition: Optional[Expression] = None) -> "DataFrame":
        """Cartesian product (reference: Dataset.crossJoin), lowered to a
        constant-key equi-join so the expansion produces |L|x|R| rows."""
        from .expr import Literal
        one = Literal(1)
        return self._with(L.Join(self.plan, other.plan, [one], [one],
                                 "inner", condition))

    crossJoin = cross_join

    def join(self, other: "DataFrame", on=None, how: str = "inner",
             left_on=None, right_on=None,
             condition: Optional[Expression] = None) -> "DataFrame":
        """Equi-join on the column name(s) `on` (USING semantics) or on
        `left_on`/`right_on` key expressions, with an optional residual
        `condition` on the joined row. `how` is one of inner, left,
        right, full, left_semi, left_anti or cross, or an alias of one
        (`_JOIN_ALIASES`)."""
        how = self._JOIN_ALIASES.get(how, how)
        if how == "cross":
            return self.cross_join(other, condition)
        names = None
        if on is not None:
            names = [on] if isinstance(on, str) else list(on)
            lk = [ColumnRef(n) for n in names]
            rk = [ColumnRef(n) for n in names]
        else:
            lk = [_expr(e) for e in (left_on if isinstance(left_on, (list, tuple))
                                     else [left_on])]
            rk = [_expr(e) for e in (right_on if isinstance(right_on, (list, tuple))
                                     else [right_on])]
        join = L.Join(self.plan, other.plan, lk, rk, how, condition)
        if names is not None and how not in ("left_semi", "left_anti"):
            # USING-join semantics (reference Dataset.join(df, usingColumns)):
            # one output key column, the left one (coalesced with the
            # right copy for right/full outer), right copies dropped
            from .expr import Coalesce
            name_map = join.right_name_map()
            drop = {name_map[n] for n in names if n in name_map}
            exprs: List[Expression] = []
            for n in join.schema().names:
                if n in drop:
                    continue
                if n in names and how in ("right", "full"):
                    exprs.append(Alias(Coalesce(ColumnRef(n),
                                                ColumnRef(name_map[n])), n))
                else:
                    exprs.append(ColumnRef(n))
            return self._with(L.Project(join, exprs))
        return self._with(join)

    def sort(self, *orders) -> "DataFrame":
        os = [o if isinstance(o, SortOrder) else
              SortOrder(_expr(o), ascending=True) for o in orders]
        return self._with(L.Sort(self.plan, os))

    orderBy = sort
    order_by = sort

    def limit(self, n: int) -> "DataFrame":
        return self._with(L.Limit(self.plan, n))

    def union(self, other: "DataFrame") -> "DataFrame":
        return self._with(L.Union(self.plan, other.plan))

    unionAll = union

    def intersect(self, other: "DataFrame") -> "DataFrame":
        """INTERSECT (distinct): rows present in both sides, NULLs
        matching NULLs (reference: basicLogicalOperators Intersect ->
        ReplaceIntersectWithSemiJoin)."""
        return self._with(set_op_plan(self.plan, other.plan, "left_semi"))

    def except_(self, other: "DataFrame") -> "DataFrame":
        """EXCEPT (distinct): rows of this side absent from the other
        (ReplaceExceptWithAntiJoin)."""
        return self._with(set_op_plan(self.plan, other.plan, "left_anti"))

    subtract = except_

    def exceptAll(self, other: "DataFrame") -> "DataFrame":
        raise AnalysisError(
            "EXCEPT ALL (multiset) is not supported; use except_ for "
            "the DISTINCT form")

    def distinct(self) -> "DataFrame":
        """Deduplicate rows: an aggregate grouping on every column with no
        aggregate functions (reference: Dataset.distinct -> Deduplicate ->
        Aggregate rewrite)."""
        cols = [ColumnRef(n) for n in self.plan.schema().names]
        return self._with(L.Aggregate(self.plan, cols, []))

    def drop_duplicates(self, subset: Optional[Sequence[str]] = None
                        ) -> "DataFrame":
        """Keep one row per key (an arbitrary one, like the reference's
        Deduplicate): row_number over a window partitioned on the subset,
        filtered to 1."""
        if subset is None:
            return self.distinct()
        missing = [n for n in subset if n not in self.plan.schema().names]
        if missing:
            raise AnalysisError(f"dropDuplicates: unknown columns {missing}")
        if set(subset) == set(self.plan.schema().names):
            return self.distinct()
        from .window import Window, row_number
        w = Window.partition_by(*[ColumnRef(n) for n in subset]) \
            .order_by(ColumnRef(subset[0]))
        keep_cols = self.plan.schema().names
        rn = "__rn"
        while rn in keep_cols:  # never clobber a real column
            rn = "_" + rn
        return (self.with_column(rn, row_number().over(w))
                .filter(ColumnRef(rn) == 1)
                .select(*[ColumnRef(n) for n in keep_cols]))

    dropDuplicates = drop_duplicates

    # -- metadata -----------------------------------------------------------

    @property
    def schema(self) -> T.Schema:
        return self.plan.schema()

    @property
    def columns(self) -> List[str]:
        return self.plan.schema().names

    def explain(self, extended: bool = False, runtime: bool = False,
                analysis: bool = False, rules: bool = False) -> None:
        """Print the plan. runtime=True executes first and annotates each
        operator with its output rows (the SQLMetrics analog);
        rules=True appends the optimizer's per-rule trace; analysis=True
        appends the static analyzer's findings (`analysis/`), those of
        the run when runtime=True, else of a walk of the plan without
        executing."""
        qe = self._qe()
        if runtime:
            qe.execute_batch()
        print(qe.explain(extended, runtime=runtime, analysis=analysis,
                         rules=rules))

    # -- actions ------------------------------------------------------------

    def _qe(self):
        from .execution.executor import QueryExecution
        parsed, self._parsed = self._parsed, None
        return QueryExecution(self.session, self.plan, parsed=parsed)

    def collect(self) -> pa.Table:
        return self._qe().collect()

    @property
    def write(self) -> "DataFrameWriter":
        return DataFrameWriter(self)

    @property
    def stat(self) -> "DataFrameStat":
        return DataFrameStat(self)

    def cache(self) -> "DataFrame":
        """Mark this plan for materialization on first action; later
        queries containing an equal subtree read the cached table
        (reference: CacheManager.scala plan-fingerprint cache)."""
        self.session.mark_cache(self.plan)
        return self

    persist = cache

    def unpersist(self) -> "DataFrame":
        self.session.uncache(self.plan)
        return self

    def write_stream(self, checkpoint_dir: str,
                     output_mode: str = "complete",
                     sink_path: str = None):
        """Start a micro-batch streaming query over this plan (the plan
        must contain one streaming source; reference:
        DataStreamWriter.start -> MicroBatchExecution). `sink_path`
        adds a FileStreamSink: per-batch parquet parts committed by an
        atomic `_metadata` manifest (read back with
        spark_tpu_torch.streaming.read_sink), exactly-once under
        crash-replay."""
        from .streaming import StreamingQuery, _StreamSource
        streams = []

        def walk(n):
            if isinstance(n, _StreamSource):
                streams.append(n.stream)
            for c in n.children:
                walk(c)

        walk(self.plan)
        if len(streams) != 1:
            raise AnalysisError(
                f"write_stream needs exactly one streaming source "
                f"(found {len(streams)})")
        return StreamingQuery(self.session, self.plan, streams[0],
                              checkpoint_dir, output_mode,
                              sink_path=sink_path)

    writeStream = write_stream

    def checkpoint(self) -> "DataFrame":
        """Materialize and truncate lineage (reference: RDD.checkpoint /
        Dataset.checkpoint). With spark_tpu.sql.checkpoint.dir set, the
        result persists as Parquet (ReliableCheckpointRDD analog) and the
        returned frame scans it from disk; otherwise it is held in
        memory (localCheckpoint)."""
        import os
        import uuid

        ckpt_dir = str(self.session.conf.get("spark_tpu.sql.checkpoint.dir"))
        if ckpt_dir:
            path = os.path.join(ckpt_dir, f"ckpt-{uuid.uuid4().hex[:12]}")
            self.write.parquet(path)
            return self.session.read_parquet(path)
        return self.local_checkpoint()

    def local_checkpoint(self) -> "DataFrame":
        """In-memory materialization + lineage truncation (reference:
        Dataset.localCheckpoint — never reliable, ignores checkpoint.dir).
        The source name is unique per call: the fingerprint-keyed data
        cache would otherwise cross-match distinct checkpoints."""
        import uuid

        from .io.sources import ArrowTableSource
        table = self.collect()
        name = f"__checkpoint_{uuid.uuid4().hex[:12]}__"
        return self._with(L.Scan(ArrowTableSource(name, table)))

    localCheckpoint = local_checkpoint

    def to_pandas(self):
        return self.collect().to_pandas()

    toPandas = to_pandas

    def count(self) -> int:
        agg = L.Aggregate(self.plan, [], [AggExpr(Count(None), "count")])
        table = DataFrame(self.session, agg).collect()
        return table.column("count")[0].as_py()

    def show(self, n: int = 20) -> None:
        print(self.limit(n).to_pandas().to_string())


class DataFrameWriter:
    """df.write.mode(...).parquet(path) (reference: DataFrameWriter +
    FileFormatWriter.scala). Writes a directory of part files, so the
    output reads back through the same directory-dataset scan path."""

    _MODES = ("error", "errorifexists", "overwrite", "append", "ignore")

    def __init__(self, df: DataFrame):
        self._df = df
        self._mode = "error"

    def mode(self, m: str) -> "DataFrameWriter":
        m = m.lower()
        if m not in self._MODES:
            raise ValueError(f"unknown write mode {m!r}; one of "
                             f"{self._MODES}")
        self._mode = m
        return self

    def parquet(self, path: str) -> None:
        import glob
        import os
        import shutil

        import pyarrow.parquet as pq

        exists = os.path.exists(path) and (
            not os.path.isdir(path) or bool(os.listdir(path)))
        if exists:
            if self._mode in ("error", "errorifexists"):
                raise FileExistsError(
                    f"path {path!r} already exists (write mode=error)")
            if self._mode == "ignore":
                return
        # execute BEFORE touching the target: a failing query must not
        # destroy the previous output under mode=overwrite
        table = self._df.collect()
        if exists and self._mode == "overwrite":
            if os.path.isdir(path):
                shutil.rmtree(path)
            else:
                os.remove(path)
        if os.path.exists(path) and not os.path.isdir(path):
            raise NotADirectoryError(
                f"append target {path!r} is a file, not a dataset "
                f"directory")
        os.makedirs(path, exist_ok=True)
        n = len(glob.glob(os.path.join(path, "part-*.parquet")))
        pq.write_table(table,
                       os.path.join(path, f"part-{n:05d}.parquet"))


class DataFrameStat:
    """df.stat.* (reference: DataFrameStatFunctions — the sketch entry
    points backed by common/sketch): each sketch is built on the device
    from the column's live, non-NULL values."""

    def __init__(self, df: DataFrame):
        self._df = df

    def _column_device(self, col_name: str):
        from .execution.executor import QueryExecution
        qe = QueryExecution(self._df.session,
                            L.Project(self._df.plan, [ColumnRef(col_name)]))
        batch = qe.execute_batch()
        c = batch.columns[batch.names[0]]
        sel = batch.selection_mask()
        mask = sel if c.validity is None else (sel & c.validity)
        return c.data, mask

    def bloom_filter(self, col_name: str, expected_items: int,
                     fpp: float = 0.03):
        from .sketch import BloomFilter
        data, mask = self._column_device(col_name)
        return BloomFilter.build(data, expected_items, fpp, mask=mask)

    bloomFilter = bloom_filter

    def count_min_sketch(self, col_name: str, eps: float = 0.001,
                         confidence: float = 0.99):
        from .sketch import CountMinSketch
        data, mask = self._column_device(col_name)
        return CountMinSketch.build(data, eps, confidence, mask=mask)

    countMinSketch = count_min_sketch


def set_op_plan(lp: L.LogicalPlan, rp: L.LogicalPlan,
                how: str) -> L.LogicalPlan:
    """INTERSECT/EXCEPT (distinct) as a tagged union + group-by: each
    side contributes a presence flag, one aggregate groups on every
    column (group keys are NULL-safe and take every dtype), and a filter
    keeps groups present on the right side(s). Equivalent to the
    reference's ReplaceIntersectWithSemiJoin / ReplaceExceptWithAntiJoin
    rewrites."""
    from .expr import Literal
    from .expr_agg import Max
    ls, rs = lp.schema(), rp.schema()
    if len(ls.fields) != len(rs.fields):
        raise AnalysisError(
            f"set operation needs equal column counts "
            f"({len(ls.fields)} vs {len(rs.fields)})")
    lnames = ls.names
    tag_l = L.Project(lp, [ColumnRef(n) for n in lnames]
                      + [Alias(Literal(1), "__in_l"),
                         Alias(Literal(0), "__in_r")])
    # right columns rename to the left's so the union lines up
    tag_r = L.Project(rp, [Alias(ColumnRef(rn), ln)
                           for rn, ln in zip(rs.names, lnames)]
                      + [Alias(Literal(0), "__in_l"),
                         Alias(Literal(1), "__in_r")])
    u = L.Union(tag_l, tag_r)
    g = L.Aggregate(u, [ColumnRef(n) for n in lnames],
                    [AggExpr(Max(ColumnRef("__in_l")), "__lf"),
                     AggExpr(Max(ColumnRef("__in_r")), "__rf")])
    lf = ColumnRef("__lf")
    rf = ColumnRef("__rf")
    cond = (lf == Literal(1)) & (rf == Literal(1)) \
        if how == "left_semi" else \
        (lf == Literal(1)) & (rf == Literal(0))
    return L.Project(L.Filter(g, cond),
                     [ColumnRef(n) for n in lnames])


class GroupedData:
    """Reference: RelationalGroupedDataset."""

    def __init__(self, df: DataFrame, group_exprs: List[Expression]):
        self._df = df
        self._groups = group_exprs

    def agg(self, *aggs) -> DataFrame:
        agg_exprs = []
        for a in aggs:
            if isinstance(a, AggExpr):
                agg_exprs.append(a)
            elif isinstance(a, Alias) and isinstance(a.child, AggregateFunction):
                agg_exprs.append(AggExpr(a.child, a.name()))
            elif isinstance(a, AggregateFunction):
                agg_exprs.append(AggExpr(a, repr(a)))
            else:
                raise AnalysisError(f"not an aggregate: {a!r}")
        plan = L.Aggregate(self._df.plan, self._groups, agg_exprs)
        return DataFrame(self._df.session, plan)

    def count(self) -> DataFrame:
        return self.agg(AggExpr(Count(None), "count"))

    def apply_in_pandas(self, fn, schema) -> DataFrame:
        """Grouped-map pandas UDF: ``fn(pdf) -> pdf`` per key group
        (reference: FlatMapGroupsInPandasExec over Arrow batches,
        `ArrowEvalPythonExec.scala:1` family). The input materializes
        on the host — the same stage cut the reference makes; under
        `spark_tpu.sql.udf.mode=worker` each group goes through the
        session's UDF worker pool. The result is a new in-memory table,
        ingested to the device by the next query over it. `schema` is
        "name type, ..." or a T.Schema."""
        import pandas as pd
        from .udf import _parse_return_type

        if isinstance(schema, str):
            fields = []
            for part in schema.split(","):
                name, typ = part.strip().rsplit(" ", 1)
                fields.append(T.Field(name.strip(),
                                      _parse_return_type(typ), True))
            out_schema = T.Schema(fields)
        else:
            out_schema = schema
        key_names = [g.name() for g in self._groups]
        pdf = self._df.select(
            *([*self._groups] + [ColumnRef(n)
                                 for n in self._df.plan.schema().names
                                 if n not in {g.name()
                                              for g in self._groups}])
        ).to_pandas() if self._groups else self._df.to_pandas()
        if key_names:
            groups = [g.reset_index(drop=True)
                      for _, g in pdf.groupby(key_names, sort=False,
                                              dropna=False)]
        else:
            groups = [pdf]
        mode = str(self._df.session.conf.get(
            "spark_tpu.sql.udf.mode") or "inprocess")
        if mode == "worker":
            # out-of-process lane: one EVAL frame per key group through
            # the session's worker pool (FlatMapGroupsInPandasExec)
            from .execution.python_eval import eval_grouped_map_worker
            pieces = eval_grouped_map_worker(
                self._df.session, fn, groups,
                [f.name for f in out_schema.fields])
        else:
            pieces = [fn(g) for g in groups]
        out = pd.concat(pieces, ignore_index=True) if pieces else \
            pd.DataFrame({f.name: [] for f in out_schema.fields})
        out = out[[f.name for f in out_schema.fields]]
        for f in out_schema.fields:  # pin declared dtypes
            if not isinstance(f.dtype, (T.StringType, T.DateType)):
                out[f.name] = out[f.name].astype(f.dtype.np_dtype)
        # a plain in-memory scan — never registered, so the session
        # catalog stays free of internal temp tables
        return self._df.session.create_dataframe(out, "__grouped_map__")

    applyInPandas = apply_in_pandas
