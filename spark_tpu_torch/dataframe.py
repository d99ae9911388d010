"""DataFrame API: a lazy logical-plan holder (the port of the
`spark_tpu/dataframe.py` subset the slices use; reference:
`Dataset.scala:191`). Every method builds a new logical plan; actions
(`collect`, `to_pandas`) run the QueryExecution pipeline. Window
functions in `select`/`with_column` become Window nodes below the
projection; INTERSECT and EXCEPT are a tagged union plus a group-by
(`set_op_plan`)."""

from __future__ import annotations

from typing import List, Optional, Sequence

import pyarrow as pa

from . import types as T
from .expr import Alias, AnalysisError, ColumnRef, Expression, SortOrder
from .expr_agg import AggExpr, AggregateFunction, Count
from .plan import logical as L


def _expr(e) -> Expression:
    from .functions import _expr as f
    return f(e)


class DataFrame:
    def __init__(self, session, plan: L.LogicalPlan):
        self.session = session
        self.plan = plan

    # -- transformations ----------------------------------------------------

    def _with(self, plan: L.LogicalPlan) -> "DataFrame":
        return DataFrame(self.session, plan)

    def select(self, *exprs) -> "DataFrame":
        plan, es = self._extract_windows([_expr(e) for e in exprs])
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

    # -- actions ------------------------------------------------------------

    def _qe(self):
        from .execution.executor import QueryExecution
        return QueryExecution(self.session, self.plan)

    def collect(self) -> pa.Table:
        return self._qe().collect()

    def to_pandas(self):
        return self.collect().to_pandas()

    toPandas = to_pandas


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
