"""DataFrame API: a lazy logical-plan holder (the port of the
`spark_tpu/dataframe.py` subset the slice uses; reference:
`Dataset.scala:191`). Every method builds a new logical plan; actions
(`collect`, `to_pandas`) run the QueryExecution pipeline."""

from __future__ import annotations

from typing import List, Optional

import pyarrow as pa

from . import types as T
from .expr import Alias, AnalysisError, Expression, SortOrder
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
        return self._with(L.Project(self.plan, [_expr(e) for e in exprs]))

    def filter(self, condition: Expression) -> "DataFrame":
        return self._with(L.Filter(self.plan, condition))

    where = filter

    def group_by(self, *group_exprs) -> "GroupedData":
        return GroupedData(self, [_expr(g) for g in group_exprs])

    groupBy = group_by

    def agg(self, *aggs) -> "DataFrame":
        return GroupedData(self, []).agg(*aggs)

    def join(self, other: "DataFrame", how: str = "inner", left_on=None,
             right_on=None, condition: Optional[Expression] = None
             ) -> "DataFrame":
        """Equi-join on `left_on`/`right_on` key expressions, with an
        optional residual `condition` on the joined row. `how` is one of
        inner, left, right, full, left_semi or left_anti."""
        lk = [_expr(e) for e in (left_on if isinstance(left_on, (list, tuple))
                                 else [left_on])]
        rk = [_expr(e) for e in (right_on if isinstance(right_on, (list, tuple))
                                 else [right_on])]
        return self._with(L.Join(self.plan, other.plan, lk, rk, how,
                                 condition))

    def sort(self, *orders) -> "DataFrame":
        os = [o if isinstance(o, SortOrder) else
              SortOrder(_expr(o), ascending=True) for o in orders]
        return self._with(L.Sort(self.plan, os))

    orderBy = sort
    order_by = sort

    def limit(self, n: int) -> "DataFrame":
        return self._with(L.Limit(self.plan, n))

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
