"""Window function API + expression node (the port of
`spark_tpu/window.py`).

Mirrors pyspark's `Window`/`WindowSpec` builder surface
(`python/pyspark/sql/window.py`) and the reference's WindowExpression
(`sql/catalyst/.../expressions/windowExpressions.scala`): a window
function + its spec travel as ONE expression; the DataFrame layer (and
the SQL frontend) extract them into a `Window` plan node, and
`WindowExec` evaluates every function of a shared spec over one sorted
permutation (execution/window.py).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from . import types as T
from .expr import (AnalysisError, ColumnRef, Expression, SortOrder)

RANKING_KINDS = ("row_number", "rank", "dense_rank")
SHIFT_KINDS = ("lag", "lead")
AGG_KINDS = ("sum", "count", "min", "max", "avg")


#: frame boundary sentinels (pyspark's Window.unboundedPreceding /
#: unboundedFollowing / currentRow values)
UNBOUNDED_PRECEDING = -(1 << 63)
UNBOUNDED_FOLLOWING = (1 << 63) - 1
CURRENT_ROW = 0


class WindowSpec:
    def __init__(self, partition_by: Sequence[Expression] = (),
                 order_by: Sequence[SortOrder] = (),
                 frame: Optional[Tuple[str, int, int]] = None):
        self._partition = tuple(partition_by)
        self._order = tuple(order_by)
        # ("rows"|"range", start, end) with UNBOUNDED_* sentinels, or
        # None for the Spark default (RANGE UNBOUNDED PRECEDING ..
        # CURRENT ROW when ordered, the whole partition otherwise)
        self._frame = frame

    def partition_by(self, *cols) -> "WindowSpec":
        from .functions import _expr
        return WindowSpec(tuple(_expr(c) for c in cols), self._order,
                          self._frame)

    partitionBy = partition_by

    def order_by(self, *orders) -> "WindowSpec":
        from .functions import _expr
        os = []
        for o in orders:
            os.append(o if isinstance(o, SortOrder)
                      else SortOrder(_expr(o), ascending=True))
        return WindowSpec(self._partition, tuple(os), self._frame)

    orderBy = order_by

    def rows_between(self, start: int, end: int) -> "WindowSpec":
        """ROWS BETWEEN: physical row offsets relative to the current
        row (reference: SpecifiedWindowFrame RowFrame)."""
        return WindowSpec(self._partition, self._order,
                          ("rows", int(start), int(end)))

    rowsBetween = rows_between

    def range_between(self, start: int, end: int) -> "WindowSpec":
        """RANGE BETWEEN: offsets in ORDER-BY key value space; needs a
        single numeric order key (reference: RangeFrame)."""
        return WindowSpec(self._partition, self._order,
                          ("range", int(start), int(end)))

    rangeBetween = range_between


class Window:
    """pyspark-style entry points: Window.partitionBy(...).orderBy(...)."""

    unboundedPreceding = UNBOUNDED_PRECEDING
    unboundedFollowing = UNBOUNDED_FOLLOWING
    currentRow = CURRENT_ROW

    @staticmethod
    def partition_by(*cols) -> WindowSpec:
        return WindowSpec().partition_by(*cols)

    partitionBy = partition_by

    @staticmethod
    def order_by(*orders) -> WindowSpec:
        return WindowSpec().order_by(*orders)

    orderBy = order_by


class WindowExpr(Expression):
    """One window function over a spec. `children` flattens
    [arg?] + partition exprs + order SortOrders so generic tree
    transforms (qualified-name rewriting, constant folding) reach every
    sub-expression; `map_children` rebuilds the structure."""

    def __init__(self, kind: str, arg: Optional[Expression],
                 spec: WindowSpec, offset: int = 1, default=None):
        self.kind = kind
        self.arg = arg
        self.spec = spec
        self.offset = offset
        self.default = default
        kids: List[Expression] = [] if arg is None else [arg]
        kids += list(spec._partition)
        kids += list(spec._order)
        self.children = tuple(kids)

    def map_children(self, f):
        kids = [f(c) for c in self.children]
        i = 0
        arg = None
        if self.arg is not None:
            arg = kids[0]
            i = 1
        np_ = len(self.spec._partition)
        partition = tuple(kids[i:i + np_])
        order = tuple(kids[i + np_:])
        return WindowExpr(self.kind, arg,
                          WindowSpec(partition, order, self.spec._frame),
                          self.offset, self.default)

    def dtype(self, schema: T.Schema) -> T.DataType:
        if self.kind in RANKING_KINDS or self.kind == "count":
            return T.LONG
        if self.kind in SHIFT_KINDS:
            return self.arg.dtype(schema)
        from .expr_agg import Avg, Sum
        if self.kind == "sum":
            return Sum(self.arg).result_type(schema)
        if self.kind == "avg":
            return Avg(self.arg).result_type(schema)
        return self.arg.dtype(schema)  # min/max

    def nullable(self, schema) -> bool:
        if self.kind in RANKING_KINDS or self.kind == "count":
            return False
        return True

    def eval(self, batch):
        raise AnalysisError(
            f"window function {self.kind} must be planned through a "
            f"Window node (use select/withColumn)")

    def over(self, spec: WindowSpec) -> "WindowExpr":
        if self.kind in RANKING_KINDS + SHIFT_KINDS and not spec._order:
            # the reference rejects ranking/offset functions without a
            # window ordering at analysis time; silent arbitrary-order
            # ranks would be worse
            raise AnalysisError(
                f"{self.kind}() requires an ORDER BY in its window "
                f"specification")
        return WindowExpr(self.kind, self.arg, spec, self.offset,
                          self.default)

    def __repr__(self):
        parts = [] if self.arg is None else [repr(self.arg)]
        spec = (f"partition by {list(self.spec._partition)!r} "
                f"order by {list(self.spec._order)!r}")
        if self.spec._frame is not None:
            # the frame is part of the printed plan, as in the JAX package
            spec += f" frame {self.spec._frame!r}"
        return f"{self.kind}({', '.join(parts)}) OVER ({spec})"


def contains_window(e: Expression) -> bool:
    if isinstance(e, WindowExpr):
        return True
    return any(contains_window(c) for c in e.children)


#: aggregate class name -> window kind (shared by AggregateFunction.over
#: and the SQL frontend's OVER lowering — keep the one copy)
AGG_WINDOW_KINDS = {"Sum": "sum", "Count": "count", "Min": "min",
                    "Max": "max", "Avg": "avg"}


def _spec_key(w: WindowExpr) -> tuple:
    return (tuple(repr(p) for p in w.spec._partition),
            tuple(repr(o) for o in w.spec._order))


def extract_window_exprs(plan, exprs: Sequence[Expression]):
    """Replace WindowExpr occurrences in `exprs` with column references
    and return (plan wrapped in Window nodes, rewritten exprs).

    - functions sharing a (partition, order) spec share ONE Window node,
      so one sorted permutation serves them all;
    - generated output names never collide with existing columns (a
      desired alias that would collide gets a fresh internal name and is
      re-aliased by the enclosing projection)."""
    from .expr import Alias, ColumnRef
    from .plan import logical as L
    if not any(contains_window(e) for e in exprs):
        # keep the window-free fast path lazy: no schema() walk
        return plan, list(exprs)
    taken = set(plan.schema().names)
    collected: List[tuple] = []  # (WindowExpr, out_name)
    counter = [0]

    def fresh(want: Optional[str]) -> str:
        if want and want not in taken:
            taken.add(want)
            return want
        while True:
            name = f"_w{counter[0]}"
            counter[0] += 1
            if name not in taken:
                taken.add(name)
                return name

    def extract(e: Expression, top_name: Optional[str]) -> Expression:
        if isinstance(e, WindowExpr):
            name = fresh(top_name)
            collected.append((e, name))
            return ColumnRef(name)
        return e.map_children(lambda c: extract(c, None))

    out: List[Expression] = []
    for e in exprs:
        if not contains_window(e):
            out.append(e)
        elif isinstance(e, Alias):
            inner = extract(e.child, e.name())
            out.append(inner if isinstance(inner, ColumnRef)
                       and inner.name() == e.name() else
                       Alias(inner, e.name()))
        else:
            out.append(extract(e, None))

    groups: dict = {}
    order: List[tuple] = []
    for w, name in collected:
        k = _spec_key(w)
        if k not in groups:
            groups[k] = []
            order.append(k)
        groups[k].append((w, name))
    for k in order:
        plan, group = _project_computed_keys(plan, groups[k], fresh)
        plan = L.WindowPlan(plan, group)
    return plan, out


def _project_computed_keys(plan, group, fresh):
    """Computed partition/order keys get projected into named columns
    below the Window node, so WindowExec can declare a hash-clustered
    distribution instead of AllTuples (as the JAX package does, so the
    plans print alike)."""
    from .expr import Alias, ColumnRef
    from .plan import logical as L
    spec = group[0][0].spec
    added: List[Expression] = []

    def as_ref(e: Expression) -> Expression:
        base = e
        while isinstance(base, Alias):
            base = base.child
        if isinstance(base, ColumnRef):
            return base
        name = fresh(None)
        added.append(Alias(e, name))
        return ColumnRef(name)

    new_partition = tuple(as_ref(p) for p in spec._partition)
    new_order = tuple(SortOrder(as_ref(o.child), o.ascending,
                                o.nulls_first) for o in spec._order)
    if not added:
        return plan, group
    keep = [ColumnRef(n) for n in plan.schema().names]
    plan = L.Project(plan, keep + added)
    # frames are per-FUNCTION: rebuild each spec with its own frame
    new_group = [(WindowExpr(w.kind, w.arg,
                             WindowSpec(new_partition, new_order,
                                        w.spec._frame),
                             w.offset, w.default), name)
                 for w, name in group]
    return plan, new_group


def row_number() -> WindowExpr:
    return WindowExpr("row_number", None, WindowSpec())


def rank() -> WindowExpr:
    return WindowExpr("rank", None, WindowSpec())


def dense_rank() -> WindowExpr:
    return WindowExpr("dense_rank", None, WindowSpec())


def lag(e, offset: int = 1, default=None) -> WindowExpr:
    from .functions import _expr
    return WindowExpr("lag", _expr(e), WindowSpec(), offset=offset,
                      default=default)


def lead(e, offset: int = 1, default=None) -> WindowExpr:
    from .functions import _expr
    return WindowExpr("lead", _expr(e), WindowSpec(), offset=-offset,
                      default=default)
