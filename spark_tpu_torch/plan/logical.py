"""Logical plan nodes (the port of `spark_tpu/plan/logical.py`; reference:
`plans/logical/basicLogicalOperators.scala`).

Plans are immutable trees; `schema()` performs type resolution eagerly
and by name, raising `AnalysisError` on unresolvable names/types.
`simple_string`/`tree_string` match the JAX package character for
character, so plan-level parity is a string compare.
"""

from __future__ import annotations

import copy
from typing import Callable, Optional, Sequence, Tuple

from .. import types as T
from ..expr import (AnalysisError, Expression, SortOrder, structurally_equal)
from ..expr_agg import AggExpr


class LogicalPlan:
    children: Tuple["LogicalPlan", ...] = ()

    def schema(self) -> T.Schema:
        raise NotImplementedError

    def map_children(self, f: Callable[["LogicalPlan"], "LogicalPlan"]):
        if not self.children:
            return self
        new = copy.copy(self)
        new.children = tuple(f(c) for c in self.children)
        return new

    def transform_up(self, f) -> "LogicalPlan":
        node = self.map_children(lambda c: c.transform_up(f))
        out = f(node)
        return node if out is None else out

    def transform_down(self, f) -> "LogicalPlan":
        out = f(self)
        node = self if out is None else out
        return node.map_children(lambda c: c.transform_down(f))

    def tree_string(self, depth: int = 0) -> str:
        line = "  " * depth + self.simple_string()
        return "\n".join([line] + [c.tree_string(depth + 1) for c in self.children])

    def simple_string(self) -> str:
        return type(self).__name__

    def same_result(self, other: "LogicalPlan") -> bool:
        """Structural plan equality (reference: PlanTest.comparePlans)."""
        if type(self) is not type(other) or len(self.children) != len(other.children):
            return False
        sa = {k: v for k, v in self.__dict__.items() if k != "children"}
        sb = {k: v for k, v in other.__dict__.items() if k != "children"}
        for k in sa:
            if not _attr_eq(sa.get(k), sb.get(k)):
                return False
        return all(a.same_result(b) for a, b in zip(self.children, other.children))

    def __repr__(self):
        return self.tree_string()


def _attr_eq(a, b) -> bool:
    if isinstance(a, Expression) and isinstance(b, Expression):
        return structurally_equal(a, b)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_attr_eq(x, y) for x, y in zip(a, b))
    if isinstance(a, AggExpr) and isinstance(b, AggExpr):
        return (a.out_name == b.out_name
                and type(a.func) is type(b.func)
                and (a.func.child is None) == (b.func.child is None)
                and (a.func.child is None
                     or structurally_equal(a.func.child, b.func.child)))
    try:
        return bool(a == b)
    except Exception:
        return a is b


class LeafPlan(LogicalPlan):
    pass


class ScalarSubqueryExpr(Expression):
    """An uncorrelated scalar subquery embedded in an expression
    (reference: ScalarSubquery in subquery.scala). The executor runs the
    subplan before optimizing the outer query and substitutes its single
    value as a Literal."""

    def __init__(self, plan: LogicalPlan):
        self.plan = plan
        self.children = ()

    def dtype(self, schema):
        return self.plan.schema().fields[0].dtype

    def nullable(self, schema):
        return True  # empty result -> NULL

    def references(self):
        return set()

    def foldable(self):
        return False

    def __repr__(self):
        return "scalar-subquery(...)"


def iter_expressions(plan: LogicalPlan):
    """Yield every expression embedded anywhere in the plan — the single
    enumeration of expression-bearing slots (keep map_expressions' node
    cases in sync with this)."""
    stack = [plan]
    while stack:
        n = stack.pop()
        stack.extend(n.children)
        if isinstance(n, Project):
            yield from n.exprs
        elif isinstance(n, Filter):
            yield n.condition
        elif isinstance(n, Join):
            yield from n.left_keys
            yield from n.right_keys
            if n.condition is not None:
                yield n.condition
        elif isinstance(n, Aggregate):
            yield from n.group_exprs
            for a in n.agg_exprs:
                yield from a.func.children
        elif isinstance(n, Sort):
            for o in n.orders:
                yield o.child
        elif isinstance(n, WindowPlan):
            for w, _name in n.wexprs:
                yield from w.children
        elif isinstance(n, Generate):
            yield n.gen_expr


def iter_scans(plan: LogicalPlan):
    """Yield every Scan node."""
    if isinstance(plan, Scan):
        yield plan
    for c in plan.children:
        yield from iter_scans(c)


def map_expressions(plan: LogicalPlan, f) -> LogicalPlan:
    """Rebuild a plan with every embedded expression passed through
    `f: Expression -> Expression` (used for scalar-subquery substitution;
    the reference's QueryPlan.transformExpressions). Node cases must
    mirror iter_expressions."""

    def walk(node: LogicalPlan) -> LogicalPlan:
        node = node.map_children(walk)
        if isinstance(node, Project):
            return Project(node.child, [f(e) for e in node.exprs])
        if isinstance(node, Filter):
            return Filter(node.child, f(node.condition))
        if isinstance(node, Join):
            return Join(node.left, node.right,
                        [f(k) for k in node.left_keys],
                        [f(k) for k in node.right_keys], node.how,
                        None if node.condition is None
                        else f(node.condition),
                        node.null_aware)
        if isinstance(node, Aggregate):
            aggs = []
            for a in node.agg_exprs:
                func = a.func
                if func.children:
                    func = func.with_args([f(c) for c in func.children])
                aggs.append(type(a)(func, a.out_name))
            return Aggregate(node.child, [f(g) for g in node.group_exprs],
                             aggs)
        if isinstance(node, Sort):
            return Sort(node.child, [SortOrder(f(o.child), o.ascending,
                                               o.nulls_first)
                                     for o in node.orders])
        if isinstance(node, WindowPlan):
            return WindowPlan(node.child,
                              [(w.map_children(f), name)
                               for w, name in node.wexprs])
        if isinstance(node, Generate):
            return Generate(node.child, f(node.gen_expr), node.out_name,
                            node.outer)
        return node

    return walk(plan)


class Range(LeafPlan):
    """spark.range analog (reference: basicPhysicalOperators RangeExec)."""

    def __init__(self, start: int, end: int, step: int = 1):
        self.start = start
        self.end = end
        self.step = step
        self.children = ()

    def num_rows(self) -> int:
        return max(0, -(-(self.end - self.start) // self.step))

    def schema(self) -> T.Schema:
        return T.Schema([T.Field("id", T.LONG, nullable=False)])

    def simple_string(self):
        return f"Range({self.start}, {self.end}, {self.step})"


class Scan(LeafPlan):
    """Scan of a cataloged table; `source` is an io.sources.TableSource
    that knows its schema and loads batches with column pruning and
    predicate pushdown."""

    def __init__(self, source, required_columns: Optional[Sequence[str]] = None,
                 pushed_filters: Sequence[Expression] = ()):
        self.source = source
        self.required_columns = (tuple(required_columns)
                                 if required_columns is not None else None)
        self.pushed_filters = tuple(pushed_filters)
        self.children = ()

    def schema(self) -> T.Schema:
        full = self.source.schema()
        if self.required_columns is None:
            return full
        return T.Schema([full.field(n) for n in self.required_columns])

    def simple_string(self):
        cols = "*" if self.required_columns is None else ",".join(self.required_columns)
        f = f" pushed={list(self.pushed_filters)!r}" if self.pushed_filters else ""
        return f"Scan({self.source.name}, [{cols}]{f})"


class Project(LogicalPlan):
    def __init__(self, child: LogicalPlan, exprs: Sequence[Expression]):
        self.children = (child,)
        self.exprs = tuple(exprs)

    @property
    def child(self):
        return self.children[0]

    def schema(self) -> T.Schema:
        cs = self.child.schema()
        return T.Schema([T.Field(e.name(), e.dtype(cs), e.nullable(cs))
                         for e in self.exprs])

    def simple_string(self):
        return f"Project({list(self.exprs)!r})"


class Filter(LogicalPlan):
    def __init__(self, child: LogicalPlan, condition: Expression):
        self.children = (child,)
        self.condition = condition

    @property
    def child(self):
        return self.children[0]

    def schema(self) -> T.Schema:
        cond_t = self.condition.dtype(self.child.schema())
        if not isinstance(cond_t, T.BooleanType):
            raise AnalysisError(f"filter condition must be boolean, got {cond_t!r}")
        return self.child.schema()

    def simple_string(self):
        return f"Filter({self.condition!r})"


class Aggregate(LogicalPlan):
    def __init__(self, child: LogicalPlan, group_exprs: Sequence[Expression],
                 agg_exprs: Sequence[AggExpr]):
        self.children = (child,)
        self.group_exprs = tuple(group_exprs)
        self.agg_exprs = tuple(agg_exprs)

    @property
    def child(self):
        return self.children[0]

    def schema(self) -> T.Schema:
        cs = self.child.schema()
        fields = [T.Field(g.name(), g.dtype(cs), g.nullable(cs))
                  for g in self.group_exprs]
        for a in self.agg_exprs:
            fields.append(T.Field(a.out_name, a.func.result_type(cs),
                                  a.func.result_nullable(cs)))
        return T.Schema(fields)

    def simple_string(self):
        return (f"Aggregate(groups={list(self.group_exprs)!r}, "
                f"aggs={list(self.agg_exprs)!r})")


JOIN_TYPES = ("inner", "left", "right", "full", "left_semi", "left_anti")


def _name_map(ls: T.Schema, rs: T.Schema) -> dict:
    taken = {f.name for f in ls.fields}
    m = {}
    for f in rs.fields:
        name = f.name
        while name in taken:
            name = name + "_r"
        m[f.name] = name
        taken.add(name)
    return m


class Join(LogicalPlan):
    """Equi-join on key expression pairs (reference: logical Join +
    ExtractEquiJoinKeys). `condition` is an optional residual non-equi
    predicate applied post-match."""

    def __init__(self, left: LogicalPlan, right: LogicalPlan,
                 left_keys: Sequence[Expression], right_keys: Sequence[Expression],
                 how: str = "inner", condition: Optional[Expression] = None,
                 null_aware: bool = False):
        if how not in JOIN_TYPES:
            raise AnalysisError(f"unsupported join type {how!r}")
        if len(left_keys) != len(right_keys) or not left_keys:
            raise AnalysisError("join requires matching, non-empty key lists")
        if null_aware and how != "left_anti":
            raise AnalysisError("null_aware applies to left_anti only")
        self.children = (left, right)
        self.left_keys = tuple(left_keys)
        self.right_keys = tuple(right_keys)
        self.how = how
        self.condition = condition
        # SQL NOT IN semantics (null-aware anti-join): any NULL in the
        # build keys empties the result; a NULL probe key only survives
        # when the build side is empty
        self.null_aware = null_aware

    @property
    def left(self):
        return self.children[0]

    @property
    def right(self):
        return self.children[1]

    def right_name_map(self) -> dict:
        """right-field name -> output name (collisions suffixed `_r`)."""
        return _name_map(self.left.schema(), self.right.schema())

    def schema(self) -> T.Schema:
        ls = self.left.schema()
        if self.how in ("left_semi", "left_anti"):
            return ls
        rs = self.right.schema()
        # from the two schemas already in hand: asking right_name_map()
        # would compute both again, three times a join level in all
        name_map = _name_map(ls, rs)
        left_nullable = self.how in ("right", "full")
        right_nullable = self.how in ("left", "full")
        fields = [T.Field(f.name, f.dtype, f.nullable or left_nullable)
                  for f in ls.fields]
        for f in rs.fields:
            fields.append(T.Field(name_map[f.name], f.dtype,
                                  f.nullable or right_nullable))
        return T.Schema(fields)

    def simple_string(self):
        return (f"Join({self.how}, {list(self.left_keys)!r} = "
                f"{list(self.right_keys)!r}"
                + (f", cond={self.condition!r}" if self.condition is not None else "")
                + (", null_aware" if self.null_aware else "")
                + ")")


class WindowPlan(LogicalPlan):
    """Append window-function columns over ONE shared (partition, order)
    spec (reference: logical Window in basicLogicalOperators.scala;
    different specs become separate nodes)."""

    def __init__(self, child: LogicalPlan, wexprs: Sequence[Tuple]):
        # wexprs: (WindowExpr, out_name) pairs sharing one spec
        from ..window import WindowExpr
        if not wexprs:
            raise AnalysisError("Window requires at least one function")
        spec0 = wexprs[0][0].spec
        for w, _ in wexprs:
            if not isinstance(w, WindowExpr):
                raise AnalysisError(f"not a window expression: {w!r}")
            if (tuple(repr(p) for p in w.spec._partition)
                    != tuple(repr(p) for p in spec0._partition)
                    or tuple(repr(o) for o in w.spec._order)
                    != tuple(repr(o) for o in spec0._order)):
                raise AnalysisError(
                    "one Window node requires a shared window spec")
        self.children = (child,)
        self.wexprs = tuple(wexprs)

    @property
    def child(self):
        return self.children[0]

    def schema(self) -> T.Schema:
        cs = self.child.schema()
        fields = list(cs.fields)
        for w, name in self.wexprs:
            fields.append(T.Field(name, w.dtype(cs), w.nullable(cs)))
        return T.Schema(fields)

    def simple_string(self):
        return f"Window({[(repr(w), n) for w, n in self.wexprs]!r})"


class Sort(LogicalPlan):
    def __init__(self, child: LogicalPlan, orders: Sequence[SortOrder]):
        self.children = (child,)
        self.orders = tuple(orders)

    @property
    def child(self):
        return self.children[0]

    def schema(self) -> T.Schema:
        return self.child.schema()

    def simple_string(self):
        return f"Sort({list(self.orders)!r})"


class Limit(LogicalPlan):
    def __init__(self, child: LogicalPlan, n: int):
        self.children = (child,)
        self.n = n

    @property
    def child(self):
        return self.children[0]

    def schema(self) -> T.Schema:
        return self.child.schema()

    def simple_string(self):
        return f"Limit({self.n})"


class Union(LogicalPlan):
    """UNION ALL of two plans with equal column counts; names come from
    the left side, types widen to their common type."""

    def __init__(self, left: LogicalPlan, right: LogicalPlan):
        ls, rs = left.schema(), right.schema()
        if len(ls) != len(rs):
            raise AnalysisError("UNION requires same column count")
        self.children = (left, right)

    def schema(self) -> T.Schema:
        ls = self.children[0].schema()
        rs = self.children[1].schema()
        fields = []
        for a, b in zip(ls.fields, rs.fields):
            fields.append(T.Field(a.name, T.common_type(a.dtype, b.dtype),
                                  a.nullable or b.nullable))
        return T.Schema(fields)


class Watermark(LogicalPlan):
    """Event-time watermark marker (reference: EventTimeWatermark in
    basicLogicalOperators.scala + WatermarkTracker.scala:1): schema
    passthrough; the streaming runtime reads (column, delay) to drop
    late rows and evict closed windows. Batch planning strips it."""

    def __init__(self, child: LogicalPlan, col_name: str, delay_us: int):
        self.children = (child,)
        self.col_name = col_name
        self.delay_us = int(delay_us)

    @property
    def child(self):
        return self.children[0]

    def schema(self) -> T.Schema:
        return self.child.schema()

    def simple_string(self):
        return f"Watermark({self.col_name}, {self.delay_us}us)"


class Generate(LogicalPlan):
    """One output row per array element of `gen_expr` (explode) — the
    reference's logical Generate (`basicLogicalOperators.scala`) over
    `GenerateExec.scala:1`. Child columns replicate per element; the
    element column appends as `out_name`. `outer=True` keeps empty/NULL
    arrays as one NULL-element row (explode_outer)."""

    def __init__(self, child: LogicalPlan, gen_expr, out_name: str,
                 outer: bool = False):
        self.children = (child,)
        self.gen_expr = gen_expr
        self.out_name = out_name
        self.outer = outer

    @property
    def child(self):
        return self.children[0]

    def schema(self) -> T.Schema:
        cs = self.child.schema()
        dt = self.gen_expr.dtype(cs)
        if not isinstance(dt, T.ArrayType):
            raise AnalysisError(
                f"explode() needs an array, got {dt!r}")
        # array columns do not replicate through a Generate (their
        # per-row slices have no cheap element-space gather); scalar
        # columns + the generated element column come out
        fields = [f for f in cs.fields
                  if not isinstance(f.dtype, T.ArrayType)]
        fields.append(T.Field(self.out_name, dt.element, True))
        return T.Schema(fields)

    def simple_string(self):
        return (f"Generate(explode{'_outer' if self.outer else ''}"
                f"({self.gen_expr!r}) AS {self.out_name})")
