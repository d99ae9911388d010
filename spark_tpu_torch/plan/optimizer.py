"""Logical optimizer rules (the port of `spark_tpu/plan/optimizer.py`).

Every rule of the JAX package's default pipeline (reference:
`optimizer/Optimizer.scala:42`), in its batch order: the distinct-
aggregate rewrite, filter combination, filter pushdown through
projections and into scans, the cost-based join reorder
(`join_reorder.py`), the projection collapse into aggregates, the
group-key aggregate rewrite, constant folding and column pruning.
`spark_tpu.sql.optimizer.excludedRules` drops rules by name.
"""

from __future__ import annotations

from typing import List, Optional, Set

from .. import types as T
from ..columnar import Batch as ColBatch
from ..expr import (Alias, AnalysisError, And, Cast, ColumnRef, Expression,
                    Literal, Mul, structurally_equal)
from .logical import (Aggregate, Filter, Join, Limit, LogicalPlan, Project,
                      Scan, Sort, Union)
from .rules import Batch, Rule, RuleExecutor


class CombineFilters(Rule):
    name = "CombineFilters"
    schema_preserving = True

    def apply(self, plan):
        def f(node):
            if isinstance(node, Filter) and isinstance(node.child, Filter):
                inner = node.child
                return Filter(inner.child, And(inner.condition, node.condition))
            return node
        return plan.transform_up(f)


def _substitute(expr: Expression, mapping: dict) -> Expression:
    def f(node):
        if isinstance(node, ColumnRef) and node._name in mapping:
            return mapping[node._name]
        return node
    return expr.transform_up(f)


def _project_mapping(proj: Project) -> dict:
    mapping = {}
    for e in proj.exprs:
        if isinstance(e, Alias):
            mapping[e.name()] = e.child
        elif isinstance(e, ColumnRef):
            mapping[e.name()] = e
    return mapping


class PushFilterThroughProject(Rule):
    name = "PushFilterThroughProject"
    schema_preserving = True

    def apply(self, plan):
        def f(node):
            if isinstance(node, Filter) and isinstance(node.child, Project):
                proj = node.child
                cond = _substitute(node.condition, _project_mapping(proj))
                try:
                    cond.dtype(proj.child.schema())
                except Exception:
                    return node  # references a computed column we can't inline
                return Project(Filter(proj.child, cond), proj.exprs)
            return node
        return plan.transform_up(f)


class PushFilterIntoScan(Rule):
    """Hand conjuncts to the source (reference: DataSource V2
    `SupportsPushDownFilters`). The source keeps what it can use for IO
    skipping; everything is still re-applied as a residual filter."""

    name = "PushFilterIntoScan"
    schema_preserving = True

    def apply(self, plan):
        def f(node):
            if isinstance(node, Filter) and isinstance(node.child, Scan):
                scan = node.child
                conjuncts = _split_conjuncts(node.condition)
                new_pushed = [c for c in conjuncts
                              if scan.source.can_push(c)
                              and not any(c is p for p in scan.pushed_filters)
                              and not any(structurally_equal(c, p)
                                          for p in scan.pushed_filters)]
                if not new_pushed:
                    return node
                new_scan = Scan(scan.source, scan.required_columns,
                                tuple(scan.pushed_filters) + tuple(new_pushed))
                return Filter(new_scan, node.condition)
            return node
        return plan.transform_up(f)


def _split_conjuncts(e: Expression) -> List[Expression]:
    if isinstance(e, And):
        return _split_conjuncts(e.children[0]) + _split_conjuncts(e.children[1])
    return [e]


class PruneColumns(Rule):
    """Top-down required-column propagation narrowing Scan nodes
    (reference: `ColumnPruning` + `V2ScanRelationPushDown`)."""

    name = "PruneColumns"
    schema_preserving = False

    def apply(self, plan):
        return self._prune(plan, None)

    def _prune(self, node: LogicalPlan, needed: Optional[Set[str]]):
        if isinstance(node, Scan):
            if needed is None:
                return node
            avail = node.source.schema().names
            for f in node.pushed_filters:
                needed = needed | f.references()
            from ..expr import case_sensitive
            if case_sensitive():
                cols = tuple(n for n in avail if n in needed)
            else:
                lowered = {n.lower() for n in needed}
                cols = tuple(n for n in avail if n.lower() in lowered)
            if node.required_columns is not None and \
                    set(node.required_columns) == set(cols):
                return node
            return Scan(node.source, cols, node.pushed_filters)
        if isinstance(node, Project):
            child_needed = set()
            for e in node.exprs:
                child_needed |= e.references()
            return Project(self._prune(node.child, child_needed), node.exprs)
        if isinstance(node, Filter):
            child_needed = None if needed is None else \
                needed | node.condition.references()
            return Filter(self._prune(node.child, child_needed), node.condition)
        if isinstance(node, Aggregate):
            child_needed = set()
            for g in node.group_exprs:
                child_needed |= g.references()
            for a in node.agg_exprs:
                child_needed |= a.func.references()
            return Aggregate(self._prune(node.child, child_needed),
                             node.group_exprs, node.agg_exprs)
        if isinstance(node, Join):
            left_names = set(node.left.schema().names)
            right_names = set(node.right.schema().names)
            refs = set()
            for k in node.left_keys + node.right_keys:
                refs |= k.references()
            if node.condition is not None:
                refs |= node.condition.references()
            if needed is None:
                ln = rn = None
            else:
                want = needed | refs
                # references use POST-join names (`_r`-suffixed on
                # collision): keep the whole `_r` chain alive
                rename = {out: orig for orig, out
                          in node.right_name_map().items()}
                ln = {n for n in want if n in left_names}
                rn = set()
                for w in want:
                    orig = rename.get(w, w)
                    if orig not in right_names:
                        continue
                    rn.add(orig)
                    step = orig
                    while step != w:
                        if step in left_names:
                            ln.add(step)
                        step = step + "_r"
            return copy_join(node, self._prune(node.left, ln),
                             self._prune(node.right, rn))
        if isinstance(node, Sort):
            child_needed = None
            if needed is not None:
                child_needed = set(needed)
                for o in node.orders:
                    child_needed |= o.child.references()
            return Sort(self._prune(node.child, child_needed), node.orders)
        if isinstance(node, Limit):
            return Limit(self._prune(node.child, needed), node.n)
        if isinstance(node, Union):
            return Union(self._prune(node.children[0], None),
                         self._prune(node.children[1], None))
        return node.map_children(lambda c: self._prune(c, None))



def copy_join(j: Join, left, right) -> Join:
    new = Join(left, right, j.left_keys, j.right_keys, j.how, j.condition,
               j.null_aware)
    # carry the reorder cost model's estimate through rebuilds (pruning
    # runs after the JoinReorder batch and must not strip it)
    if hasattr(j, "_cbo_est_rows"):
        new._cbo_est_rows = j._cbo_est_rows
    return new

class ConstantFolding(Rule):
    name = "ConstantFolding"
    schema_preserving = False

    def apply(self, plan):
        empty = ColBatch({}, None)

        def fold_expr(e: Expression) -> Expression:
            def f(node):
                if (node.foldable() and not isinstance(node, Literal)
                        and not isinstance(node, Alias)):
                    try:
                        dt = node.dtype(T.Schema([]))
                    except Exception:
                        return node
                    if isinstance(dt, (T.StringType, T.DecimalType)):
                        return node
                    try:
                        v = node.eval(empty)
                    except Exception:
                        return node
                    if v.validity is not None:
                        return node
                    return Literal(v.data.item(), dt)
                return node
            return e.transform_up(f)

        def f(node):
            if isinstance(node, Project):
                return Project(node.child, [fold_expr(e) for e in node.exprs])
            if isinstance(node, Filter):
                return Filter(node.child, fold_expr(node.condition))
            return node
        return plan.transform_up(f)


class CollapseProjectIntoAggregate(Rule):
    """Aggregate over Project -> Aggregate with the projected expressions
    inlined (reference: CollapseProject). Lets `key_domain` see through
    `(id % N) AS k` aliases and keep the dense-domain aggregate path."""

    name = "CollapseProjectIntoAggregate"
    schema_preserving = False

    def apply(self, plan):
        def f(node):
            if not (isinstance(node, Aggregate)
                    and isinstance(node.child, Project)):
                return node
            proj = node.child
            mapping = _project_mapping(proj)

            def subst(e: Expression) -> Optional[Expression]:
                out = _substitute(e, mapping)
                try:
                    out.dtype(proj.child.schema())
                except Exception:
                    return None
                return out

            new_groups = []
            for g in node.group_exprs:
                s = subst(g.child if isinstance(g, Alias) else g)
                if s is None:
                    return node
                new_groups.append(Alias(s, g.name()))
            new_aggs = []
            for a in node.agg_exprs:
                func = a.func
                if func.children:
                    args = [subst(c) for c in func.children]
                    if any(s is None for s in args):
                        return node
                    func = func.with_args(args)
                new_aggs.append(type(a)(func, a.out_name))
            return Aggregate(proj.child, new_groups, new_aggs)

        return plan.transform_up(f)


class RewriteDistinctAggregates(Rule):
    """count/sum/avg(DISTINCT x) -> the plain aggregate over a
    (groups, x) dedupe aggregate — the single-distinct case of the
    reference's `AggUtils.planAggregateWithOneDistinct` (Expand-based
    mixed plans are not supported; mixing distinct and plain aggregates
    raises)."""

    name = "RewriteDistinctAggregates"
    # count(distinct) -> count over a dedupe changes result nullability
    schema_preserving = False

    def apply(self, plan):
        from ..expr_agg import (AggExpr, Avg, AvgDistinct, Count,
                                CountDistinct, Sum, SumDistinct)
        markers = {CountDistinct: Count, SumDistinct: Sum,
                   AvgDistinct: Avg}

        def f(node):
            if not isinstance(node, Aggregate):
                return node
            distinct = [a for a in node.agg_exprs
                        if type(a.func) in markers]
            if not distinct:
                return node
            if len(distinct) != len(node.agg_exprs):
                raise AnalysisError(
                    "mixing DISTINCT aggregates with plain aggregates is "
                    "not supported yet")
            firsts = [a.func.child for a in distinct]
            if not all(structurally_equal(firsts[0], e) for e in firsts[1:]):
                raise AnalysisError(
                    "multiple DISTINCT aggregates on different expressions "
                    "are not supported yet")
            dedup_key = Alias(firsts[0], "__distinct_key")
            inner = Aggregate(node.child,
                              list(node.group_exprs) + [dedup_key], [])
            outer_groups = [ColumnRef(g.name()) for g in node.group_exprs]
            outer_aggs = [AggExpr(markers[type(a.func)](
                ColumnRef("__distinct_key")), a.out_name)
                for a in distinct]
            return Aggregate(inner, outer_groups, outer_aggs)

        return plan.transform_up(f)


class RewriteGroupKeyAggregates(Rule):
    """sum/min/max/avg OF A GROUP KEY rewrite to post-aggregation
    arithmetic: within a group every value of the key is identical, so
    sum(k) = k * count(k), min(k) = max(k) = k, avg(k) = k. This drops
    whole accumulator rows from the aggregate kernel (the MXU one-hot
    kernel's cost is linear in limb rows — the headline
    AggregateBenchmark shape `sum(k) group by k` goes from 4 limb rows
    to 1). No reference analog: WholeStageCodegen pays per-row cost for
    these regardless; the columnar formulation makes the rewrite free.

    NULL-key groups stay correct without conditionals: the projected
    key value is itself NULL exactly for that group, and sum's count
    factor only multiplies a non-null key."""

    name = "RewriteGroupKeyAggregates"
    # sum/min/max/avg of a group key become post-aggregation arithmetic
    # whose nullability follows the key, not the aggregate
    schema_preserving = False

    def apply(self, plan):
        from ..expr_agg import AggExpr, Avg, Count, Max, Min, Sum

        def match_group(node, child, child_schema):
            for g in node.group_exprs:
                base = g.child if isinstance(g, Alias) else g
                if structurally_equal(child, g) or \
                        structurally_equal(child, base):
                    return g
                if isinstance(child, ColumnRef) and \
                        child.name() == g.name():
                    # a bare name equal to the group ALIAS only means
                    # the group key when no real child column shadows
                    # it — group_by(col('a').alias('k')).agg(sum('k'))
                    # with an actual column k must aggregate column k
                    try:
                        child.dtype(child_schema)
                        resolves_in_child = True
                    except Exception:
                        resolves_in_child = False
                    if not resolves_in_child:
                        return g
            return None

        def f(node):
            if not isinstance(node, Aggregate) or not node.group_exprs:
                return node
            child_schema = node.child.schema()
            hits = {}
            for a in node.agg_exprs:
                if not isinstance(a.func, (Sum, Min, Max, Avg)) or \
                        a.func.child is None:
                    continue
                if isinstance(a.func, Avg) and isinstance(
                        a.func.child.dtype(child_schema), T.DecimalType):
                    continue  # avg(decimal) shifts scale; keep in agg
                try:
                    child_dt = a.func.child.dtype(child_schema)
                except Exception:
                    child_dt = None
                if isinstance(child_dt, T.FractionalType):
                    # -0.0 == 0.0 land in ONE group yet remain distinct
                    # values, so the group's key representative is not
                    # value-faithful: max(k) over {-0.0, 0.0} is 0.0
                    # but the kept key may be -0.0 (and sum(k) != k*n).
                    # Found by the differential plan fuzzer (seed class
                    # 166/284/455); float keys keep the real aggregate.
                    continue
                g = match_group(node, a.func.child, child_schema)
                if g is not None:
                    hits[a.out_name] = (a, g)
            if not hits:
                return node

            remaining = [a for a in node.agg_exprs
                         if a.out_name not in hits]
            # one count per distinct summed key expression
            cnt_names = {}
            counts = []
            for out_name, (a, g) in hits.items():
                if not isinstance(a.func, Sum):
                    continue
                key = repr(g)
                if key not in cnt_names:
                    cnt_names[key] = f"__gk_cnt{len(cnt_names)}"
                    counts.append(AggExpr(Count(a.func.child),
                                          cnt_names[key]))
            inner = Aggregate(node.child, node.group_exprs,
                              remaining + counts)
            out_exprs = [ColumnRef(g.name()) for g in node.group_exprs]
            for a in node.agg_exprs:
                hit = hits.get(a.out_name)
                if hit is None:
                    out_exprs.append(ColumnRef(a.out_name))
                    continue
                _, g = hit
                keyref = ColumnRef(g.name())
                want = a.func.result_type(child_schema)
                if isinstance(a.func, Sum):
                    e = Mul(keyref, ColumnRef(cnt_names[repr(g)]))
                    if type(e.dtype(inner.schema())) is not type(want) or \
                            isinstance(want, T.DecimalType):
                        e = Cast(e, want)
                elif isinstance(a.func, Avg):
                    e = Cast(keyref, want)
                else:  # min/max of the key is the key
                    e = keyref
                out_exprs.append(Alias(e, a.out_name))
            return Project(inner, out_exprs)

        return plan.transform_up(f)


EXCLUDED_RULES_KEY = "spark_tpu.sql.optimizer.excludedRules"


def excluded_rule_names(conf) -> Set[str]:
    """Parse `spark_tpu.sql.optimizer.excludedRules` (comma-separated
    rule names; `*` = every rule)."""
    if conf is None:
        return set()
    raw = str(conf.get(EXCLUDED_RULES_KEY) or "")
    return {s.strip() for s in raw.split(",") if s.strip()}


def default_optimizer(conf=None, reorder_log=None, validator=None,
                      tracer=None) -> RuleExecutor:
    """`conf` enables the conf-gated batch (cost-based join reorder) and
    the excludedRules lever; without it the pipeline is the
    conf-independent rule set. `reorder_log` is a list the reorder rule
    appends its decision records to. `validator`/`tracer` are the
    plan-integrity hooks (`analysis/plan_integrity.py`) the executor
    installs from `planChangeValidation` / `planChangeLog`."""
    from .join_reorder import CostBasedJoinReorder
    batches = [
        Batch("Rewrite", [RewriteDistinctAggregates()], strategy="once"),
        Batch("Filter pushdown", [
            CombineFilters(),
            PushFilterThroughProject(),
            PushFilterIntoScan(),
        ]),
        # after pushdown (selectivities read the settled Filter chains),
        # before pruning/collapse (which see the reordered tree)
        Batch("JoinReorder", [CostBasedJoinReorder(conf, reorder_log)],
              strategy="once"),
        Batch("Collapse", [CollapseProjectIntoAggregate()]),
        Batch("KeyAggs", [RewriteGroupKeyAggregates()], strategy="once"),
        Batch("Fold", [ConstantFolding()], strategy="once"),
        Batch("Prune", [PruneColumns()], strategy="once"),
    ]
    excluded = excluded_rule_names(conf)
    if excluded:
        kept = []
        for b in batches:
            rules = [r for r in b.rules
                     if "*" not in excluded and r.name not in excluded]
            if rules:
                kept.append(Batch(b.name, rules, b.strategy,
                                  b.max_iterations))
        batches = kept
    return RuleExecutor(batches, validator=validator, tracer=tracer)
