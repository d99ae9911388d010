"""Logical optimizer rules (the port of `spark_tpu/plan/optimizer.py`).

Ported so far: filter combination, filter pushdown through projections
and into scans, the projection collapse into aggregates, constant
folding and column pruning — the rules that shape Q1's and Q6's plans
(reference: `optimizer/Optimizer.scala:42`). The batches keep the JAX
package's order; RewriteDistinctAggregates, CostBasedJoinReorder and
RewriteGroupKeyAggregates are not ported yet (none of them rewrites a
plan of the slice).
"""

from __future__ import annotations

from typing import List, Optional, Set

from .. import types as T
from ..columnar import Batch as ColBatch
from ..expr import (Alias, And, ColumnRef, Expression, Literal,
                    structurally_equal)
from .logical import (Aggregate, Filter, Join, Limit, LogicalPlan, Project,
                      Scan, Sort)
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
            return Join(self._prune(node.left, ln),
                        self._prune(node.right, rn), node.left_keys,
                        node.right_keys, node.how, node.condition,
                        node.null_aware)
        if isinstance(node, Sort):
            child_needed = None
            if needed is not None:
                child_needed = set(needed)
                for o in node.orders:
                    child_needed |= o.child.references()
            return Sort(self._prune(node.child, child_needed), node.orders)
        if isinstance(node, Limit):
            return Limit(self._prune(node.child, needed), node.n)
        return node.map_children(lambda c: self._prune(c, None))


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


EXCLUDED_RULES_KEY = "spark_tpu.sql.optimizer.excludedRules"


def excluded_rule_names(conf) -> Set[str]:
    """Parse `spark_tpu.sql.optimizer.excludedRules` (comma-separated
    rule names; `*` = every rule)."""
    if conf is None:
        return set()
    raw = str(conf.get(EXCLUDED_RULES_KEY) or "")
    return {s.strip() for s in raw.split(",") if s.strip()}


def default_optimizer(conf=None) -> RuleExecutor:
    batches = [
        Batch("Filter pushdown", [
            CombineFilters(),
            PushFilterThroughProject(),
            PushFilterIntoScan(),
        ]),
        Batch("Collapse", [CollapseProjectIntoAggregate()]),
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
    return RuleExecutor(batches)
