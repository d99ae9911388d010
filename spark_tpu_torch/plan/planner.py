"""Logical -> physical planning, single device (the port of
`spark_tpu/plan/planner.py` at mesh size 0; reference:
`SparkPlanner.scala:28`).

After conversion, `ensure_requirements` inserts an exchange wherever a
child's partitioning does not meet its parent's required distribution
(reference: `EnsureRequirements.scala:44`), as the JAX package does at
mesh size 0: there every leaf is one partition, so the only exchange is
the replicated build side of a join without key columns (a cross join
lowers to a join on literal keys). Then runtime join filters are
injected (`runtime_filter.py`, when `runtimeFilter.enabled`) and every
join, exchange, aggregate and filter node gets the tag its flags and
metrics carry.
"""

from __future__ import annotations

from typing import Optional

from ..columnar import bucket_capacity
from ..config import Conf
from ..expr import AnalysisError
from . import logical as L
from . import physical as P


def plan_physical(plan: L.LogicalPlan, conf: Conf) -> P.PhysicalPlan:
    phys = ensure_requirements(_convert(plan, conf))
    from .runtime_filter import ENABLED_KEY, inject_runtime_filters
    if bool(conf.get(ENABLED_KEY)):
        phys = inject_runtime_filters(phys, conf)
    _assign_join_tags(phys)
    return phys


def _assign_join_tags(plan: P.PhysicalPlan) -> None:
    """Stable per-node tags for the join/aggregate/runtime-filter flags
    and metrics (the executor's re-plan loop keys on them), numbered in
    post-order as the JAX package numbers them."""
    counters = {"j": 0, "cj": 0, "e": 0, "a": 0, "rf": 0}
    seen = set()  # creation chains are DAG-shared under rf nodes:
    # tag each node once

    def next_tag(kind: str) -> str:
        counters[kind] += 1
        return f"{kind}{counters[kind] - 1}"

    def walk(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for c in node.children:
            walk(c)
        if isinstance(node, P.JoinExec):
            # runtime-filter creation semis count apart, so injecting
            # one never renumbers the real joins
            node.tag = next_tag("cj" if node.creation_side else "j")
        elif isinstance(node, P.ExchangeExec):
            node.tag = next_tag("e")
        elif isinstance(node, P.HashAggregateExec):
            node.tag = next_tag("a")
        elif isinstance(node, P.RuntimeFilterExec):
            node.tag = next_tag("rf")

    walk(plan)


def estimate_rows(plan: L.LogicalPlan) -> Optional[int]:
    """Upper-bound row estimate from source statistics. None = unknown."""
    if isinstance(plan, L.Range):
        return plan.num_rows()
    if isinstance(plan, L.Scan):
        return plan.source.estimated_rows()
    if isinstance(plan, (L.Project, L.Filter, L.Sort)):
        return estimate_rows(plan.children[0])
    if isinstance(plan, L.Limit):
        child = estimate_rows(plan.children[0])
        return plan.n if child is None else min(plan.n, child)
    if isinstance(plan, L.Aggregate):
        return estimate_rows(plan.children[0])
    if isinstance(plan, L.Join) and plan.how == "inner":
        l = estimate_rows(plan.children[0])
        r = estimate_rows(plan.children[1])
        if l is not None and r is not None:
            return max(l, r)
    return None


def _convert(plan: L.LogicalPlan, conf: Conf) -> P.PhysicalPlan:
    if isinstance(plan, L.Range):
        return P.RangeExec(plan.start, plan.end, plan.step)
    if isinstance(plan, L.Scan):
        return P.ScanExec(plan.source, plan.required_columns,
                          plan.pushed_filters)
    if isinstance(plan, L.Project):
        return P.ProjectExec(_convert(plan.child, conf), plan.exprs)
    if isinstance(plan, L.Filter):
        return P.FilterExec(_convert(plan.child, conf), plan.condition)
    if isinstance(plan, L.Aggregate):
        child = _convert(plan.child, conf)
        est = int(conf.get("spark_tpu.sql.aggregate.estimatedGroups"))
        rows = estimate_rows(plan.child)
        if rows is not None:
            est = min(est, bucket_capacity(max(1, rows)))
        return P.HashAggregateExec(child, plan.group_exprs, plan.agg_exprs,
                                   mode="complete", est_groups=est)
    if isinstance(plan, L.Sort):
        return P.SortExec(_convert(plan.child, conf), plan.orders)
    if isinstance(plan, L.Limit):
        return P.LimitExec(_convert(plan.child, conf), plan.n)
    if isinstance(plan, L.Join):
        exec_ = P.JoinExec(_convert(plan.left, conf), _convert(plan.right, conf),
                           plan.left_keys, plan.right_keys, plan.how,
                           plan.condition, plan.schema())
        exec_.null_aware = plan.null_aware
        return exec_
    if isinstance(plan, L.WindowPlan):
        return P.WindowExec(_convert(plan.child, conf), plan.wexprs,
                            plan.schema())
    if isinstance(plan, L.Union):
        return P.UnionExec(_convert(plan.children[0], conf),
                           _convert(plan.children[1], conf), plan.schema())
    raise AnalysisError(f"no physical strategy for {type(plan).__name__}")


def ensure_requirements(plan: P.PhysicalPlan) -> P.PhysicalPlan:
    """Insert exchanges where a child's partitioning fails its parent's
    requirement (reference: EnsureRequirements.ensureDistributionAndOrdering:49),
    the JAX package's rule at mesh size 0. Every child is one partition
    there, so only a broadcast requirement (the build side of a join
    without key columns) is ever unmet."""
    import copy
    new_children = tuple(ensure_requirements(c) for c in plan.children)
    if new_children != plan.children:
        plan = copy.copy(plan)
        plan.children = new_children

    fixed = []
    changed = False
    for child, dist in zip(plan.children, plan.required_child_distributions()):
        if child.output_partitioning().satisfies(dist):
            fixed.append(child)
            continue
        if not isinstance(dist, P.BroadcastDistribution):
            raise AnalysisError(f"no exchange meets {dist!r} on one device")
        changed = True
        fixed.append(P.ExchangeExec(child, P.Replicated()))
    if changed:
        plan = copy.copy(plan)
        plan.children = tuple(fixed)
    return plan
