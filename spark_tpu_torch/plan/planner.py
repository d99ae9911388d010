"""Logical -> physical planning (the port of `spark_tpu/plan/planner.py`;
reference: `SparkPlanner.scala:28` strategies + `EnsureRequirements.scala:44`).

After conversion, `ensure_requirements` inserts an exchange wherever a
child's partitioning does not meet its parent's required distribution.
On one device every leaf is one partition, so the only exchange is the
replicated build side of a join without key columns (a cross join
lowers to a join on literal keys). On a mesh (mesh.size > 1), as in the
JAX package:

- leaves shard rows over the data axis (their partitioning becomes
  Unknown, which forces exchanges);
- aggregates split into partial -> exchange -> final (the
  `AggUtils.scala` two-phase plan), so only accumulator tables move
  between shards; positional aggregates stay complete;
- joins pick broadcast or shuffle from source row estimates against
  `autoBroadcastJoinThreshold` (`SparkStrategies.scala JoinSelection:142`);
  the adaptive re-planner can force a join to broadcast
  (`join_strategy_overrides`).

Then runtime join filters are injected (`runtime_filter.py`, when
`runtimeFilter.enabled`) and every join, exchange, aggregate and filter
node gets the tag its flags and metrics carry.
"""

from __future__ import annotations

from typing import Optional

from ..columnar import bucket_capacity
from ..config import Conf
from ..expr import AnalysisError, ColumnRef
from . import logical as L
from . import physical as P


def plan_physical(plan: L.LogicalPlan, conf: Conf,
                  join_strategy_overrides: Optional[dict] = None
                  ) -> P.PhysicalPlan:
    """`join_strategy_overrides` ({join_tag: strategy}) is the adaptive
    re-planner's seam (DynamicJoinSelection.scala:1): join tags depend
    only on join order in the converted tree, so they are stable across
    re-plans of one optimized plan; overrides apply before exchange
    insertion, so requirements re-derive for the new strategy."""
    n = max(1, int(conf.get("spark_tpu.sql.mesh.size")))
    phys = _convert(plan, conf, n)
    if join_strategy_overrides:
        _assign_join_tags(phys)
        _apply_strategy_overrides(phys, join_strategy_overrides)
    phys = ensure_requirements(phys, conf, n)
    from .runtime_filter import ENABLED_KEY, inject_runtime_filters
    if bool(conf.get(ENABLED_KEY)):
        phys = inject_runtime_filters(phys, conf)
    _assign_join_tags(phys)
    return phys


def _apply_strategy_overrides(plan: P.PhysicalPlan,
                              overrides: dict) -> None:
    for c in plan.children:
        _apply_strategy_overrides(c, overrides)
    if isinstance(plan, P.JoinExec) and plan.tag in overrides:
        plan.strategy = overrides[plan.tag]


def _assign_join_tags(plan: P.PhysicalPlan) -> None:
    """Stable per-node tags for the join/aggregate/runtime-filter flags
    and metrics (the executor's re-plan loop keys on them), numbered in
    post-order as the JAX package numbers them. Every node also gets an
    `op_tag` (`op0`, `op1`, ...), which its output row count is kept
    under (`rows_<op_tag>`, shown by `explain(runtime=True)`)."""
    counters = {"j": 0, "cj": 0, "e": 0, "a": 0, "rf": 0, "op": 0}
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
        node.op_tag = next_tag("op")

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


def _estimated_bytes(plan: L.LogicalPlan) -> Optional[int]:
    rows = estimate_rows(plan)
    if rows is None:
        return None
    return rows * 8 * max(1, len(plan.schema().fields))


def _pick_join_strategy(plan: L.Join, conf: Conf, n: int) -> str:
    if n <= 1:
        return "shuffle"  # the strategies coincide on one device
    if plan.how in ("right", "full"):
        # a replicated build would emit its unmatched rows on every shard
        return "shuffle"
    threshold = int(conf.get("spark_tpu.sql.autoBroadcastJoinThreshold"))
    est = _estimated_bytes(plan.right)
    if est is not None and est <= threshold:
        return "broadcast"
    return "shuffle"


def _convert(plan: L.LogicalPlan, conf: Conf, n: int) -> P.PhysicalPlan:
    if isinstance(plan, L.Range):
        node = P.RangeExec(plan.start, plan.end, plan.step)
        node.dist_n = n
        return node
    if isinstance(plan, L.Scan):
        node = P.ScanExec(plan.source, plan.required_columns,
                          plan.pushed_filters)
        node.dist_n = n
        return node
    if isinstance(plan, L.Project):
        return P.ProjectExec(_convert(plan.child, conf, n), plan.exprs)
    if isinstance(plan, L.Filter):
        return P.FilterExec(_convert(plan.child, conf, n), plan.condition)
    if isinstance(plan, L.Aggregate):
        child = _convert(plan.child, conf, n)
        est = int(conf.get("spark_tpu.sql.aggregate.estimatedGroups"))
        rows = estimate_rows(plan.child)
        if rows is not None:
            est = min(est, bucket_capacity(max(1, rows)))
        positional = any(getattr(a.func, "positional", False)
                         for a in plan.agg_exprs)
        if n <= 1 or positional:
            # one device needs no partial/final split, and positional
            # aggregates (percentile/collect_*) have none: one complete
            # pass per shard behind the exchange its requirement demands
            return P.HashAggregateExec(child, plan.group_exprs,
                                       plan.agg_exprs, mode="complete",
                                       est_groups=est)
        # two-phase: per-shard partial tables, exchange by group key (or
        # gathered to every shard for a global aggregate), final re-reduce
        partial = P.HashAggregateExec(child, plan.group_exprs,
                                      plan.agg_exprs, mode="partial",
                                      est_groups=est)
        final_groups = [ColumnRef(g.name()) for g in plan.group_exprs]
        return P.HashAggregateExec(partial, final_groups, plan.agg_exprs,
                                   mode="final", est_groups=est)
    if isinstance(plan, L.Sort):
        return P.SortExec(_convert(plan.child, conf, n), plan.orders)
    if isinstance(plan, L.Limit):
        return P.LimitExec(_convert(plan.child, conf, n), plan.n)
    if isinstance(plan, L.Join):
        exec_ = P.JoinExec(_convert(plan.left, conf, n),
                           _convert(plan.right, conf, n),
                           plan.left_keys, plan.right_keys, plan.how,
                           plan.condition, plan.schema(),
                           strategy=_pick_join_strategy(plan, conf, n))
        exec_.null_aware = plan.null_aware
        # the reorder cost model's estimate (plan/join_reorder.py):
        # advisory only -- graded as a `join_rows` prediction, shown by
        # explain(runtime=True); never part of the plan's describe()
        exec_.cbo_est_rows = getattr(plan, "_cbo_est_rows", None)
        return exec_
    if isinstance(plan, L.WindowPlan):
        return P.WindowExec(_convert(plan.child, conf, n), plan.wexprs,
                            plan.schema())
    if isinstance(plan, L.Watermark):
        return _convert(plan.child, conf, n)  # batch: passthrough
    if isinstance(plan, L.Generate):
        return P.GenerateExec(_convert(plan.child, conf, n), plan.gen_expr,
                              plan.out_name, plan.schema(), outer=plan.outer)
    if isinstance(plan, L.Union):
        return P.UnionExec(_convert(plan.children[0], conf, n),
                           _convert(plan.children[1], conf, n),
                           plan.schema())
    raise AnalysisError(f"no physical strategy for {type(plan).__name__}")


def _join_co_partitioned(left: P.PhysicalPlan, right: P.PhysicalPlan,
                         lk, rk) -> bool:
    """True when both join children are already laid out so equal keys
    share a shard. Checked jointly — each side meeting its clustered
    requirement alone is not enough: hash layouts on different key
    subsets (or positions) send equal rows to different shards
    (reference: EnsureRequirements' key-ordering co-partition check)."""
    lp = left.output_partitioning()
    rp = right.output_partitioning()
    if isinstance(lp, P.SinglePartition) and isinstance(rp, P.SinglePartition):
        return True
    if not (isinstance(lp, P.HashPartitioning)
            and isinstance(rp, P.HashPartitioning)):
        return False
    if lp.num_partitions != rp.num_partitions or not lp.keys:
        return False
    try:
        lpos = [lk.index(k) for k in lp.keys]
        rpos = [rk.index(k) for k in rp.keys]
    except ValueError:
        return False
    return lpos == rpos


def ensure_requirements(plan: P.PhysicalPlan, conf: Conf,
                        n: int = 1) -> P.PhysicalPlan:
    """Insert exchanges where a child's partitioning fails its parent's
    requirement (reference: EnsureRequirements.ensureDistributionAndOrdering:49)."""
    import copy
    new_children = tuple(ensure_requirements(c, conf, n)
                         for c in plan.children)
    if new_children != plan.children:
        plan = copy.copy(plan)
        plan.children = new_children

    dists = plan.required_child_distributions()
    parts = n if n > 1 else int(conf.get("spark_tpu.sql.shuffle.partitions"))

    if isinstance(plan, P.JoinExec) and dists and \
            isinstance(dists[0], P.ClusteredDistribution):
        lk, rk = dists[0].keys, dists[1].keys
        if not _join_co_partitioned(plan.left, plan.right, list(lk),
                                    list(rk)):
            plan = copy.copy(plan)
            plan.children = (
                P.ExchangeExec(plan.children[0],
                               P.HashPartitioning(lk, parts)),
                P.ExchangeExec(plan.children[1],
                               P.HashPartitioning(rk, parts)))
        return plan

    fixed = []
    changed = False
    for child, dist in zip(plan.children, dists):
        if child.output_partitioning().satisfies(dist):
            fixed.append(child)
            continue
        changed = True
        if isinstance(dist, P.ClusteredDistribution):
            fixed.append(P.ExchangeExec(
                child, P.HashPartitioning(dist.keys, parts)))
        elif isinstance(dist, P.OrderedDistribution):
            fixed.append(P.ExchangeExec(
                child, P.RangePartitioning(dist.order_key, parts,
                                           orders=plan.orders)))
        elif isinstance(dist, P.AllTuples):
            fixed.append(P.ExchangeExec(child, P.SinglePartition()))
        elif isinstance(dist, P.BroadcastDistribution):
            fixed.append(P.ExchangeExec(child, P.Replicated()))
        else:
            fixed.append(child)
    if changed:
        plan = copy.copy(plan)
        plan.children = tuple(fixed)
    return plan
