"""Query execution pipeline, eager (the port of `QueryExecution` in
`spark_tpu/execution/executor.py`; reference: `QueryExecution.scala`).

analyzed -> optimized_plan -> executed_plan -> execute_batch -> collect.
Before optimization, subtrees marked for statement-scoped
materialization (WITH-clause views) are replaced by scans of their
computed tables (`__cached__`), and uncorrelated scalar subqueries run
and become literals, as in the JAX package. There is no jit stage or
compile cache: torch runs every operator
eagerly on the session's device, bottom-up over the physical tree. A
node that several parents share (a runtime filter's creation chain is
the same node objects as its join's build side) runs once per attempt.

The adaptive re-plan loop is the JAX package's, in eager form: after a
run, the executor reads the flags operators raised (a join's output
overflowed its capacity, a unique-build join met a duplicate key, a hash
table saturated, a sort aggregate met more groups than its table holds),
sets the node's state as the reference does, and runs the query again,
at most `MAX_ATTEMPTS` times. After a converged run it shrinks the
output capacity of every join a runtime filter pruned for (the
reference's `_shrink_caps_from_rtf`), so node state — and the printed
plan — match the JAX package's after a run.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import pyarrow as pa

from ..columnar import Batch, bucket_capacity
from ..expr import Literal
from ..io.sources import ArrowTableSource
from ..plan import logical as L
from ..plan import physical as P
from ..plan.optimizer import default_optimizer
from ..plan.planner import plan_physical

#: attempts of the re-plan loop before it gives up
MAX_ATTEMPTS = 8

_REPLAN_FLAGS = ("join_overflow_", "join_nonunique_", "join_hashsat_",
                 "agg_overflow_")


def run_plan(root: P.PhysicalPlan, ctx: P.ExecContext,
             visit=None) -> Batch:
    """Compute `root` bottom-up, each node once however many parents
    share it. `visit(node, compute)` wraps each node's computation when
    given (a profiler's seam)."""
    memo: Dict[int, Batch] = {}

    def run(node: P.PhysicalPlan) -> Batch:
        out = memo.get(id(node))
        if out is None:
            inputs = [run(c) for c in node.children]
            out = node.compute(ctx, inputs) if visit is None else \
                visit(node, lambda: node.compute(ctx, inputs))
            memo[id(node)] = out
        return out

    return run(root)


def plan_nodes(root: P.PhysicalPlan, kind) -> List:
    """Every node of type `kind` in post-order, each once (the plan is a
    DAG)."""
    seen, out = set(), []

    def walk(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for c in node.children:
            walk(c)
        if isinstance(node, kind):
            out.append(node)

    walk(root)
    return out


def apply_flags(root: P.PhysicalPlan, flags: List[str],
                metrics: Dict[str, object]) -> None:
    """Set the node state each raised re-plan flag asks for."""
    joins = {j.tag: j for j in plan_nodes(root, P.JoinExec)}
    aggs = {a.tag: a for a in plan_nodes(root, P.HashAggregateExec)}
    for k in flags:
        if k.startswith("join_nonunique_"):
            joins[k[len("join_nonunique_"):]].unique_build = False
        elif k.startswith("join_hashsat_"):
            # a correctness re-plan like the unique-build fallback:
            # pin this join to the sort kernel
            joins[k[len("join_hashsat_"):]].hash_fallback = False
        elif k.startswith("join_overflow_"):
            tag = k[len("join_overflow_"):]
            total = int(metrics[f"join_rows_{tag}"])
            joins[tag].out_cap = bucket_capacity(max(total, 8))
        else:
            tag = k[len("agg_overflow_"):]
            total = int(metrics[f"agg_groups_{tag}"])
            aggs[tag].est_groups = bucket_capacity(max(total, 8))


def shrink_caps_from_rtf(root: P.PhysicalPlan,
                         metrics: Dict[str, object]) -> None:
    """Shrink the output capacity of each join a runtime filter guards:
    the join's capacity was seeded from the unpruned probe capacity, and
    the survivors (rtf_tested - rtf_pruned) bound what its output holds
    on the next run. The measured join_rows floor the new value, so a
    shrunk capacity never overflows on the same data."""
    def walk(node, ancestors):
        for c in node.children:
            walk(c, ancestors + (node,))
        if not isinstance(node, P.RuntimeFilterExec):
            return
        tested = metrics.get(f"rtf_tested_{node.tag}")
        pruned = metrics.get(f"rtf_pruned_{node.tag}")
        if tested is None or pruned is None:
            return
        surv = int(tested) - int(pruned)
        if int(tested) <= 0 or int(pruned) <= 0 or surv < 0:
            return  # the filter never pruned: nothing to shrink from
        # climb from the filter to the join it guards (narrow ops pass)
        for anc in reversed(ancestors):
            if isinstance(anc, (P.ProjectExec, P.FilterExec,
                                P.RuntimeFilterExec)):
                continue
            if isinstance(anc, P.JoinExec):
                actual = int(metrics.get(f"join_rows_{anc.tag}", 0))
                new = bucket_capacity(max(2 * surv, actual, 8))
                if anc.out_cap is None or new < anc.out_cap:
                    anc.out_cap = new
            break  # the guarded join (or an opaque op) ends the climb

    walk(root, ())


class QueryExecution:
    def __init__(self, session, logical: L.LogicalPlan):
        self.session = session
        self.logical = logical
        self._analyzed: Optional[L.LogicalPlan] = None
        self._optimized: Optional[L.LogicalPlan] = None
        self._executed: Optional[P.PhysicalPlan] = None
        self.phase_times: Dict[str, float] = {}
        self.last_metrics: Dict[str, object] = {}
        #: runs the last execute_batch took (1 + re-plans)
        self.attempts = 0

    def _activate_conf(self) -> None:
        from ..expr import set_case_sensitive
        set_case_sensitive(bool(
            self.session.conf.get("spark_tpu.sql.caseSensitive")))

    @property
    def analyzed(self) -> L.LogicalPlan:
        if self._analyzed is None:
            t0 = time.perf_counter()
            self._activate_conf()
            self.logical.schema()  # eager name/type resolution raises here
            self._analyzed = self.logical
            self.phase_times["analysis"] = time.perf_counter() - t0
        return self._analyzed

    def _apply_cache(self, plan: L.LogicalPlan) -> L.LogicalPlan:
        """Substitute marked subtrees with scans over their materialized
        tables (reference: CacheManager.useCachedData). A marked subtree
        not yet computed in this statement is computed on first use.
        Matching is on the pre-optimization plan fingerprint."""
        session = self.session
        if not session._cache_requests:
            return plan
        root_fp = session._plan_fingerprint(plan)

        def f(node):
            fp = session._plan_fingerprint(node)
            table = session._data_cache.get(fp)
            if table is None and fp in session._cache_requests \
                    and fp != root_fp:
                # first use inside a larger query: compute it now (the
                # root itself runs on the normal path)
                table = QueryExecution(
                    session, session._cache_requests[fp]).collect()
                session._data_cache[fp] = table
            if table is not None:
                return L.Scan(ArrowTableSource("__cached__", table))
            return None

        # top-down so the largest marked subtree wins
        return plan.transform_down(f)

    def _resolve_scalar_subqueries(self, plan: L.LogicalPlan
                                   ) -> L.LogicalPlan:
        """Run uncorrelated scalar subqueries and substitute their single
        value as a Literal — before optimization, so the literal takes
        part in pushdown (reference: PlanSubqueries + ScalarSubquery
        execution). The value reaches the host with one sync."""
        def has_subquery(e) -> bool:
            return isinstance(e, L.ScalarSubqueryExpr) or \
                any(has_subquery(c) for c in e.children)

        if not any(has_subquery(e) for e in L.iter_expressions(plan)):
            return plan

        def resolve(node):
            if not isinstance(node, L.ScalarSubqueryExpr):
                return node
            fields = node.plan.schema().fields
            if len(fields) != 1:
                raise RuntimeError(
                    "scalar subquery must return exactly one column")
            table = QueryExecution(self.session, node.plan).collect()
            if table.num_rows > 1:
                raise RuntimeError(
                    "scalar subquery returned more than one row")
            val = None if table.num_rows == 0 else \
                table.column(0)[0].as_py()
            return Literal(val, fields[0].dtype)

        return L.map_expressions(plan, lambda e: e.transform_up(resolve))

    @property
    def optimized_plan(self) -> L.LogicalPlan:
        if self._optimized is None:
            t0 = time.perf_counter()
            plan = self._resolve_scalar_subqueries(
                self._apply_cache(self.analyzed))
            self._optimized = default_optimizer(self.session.conf).execute(
                plan)
            self.phase_times["optimization"] = time.perf_counter() - t0
        return self._optimized

    @property
    def executed_plan(self) -> P.PhysicalPlan:
        if self._executed is None:
            t0 = time.perf_counter()
            self._executed = plan_physical(self.optimized_plan,
                                           self.session.conf)
            self.phase_times["planning"] = time.perf_counter() - t0
        return self._executed

    def execute_batch(self) -> Batch:
        session = self.session
        session._exec_depth += 1
        try:
            return self._execute_batch()
        finally:
            session._exec_depth -= 1
            if session._exec_depth == 0:
                # statement-scoped materializations end with the
                # outermost execution; the marks stay, so running the
                # statement again computes a shared view once again
                session._data_cache.clear()

    def _execute_batch(self) -> Batch:
        root = self.executed_plan
        conf = self.session.conf
        adaptive = bool(conf.get("spark_tpu.sql.adaptive.enabled"))
        t0 = time.perf_counter()
        overflow: List[str] = []
        for attempt in range(MAX_ATTEMPTS):
            ctx = P.ExecContext(conf, self.session.device)
            out = run_plan(root, ctx)
            overflow = [k for k, v in ctx.flags.items()
                        if k.startswith(_REPLAN_FLAGS) and bool(v)]
            if not overflow:
                break
            # unique-build / hash-saturation fallbacks are correctness
            # re-plans, not capacity growth — never gated by the conf
            if not adaptive and any(
                    not k.startswith(("join_nonunique_", "join_hashsat_"))
                    for k in overflow):
                raise RuntimeError(
                    f"capacity overflow in {overflow} with adaptive "
                    f"re-planning disabled "
                    f"(spark_tpu.sql.adaptive.enabled=false)")
            apply_flags(root, overflow, ctx.metrics)
        else:
            raise RuntimeError(f"capacity retries did not converge; still "
                               f"overflowing: {overflow}")
        self.attempts = attempt + 1
        self.last_metrics = {
            k: (float(v) if isinstance(v, float) else int(v))
            for k, v in ctx.metrics.items()}
        if adaptive:
            shrink_caps_from_rtf(root, self.last_metrics)
        self.phase_times["execute"] = time.perf_counter() - t0
        return out

    def collect(self) -> pa.Table:
        batch = self.execute_batch()
        t0 = time.perf_counter()
        table = batch.to_arrow()
        self.phase_times["egress"] = time.perf_counter() - t0
        return table
