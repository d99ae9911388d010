"""Query execution pipeline, eager (the port of `QueryExecution` in
`spark_tpu/execution/executor.py`; reference: `QueryExecution.scala`).

analyzed -> optimized_plan -> executed_plan -> execute_batch -> collect.
Before optimization, subtrees the session's data cache holds (a
`cache()`-marked plan, a WITH-clause view) are replaced by scans of
their materialized tables (`__cached__`), and uncorrelated scalar
subqueries run and become literals, as in the JAX package. After the
root of a marked plan runs, its result fills the cache; when the
outermost execution ends, only the statement-scoped (implicit) entries
are evicted. `explain()` prints the plans, the cost-based reorder's
decisions, per-operator output rows after a run (`rows_<op_tag>`) and
the optimizer's rule trace. There is no jit stage or
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

Two kinds of state outlive an execution, as in the JAX package. Scans
load once per execution, before the re-plan loop, through the device
table cache (`io/device_cache.py`), so every attempt and every later
query over the same data reuses the loaded batches. And the capacities a
converged run settled on are kept in `session._aqe_caps`, keyed by the
optimized plan and its sources' identity stamps: the next execution of
that plan starts from them and skips the re-plan attempts.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import pyarrow as pa
import torch

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


#: most plans `session._aqe_caps` keeps (plan strings are large)
MAX_SAVED_PLANS = 256


def run_plan(root: P.PhysicalPlan, ctx: P.ExecContext,
             visit=None, loaded: Optional[Dict[int, Batch]] = None
             ) -> Batch:
    """Compute `root` bottom-up, each node once however many parents
    share it. `loaded` maps node ids to batches computed already (the
    scans `load_scans` loaded), which are not computed again.
    `visit(node, compute)` wraps each node's computation when given (a
    profiler's seam). Each node it computes (not the loaded scans, which
    the JAX package feeds in as inputs) keeps its live output rows as
    the metric `rows_<op_tag>` (the SQLMetrics analog), counted inside
    the computation `visit` times."""
    memo: Dict[int, Batch] = dict(loaded or {})

    def compute(node: P.PhysicalPlan, inputs: List[Batch]) -> Batch:
        out = node.compute(ctx, inputs)
        if hasattr(node, "op_tag"):
            ctx.add_metric(f"rows_{node.op_tag}",
                           out.capacity if out.selection is None
                           else out.selection.sum())
        return out

    def run(node: P.PhysicalPlan) -> Batch:
        out = memo.get(id(node))
        if out is None:
            inputs = [run(c) for c in node.children]
            out = compute(node, inputs) if visit is None else \
                visit(node, lambda: compute(node, inputs))
            memo[id(node)] = out
        return out

    return run(root)


def host_metrics(metrics: Dict[str, object]) -> Dict[str, object]:
    """Metric values on the host: floats stay floats, the rest become
    ints; the device tensors among them leave the card in one copy per
    dtype class."""
    out: Dict[str, object] = {}
    pending = {True: [], False: []}  # is float -> [(name, tensor)]
    for k, v in metrics.items():
        if isinstance(v, torch.Tensor):
            pending[v.is_floating_point()].append((k, v))
        else:
            out[k] = float(v) if isinstance(v, float) else int(v)
    for is_float, items in pending.items():
        if not items:
            continue
        dtype = torch.float64 if is_float else torch.int64
        values = torch.stack([t.reshape(()).to(dtype)
                              for _, t in items]).tolist()
        for (k, _), v in zip(items, values):
            out[k] = float(v) if is_float else int(v)
    return out


def render_trace(records: List[Dict]) -> List[str]:
    """`explain(rules=True)` lines for a rule-trace record list (the
    JAX package's `analysis/plan_integrity.render_trace`)."""
    out = []
    for r in records:
        out.append(f"  {r['batch']}.{r['rule']}: "
                   f"effective {r['effective']}/{r['invocations']}, "
                   f"{r['ms']}ms")
        for line in (r.get("diff") or "").splitlines():
            out.append("    " + line)
    return out


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


def load_scans(root: P.PhysicalPlan, conf, device) -> Dict[int, Batch]:
    """Every ScanExec's batch, loaded once through the device table
    cache, by node id (a scan that several parents share loads once)."""
    from ..io.device_cache import load_scan
    return {id(s): load_scan(s, conf, device)
            for s in plan_nodes(root, P.ScanExec)}


def collect_caps(root: P.PhysicalPlan) -> Dict[str, int]:
    """Every re-plan state of a converged plan, keyed `kind:tag` (the
    JAX package's `_collect_caps`): join output capacities, the
    unique-build and hash fallbacks, exchange blocks and aggregate group
    estimates."""
    out: Dict[str, int] = {}
    for j in plan_nodes(root, P.JoinExec):
        if j.out_cap is not None:
            out[f"join:{j.tag}"] = j.out_cap
        if j.unique_build is False:
            out[f"uniq:{j.tag}"] = 0
        if j.hash_fallback is False:
            out[f"hashfb:{j.tag}"] = 0
    for e in plan_nodes(root, P.ExchangeExec):
        if e.block_cap is not None:
            out[f"exch:{e.tag}"] = e.block_cap
    for a in plan_nodes(root, P.HashAggregateExec):
        if a.est_groups:
            out[f"agg:{a.tag}"] = a.est_groups
    return out


def apply_saved_caps(root: P.PhysicalPlan, caps: Dict[str, int]) -> None:
    """Set the state `collect_caps` harvested on the nodes of a fresh
    plan with the same tags (the JAX package's `_apply_saved_caps`)."""
    joins = {j.tag: j for j in plan_nodes(root, P.JoinExec)}
    exchanges = {e.tag: e for e in plan_nodes(root, P.ExchangeExec)}
    aggs = {a.tag: a for a in plan_nodes(root, P.HashAggregateExec)}
    for key, cap in caps.items():
        kind, tag = key.split(":", 1)
        if kind == "join" and tag in joins:
            joins[tag].out_cap = cap
        elif kind == "uniq" and tag in joins:
            joins[tag].unique_build = False
        elif kind == "hashfb" and tag in joins:
            joins[tag].hash_fallback = False
        elif kind == "exch" and tag in exchanges:
            exchanges[tag].block_cap = cap
        elif kind == "agg" and tag in aggs:
            aggs[tag].est_groups = cap


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
                                P.RuntimeFilterExec, P.ExchangeExec)):
                continue  # an exchange is the identity on one device
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
        #: per-(batch, rule) optimizer records (`RuleExecutor.trace`);
        #: None until the optimizer ran for this execution
        self.rule_trace: Optional[List[Dict]] = None
        #: the cost-based join reorder's decision records, one per
        #: eligible region; None until the optimizer ran
        self.reorder_decisions: Optional[List[Dict]] = None
        #: the Arrow result a run of a marked plan left in the data cache
        self._filled: Optional[pa.Table] = None
        #: cached tables `_apply_cache` substituted into this plan
        self._cache_hits = 0

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
        """Substitute cached subtrees with scans over their materialized
        tables (reference: CacheManager.useCachedData). A marked subtree
        not yet materialized is computed on its first use inside a
        larger query, like the reference's InMemoryRelation. Matching is
        on the pre-optimization plan fingerprint. Each table found in
        the cache counts one `session.result_cache_hits` per execution
        of this plan (`_execute_batch`), not when it is only planned."""
        session = self.session
        self._cache_hits = 0
        if not len(session._data_cache) and not session._cache_requests:
            return plan
        root_fp = session._plan_fingerprint(plan)

        def f(node):
            fp = session._plan_fingerprint(node)
            table = session._data_cache.get(fp)
            if table is not None:
                self._cache_hits += 1
            if table is None and fp in session._cache_requests \
                    and fp != root_fp:
                # first use inside a larger query: compute it now (the
                # root itself runs on the normal path, which fills the
                # cache afterwards)
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
            log: List[Dict] = []
            optimizer = default_optimizer(self.session.conf,
                                          reorder_log=log)
            self._optimized = optimizer.execute(plan)
            self.rule_trace = optimizer.trace()
            self.reorder_decisions = log
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

    def explain(self, extended: bool = False, runtime: bool = False,
                analysis: bool = False, rules: bool = False) -> str:
        """The plan as text: the physical plan (with each operator's
        runtime observables when `runtime` and the query ran), the
        logical and optimized plans when `extended`, the join reorder's
        decisions, and the optimizer's rule trace when `rules`. The JAX
        package's `QueryExecution.explain`; its XLA stage costs have no
        counterpart here."""
        if analysis:
            from ..expr import AnalysisError
            raise AnalysisError(
                "explain(analysis=True): static analysis is not yet "
                "ported to spark_tpu_torch")
        out = []
        if extended:
            out += ["== Logical Plan ==", self.logical.tree_string(),
                    "== Optimized Logical Plan ==",
                    self.optimized_plan.tree_string()]
        if runtime and self.last_metrics:
            out.append("== Physical Plan (runtime metrics) ==")
            out.append(self._runtime_tree(self.executed_plan))
        else:
            out += ["== Physical Plan ==",
                    self.executed_plan.tree_string()]
        out += ["== Join Reorder =="] + self._reorder_lines()
        if rules:
            self.optimized_plan  # the optimizer (and its trace) ran
            out.append("== Rule Trace ==")
            out += render_trace(self.rule_trace or []) or \
                ["  no rules applied"]
        return "\n".join(out)

    def _reorder_lines(self) -> List[str]:
        """The cost-based join reorder for explain(): 'reorder: yes/no'
        and, per region, the frontend order, the chosen order and the
        estimated rows of each join."""
        self.executed_plan  # the optimizer (and its log) ran
        decisions = self.reorder_decisions or []
        changed = [d for d in decisions if d.get("changed")]
        lines = [f"  reorder: {'yes' if changed else 'no'}"
                 + (f" ({len(changed)}/{len(decisions)} regions)"
                    if decisions else "")]
        for d in decisions:
            if not d.get("changed"):
                arrow = " (kept)"
            elif d.get("kind") == "orientation":
                arrow = " -> same order, probe/build orientation flipped"
            else:
                arrow = " -> " + " * ".join(d["order"])
            est = d.get("est_rows") or []
            lines.append("  " + " * ".join(d["relations"]) + arrow
                         + (f"  est rows/join: {est}" if est else ""))
        return lines

    def _runtime_tree(self, node: P.PhysicalPlan, depth: int = 0) -> str:
        """The physical tree annotated with each operator's runtime
        observables (the SQL-UI plan graph analog of
        `metric/SQLMetrics.scala:40`): output rows everywhere, a join's
        rows against its capacity and its hash table, an exchange's
        largest block, a runtime filter's pruned rows."""
        m = self.last_metrics
        notes = []
        rows = m.get(f"rows_{getattr(node, 'op_tag', '')}")
        if rows is not None:
            notes.append(f"rows out: {rows:,}")
        tag = getattr(node, "tag", None)
        if isinstance(node, P.JoinExec):
            jr = m.get(f"join_rows_{tag}")
            if jr is not None:
                cap = node.out_cap
                notes.append(f"join rows: {jr:,}"
                             + (f"/{cap:,} cap" if cap else ""))
            if getattr(node, "cbo_est_rows", None) is not None:
                notes.append(f"cbo est: {node.cbo_est_rows:,}")
            slots = m.get(f"join_table_slots_{tag}")
            if slots is not None:
                notes.append(
                    f"hash table: {slots:,} slots, build "
                    f"{m.get(f'join_build_ms_{tag}', 0)}ms, probe "
                    f"{m.get(f'join_probe_ms_{tag}', 0)}ms")
        elif isinstance(node, P.ExchangeExec):
            mx = m.get(f"exch_max_{tag}")
            if mx is not None:
                cap = node.block_cap
                notes.append(f"exch max: {mx:,}"
                             + (f"/{cap:,} cap" if cap else ""))
            er = m.get(f"exch_rows_{tag}")
            if er is not None:
                notes.append(f"exch rows: {er:,}")
        elif isinstance(node, P.RuntimeFilterExec):
            tested = m.get(f"rtf_tested_{tag}")
            pruned = m.get(f"rtf_pruned_{tag}")
            if tested is not None and pruned is not None:
                notes.append(f"rtf pruned: {pruned:,}/{tested:,}")
        note = f"   [{'; '.join(notes)}]" if notes else ""
        line = "  " * depth + node.simple_string() + note
        return "\n".join([line] + [self._runtime_tree(c, depth + 1)
                                   for c in node.children])

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
                # statement again computes a shared view once again.
                # Explicit cache() entries outlive the statement.
                session._evict_implicit_caches()

    def _aqe_cache_key(self) -> Optional[str]:
        """Plan and data identity of the capacities `session._aqe_caps`
        keeps (the JAX package's key at mesh size 1); None when a scan's
        source has no identity stamp."""
        tokens = [s.source.cache_token()
                  for s in L.iter_scans(self.optimized_plan)]
        if any(t is None for t in tokens):
            return None
        return (self.optimized_plan.tree_string()
                + f"#mesh1#src{tokens!r}")

    def _execute_batch(self) -> Batch:
        root = self.executed_plan
        session = self.session
        conf = session.conf
        adaptive = bool(conf.get("spark_tpu.sql.adaptive.enabled"))
        # seed the capacities an earlier execution of this plan over the
        # same data converged on: repeated queries skip the re-plans
        aqe_key = self._aqe_cache_key()
        saved_caps = session._aqe_caps.get(aqe_key) \
            if aqe_key is not None else None
        if saved_caps:
            apply_saved_caps(root, saved_caps)
        t0 = time.perf_counter()
        loaded = load_scans(root, conf, session.device)
        session.result_cache_hits += self._cache_hits
        self.phase_times["ingest"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        overflow: List[str] = []
        for attempt in range(MAX_ATTEMPTS):
            ctx = P.ExecContext(conf, session.device)
            out = run_plan(root, ctx, loaded=loaded)
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
        self.last_metrics = host_metrics(ctx.metrics)
        if adaptive:
            shrink_caps_from_rtf(root, self.last_metrics)
        if aqe_key is not None:
            # merge, as the JAX package does, and bound the store
            converged = collect_caps(root)
            if converged:
                store = session._aqe_caps
                store.setdefault(aqe_key, {}).update(converged)
                while len(store) > MAX_SAVED_PLANS:
                    store.pop(next(iter(store)))
        self.phase_times["execute"] = time.perf_counter() - t0
        # fill the data cache on the first action over a marked plan
        self._filled = None
        fp = session._plan_fingerprint(self.logical) \
            if session._cache_requests else None
        if fp in session._cache_requests and fp not in session._data_cache:
            t0 = time.perf_counter()
            self._filled = out.to_arrow()
            self.phase_times["egress"] = time.perf_counter() - t0
            session._data_cache[fp] = self._filled
        return out

    def collect(self) -> pa.Table:
        batch = self.execute_batch()
        if self._filled is not None:
            return self._filled  # already egressed into the data cache
        t0 = time.perf_counter()
        table = batch.to_arrow()
        self.phase_times["egress"] = time.perf_counter() - t0
        return table
