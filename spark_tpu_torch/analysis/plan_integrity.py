"""Rule-granular plan-integrity verification and plan-change tracing
(the port of `spark_tpu/analysis/plan_integrity.py`: the same checks,
error text, finding and trace records).

The reference guards its optimizer seam with structural-integrity
validation (`spark.sql.planChangeValidation`, `LogicalPlanIntegrity`)
and `PlanChangeLogger` inside `catalyst/rules/RuleExecutor.scala`; this
module is that seat for the port's `RuleExecutor`. After every
EFFECTIVE rule application (`spark_tpu.sql.planChangeValidation` =
``lite`` | ``full``) it checks:

- **resolution**: every `ColumnRef` in every expression slot resolves
  against its node's child schema(s) with a UNIQUE origin (ambiguous or
  dangling references are how a rewrite silently drops/duplicates rows);
- **schema preservation**: the ROOT output schema (names, dtypes,
  nullability) is unchanged across the rule unless the rule declares
  itself schema-changing via `Rule.schema_preserving = False`;
- **structure**: no duplicate output names at any node, Aggregate nodes
  stay coherent (at least one group or aggregate expression), and join
  key pairs keep coercible dtypes;
- **determinism**: re-running the batch on a structurally cloned input
  yields a tree-string-identical plan, so the plan fingerprints the
  executor keys its state on cannot be poisoned by a nondeterministic
  rewrite.

Violations raise a typed `PlanIntegrityError` naming the rule, batch
and first offending node in ``full`` mode; in ``lite`` they surface as
`PLAN_INTEGRITY` findings through the `analysis/findings.py` flow
(listener bus -> event log -> `explain(analysis=True)`). Every check
reads the logical plan on the host: no tensor is touched.

`PlanChangeTracer` is the `PlanChangeLogger` analog: one record per
(batch, rule) in first-application order -- invocations, effective
count, total ms and (under `spark_tpu.sql.planChangeLog`) a unified
before/after tree diff of the first effective application. The records
ride the schema-v7 `rule_trace` event-log field and
`explain(rules=True)` (`render_trace`).
"""

from __future__ import annotations

import copy
import difflib
from typing import Dict, List, Optional, Tuple

from .. import types as T
from ..expr import ColumnRef, Expression, case_sensitive
from ..plan import logical as L
from .findings import Finding

VALIDATION_KEY = "spark_tpu.sql.planChangeValidation"
CHANGE_LOG_KEY = "spark_tpu.sql.planChangeLog"

#: cap on stored diff text so a pathological plan can't bloat the
#: event log (the tracer keeps the head of the first effective diff)
MAX_DIFF_LINES = 60


class PlanIntegrityError(RuntimeError):
    """A rule application broke a plan invariant. Names the rule, the
    batch and the first offending node so the failing rewrite is
    attributable without bisecting the optimizer."""

    def __init__(self, batch: str, rule: str, check: str,
                 node: str, message: str):
        self.batch = batch
        self.rule = rule
        self.check = check
        self.node = node
        super().__init__(
            f"plan integrity violated by rule {rule!r} (batch {batch!r},"
            f" check {check}) at node {node}: {message}")


# ---------------------------------------------------------------------------
# Structural checks (resolution / duplicates / coherence / join dtypes)
# ---------------------------------------------------------------------------


def _node_expr_slots(node: L.LogicalPlan
                     ) -> List[Tuple[Expression, T.Schema]]:
    """(expression, resolution schema) pairs for one node — the node-
    local view of `logical.iter_expressions` (which flattens the whole
    tree and would lose WHICH child schema each slot resolves against)."""
    out: List[Tuple[Expression, T.Schema]] = []
    if isinstance(node, L.Project):
        cs = node.child.schema()
        out += [(e, cs) for e in node.exprs]
    elif isinstance(node, L.Filter):
        out.append((node.condition, node.child.schema()))
    elif isinstance(node, L.Join):
        ls, rs = node.left.schema(), node.right.schema()
        out += [(k, ls) for k in node.left_keys]
        out += [(k, rs) for k in node.right_keys]
        if node.condition is not None:
            # residual predicates see the post-rename combined row
            # (left fields + `_r`-suffixed right fields), even for
            # semi/anti joins whose OUTPUT schema is left-only
            nm = node.right_name_map()
            fields = list(ls.fields) + [
                T.Field(nm[f.name], f.dtype, f.nullable)
                for f in rs.fields]
            out.append((node.condition, T.Schema(fields)))
    elif isinstance(node, L.Aggregate):
        cs = node.child.schema()
        out += [(g, cs) for g in node.group_exprs]
        for a in node.agg_exprs:
            out += [(c, cs) for c in a.func.children]
    elif isinstance(node, L.Sort):
        cs = node.child.schema()
        out += [(o.child, cs) for o in node.orders]
    elif isinstance(node, L.WindowPlan):
        cs = node.child.schema()
        for w, _name in node.wexprs:
            out += [(c, cs) for c in w.children]
    elif isinstance(node, L.Generate):
        out.append((node.gen_expr, node.child.schema()))
    return out


def _iter_refs(e: Expression):
    if isinstance(e, ColumnRef):
        yield e
    for c in e.children:
        yield from _iter_refs(c)


def _origin_count(schema: T.Schema, name: str) -> int:
    """How many schema fields the engine's resolution rules would match
    for `name` (mirrors expr._resolve_field: exact first, then the
    case-insensitive fallback)."""
    exact = sum(1 for f in schema.fields if f.name == name)
    if exact or case_sensitive():
        return exact
    low = name.lower()
    return sum(1 for f in schema.fields if f.name.lower() == low)


def check_plan(plan: L.LogicalPlan) -> List[dict]:
    """Walk one plan and return every structural-invariant violation as
    `{"check", "node", "message"}` dicts (empty = clean). Schema
    computation failures anywhere surface as `resolution` violations
    rather than escaping as raw AnalysisError."""
    violations: List[dict] = []
    stack = [plan]
    nodes: List[L.LogicalPlan] = []
    while stack:
        n = stack.pop()
        nodes.append(n)
        stack.extend(n.children)
    for node in nodes:
        label = node.simple_string()[:160]
        # -- output schema computes, with unique output names ----------
        try:
            schema = node.schema()
        except Exception as e:  # noqa: BLE001 — any failure is the finding
            violations.append({
                "check": "resolution", "node": label,
                "message": f"schema computation failed: {e}"})
            continue
        names = schema.names
        dupes = sorted({n_ for n_ in names if names.count(n_) > 1})
        if dupes:
            violations.append({
                "check": "duplicate-names", "node": label,
                "message": f"duplicate output column(s) {dupes}"})
        # -- every ColumnRef resolves with a unique origin -------------
        try:
            slots = _node_expr_slots(node)
        except Exception as e:  # noqa: BLE001
            violations.append({
                "check": "resolution", "node": label,
                "message": f"child schema computation failed: {e}"})
            continue
        for expr, res_schema in slots:
            for ref in _iter_refs(expr):
                cnt = _origin_count(res_schema, ref.name())
                if cnt == 1:
                    continue
                what = "unresolvable" if cnt == 0 else \
                    f"ambiguous ({cnt} origins)"
                violations.append({
                    "check": "resolution", "node": label,
                    "message": f"column {ref.name()!r} is {what} "
                               f"against {res_schema.names}"})
        # -- node-specific coherence -----------------------------------
        if isinstance(node, L.Aggregate):
            if not node.group_exprs and not node.agg_exprs:
                violations.append({
                    "check": "aggregate-coherence", "node": label,
                    "message": "Aggregate with neither group nor "
                               "aggregate expressions"})
        if isinstance(node, L.Join):
            try:
                ls, rs = node.left.schema(), node.right.schema()
                for lk, rk in zip(node.left_keys, node.right_keys):
                    lt, rt = lk.dtype(ls), rk.dtype(rs)
                    try:
                        T.common_type(lt, rt)
                    except TypeError:
                        violations.append({
                            "check": "join-key-dtype", "node": label,
                            "message": f"join key pair {lk!r} ({lt!r}) "
                                       f"= {rk!r} ({rt!r}) has no "
                                       f"common type"})
            except Exception:  # noqa: BLE001 — resolution already reported
                pass
    return violations


def schema_delta(before: T.Schema, after: T.Schema) -> Optional[str]:
    """None when the two output schemas agree on names, dtypes and
    nullability; otherwise a one-line description of the first drift."""
    if len(before.fields) != len(after.fields):
        return (f"column count {len(before.fields)} -> "
                f"{len(after.fields)} ({before.names} -> {after.names})")
    for i, (a, b) in enumerate(zip(before.fields, after.fields)):
        if a.name != b.name:
            return f"column {i} renamed {a.name!r} -> {b.name!r}"
        if a.dtype != b.dtype:
            return f"column {a.name!r} dtype {a.dtype!r} -> {b.dtype!r}"
        if a.nullable != b.nullable:
            return (f"column {a.name!r} nullability "
                    f"{a.nullable} -> {b.nullable}")
    return None


def clone_plan(plan: L.LogicalPlan) -> L.LogicalPlan:
    """Node-level structural clone (leaf sources and expressions stay
    shared): enough to catch a rule that depends on node identity or
    mutates nodes in place, without deep-copying table data."""
    new = copy.copy(plan)
    new.children = tuple(clone_plan(c) for c in plan.children)
    return new


# ---------------------------------------------------------------------------
# The validator (RuleExecutor hook)
# ---------------------------------------------------------------------------


class PlanIntegrityValidator:
    """`mode` = ``lite`` (collect `PLAN_INTEGRITY` findings) or ``full``
    (raise `PlanIntegrityError` at the first violation). Installed into
    `RuleExecutor` by `QueryExecution.optimized_plan` when
    `spark_tpu.sql.planChangeValidation` != off."""

    def __init__(self, mode: str = "full"):
        if mode not in ("lite", "full"):
            raise ValueError(f"invalid validation mode {mode!r}")
        self.mode = mode
        self.findings: List[Finding] = []
        #: (plan object, its violation set) from the last after_rule —
        #: rules run sequentially, so the previous rule's `after` IS
        #: the next rule's `before` (by identity) and its check_plan
        #: walk can be reused as the baseline
        self._last_checked = None

    def _report(self, batch: str, rule: str, check: str, node: str,
                message: str) -> None:
        if self.mode == "full":
            raise PlanIntegrityError(batch, rule, check, node, message)
        self.findings.append(Finding(
            code="PLAN_INTEGRITY",
            message=f"rule {rule!r} (batch {batch!r}, check {check}) "
                    f"at {node}: {message}",
            op=rule,
            detail={"batch": batch, "rule": rule, "check": check,
                    "node": node}))

    def after_rule(self, batch: str, rule, before: L.LogicalPlan,
                   after: L.LogicalPlan) -> None:
        """Invariants on one EFFECTIVE rule application. Violations
        already present in `before` are NOT attributed to the rule —
        a user plan may legally carry e.g. duplicate output names
        (`SELECT k, k`), and only NEW breakage is the rule's fault."""
        cached = self._last_checked
        if cached is not None and cached[0] is before:
            baseline = cached[1]
        else:
            baseline = {(v["check"], v["message"])
                        for v in check_plan(before)}
        after_violations = check_plan(after)
        self._last_checked = (after, {(v["check"], v["message"])
                                      for v in after_violations})
        for v in after_violations:
            if (v["check"], v["message"]) in baseline:
                continue
            self._report(batch, rule.name, v["check"], v["node"],
                         v["message"])
        preserving = getattr(rule, "schema_preserving", None)
        if preserving is not False:
            # undeclared rules are held to the preservation contract
            # (RL100 separately forces the declaration to be explicit)
            try:
                delta = schema_delta(before.schema(), after.schema())
            except Exception:  # noqa: BLE001 — reported by check_plan
                delta = None
            if delta is not None:
                self._report(batch, rule.name, "schema-preservation",
                             after.simple_string()[:160], delta)

    def after_batch(self, batch, batch_input: L.LogicalPlan,
                    batch_output: L.LogicalPlan, rerun) -> None:
        """Determinism: `rerun(plan)` (a side-effect-free replay of the
        batch, provided by the executor) over a structural clone of the
        batch input must reproduce the batch output exactly."""
        try:
            replay = rerun(clone_plan(batch_input))
        except Exception as e:  # noqa: BLE001 — a replay-only failure
            self._report(batch.name, "*", "determinism",
                         batch_input.simple_string()[:160],
                         f"batch replay raised: {e}")
            return
        if replay.tree_string() != batch_output.tree_string():
            diff = "\n".join(difflib.unified_diff(
                batch_output.tree_string().splitlines(),
                replay.tree_string().splitlines(),
                "first run", "replay", lineterm=""))[:2000]
            self._report(batch.name, "*", "determinism",
                         batch_output.simple_string()[:160],
                         "replaying the batch produced a different "
                         "plan:\n" + diff)


# ---------------------------------------------------------------------------
# Plan-change tracing (PlanChangeLogger analog)
# ---------------------------------------------------------------------------


class PlanChangeTracer:
    """Per-(batch, rule) application records in first-application order:
    `{"batch", "rule", "invocations", "effective", "ms"[, "diff"]}` —
    the event-log `rule_trace` payload. `diffs=True` (conf
    `spark_tpu.sql.planChangeLog`) captures a unified before/after tree
    diff of each rule's FIRST effective application."""

    def __init__(self, diffs: bool = False):
        self.diffs = diffs
        self.records: List[Dict] = []
        self._index: Dict[Tuple[str, str], Dict] = {}

    def after_rule(self, batch: str, rule, before: L.LogicalPlan,
                   after: L.LogicalPlan, effective: bool,
                   ms: float) -> None:
        key = (batch, rule.name)
        rec = self._index.get(key)
        if rec is None:
            rec = {"batch": batch, "rule": rule.name,
                   "invocations": 0, "effective": 0, "ms": 0.0}
            self._index[key] = rec
            self.records.append(rec)
        rec["invocations"] += 1
        rec["ms"] = round(rec["ms"] + ms, 3)
        if effective:
            rec["effective"] += 1
            if self.diffs and "diff" not in rec:
                lines = list(difflib.unified_diff(
                    before.tree_string().splitlines(),
                    after.tree_string().splitlines(),
                    "before", "after", lineterm=""))[:MAX_DIFF_LINES]
                rec["diff"] = "\n".join(lines)

    def render(self) -> List[str]:
        """explain(rules=True) lines."""
        if not self.records:
            return ["  no rules applied"]
        return render_trace(self.records)


def render_trace(records: List[Dict]) -> List[str]:
    """Human-readable lines for a rule_trace record list (shared by
    explain(rules=True) and any log replay tooling)."""
    out = []
    for r in records:
        out.append(f"  {r['batch']}.{r['rule']}: "
                   f"effective {r['effective']}/{r['invocations']}, "
                   f"{r['ms']}ms")
        for line in (r.get("diff") or "").splitlines():
            out.append("    " + line)
    return out
