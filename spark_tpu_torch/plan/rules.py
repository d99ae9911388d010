"""Rule executor: fixed-point batches of plan-rewrite rules (the port of
`spark_tpu/plan/rules.py`; reference: `catalyst/rules/RuleExecutor.scala`
with per-rule effectiveness tracking a la `QueryPlanningTracker.scala:93`).

`RuleExecutor.timings` keeps one record per (batch, rule) in the order
rules first ran; `QueryExecution.rule_trace` reads it. The JAX package's
plan-integrity validator is not ported yet.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .logical import LogicalPlan


class Rule:
    name: str = "rule"

    #: True = this rule keeps the ROOT output schema identical; False =
    #: it may legitimately reshape output schemas (kept for parity with
    #: the JAX package's rule contract)
    schema_preserving: Optional[bool] = None

    def apply(self, plan: LogicalPlan) -> LogicalPlan:
        raise NotImplementedError


@dataclass
class Batch:
    name: str
    rules: Sequence[Rule]
    strategy: str = "fixed_point"  # or "once"
    max_iterations: int = 100


@dataclass
class RuleTiming:
    batch: str
    rule: str
    total_ns: int = 0
    invocations: int = 0
    effective: int = 0


class RuleExecutor:
    def __init__(self, batches: Sequence[Batch]):
        self.batches = list(batches)
        #: (batch name, rule name) -> timing, in first-application order
        self.timings: Dict[Tuple[str, str], RuleTiming] = {}

    def execute(self, plan: LogicalPlan) -> LogicalPlan:
        for batch in self.batches:
            plan = self._run_batch(batch, plan)
        return plan

    def _run_batch(self, batch: Batch, plan: LogicalPlan) -> LogicalPlan:
        iters = 1 if batch.strategy == "once" else batch.max_iterations
        for _ in range(iters):
            changed = False
            for rule in batch.rules:
                t0 = time.perf_counter_ns()
                new_plan = rule.apply(plan)
                elapsed_ns = time.perf_counter_ns() - t0
                effective = (new_plan is not plan
                             and not new_plan.same_result(plan))
                t = self.timings.get((batch.name, rule.name))
                if t is None:
                    t = self.timings[(batch.name, rule.name)] = \
                        RuleTiming(batch.name, rule.name)
                t.total_ns += elapsed_ns
                t.invocations += 1
                if effective:
                    t.effective += 1
                    changed = True
                plan = new_plan
            if not changed:
                break
        else:
            if batch.strategy == "fixed_point":
                raise RuntimeError(
                    f"batch {batch.name!r} did not converge in "
                    f"{batch.max_iterations} iterations")
        return plan

    def trace(self) -> List[Dict]:
        """One record per (batch, rule) in first-application order:
        `{"batch", "rule", "invocations", "effective", "ms"}`, the JAX
        package's `rule_trace` payload."""
        return [{"batch": t.batch, "rule": t.rule,
                 "invocations": t.invocations, "effective": t.effective,
                 "ms": round(t.total_ns / 1e6, 3)}
                for t in self.timings.values()]
