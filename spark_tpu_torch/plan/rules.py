"""Rule executor: fixed-point batches of plan-rewrite rules (the port of
`spark_tpu/plan/rules.py`; reference: `catalyst/rules/RuleExecutor.scala`
with per-rule effectiveness tracking a la `QueryPlanningTracker.scala:93`).

`RuleExecutor.timings` keeps one record per (batch, rule) in the order
rules first ran (`trace()`). The plan-integrity seam is the JAX
package's: an optional validator (invariant checks after every effective
rule application, a determinism replay after every effective batch,
`analysis/plan_integrity.py`) and an optional tracer (the
`PlanChangeLogger` analog whose records become `QueryExecution.
rule_trace` and the event log's `rule_trace`).
"""

from __future__ import annotations

import time
from contextvars import ContextVar
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .logical import LogicalPlan

#: True while the integrity validator replays a batch for the
#: determinism check. Rules with observable side channels (the join
#: reorder decision log) stay silent during a replay, or the check
#: itself would double-append their records. A ContextVar, not a module
#: global: sessions optimize on concurrent threads.
_IN_REPLAY: ContextVar[bool] = ContextVar(
    "spark_tpu_rule_replay", default=False)


def in_replay() -> bool:
    return _IN_REPLAY.get()


class Rule:
    name: str = "rule"

    #: Plan-integrity contract: True = this rule keeps the ROOT output
    #: schema (names/dtypes/nullability) identical; False = the rule
    #: legitimately reshapes output schemas and the verifier skips the
    #: preservation check for it. None = undeclared: the verifier holds
    #: such rules to the preservation contract, and the `rule-registry`
    #: lint fails any Rule subclass that does not declare it in its own
    #: class body.
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
    def __init__(self, batches: Sequence[Batch], validator=None,
                 tracer=None):
        self.batches = list(batches)
        #: (batch name, rule name) -> timing, in first-application order
        self.timings: Dict[Tuple[str, str], RuleTiming] = {}
        #: analysis.plan_integrity.PlanIntegrityValidator (or None):
        #: after_rule on every effective application, after_batch with a
        #: replay closure for the determinism check
        self.validator = validator
        #: analysis.plan_integrity.PlanChangeTracer (or None)
        self.tracer = tracer
        #: did the batch currently being observed rewrite the plan?
        self._batch_effective = False

    def execute(self, plan: LogicalPlan) -> LogicalPlan:
        for batch in self.batches:
            batch_input = plan
            plan = self._run_batch(batch, plan, observe=True)
            # a no-op batch replays trivially: only batches with at
            # least one effective application pay the determinism
            # replay (an extra full batch run)
            if self.validator is not None and self._batch_effective:
                self.validator.after_batch(
                    batch, batch_input, plan,
                    lambda p, b=batch: self._replay_batch(b, p))
        return plan

    def _replay_batch(self, batch: Batch, plan: LogicalPlan
                      ) -> LogicalPlan:
        """Side-effect-free re-run for the determinism check: no
        timings, no tracer/validator hooks, side channels silenced."""
        token = _IN_REPLAY.set(True)
        try:
            return self._run_batch(batch, plan, observe=False)
        finally:
            _IN_REPLAY.reset(token)

    def _run_batch(self, batch: Batch, plan: LogicalPlan,
                   observe: bool) -> LogicalPlan:
        iters = 1 if batch.strategy == "once" else batch.max_iterations
        if observe:
            self._batch_effective = False
        for _ in range(iters):
            changed = False
            for rule in batch.rules:
                t0 = time.perf_counter_ns()
                new_plan = rule.apply(plan)
                elapsed_ns = time.perf_counter_ns() - t0
                effective = (new_plan is not plan
                             and not new_plan.same_result(plan))
                if observe:
                    t = self.timings.get((batch.name, rule.name))
                    if t is None:
                        t = self.timings[(batch.name, rule.name)] = \
                            RuleTiming(batch.name, rule.name)
                    t.total_ns += elapsed_ns
                    t.invocations += 1
                    if effective:
                        t.effective += 1
                    if self.tracer is not None:
                        self.tracer.after_rule(
                            batch.name, rule, plan, new_plan, effective,
                            elapsed_ns / 1e6)
                    if effective and self.validator is not None:
                        self.validator.after_rule(batch.name, rule,
                                                  plan, new_plan)
                if effective:
                    changed = True
                    if observe:
                        self._batch_effective = True
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
