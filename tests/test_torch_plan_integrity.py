"""The port's plan-integrity validator and plan-change tracer
(`spark_tpu_torch/analysis/plan_integrity.py`, the `RuleExecutor`
hooks, the executor's install of both, the fuzzer under validation)
against the JAX package's, on the CPU: every case of
`tests/test_plan_integrity.py` through both packages on the same
table, with the same synthetic rules written against each package's
`Rule` and logical plan, and the same error text, finding and trace
records required of both (rule timings put aside).

Seeds 0-149 of the fuzzer run through both packages with both
validators on in `tests/test_torch_plan_fuzz*.py` (conftest's default
`full`, and the port's `run_seed` sets it); here the port's `run_seed`
is shown to validate (a broken rule in its optimizer raises), and the
JAX package's pinned seeds give both packages' `run_seed` the same
summary.
"""

import pandas as pd
import pyarrow as pa
import pytest

from spark_tpu import functions as RF
from spark_tpu import history as ref_history
from spark_tpu.analysis import plan_integrity as ref_pi
from spark_tpu.plan import logical as RL
from spark_tpu.plan import optimizer as ref_optimizer
from spark_tpu.plan import rules as ref_rules
from spark_tpu.session import SparkTpuSession as RefSession
from spark_tpu.testing import plan_fuzz as ref_fuzz
from spark_tpu_torch import SparkTpuSession
from spark_tpu_torch import functions as PF
from spark_tpu_torch import history as port_history
from spark_tpu_torch.analysis import plan_integrity as port_pi
from spark_tpu_torch.plan import logical as PL
from spark_tpu_torch.plan import optimizer as port_optimizer
from spark_tpu_torch.plan import rules as port_rules
from spark_tpu_torch.testing import plan_fuzz as port_fuzz

VALIDATION_KEY = "spark_tpu.sql.planChangeValidation"
CHANGE_LOG_KEY = "spark_tpu.sql.planChangeLog"
EXCLUDED_KEY = "spark_tpu.sql.optimizer.excludedRules"

TABLE = pa.table({
    "a": pa.array([1, 2, 3, 4, None], pa.int64()),
    "b": pa.array([10.0, -1.5, None, 0.25, 3.0], pa.float64()),
    "c": pa.array(["x", "y", None, "x", "z"], pa.string())})


class Pkg:
    """One package's surface for these cases."""

    def __init__(self, name, session, F, L, rules, pi, optimizer, history):
        self.name, self.F, self.L = name, F, L
        self.rules, self.pi, self.optimizer = rules, pi, optimizer
        self.history = history
        self._session = session

    def session(self, confs=()):
        s = self._session()
        s.register_table("pi_t", TABLE)
        for k, v in confs:
            s.conf.set(k, v)
        return s


PKGS = (
    Pkg("port", lambda: SparkTpuSession.builder().device("cpu")
        .get_or_create(), PF, PL, port_rules, port_pi, port_optimizer,
        port_history),
    Pkg("jax", lambda: RefSession(register_active=False), RF, RL,
        ref_rules, ref_pi, ref_optimizer, ref_history),
)


def each(fn):
    """fn(pkg) for both packages; returns the two results."""
    return [fn(p) for p in PKGS]


def trace(records):
    return [(r["batch"], r["rule"], r["invocations"], r["effective"],
             r.get("diff")) for r in records or []]


# ---------------------------------------------------------------------------
# synthetic rules, one class per package
# ---------------------------------------------------------------------------


def bad_prune(p):
    L = p.L

    class BadPrune(p.rules.Rule):
        name = "BadPrune"
        schema_preserving = False

        def apply(self, plan):
            def f(node):
                if isinstance(node, L.Project) and len(node.exprs) > 1:
                    return L.Project(node.child, node.exprs[:1])
                return node
            return plan.transform_up(f)
    return BadPrune()


def silent_reshape(p):
    L = p.L

    class SilentReshape(p.rules.Rule):
        name = "SilentReshape"
        schema_preserving = True  # lies

        def apply(self, plan):
            if isinstance(plan, L.Project):
                return L.Project(plan.child, plan.exprs[:1])
            return plan
    return SilentReshape()


def jitter(p):
    L = p.L

    class Jitter(p.rules.Rule):
        name = "Jitter"
        schema_preserving = True

        def __init__(self):
            self.n = 0

        def apply(self, plan):
            self.n += 1
            return L.Limit(plan, 100 + self.n)
    return Jitter()


def _prune_df(p, s):
    F = p.F
    return s.table("pi_t").select(F.col("a"), F.col("b")) \
        .filter(F.col("b") > F.lit(0.0))


def _prune_after_optimizer_df(p, s):
    """A Project of two columns whose parent reads both, as the
    optimizer leaves it (BadPrune breaks it after the real batches)."""
    F = p.F
    return s.table("pi_t").select(F.col("a"), F.col("b")) \
        .select((F.col("a") + F.col("b")).alias("s"))


# ---------------------------------------------------------------------------
# the validator catches broken rules, by name
# ---------------------------------------------------------------------------


def test_full_mode_names_the_rule():
    def run(p):
        ex = p.rules.RuleExecutor(
            [p.rules.Batch("bad", [bad_prune(p)])],
            validator=p.pi.PlanIntegrityValidator("full"))
        with pytest.raises(p.pi.PlanIntegrityError) as ei:
            ex.execute(_prune_df(p, p.session()).plan)
        e = ei.value
        return (e.rule, e.batch, e.check, e.node, str(e))

    got, want = each(run)
    assert got == want
    assert got[:3] == ("BadPrune", "bad", "resolution")
    assert "'b'" in got[4]


def test_lite_mode_collects_findings():
    def run(p):
        v = p.pi.PlanIntegrityValidator("lite")
        p.rules.RuleExecutor([p.rules.Batch("bad", [bad_prune(p)])],
                             validator=v).execute(
            _prune_df(p, p.session()).plan)
        return [(f.code, f.op, f.message, f.detail) for f in v.findings]

    got, want = each(run)
    assert got == want and got, "lite mode swallowed the violation"
    assert all(c == "PLAN_INTEGRITY" for c, _, _, _ in got)
    assert got[0][1] == "BadPrune" and got[0][3]["batch"] == "bad"


def test_schema_preservation_contract():
    def run(p):
        F = p.F
        df = p.session().table("pi_t").select(F.col("a"), F.col("b"))
        ex = p.rules.RuleExecutor(
            [p.rules.Batch("reshape", [silent_reshape(p)],
                           strategy="once")],
            validator=p.pi.PlanIntegrityValidator("full"))
        with pytest.raises(p.pi.PlanIntegrityError) as ei:
            ex.execute(df.plan)
        return (ei.value.rule, ei.value.check, str(ei.value))

    got, want = each(run)
    assert got == want
    assert got[:2] == ("SilentReshape", "schema-preservation")


def test_nondeterministic_rule_caught():
    def run(p):
        df = p.session().table("pi_t").select(p.F.col("a"))
        ex = p.rules.RuleExecutor(
            [p.rules.Batch("jit", [jitter(p)], strategy="once")],
            validator=p.pi.PlanIntegrityValidator("full"))
        with pytest.raises(p.pi.PlanIntegrityError) as ei:
            ex.execute(df.plan)
        return (ei.value.check, ei.value.batch, str(ei.value))

    got, want = each(run)
    assert got == want
    assert got[:2] == ("determinism", "jit")


def test_preexisting_violations_not_attributed():
    """`SELECT a, a`-style duplicate names are legal user plans: a rule
    that merely touches such a plan is not blamed."""
    def run(p):
        F = p.F
        s = p.session()
        df = s.table("pi_t").select(F.col("a"), F.col("a")) \
            .filter(F.col("a") > F.lit(0)).filter(F.col("a") < F.lit(10))
        violations = p.pi.check_plan(df.plan)
        v = p.pi.PlanIntegrityValidator("full")
        out = p.optimizer.default_optimizer(s.conf, validator=v) \
            .execute(df.plan)
        return violations, out.tree_string()

    got, want = each(run)
    assert got == want
    assert any(v["check"] == "duplicate-names" for v in got[0])


def test_replay_does_not_double_append_reorder_decisions():
    """The determinism replay re-runs the JoinReorder batch; the reorder
    log stays as the JAX package's (the replay guard, `in_replay`): one
    decision per region, not two."""
    import numpy as np
    sizes = {"ra": 400, "rb": 40, "rc": 4}

    def run(p):
        s = p.session(((VALIDATION_KEY, "full"),))
        for t, n in sizes.items():
            s.register_table(t, pd.DataFrame({
                f"k{t}": np.arange(n) % 4,
                f"v{t}": np.arange(n, dtype=float)}))
        qe = s.sql("SELECT sum(vra) AS x FROM ra, rb, rc "
                   "WHERE kra = krb AND krb = krc")._qe()
        qe.optimized_plan
        return qe.reorder_decisions, trace(qe.rule_trace)

    got, want = each(run)
    assert got == want
    # the reorder was effective, so the batch was replayed
    assert ("JoinReorder", "CostBasedJoinReorder", 1, 1, None) in got[1]
    assert len(got[0]) == 1, got[0]


# ---------------------------------------------------------------------------
# end to end: conf wiring, trace, explain, event log
# ---------------------------------------------------------------------------


def test_full_validation_clean_query():
    def run(p):
        F = p.F
        s = p.session(((VALIDATION_KEY, "full"),))
        df = s.table("pi_t").filter(F.col("a") > F.lit(1)) \
            .group_by(F.col("c")).agg(F.avg(F.col("b")).alias("ab"))
        qe = df._qe()
        got = qe.collect().sort_by("c")
        assert set(qe.rule_trace[0]) >= {"batch", "rule", "invocations",
                                         "effective", "ms"}
        return got.to_pylist(), trace(qe.rule_trace)

    got, want = each(run)
    assert got == want
    assert sum(e for _, _, _, e, _ in got[1]) >= 1


def test_explain_rules_section():
    def run(p):
        text = p.session().table("pi_t").filter(p.F.col("a") > p.F.lit(1)) \
            ._qe().explain(rules=True)
        section = text.split("== Rule Trace ==")[1]
        # the per-rule ms differ by machine; the rest is the same text
        return [line.rsplit(",", 1)[0] for line in section.splitlines()]

    got, want = each(run)
    assert got == want and any("effective" in ln for ln in got)


def test_change_log_diff():
    def run(p):
        F = p.F
        s = p.session(((CHANGE_LOG_KEY, True),))
        df = s.table("pi_t").filter(F.col("a") > F.lit(0)) \
            .filter(F.col("a") < F.lit(9))
        qe = df._qe()
        qe.collect()
        lines = p.pi.render_trace(qe.rule_trace)
        return trace(qe.rule_trace), [ln for ln in lines
                                      if not ln.startswith("  ") or
                                      ln.startswith("    ")]

    got, want = each(run)
    assert got[0] == want[0]
    diffs = [d for *_, d in got[0] if d]
    assert diffs and any(ln.startswith(("-", "+"))
                         for ln in diffs[0].splitlines())
    assert got[1] == want[1]


def test_excluded_rules_ablation():
    def run(p):
        F = p.F
        s = p.session()
        df = s.table("pi_t").filter(F.col("a") > F.lit(0)) \
            .filter(F.col("a") < F.lit(9))
        s.conf.set(EXCLUDED_KEY, "*")
        qe_off = df._qe()
        base = qe_off.collect().sort_by("a").to_pylist()
        assert not qe_off.rule_trace, "excludedRules=* still ran rules"
        s.conf.set(EXCLUDED_KEY, "CombineFilters")
        qe = df._qe()
        got = qe.collect().sort_by("a").to_pylist()
        assert all(r["rule"] != "CombineFilters" for r in qe.rule_trace)
        assert got == base
        return got, trace(qe.rule_trace)

    got, want = each(run)
    assert got == want


def test_rule_trace_rides_event_log(tmp_path):
    """Schema v7's `rule_trace`, read back through both packages'
    history from each package's log, and `rule_report` over it."""
    reports = []
    for p in PKGS:
        d = str(tmp_path / p.name)
        s = p.session(((VALIDATION_KEY, "full"),
                       ("spark_tpu.sql.eventLog.dir", d)))
        F = p.F
        s.table("pi_t").filter(F.col("a") > F.lit(0)) \
            .filter(F.col("a") < F.lit(9))._qe().collect()
        for h in (port_history, ref_history):
            events = h.read_event_log(d)
            assert len(events) == 1
            assert events.iloc[-1]["schema_version"] == 7
            assert isinstance(events.iloc[-1]["rule_trace"], list)
            rr = h.rule_report(events)
            assert {"batch", "rule", "invocations", "effective", "ms",
                    "integrity_findings"} <= set(rr.columns)
            reports.append(rr[["batch", "rule", "invocations", "effective",
                               "integrity_findings"]].to_dict("records"))
    assert all(r == reports[0] for r in reports[1:]), reports
    assert any(r["effective"] >= 1 for r in reports[0])


def test_lite_findings_reach_analysis_findings():
    """Lite-mode PLAN_INTEGRITY findings join the analyzer's findings on
    the execution (the executor's `_integrity_findings`), in both
    packages, the analyzer on or off."""
    def run(p, enabled):
        s = p.session(((VALIDATION_KEY, "lite"),
                       ("spark_tpu.sql.analysis.enabled", enabled)))
        opt = p.optimizer.default_optimizer

        def broken(*a, **kw):
            ex = opt(*a, **kw)
            ex.batches.append(p.rules.Batch("bad", [bad_prune(p)]))
            return ex

        import importlib
        mod = importlib.import_module(
            p.optimizer.__name__.split(".plan.")[0]
            + ".execution.executor")
        saved = mod.default_optimizer
        mod.default_optimizer = broken
        try:
            qe = _prune_after_optimizer_df(p, s)._qe()
            qe.optimized_plan
            qe.executed_plan
            return [(f.code, f.op, f.message)
                    for f in qe._integrity_findings]
        finally:
            mod.default_optimizer = saved

    for enabled in (True, False):
        got, want = [run(p, enabled) for p in PKGS]
        assert got == want and got[0][0] == "PLAN_INTEGRITY"


# ---------------------------------------------------------------------------
# the fuzzer under validation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 3])
def test_pinned_seeds_match_reference(seed):
    """The JAX package's pinned seeds: both packages' `run_seed` under
    full validation give the same summary (effective rules, ablations)."""
    got, want = [p.session() for p in PKGS], None
    got = port_fuzz.run_seed(got[0], seed, ablate="one")
    want = ref_fuzz.run_seed(PKGS[1].session(), seed, ablate="one")
    assert got == want


def test_run_seed_validates(monkeypatch):
    """The port's `run_seed` turns on full validation for every seed: a
    broken rule in the optimizer raises PlanIntegrityError naming it,
    though the session's own default is off."""
    from spark_tpu_torch.execution import executor
    s = PKGS[0].session(((VALIDATION_KEY, "off"),))
    opt = executor.default_optimizer

    def broken(*a, **kw):
        ex = opt(*a, **kw)
        ex.batches.append(port_rules.Batch("bad", [bad_prune(PKGS[0])]))
        return ex

    seed = next(sd for sd in range(50) if _seed_projects_two(sd))
    monkeypatch.setattr(executor, "default_optimizer", broken)
    with pytest.raises(port_pi.PlanIntegrityError, match="BadPrune"):
        port_fuzz.run_seed(s, seed, ablate="none")
    assert s.conf.get(VALIDATION_KEY) == "off"  # conf restored


def _seed_projects_two(seed):
    """Whether BadPrune, applied to the seed's optimized plan, breaks a
    reference the plan did not break before."""
    import random
    s = PKGS[0].session(((VALIDATION_KEY, "off"),))
    _, _, df = port_fuzz.gen_case(random.Random(seed), s, 40)
    plan = df._qe().optimized_plan
    broken = bad_prune(PKGS[0]).apply(plan)
    before = {(v["check"], v["message"]) for v in port_pi.check_plan(plan)}
    return any((v["check"], v["message"]) not in before
               for v in port_pi.check_plan(broken))
