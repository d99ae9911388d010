"""Shared harness of the `tests/test_torch_plan_fuzz*.py` tests: one
seed of the differential plan fuzzer through the JAX package and the
port, on the CPU.

For one seed both packages' generators (`spark_tpu/testing/plan_fuzz.py`
and its port) make the same draws from `random.Random(seed)`, so they
build the same tables and the same query. The query then runs once in
each package, and:

- the executed plans must print the same before the run, and the
  optimizer's rule traces (batch, rule, invocations, effective) agree;
- the Arrow results must be equal as `canonical_bytes` compares them
  (schema, then rows in a total order of value bit patterns, so -0.0
  against 0.0, NaN, the infinities and NULLs all count), except that
  finite nonzero floats may differ within rtol 1e-12 plus atol 1e-9:
  the JAX package adds float sums in XLA's order and the port in its own
  (`plan_fuzz.result_mismatch`).

The JAX package's compiled-stage cache keys a whole-table scan by its
printed plan, which does not hold the table's schema: after a seed
registers a table of the same name with other columns, a plan that
prints the same reuses the old stage and returns the old table's
columns (ROADMAP Queue 3; seed 165 after seeds 50-164). Each seed
therefore starts the reference with an empty stage cache.
"""

import random

from spark_tpu.session import SparkTpuSession as RefSession
from spark_tpu.testing import plan_fuzz as RF
from spark_tpu_torch import SparkTpuSession
from spark_tpu_torch.testing import plan_fuzz as PF

#: the fuzzer's default table size (`spark_tpu.sql.fuzz.maxRows`)
MAX_ROWS = 40


class FuzzPair:
    """A port session on the CPU and a reference session, reused across
    seeds (each seed registers its tables afresh)."""

    def __init__(self):
        self.port = SparkTpuSession.builder().device("cpu").get_or_create()
        self.ref = RefSession(register_active=False)

    def check(self, seed: int, max_rows: int = MAX_ROWS):
        """Run `seed` through both packages; returns (port result,
        reference result)."""
        self.ref._stage_cache.clear()
        _, sql, pdf = PF.gen_case(random.Random(seed), self.port, max_rows)
        rng = random.Random(seed)
        tables = RF.gen_tables(rng, max_rows)
        for name, tbl in tables.items():
            self.ref.register_table(name, tbl)
        rsql = RF.gen_sql(rng, tables) if rng.random() < 0.25 else None
        rdf = self.ref.sql(rsql) if rsql else \
            RF.gen_query(rng, self.ref, tables)
        assert sql == rsql, (sql, rsql)
        pqe, rqe = pdf._qe(), rdf._qe()
        assert pqe.executed_plan.tree_string() == \
            rqe.executed_plan.tree_string(), f"seed {seed}: plans differ"
        got, want = pqe.collect(), rqe.collect()

        def trace(qe):
            return [(r["batch"], r["rule"], r["invocations"], r["effective"])
                    for r in qe.rule_trace]

        assert trace(pqe) == trace(rqe), f"seed {seed}: rule traces differ"
        mismatch = PF.result_mismatch(got, want)
        assert mismatch is None, f"seed {seed}: {mismatch}"
        return got, want


def check_port_seed(pair: FuzzPair, seed: int) -> None:
    """The port's own differential run of `seed`: optimizer off, on and
    with its first effective rule ablated, and planned twice."""
    res = PF.run_seed(pair.port, seed, ablate="one", max_rows=MAX_ROWS)
    assert res["seed"] == seed
