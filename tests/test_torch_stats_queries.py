"""The function-library programs F1-F3 (`spark_tpu_torch/testing/
function_queries.py`) through the port against the JAX package, on the
CPU: F1 and F2 over TPC-H at SF 0.002, F3 over TPC-DS at SF 0.01.

Each program runs as SQL text in fresh sessions of both packages
(`torch_sql_parity.sessions`): the executed plans must print the same
before and after the run, the results must be equal (F1's moment
columns within the data-derived bound that `function_queries` states,
other floats within rtol 1e-12, everything else exactly), and the
port's result must pass the pandas/numpy/scipy golden.
"""

import pytest

from spark_tpu_torch.testing import function_queries as FQ
from spark_tpu_torch.tpcds.queries import TABLES as DS_TABLES
from torch_sql_parity import (TABLES, assert_tables_match, sessions,
                              write_data, write_tpcds)

TPCH_SF = 0.002
TPCDS_SF = 0.01


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return {"tpch": write_data(tmp_path_factory, TPCH_SF),
            "tpcds": write_tpcds(tmp_path_factory, TPCDS_SF)}


def run_both(path, name, tag, confs=()):
    """(port result, reference result) of program `name`, with the
    executed plans held equal before and after the run."""
    tables = TABLES if FQ.SUITE[name] == "tpch" else DS_TABLES
    port, ref = sessions(path, tag, confs, tables)
    pqe = port.sql(FQ.QUERIES[name])._qe()
    rqe = ref.sql(FQ.QUERIES[name])._qe()
    assert pqe.executed_plan.tree_string() == \
        rqe.executed_plan.tree_string()
    got, want = pqe.collect(), rqe.collect()
    assert pqe.executed_plan.tree_string() == \
        rqe.executed_plan.tree_string()
    return got, want, pqe.executed_plan.tree_string()


@pytest.mark.parametrize("name", ["f1", "f2", "f3"])
def test_program_matches_reference_and_golden(paths, name):
    path = paths[FQ.SUITE[name]]
    got, want, _plan = run_both(path, name, f"fq_{name}")
    answer, tolerances = FQ.golden(name, path)
    if tolerances is None:
        assert_tables_match(got, want)
    else:
        assert got.schema == want.schema
        FQ.compare_tables(got, want, tolerances, f"{name} against the "
                          "JAX package")
    FQ.compare(got, answer, tolerances, f"{name} against the golden")
    # F1: TPC-H's 4 (flag, status) pairs; F2: 7 ship modes by 4 quarters
    assert got.num_rows == {"f1": 4, "f2": 28}.get(name, got.num_rows) > 0


def test_f1_takes_one_dense_aggregate_of_sums(paths, monkeypatch):
    """F1's plan: one complete-mode aggregate over a dense key, whose
    accumulators are all sums, so its rows go to the dense group-by's
    kernel wrapper in one call: the 12 slots of the (flag, status) key,
    11 int rows (count(*) carries the occupancy counts, so no row of
    ones of its own) and 26 float rows. At this domain `plan_launches`
    cuts them into three private launches (ROADMAP Queue 2 item A)."""
    from spark_tpu_torch.execution import dense_groupby as D
    from spark_tpu_torch.execution.executor import plan_nodes
    from spark_tpu_torch.plan.physical import HashAggregateExec
    calls = []
    original = D.dense_groupby_sums

    def recording(idx, int_rows, float_rows, domain, int_widths=None):
        calls.append((len(int_rows), len(float_rows), domain))
        return original(idx, int_rows, float_rows, domain, int_widths)

    monkeypatch.setattr(D, "dense_groupby_sums", recording)
    port, _ref = sessions(paths["tpch"], "fq_plan")
    qe = port.sql(FQ.QUERIES["f1"])._qe()
    qe.collect()
    (agg,) = plan_nodes(qe.executed_plan, HashAggregateExec)
    base = agg.child.schema()
    specs = [s for a in agg.agg_exprs for s in a.func.accumulators(base)]
    assert all(s.reduce == "sum" for s in specs)
    assert calls == [(11, 26, 12)]
    plan = D.plan_launches(12, 11, 26)
    assert [p.variant for p in plan] == ["private"] * 3
    assert sum(len(p.ints) + len(p.floats) for p in plan) == 37


def test_f1_scatter_mode_agrees(paths):
    """F1 under aggregate.kernelMode=scatter gives the default mode's
    result within F1's moment bound."""
    path = paths["tpch"]
    port, _ref = sessions(path, "fq_auto")
    scat, _ref2 = sessions(path, "fq_scatter", (
        ("spark_tpu.sql.aggregate.kernelMode", "scatter"),))
    a = port.sql(FQ.QUERIES["f1"]).collect()
    b = scat.sql(FQ.QUERIES["f1"]).collect()
    _answer, tolerances = FQ.golden("f1", path)
    FQ.compare_tables(a, b, tolerances, "f1 under kernelMode=scatter")
