"""TPC-H on the mesh against the JAX package, on the CPU at SF 0.002:
the DataFrame programs of Q1, Q3, Q5 and Q6 (`tests/test_tpch.py:54`)
and SQL Q1-Q6 at mesh 8 through both packages — equal Arrow results in
the reference's order, equal executed plans (`tree_string()` before
and after the run, and `describe()`), the pandas golden, and the port's
mesh-0 rows. SQL Q7-Q22 are in `test_torch_mesh_tpch_more.py` and
`test_torch_mesh_tpch_rest.py`, split so each file runs alone in about a
minute."""

import pytest

from spark_tpu.tpch import queries as RQ
from spark_tpu_torch.tpch import queries as PQ
from spark_tpu_torch.tpch.sql_queries import SQL_QUERIES
from torch_mesh_parity import MESH, assert_rows_match
from torch_sql_parity import (assert_tables_match, check_golden, sessions,
                              write_data)

SF = 0.002


@pytest.fixture(scope="module")
def tpch_path(tmp_path_factory):
    return write_data(tmp_path_factory, SF)


def check_mesh_query(path: str, qname: str, tag: str, n: int = 8,
                     dataframe: bool = False):
    """`qname` (SQL text, or the DataFrame program) at mesh `n` through
    both packages, held as the module docstring says."""
    port, ref = sessions(path, tag, confs=((MESH, n),))
    if dataframe:
        pqe, rqe = PQ.QUERIES[qname](port)._qe(), RQ.QUERIES[qname](ref)._qe()
    else:
        pqe = port.sql(SQL_QUERIES[qname])._qe()
        rqe = ref.sql(SQL_QUERIES[qname])._qe()
    assert pqe.executed_plan.tree_string() == \
        rqe.executed_plan.tree_string()
    got, want = pqe.collect(), rqe.collect()
    assert_tables_match(got, want)
    assert pqe.executed_plan.tree_string() == \
        rqe.executed_plan.tree_string()
    assert pqe.executed_plan.describe() == rqe.executed_plan.describe()
    assert "ExchangeExec" in pqe.executed_plan.tree_string()
    if not dataframe:
        check_golden(got, qname, path)
    port.conf.set(MESH, 0)
    one = (PQ.QUERIES[qname](port) if dataframe
           else port.sql(SQL_QUERIES[qname])).collect()
    assert_rows_match(got, one)
    return pqe


@pytest.mark.parametrize("qname", ["q1", "q3", "q5", "q6"])
def test_dataframe_query_on_mesh(tpch_path, qname):
    check_mesh_query(tpch_path, qname, f"m{qname}_df", dataframe=True)


@pytest.mark.parametrize("qname", [f"q{i}" for i in range(1, 7)])
def test_sql_query_on_mesh(tpch_path, qname):
    check_mesh_query(tpch_path, qname, f"m{qname}_sql")
