"""TPC-H Q1-Q11 as SQL text through the port against the JAX package,
on the CPU at SF 0.002 (`torch_sql_parity.py` says what each case
holds: equal Arrow results, equal executed plans before and after the
run, and the pandas golden). Q12-Q22 are in `test_torch_sql_tpch_more.py`
and Q2, Q20 and Q21 at SF 0.05, where they return rows, in
`test_torch_sql_sf005.py`; the files are split so each runs alone in
well under two minutes.
"""

import pytest

from spark_tpu_torch.tpch import queries as PQ
from spark_tpu_torch.tpch.sql_queries import SQL_QUERIES
from torch_sql_parity import assert_tables_match, check_query, sessions
from torch_sql_parity import write_data

SF = 0.002


@pytest.fixture(scope="module")
def tpch_path(tmp_path_factory):
    return write_data(tmp_path_factory, SF)


@pytest.mark.parametrize("qname", [f"q{i}" for i in range(1, 12)])
def test_sql_query_matches_reference(tpch_path, qname):
    check_query(tpch_path, qname, f"{qname}_sf{SF}")


@pytest.mark.parametrize("qname", ["q1", "q3", "q5", "q6"])
def test_sql_equals_the_dataframe_program(tpch_path, qname):
    """The SQL text and the DataFrame program of the same query give
    the same rows (SQL's column order differs; Q5's ties may not)."""
    port, _ref = sessions(tpch_path, f"{qname}_df")
    sql = port.sql(SQL_QUERIES[qname]).collect()
    df = PQ.QUERIES[qname](port).collect()
    sql = sql.select(df.column_names)
    if qname == "q5":
        sql, df = sql.sort_by("n_name"), df.sort_by("n_name")
    assert_tables_match(sql, df)
