"""TPC-H Q2, Q20 and Q21 as SQL text at SF 0.05 through the port against
the JAX package (see `test_torch_sql_tpch.py`). At SF 0.002 these three
return no row or one; at SF 0.05 they return 12, 2 and 23, so their
correlated subqueries, IN and EXISTS rewrites are held on real rows.
"""

import pytest

from torch_sql_parity import check_query, write_data

SF = 0.05


@pytest.fixture(scope="module")
def tpch_path(tmp_path_factory):
    return write_data(tmp_path_factory, SF)


@pytest.mark.parametrize("qname,rows", [("q2", 12), ("q20", 2), ("q21", 23)])
def test_sql_query_matches_reference(tpch_path, qname, rows):
    got = check_query(tpch_path, qname, f"{qname}_sf{SF}")
    assert got.num_rows == rows
