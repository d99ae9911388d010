"""TPC-H Q12-Q22 as SQL text through the port against the JAX package,
on the CPU at SF 0.002 (see `test_torch_sql_tpch.py`). Q22 returns no
row at any scale the datagen makes (every customer has orders, so its
NOT EXISTS removes everyone), in both packages.
"""

import pytest

from torch_sql_parity import check_query, write_data

SF = 0.002


@pytest.fixture(scope="module")
def tpch_path(tmp_path_factory):
    return write_data(tmp_path_factory, SF)


@pytest.mark.parametrize("qname", [f"q{i}" for i in range(12, 23)])
def test_sql_query_matches_reference(tpch_path, qname):
    check_query(tpch_path, qname, f"{qname}_sf{SF}")
