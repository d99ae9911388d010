"""TPC-H SQL Q15-Q22 on the mesh against the JAX package, on the CPU at
SF 0.002, held as `test_torch_mesh_tpch.py` holds Q1-Q6."""

import pytest

from test_torch_mesh_tpch import check_mesh_query, tpch_path  # noqa: F401


@pytest.mark.parametrize("qname", [f"q{i}" for i in range(15, 23)])
def test_sql_query_on_mesh(tpch_path, qname):  # noqa: F811
    check_mesh_query(tpch_path, qname, f"m{qname}_sql")
