"""TPC-DS q48-q65 as SQL text through the port against the JAX package,
on the CPU at SF 0.01 (see `test_torch_tpcds.py`)."""

import pytest

from torch_sql_parity import NO_RUNTIME_FILTERS, TPCDS, check_query
from torch_sql_parity import write_tpcds

SF = 0.01
QUERIES = ["q48", "q52", "q55", "q59", "q61", "q63", "q65"]


@pytest.fixture(scope="module")
def tpcds_path(tmp_path_factory):
    return write_tpcds(tmp_path_factory, SF)


@pytest.mark.parametrize("qname", QUERIES)
def test_tpcds_sql_matches_reference(tpcds_path, qname):
    check_query(tpcds_path, qname, f"{qname}_ds", TPCDS, NO_RUNTIME_FILTERS)
