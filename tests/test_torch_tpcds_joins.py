"""TPC-DS join cases through the port against the JAX package, on the
CPU at SF 0.01, with runtime filters on (the default), as the JAX
package's `tests/test_tpcds.py` runs them:

- q19 and q68 under `join.kernelMode=sort` and `=hash` give the same
  Arrow bytes, with the hash kernel shown to have run;
- q19, q73 and q79 with the cost-based join reorder on and off give the
  same rows, and the reorder changes their plans.

Each run is also held to the reference and the golden
(`torch_sql_parity.check_query`).
"""

import pytest

from torch_sql_parity import TPCDS, check_query, sessions, write_tpcds

SF = 0.01
KERNEL_KEY = "spark_tpu.sql.join.kernelMode"
CBO_KEY = "spark_tpu.sql.cbo.joinReorder"


@pytest.fixture(scope="module")
def tpcds_path(tmp_path_factory):
    return write_tpcds(tmp_path_factory, SF)


@pytest.mark.parametrize("qname", ["q19", "q68"])
def test_tpcds_join_kernel_matrix(tpcds_path, qname):
    from spark_tpu_torch.tpcds.sql_queries import SQL_QUERIES
    outs = {}
    for mode in ("sort", "hash"):
        outs[mode] = check_query(tpcds_path, qname, f"{qname}_k{mode}",
                                 TPCDS, ((KERNEL_KEY, mode),))
    port, _ref = sessions(tpcds_path, f"{qname}_khash_m",
                          ((KERNEL_KEY, "hash"),), TPCDS[0])
    qe = port.sql(SQL_QUERIES[qname])._qe()
    qe.collect()
    assert any(k.startswith("join_table_slots_") for k in qe.last_metrics), \
        "hash kernel never ran — forced mode was ignored"
    assert outs["sort"].equals(outs["hash"])


@pytest.mark.parametrize("qname", ["q19", "q73", "q79"])
def test_tpcds_reorder_on_off_identical(tpcds_path, qname):
    from spark_tpu_torch.tpcds.sql_queries import SQL_QUERIES
    outs, plans = {}, {}
    for on in (True, False):
        outs[on] = check_query(tpcds_path, qname, f"{qname}_cbo{on}",
                               TPCDS, ((CBO_KEY, on),))
        port, _ref = sessions(tpcds_path, f"{qname}_cbo{on}_p",
                              ((CBO_KEY, on),), TPCDS[0])
        plans[on] = port.sql(SQL_QUERIES[qname])._qe().executed_plan \
            .tree_string()
    assert outs[True].equals(outs[False])
    assert plans[True] != plans[False]
