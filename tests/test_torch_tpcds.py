"""TPC-DS through the port against the JAX package, on the CPU at SF
0.01 (`torch_sql_parity.py` says what each case holds: equal Arrow
results, equal executed plans before and after the run, and the pandas
golden). This file: the port's data generator, SQL texts and goldens
against the JAX package's, q1-q43 as SQL text, the DataFrame forms, and
q61's exchange. q48-q65 are in
`test_torch_tpcds_more.py`, q68-q98 in `test_torch_tpcds_rest.py`, and
the join-kernel matrix and the join-reorder cases in
`test_torch_tpcds_joins.py`; the files are split so each runs alone in
well under two minutes. The parity sweeps run with runtime filters off,
as the JAX package's own sweep does.
"""

import pytest

from spark_tpu.tpcds import queries as RQ
from spark_tpu.tpcds.datagen import generate as ref_generate
from spark_tpu_torch.tpcds import queries as PQ
from spark_tpu_torch.tpcds.datagen import generate
from spark_tpu_torch.tpcds.sql_queries import SQL_QUERIES
from torch_sql_parity import (NO_RUNTIME_FILTERS, TPCDS, assert_tables_match,
                              check_golden, check_query, sessions,
                              write_tpcds)

SF = 0.01


@pytest.fixture(scope="module")
def tpcds_path(tmp_path_factory):
    return write_tpcds(tmp_path_factory, SF)


def test_datagen_matches_reference():
    """The port's copy of the generator gives the JAX package's tables."""
    got, want = generate(SF), ref_generate(SF)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].equals(want[name]), name


def test_sql_texts_match_reference():
    """The port runs the JAX package's query texts, word for word."""
    from spark_tpu.tpcds.sql_queries import SQL_QUERIES as REF_SQL
    assert SQL_QUERIES == REF_SQL


@pytest.mark.parametrize("qname", sorted(SQL_QUERIES))
def test_golden_matches_reference(tpcds_path, qname):
    """The port's pandas golden gives the JAX package's golden answer on
    the same data (float columns within the suite's golden atol)."""
    from spark_tpu.tpcds.golden import GOLDEN as REF_GOLDEN
    _tables, _queries, golden, atol = TPCDS
    got, want = golden.GOLDEN[qname](tpcds_path), REF_GOLDEN[qname](tpcds_path)
    assert got.columns.tolist() == want.columns.tolist()
    golden.compare(got.reset_index(drop=True), want.reset_index(drop=True),
                   float_atol=atol)


def test_every_query_is_split_over_the_files():
    from test_torch_tpcds_more import QUERIES as MORE
    from test_torch_tpcds_rest import QUERIES as REST
    assert sorted(QUERIES + MORE + REST) == sorted(SQL_QUERIES)


QUERIES = ["q1", "q3", "q7", "q19", "q27", "q42", "q43"]


@pytest.mark.parametrize("qname", QUERIES)
def test_tpcds_sql_matches_reference(tpcds_path, qname):
    check_query(tpcds_path, qname, f"{qname}_ds", TPCDS, NO_RUNTIME_FILTERS)


@pytest.mark.parametrize("qname", sorted(PQ.QUERIES))
def test_tpcds_dataframe_forms(tpcds_path, qname):
    """Each DataFrame form equals the JAX package's (result and plan),
    passes the golden, and gives the same rows as its SQL text."""
    tables, _queries, _golden, _atol = TPCDS
    port, ref = sessions(tpcds_path, f"{qname}_dsdf", NO_RUNTIME_FILTERS,
                         tables)
    pqe = PQ.QUERIES[qname](port)._qe()
    rqe = RQ.QUERIES[qname](ref)._qe()
    assert pqe.executed_plan.tree_string() == \
        rqe.executed_plan.tree_string()
    got = pqe.collect()
    assert_tables_match(got, rqe.collect())
    check_golden(got, qname, tpcds_path, TPCDS)
    sql = port.sql(SQL_QUERIES[qname]).collect()
    assert_tables_match(sql.select(got.column_names), got)


def test_q61_plans_the_replicated_exchange(tpcds_path):
    """q61 cross-joins two one-row aggregates: the join has no key
    columns, so its build side needs every row on every partition and
    the planner puts a replicated exchange above it, printed as the
    JAX package prints it (`check_query` holds the whole plan)."""
    port, _ref = sessions(tpcds_path, "q61_exchange", NO_RUNTIME_FILTERS,
                          TPCDS[0])
    plan = port.sql(SQL_QUERIES["q61"])._qe().executed_plan.tree_string()
    assert "ExchangeExec(Replicated(num_partitions=1), block=None)" in plan
    got = check_query(tpcds_path, "q61", "q61_ds_exchange", TPCDS,
                      NO_RUNTIME_FILTERS)
    assert got.num_rows == 1
