"""Shared harness of the `tests/test_torch_sql*.py` and
`tests/test_torch_tpcds*.py` parity tests.

Each case gets two fresh sessions, one per package, with the TPC-H (or
TPC-DS) tables registered under the usual catalog names but read
through sources named after the case (`lineitem_<tag>`): the JAX package keeps
per-session state keyed by printed plans, so a plan printed by an
earlier query must not reach a later case. A SQL text then runs through
both, and:

- the Arrow results must be equal: the same schema, and every column
  equal, NULLs included; float columns within a relative 1e-12 (the JAX
  package's XLA rewrites division by a constant into multiplication by
  its reciprocal and folds constant factors, so a double computed from
  decimals can differ in its last bits);
- the executed plans must print the same, before the run and after it
  (the re-plan loop and the runtime filters leave node state behind);
- the result must pass the port's pandas golden answer.
"""

import os

import numpy as np
import pyarrow as pa

from spark_tpu.io.sources import ParquetSource as RefParquetSource
from spark_tpu.session import SparkTpuSession as RefSession
from spark_tpu_torch import SparkTpuSession
from spark_tpu_torch.io.sources import ParquetSource
from spark_tpu_torch.tpcds import golden as DSG
from spark_tpu_torch.tpcds.queries import TABLES as DS_TABLES
from spark_tpu_torch.tpcds.sql_queries import SQL_QUERIES as DS_QUERIES
from spark_tpu_torch.tpch import golden as G
from spark_tpu_torch.tpch.datagen import write_parquet
from spark_tpu_torch.tpch.sql_queries import SQL_QUERIES

TABLES = ("lineitem", "orders", "customer", "supplier", "nation", "region",
          "part", "partsupp")

#: (tables, SQL texts, golden module, golden float atol) of each suite;
#: TPC-DS's atol is its JAX test's (avg over decimals rounds at scale 6)
TPCH = (TABLES, SQL_QUERIES, G, 1e-6)
TPCDS = (DS_TABLES, DS_QUERIES, DSG, 1e-4)

#: relative tolerance of float columns against the JAX package
FLOAT_RTOL = 1e-12


def write_data(tmp_path_factory, sf: float) -> str:
    path = str(tmp_path_factory.mktemp("tpch_sql") / f"sf{sf}")
    write_parquet(path, sf)
    return path


def write_tpcds(tmp_path_factory, sf: float) -> str:
    from spark_tpu_torch.tpcds.datagen import write_parquet as write_ds
    path = str(tmp_path_factory.mktemp("tpcds_sql") / f"sf{sf}")
    write_ds(path, sf)
    return path


#: the conf of the TPC-DS parity sweeps: runtime filters off, as the JAX
#: package's own sweep runs (results are the same on and off; the
#: kernel-matrix and reorder cases keep them on)
NO_RUNTIME_FILTERS = (("spark_tpu.sql.runtimeFilter.enabled", False),)


def sessions(path: str, tag: str, confs=(), tables=TABLES):
    """(port, reference): fresh sessions over the data at `path`."""
    port = SparkTpuSession.builder().device("cpu").get_or_create()
    ref = RefSession(register_active=False)
    for key, value in confs:
        port.conf.set(key, value)
        ref.conf.set(key, value)
    for t in tables:
        file = os.path.join(path, f"{t}.parquet")
        port.register_table(t, ParquetSource(file, f"{t}_{tag}"))
        ref.register_table(t, RefParquetSource(file, f"{t}_{tag}"))
    return port, ref


def assert_tables_match(got: pa.Table, want: pa.Table) -> None:
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows
    for name, g, w in zip(want.column_names, got.columns, want.columns):
        if pa.types.is_floating(w.type):
            gv, wv = g.is_valid().to_numpy(zero_copy_only=False), \
                w.is_valid().to_numpy(zero_copy_only=False)
            np.testing.assert_array_equal(gv, wv, err_msg=name)
            np.testing.assert_allclose(
                g.to_numpy(zero_copy_only=False)[gv],
                w.to_numpy(zero_copy_only=False)[wv], rtol=FLOAT_RTOL,
                err_msg=name)
        else:
            assert g.equals(w), name


def check_query(path: str, qname: str, tag: str, suite=TPCH, confs=()):
    """Run `qname` of `suite` (TPC-H unless given) as SQL through both
    packages and hold the port to the reference and the golden. Returns
    the port's result."""
    tables, queries, golden, atol = suite
    port, ref = sessions(path, tag, confs, tables)
    pqe = port.sql(queries[qname])._qe()
    rqe = ref.sql(queries[qname])._qe()
    assert pqe.executed_plan.tree_string() == \
        rqe.executed_plan.tree_string()
    got, want = pqe.collect(), rqe.collect()
    assert_tables_match(got, want)
    assert pqe.executed_plan.tree_string() == \
        rqe.executed_plan.tree_string()
    check_golden(got, qname, path, suite)
    return got


def check_golden(got: pa.Table, qname: str, path: str, suite=TPCH) -> None:
    _tables, _queries, golden, atol = suite
    gold = golden.GOLDEN[qname](path)
    out = golden.normalize_decimals(got.to_pandas())[gold.columns.tolist()]
    golden.compare(out.reset_index(drop=True), gold, float_atol=atol)
