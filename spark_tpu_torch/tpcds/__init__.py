"""TPC-DS harness: data generation, the tranche-1 queries, and pandas
golden references for result-parity checks (the port's own copies of
`spark_tpu/tpcds/`: pure Python, numpy, pandas and pyarrow, so the port
and `chip_smoke.py` run them without the JAX package) — the TPC-DS
sibling of `tpch/`, modeled on the reference's committed TPC-DS suites
(`TPCDSQueryTestSuite.scala:54` golden results + plan stability,
`TPCDSQueryBenchmark.scala:54` timed queries over generated data).

The store-channel subset is generated (datagen.py), goldens are an
independent pandas engine (golden.py), queries ship as SQL text
(sql_queries.py, ~21 queries covering CTE nesting, ROLLUP, windows and
3-7-way snowflake joins) plus DataFrame forms for the bench/smoke
subset (queries.py)."""

from .datagen import generate, write_parquet
from .queries import QUERIES, register_tables
from .sql_queries import SQL_QUERIES

__all__ = ["generate", "write_parquet", "QUERIES", "SQL_QUERIES",
           "register_tables"]
