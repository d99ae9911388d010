"""The port's catalog and DDL/DML (`spark_tpu_torch/catalog.py`,
`sql/ddl.py`) against the JAX package, on the CPU.

The seven cases of the reference's `tests/test_catalog_ddl.py` — CREATE
TABLE [AS SELECT], INSERT INTO ... VALUES and ... SELECT, DROP, SHOW
TABLES, DESCRIBE, the warehouse seen from a fresh session, the by-position
INSERT cast and its arity check, the DataFrame API over a persistent
table — plus USING parquet and the device cache over an INSERT. Each
statement runs in a port session and a reference session, each over its
own warehouse directory under `tmp_path`: the command results and the
queries' Arrow results must be equal, and so must the error messages.
The warehouse layout is shared: a reference session reads the port's
tables and the other way round.
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

from spark_tpu.session import SparkTpuSession as RefSession
from spark_tpu_torch import SparkTpuSession
from torch_sql_parity import assert_tables_match

WH_KEY = "spark_tpu.sql.warehouse.dir"


def port_session(wh):
    s = SparkTpuSession.builder().device("cpu").get_or_create()
    s.conf.set(WH_KEY, str(wh))
    return s


def ref_session(wh):
    s = RefSession(register_active=False)
    s.conf.set(WH_KEY, str(wh))
    return s


@pytest.fixture
def both(tmp_path):
    return port_session(tmp_path / "port_wh"), ref_session(tmp_path / "ref_wh")


def run(both, text) -> pd.DataFrame:
    """`text` in both sessions: equal Arrow results; the port's."""
    port, ref = both
    got = port.sql(text).collect()
    assert_tables_match(got, ref.sql(text).collect())
    return got.to_pandas()


def same_error(both, text, match):
    """`text` raises in both sessions, with the same class name and
    message."""
    errors = []
    for s in both:
        with pytest.raises(Exception, match=match) as info:
            s.sql(text).collect()
        errors.append((type(info.value).__name__, str(info.value)))
    assert errors[0] == errors[1]


def register(both, name, data):
    for s in both:
        s.register_table(name, data)


def test_create_insert_select_roundtrip(both):
    run(both, "CREATE TABLE ddl_t (k BIGINT, name STRING, "
              "price DECIMAL(10,2))")
    got = run(both, "INSERT INTO ddl_t VALUES (1, 'widget', 9.50), "
                    "(2, 'gadget', 3.25)")
    assert got["inserted"].tolist() == [2]
    run(both, "INSERT INTO ddl_t VALUES (3, NULL, -1.00)")
    out = run(both, "SELECT k, name, price FROM ddl_t ORDER BY k")
    assert out["k"].tolist() == [1, 2, 3]
    assert out["name"].tolist()[:2] == ["widget", "gadget"]
    assert pd.isna(out["name"][2])
    assert [float(x) for x in out["price"]] == [9.5, 3.25, -1.0]


def test_ctas_and_insert_select(both):
    rng = np.random.default_rng(3)
    pdf = pd.DataFrame({"a": np.arange(10, dtype=np.int64),
                        "b": rng.normal(size=10),
                        "s": rng.choice(["x", "y"], 10)})
    register(both, "src_view", pdf)
    got = run(both, "CREATE TABLE ctas_t AS SELECT a, b * 2 AS b2, s "
                    "FROM src_view WHERE a >= 5")
    assert got.columns.tolist() == ["result"] and len(got) == 0
    out = run(both, "SELECT * FROM ctas_t ORDER BY a")
    assert out["a"].tolist() == [5, 6, 7, 8, 9]
    run(both, "INSERT INTO ctas_t SELECT a, b, s FROM src_view WHERE a < 2")
    n = run(both, "SELECT count(*) AS c FROM ctas_t")
    assert int(n["c"][0]) == 7
    run(both, "SELECT s, sum(b2) AS t, count(*) AS c FROM ctas_t "
              "GROUP BY s ORDER BY s")


def test_show_describe_drop(both, tmp_path):
    run(both, "CREATE TABLE show_t (x INT, y STRING, d DATE, "
              "m DECIMAL(12,2), f DOUBLE, b BOOLEAN)")
    register(both, "tmp_v", pd.DataFrame({"z": [1]}))
    rows = run(both, "SHOW TABLES")
    by_name = dict(zip(rows["tableName"], rows["isTemporary"]))
    assert by_name == {"show_t": False, "tmp_v": True}
    d = run(both, "DESCRIBE show_t")
    assert d["col_name"].tolist() == ["x", "y", "d", "m", "f", "b"]
    run(both, "DESC TABLE tmp_v")
    run(both, "DROP TABLE show_t")
    assert not (tmp_path / "port_wh" / "show_t").exists()
    rows = run(both, "SHOW TABLES")
    assert "show_t" not in rows["tableName"].tolist()
    same_error(both, "DROP TABLE show_t", "not found")
    run(both, "DROP TABLE IF EXISTS show_t")  # no raise
    run(both, "DROP VIEW tmp_v")
    assert run(both, "SHOW TABLES").empty


def test_create_errors_and_replace(both):
    run(both, "CREATE TABLE err_t (x INT)")
    same_error(both, "CREATE TABLE err_t (x INT)", "already exists")
    run(both, "CREATE TABLE IF NOT EXISTS err_t (x INT)")  # no raise
    register(both, "seed", pd.DataFrame({"x": np.array([7], np.int32)}))
    run(both, "CREATE OR REPLACE TABLE err_t AS SELECT x FROM seed")
    out = run(both, "SELECT * FROM err_t")
    assert out["x"].tolist() == [7]
    same_error(both, "CREATE TABLE seed (x INT)", "temp view")
    same_error(both, "CREATE TABLE j (x INT) USING json",
               "only USING parquet")
    same_error(both, "CREATE TABLE u (x BLOB)", "unknown column type")
    same_error(both, "INSERT INTO seed VALUES (1)", "temp view")
    same_error(both, "INSERT INTO nowhere VALUES (1)", "not found")
    same_error(both, "DESCRIBE nowhere", "not found")
    same_error(both, "SHOW COLUMNS", "TABLES")


def test_warehouse_survives_fresh_session(tmp_path):
    """The DDL round trip: a brand-new session over the same warehouse
    dir sees tables an earlier session created — across the packages
    too, since both keep the same layout."""
    wh = tmp_path / "wh2"
    s1 = port_session(wh)
    s1.sql("CREATE TABLE persist_t (k BIGINT, v DOUBLE) USING parquet")
    s1.sql("INSERT INTO persist_t VALUES (1, 1.5), (2, 2.5)")
    text = "SELECT k, v FROM persist_t ORDER BY k"
    s2, r2 = port_session(wh), ref_session(wh)
    got = s2.sql(text).collect()
    assert_tables_match(got, r2.sql(text).collect())
    assert got.column("k").to_pylist() == [1, 2]
    assert got.column("v").to_pylist() == [1.5, 2.5]
    assert s2.catalog.list_tables() == r2.catalog.list_tables() == [
        {"name": "persist_t", "isTemporary": False}]
    # and the reference's tables read from the port
    r2.sql("INSERT INTO persist_t VALUES (3, 3.5)")
    assert port_session(wh).sql(text).collect().column("k").to_pylist() \
        == [1, 2, 3]


def test_insert_position_cast_and_arity_check(both):
    run(both, "CREATE TABLE cast_t (k BIGINT, v DOUBLE)")
    run(both, "INSERT INTO cast_t VALUES (1, 2)")  # int -> double cast
    run(both, "INSERT INTO cast_t VALUES (-4, -2.5)")
    out = run(both, "SELECT * FROM cast_t ORDER BY k")
    assert out["v"].tolist() == [-2.5, 2.0]
    same_error(both, "INSERT INTO cast_t VALUES (1, 2, 3)",
               "3 columns for 2 target columns")
    same_error(both, "INSERT INTO cast_t VALUES (1, 2), (3)",
               "differ in arity")


def test_dataframe_api_over_persistent_table(both):
    from spark_tpu_torch.functions import col
    from spark_tpu_torch.io.device_cache import CACHE
    from spark_tpu.functions import col as rcol
    run(both, "CREATE TABLE api_t (k BIGINT, v DOUBLE)")
    run(both, "INSERT INTO api_t VALUES (1, 10.0), (2, 20.0), (3, 30.0)")
    port, ref = both
    got = port.table("api_t").filter(col("k") > 1).collect()
    assert_tables_match(got, ref.table("api_t").filter(rcol("k") > 1)
                        .collect())
    assert sorted(got.column("v").to_pylist()) == [20.0, 30.0]
    # an INSERT re-stamps the table: the device cache cannot serve the
    # rows loaded before it
    hits = CACHE.stats()["hits"]
    run(both, "INSERT INTO api_t VALUES (4, 40.0)")
    got = port.table("api_t").filter(col("k") > 1).collect()
    assert sorted(got.column("v").to_pylist()) == [20.0, 30.0, 40.0]
    assert CACHE.stats()["hits"] == hits
    assert port.table("api_t").count() == 4


def test_ddl_result_is_a_dataframe(both):
    port, _ = both
    df = port.sql("CREATE TABLE r_t (x INT)")
    assert isinstance(df.collect(), pa.Table)
    assert "r_t" in port.catalog and "r_t" in list(port.catalog)
    assert len(port.catalog) == 1
    assert port.catalog.describe("r_t") == [
        {"col_name": "x", "data_type": "integer", "nullable": True}]
