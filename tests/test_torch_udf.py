"""The port's Python UDFs (`spark_tpu_torch/udf.py`,
`execution/python_eval.py`, `GroupedData.apply_in_pandas`) against the
JAX package's, on the CPU, in the default in-process lane.

Every case of `tests/test_udf.py` but the mesh one runs through a port
session and a JAX-package session: the same user function, the same
input, Arrow results equal (ints, strings, dates, decimals and validity
exactly, floats within rtol 1e-12, `tests/torch_sql_parity.py`) and the
executed plans printing the same. Two TPC-H cases at SF 0.002 follow: a
pandas UDF inside a Q1-shaped SQL aggregate and scalar UDFs as a group
key and in a filter, each also held to pandas. The worker lane has its
own file, `tests/test_torch_udf_worker.py`.
"""

import datetime
import decimal
import os

import numpy as np
import pandas as pd
import pytest

import spark_tpu.functions as RF
from spark_tpu.io.sources import ParquetSource as RefParquetSource
from spark_tpu.session import SparkTpuSession as RefSession
from spark_tpu_torch import SparkTpuSession
from spark_tpu_torch import functions as PF
from spark_tpu_torch.execution.failures import FailureClass, classify
from spark_tpu_torch.io.sources import ParquetSource
from spark_tpu_torch.sql.parser import ParseError
from spark_tpu_torch.tpch.datagen import write_parquet
from spark_tpu_torch.udf_worker import UdfError
from spark_tpu_torch.udf_worker.pool import UdfWorkerLost

from torch_sql_parity import FLOAT_RTOL, assert_tables_match

SF = 0.002


class Side:
    """One package's session and its `functions` module."""

    def __init__(self, session, F):
        self.session = session
        self.F = F

    def table(self, name):
        return self.session.table(name)


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tpch_udf") / "sf")
    write_parquet(path, SF)
    port = SparkTpuSession.builder().device("cpu").get_or_create()
    ref = RefSession(register_active=False)
    frames = {
        "udf_t": pd.DataFrame({
            "x": np.array([1.0, 2.0, np.nan, 4.0]),
            "i": np.array([10, 20, 30, 40], dtype=np.int64),
            "s": ["aa", "bb", None, "dd"]}),
        "gm_t": pd.DataFrame({
            "k": np.array([0, 0, 1, 1, 2], dtype=np.int64),
            "v": np.array([1.0, 3.0, 5.0, 7.0, 9.0])}),
        "udf_dt": pd.DataFrame({
            "d": pd.to_datetime(["2023-01-15", "2024-06-30"]),
            "m": [decimal.Decimal("12.50"), decimal.Decimal("0.75")]}),
    }
    for s, src in ((port, ParquetSource), (ref, RefParquetSource)):
        for name, frame in frames.items():
            s.register_table(name, frame)
        for t in ("lineitem", "orders", "customer"):
            s.register_table(t, src(os.path.join(path, f"{t}.parquet"),
                                    f"{t}_udf"))
    return Side(port, PF), Side(ref, RF), path


def run_both(sides, build):
    """`build(side)` -> DataFrame, through the port and the JAX package:
    the plans must print the same and the results match. Returns the
    port's result and QueryExecution."""
    port, ref, _ = sides
    pqe, rqe = build(port)._qe(), build(ref)._qe()
    assert pqe.executed_plan.tree_string() == rqe.executed_plan.tree_string()
    got, want = pqe.collect(), rqe.collect()
    assert_tables_match(got, want)
    return got, pqe


# -- the cases of tests/test_udf.py ----------------------------------------


def test_scalar_udf_select(sides):
    fn = lambda v: None if v is None else v + 1.0  # noqa: E731
    got, qe = run_both(sides, lambda s: s.table("udf_t").select(
        s.F.col("i"), s.F.udf(fn, "double")(s.F.col("x")).alias("y")))
    out = got.to_pandas()
    assert out["y"][0] == 2.0 and out["y"][1] == 3.0
    assert pd.isna(out["y"][2]) and out["y"][3] == 5.0
    assert "InputExec(python_udf," in qe.spliced_plan.tree_string()
    assert "python_udfs" in qe.phase_times
    assert qe.udf_summary["mode"] == "inprocess"
    assert (qe.udf_summary["batches"], qe.udf_summary["rows"]) == (1, 4)


def test_scalar_udf_strings_and_null_return(sides):
    fn = lambda s: None if s in (None, "bb") else s.upper()  # noqa: E731
    got, _ = run_both(sides, lambda s: s.table("udf_t").select(
        s.F.udf(fn, "string")(s.F.col("s")).alias("u")))
    assert got.column("u").to_pylist() == ["AA", None, None, "DD"]


def test_udf_in_filter_and_expression_args(sides):
    fn = lambda v: v is not None and v > 25  # noqa: E731
    got, _ = run_both(sides, lambda s: s.table("udf_t").filter(
        s.F.udf(fn, "boolean")(s.F.col("i") + 1)))
    assert got.column("i").to_pylist() == [30, 40]


def test_nested_udfs(sides):
    double = lambda v: None if v is None else v * 2  # noqa: E731
    inc = lambda v: None if v is None else v + 1  # noqa: E731
    got, _ = run_both(sides, lambda s: s.table("udf_t").select(
        s.F.udf(inc, "long")(s.F.udf(double, "long")(s.F.col("i")))
        .alias("y")))
    assert got.column("y").to_pylist() == [21, 41, 61, 81]


def test_pandas_udf_vectorized(sides):
    def scaled(v: pd.Series) -> pd.Series:
        return v * 10.0

    got, _ = run_both(sides, lambda s: s.table("udf_t").select(
        s.F.pandas_udf(returnType="double")(scaled)(s.F.col("x"))
        .alias("y")))
    assert got.column("y").to_pylist() == [10.0, 20.0, None, 40.0]


def test_sql_registered_udf(sides):
    fn = lambda v: None if v is None else v ** 3  # noqa: E731
    for side in sides[:2]:
        side.session.udf.register("cube_it", fn, "long")
    got, _ = run_both(sides, lambda s: s.session.sql(
        "SELECT i, cube_it(i) AS c FROM udf_t"))
    assert got.column("c").to_pylist() == [1000, 8000, 27000, 64000]
    with pytest.raises(ParseError, match="unknown function"):
        sides[0].session.sql("SELECT no_such_udf(i) FROM udf_t")


def test_udf_downstream_of_device_ops_and_upstream_agg(sides):
    """The UDF stage cuts the plan: a device filter below, a device
    aggregate above."""
    half = lambda v: v / 2.0  # noqa: E731
    got, _ = run_both(sides, lambda s: (
        s.table("udf_t").filter(s.F.col("i") > 10)
        .select(s.F.udf(half, "double")(s.F.col("i")).alias("h"))
        .agg(s.F.sum(s.F.col("h")).alias("s"))))
    assert got.column("s").to_pylist() == [(20 + 30 + 40) / 2.0]


def test_grouped_map_apply_in_pandas(sides):
    def center(g: pd.DataFrame) -> pd.DataFrame:
        return pd.DataFrame({"k": g["k"], "c": g["v"] - g["v"].mean()})

    got, _ = run_both(sides, lambda s: (
        s.table("gm_t").group_by(s.F.col("k"))
        .apply_in_pandas(center, "k long, c double")))
    pdf = sides[0].session.table("gm_t").to_pandas()
    want = pdf.assign(c=pdf.groupby("k")["v"].transform(
        lambda v: v - v.mean()))[["k", "c"]]
    out = got.to_pandas().sort_values(["k", "c"]).reset_index(drop=True)
    want = want.sort_values(["k", "c"]).reset_index(drop=True)
    assert out["k"].tolist() == want["k"].tolist()
    np.testing.assert_allclose(out["c"], want["c"], rtol=FLOAT_RTOL)


def test_udf_date_and_decimal_args(sides):
    year_of = lambda d: d.year  # noqa: E731
    dollars = lambda m: float(m) * 2  # noqa: E731
    got, _ = run_both(sides, lambda s: s.table("udf_dt").select(
        s.F.udf(year_of, "int")(s.F.col("d")).alias("y"),
        s.F.udf(dollars, "double")(s.F.col("m")).alias("v")))
    assert got.column("y").to_pylist() == [2023, 2024]
    assert got.column("v").to_pylist() == [25.0, 1.5]


# -- TPC-H at SF 0.002 -------------------------------------------------------

Q1_SHAPED = """
SELECT l_returnflag, l_linestatus,
       sum(net(CAST(l_extendedprice AS DOUBLE), CAST(l_discount AS DOUBLE)))
           AS s,
       avg(net(CAST(l_extendedprice AS DOUBLE), CAST(l_discount AS DOUBLE)))
           AS a,
       count(*) AS n
FROM lineitem WHERE l_shipdate <= DATE '1998-09-02'
GROUP BY l_returnflag, l_linestatus ORDER BY 1, 2"""


def test_pandas_udf_in_q1_shaped_sql_aggregate(sides):
    net = lambda p, d: p * (1 - d)  # noqa: E731
    for side in sides[:2]:
        side.session.udf.register(
            "net", side.F.pandas_udf(net, "double"))
    got, qe = run_both(sides, lambda s: s.session.sql(Q1_SHAPED))
    assert "InputExec(python_udf," in qe.spliced_plan.tree_string()
    import pyarrow.parquet as pq
    li = pq.read_table(os.path.join(sides[2], "lineitem.parquet")).to_pandas()
    li = li[li["l_shipdate"] <= datetime.date(1998, 9, 2)]
    li = li.assign(net=li["l_extendedprice"].astype(float)
                   * (1 - li["l_discount"].astype(float)))
    want = (li.groupby(["l_returnflag", "l_linestatus"], as_index=False)
            .agg(s=("net", "sum"), a=("net", "mean"), n=("net", "size"))
            .sort_values(["l_returnflag", "l_linestatus"]))
    out = got.to_pandas()
    assert out["l_returnflag"].tolist() == want["l_returnflag"].tolist()
    assert out["l_linestatus"].tolist() == want["l_linestatus"].tolist()
    assert out["n"].tolist() == want["n"].tolist()
    np.testing.assert_allclose(out["s"], want["s"], rtol=1e-9)
    np.testing.assert_allclose(out["a"], want["a"], rtol=1e-9)


def test_scalar_udfs_as_group_key_and_filter(sides):
    prio = lambda s: s.split("-")[1].strip()  # noqa: E731
    late = lambda d: d.year >= 1995  # noqa: E731

    def build(s):
        F = s.F
        return (s.table("orders")
                .filter(F.udf(late, "boolean")(F.col("o_orderdate")))
                .group_by(F.udf(prio, "string")(F.col("o_orderpriority"))
                          .alias("prio"))
                .agg(F.sum(F.col("o_totalprice")).alias("total"),
                     F.count(F.col("o_orderkey")).alias("n"))
                .order_by(F.col("prio")))

    got, _ = run_both(sides, build)
    import pyarrow.parquet as pq
    o = pq.read_table(os.path.join(sides[2], "orders.parquet")).to_pandas()
    o = o[pd.to_datetime(o["o_orderdate"]).dt.year >= 1995]
    want = (o.assign(prio=o["o_orderpriority"].str.split("-").str[1]
                     .str.strip())
            .groupby("prio", as_index=False)
            .agg(total=("o_totalprice", "sum"), n=("o_orderkey", "size"))
            .sort_values("prio"))
    out = got.to_pandas()
    assert out["prio"].tolist() == want["prio"].tolist()
    assert out["n"].tolist() == want["n"].tolist()
    assert out["total"].tolist() == want["total"].tolist()


def test_decimal_udf_on_customer(sides):
    """A scalar UDF over c_acctbal gets Python Decimal objects."""
    tier = lambda b: None if b is None else int(b // 1000)  # noqa: E731
    got, _ = run_both(sides, lambda s: s.table("customer").select(
        s.F.col("c_custkey"),
        s.F.udf(tier, "long")(s.F.col("c_acctbal")).alias("tier")))
    import pyarrow.parquet as pq
    c = pq.read_table(os.path.join(sides[2], "customer.parquet")).to_pandas()
    assert got.column("c_custkey").to_pylist() == c["c_custkey"].tolist()
    assert got.column("tier").to_pylist() == \
        [int(b // 1000) for b in c["c_acctbal"]]


# -- the failure taxonomy ----------------------------------------------------


@pytest.mark.parametrize("exc,cls", [
    (UdfError("f", "ValueError", "UNAVAILABLE in user text", "tb"),
     FailureClass.FATAL),
    (UdfWorkerLost(123, "pipe closed"), FailureClass.TRANSIENT),
])
def test_udf_failures_classify(exc, cls):
    assert classify(exc) is cls
