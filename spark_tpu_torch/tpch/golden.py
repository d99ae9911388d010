"""Independent pandas implementations of the 22 TPC-H queries (the
port's copy of `spark_tpu/tpch/golden.py`).

These compute golden answers on the generated data (the trusted-engine
role duckdb/real-Spark would play; pandas is the independent engine baked
into this image). Parity checks compare engine output against these with
a small float tolerance — the `QueryTest.checkAnswer` pattern.

Tables are read once per data directory and kept, with decimal columns
cast to float64 in Arrow before `to_pandas()`: converting each decimal
cell through a Python `Decimal` object cost most of a golden's time at
SF1.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq


def normalize_decimals(df: pd.DataFrame) -> pd.DataFrame:
    """Cast Decimal object columns to float (in place, returned for
    chaining) — the shared normalization for pandas reference arithmetic
    and for comparing engine output against the goldens."""
    for c in df.columns:
        if df[c].dtype == object and len(df) and \
                df[c].iloc[0].__class__.__name__ == "Decimal":
            df[c] = df[c].astype(float)
    return df


#: the frames of the last data directory read: {name: DataFrame}
_FRAMES: Dict[str, pd.DataFrame] = {}
_FRAMES_PATH = [None]


def _read(path: str, name: str) -> pd.DataFrame:
    """The table as pandas, decimals as float64. Kept per directory, so
    the callers must not modify the frame in place."""
    if _FRAMES_PATH[0] != path:
        _FRAMES.clear()
        _FRAMES_PATH[0] = path
    df = _FRAMES.get(name)
    if df is None:
        t = pq.read_table(os.path.join(path, f"{name}.parquet"))
        for i, f in enumerate(t.schema):
            if pa.types.is_decimal(f.type):
                t = t.set_column(i, f.name, t.column(i).cast(pa.float64()))
        df = _FRAMES[name] = t.to_pandas()
    return df


def q1(path: str) -> pd.DataFrame:
    l = _read(path, "lineitem")
    l = l[l["l_shipdate"] <= pd.Timestamp("1998-09-02").date()]
    l = l.assign(
        disc_price=l["l_extendedprice"] * (1 - l["l_discount"]),
        charge=l["l_extendedprice"] * (1 - l["l_discount"])
        * (1 + l["l_tax"]))
    out = (l.groupby(["l_returnflag", "l_linestatus"], as_index=False)
           .agg(sum_qty=("l_quantity", "sum"),
                sum_base_price=("l_extendedprice", "sum"),
                sum_disc_price=("disc_price", "sum"),
                sum_charge=("charge", "sum"),
                avg_qty=("l_quantity", "mean"),
                avg_price=("l_extendedprice", "mean"),
                avg_disc=("l_discount", "mean"),
                count_order=("l_quantity", "size")))
    return out.sort_values(["l_returnflag", "l_linestatus"]) \
        .reset_index(drop=True)


def q3(path: str) -> pd.DataFrame:
    c = _read(path, "customer")
    o = _read(path, "orders")
    l = _read(path, "lineitem")
    c = c[c["c_mktsegment"] == "BUILDING"]
    o = o[o["o_orderdate"] < pd.Timestamp("1995-03-15").date()]
    l = l[l["l_shipdate"] > pd.Timestamp("1995-03-15").date()]
    m = l.merge(o, left_on="l_orderkey", right_on="o_orderkey") \
        .merge(c, left_on="o_custkey", right_on="c_custkey")
    m = m.assign(revenue=m["l_extendedprice"] * (1 - m["l_discount"]))
    out = (m.groupby(["l_orderkey", "o_orderdate", "o_shippriority"],
                     as_index=False).agg(revenue=("revenue", "sum")))
    out = out.sort_values(["revenue", "o_orderdate"],
                          ascending=[False, True]).head(10)
    return out[["l_orderkey", "o_orderdate", "o_shippriority", "revenue"]] \
        .reset_index(drop=True)


def q5(path: str) -> pd.DataFrame:
    r = _read(path, "region")
    n = _read(path, "nation")
    c = _read(path, "customer")
    o = _read(path, "orders")
    l = _read(path, "lineitem")
    s = _read(path, "supplier")
    r = r[r["r_name"] == "ASIA"]
    m = (c.merge(n, left_on="c_nationkey", right_on="n_nationkey")
         .merge(r, left_on="n_regionkey", right_on="r_regionkey"))
    o = o[(o["o_orderdate"] >= pd.Timestamp("1994-01-01").date())
          & (o["o_orderdate"] < pd.Timestamp("1995-01-01").date())]
    m = o.merge(m, left_on="o_custkey", right_on="c_custkey")
    m = l.merge(m, left_on="l_orderkey", right_on="o_orderkey")
    m = m.merge(s, left_on="l_suppkey", right_on="s_suppkey")
    m = m[m["c_nationkey"] == m["s_nationkey"]]
    m = m.assign(revenue=m["l_extendedprice"] * (1 - m["l_discount"]))
    out = (m.groupby("n_name", as_index=False).agg(revenue=("revenue", "sum"))
           .sort_values("revenue", ascending=False))
    return out.reset_index(drop=True)


def q6(path: str) -> pd.DataFrame:
    l = _read(path, "lineitem")
    m = l[(l["l_shipdate"] >= pd.Timestamp("1994-01-01").date())
          & (l["l_shipdate"] < pd.Timestamp("1995-01-01").date())
          & (l["l_discount"] >= 0.05 - 1e-9)
          & (l["l_discount"] <= 0.07 + 1e-9)
          & (l["l_quantity"] < 24)]
    return pd.DataFrame(
        {"revenue": [(m["l_extendedprice"] * m["l_discount"]).sum()]})


GOLDEN = {"q1": q1, "q3": q3, "q5": q5, "q6": q6}


def compare(got: pd.DataFrame, want: pd.DataFrame,
            float_rtol: float = 1e-6, float_atol: float = 1e-6) -> None:
    """Row-set comparison with float tolerance (QueryTest.checkAnswer).
    `float_atol` absorbs legitimate decimal-scale rounding: avg(decimal)
    rounds HALF_UP at result scale 6 per the reference, pandas does not."""
    if len(got) != len(want):
        raise AssertionError(
            f"row count {len(got)} != {len(want)}\n{got}\n{want}")
    if list(got.columns) != list(want.columns):
        raise AssertionError(f"columns {list(got.columns)} != "
                             f"{list(want.columns)}")
    for c in want.columns:
        g, w = got[c], want[c]
        try:
            gf = g.astype(float)
            wf = w.astype(float)
            if not np.allclose(gf, wf, rtol=float_rtol, atol=float_atol, equal_nan=True):
                bad = np.nonzero(~np.isclose(gf, wf, rtol=float_rtol,
                                             atol=float_atol, equal_nan=True))[0]
                raise AssertionError(
                    f"column {c} diverges at rows {bad[:5]}:\n"
                    f"got {gf.iloc[bad[:5]].tolist()}\n"
                    f"want {wf.iloc[bad[:5]].tolist()}")
        except (ValueError, TypeError):
            if list(g.astype(str)) != list(w.astype(str)):
                raise AssertionError(f"column {c} diverges:\n{g}\n{w}")


def q4(path: str) -> pd.DataFrame:
    o = _read(path, "orders")
    l = _read(path, "lineitem")
    o = o[(o["o_orderdate"] >= pd.Timestamp("1993-07-01").date())
          & (o["o_orderdate"] < pd.Timestamp("1993-10-01").date())]
    late = l[l["l_commitdate"] < l["l_receiptdate"]]["l_orderkey"].unique()
    m = o[o["o_orderkey"].isin(late)]
    out = (m.groupby("o_orderpriority", as_index=False)
           .agg(order_count=("o_orderkey", "size"))
           .sort_values("o_orderpriority"))
    return out.reset_index(drop=True)


def q12(path: str) -> pd.DataFrame:
    o = _read(path, "orders")
    l = _read(path, "lineitem")
    l = l[l["l_shipmode"].isin(["MAIL", "SHIP"])
          & (l["l_commitdate"] < l["l_receiptdate"])
          & (l["l_shipdate"] < l["l_commitdate"])
          & (l["l_receiptdate"] >= pd.Timestamp("1994-01-01").date())
          & (l["l_receiptdate"] < pd.Timestamp("1995-01-01").date())]
    m = l.merge(o, left_on="l_orderkey", right_on="o_orderkey")
    high = m["o_orderpriority"].isin(["1-URGENT", "2-HIGH"])
    m = m.assign(high_line_count=high.astype(np.int64),
                 low_line_count=(~high).astype(np.int64))
    out = (m.groupby("l_shipmode", as_index=False)
           .agg(high_line_count=("high_line_count", "sum"),
                low_line_count=("low_line_count", "sum"))
           .sort_values("l_shipmode"))
    return out.reset_index(drop=True)


def q14(path: str) -> pd.DataFrame:
    l = _read(path, "lineitem")
    p = _read(path, "part")
    l = l[(l["l_shipdate"] >= pd.Timestamp("1995-09-01").date())
          & (l["l_shipdate"] < pd.Timestamp("1995-10-01").date())]
    m = l.merge(p, left_on="l_partkey", right_on="p_partkey")
    rev = m["l_extendedprice"] * (1 - m["l_discount"])
    promo = rev.where(m["p_type"].str.startswith("TYPE 1"), 0.0)
    return pd.DataFrame({"promo_revenue":
                         [100.0 * promo.sum() / rev.sum()]})


def q17(path: str) -> pd.DataFrame:
    l = _read(path, "lineitem")
    p = _read(path, "part")
    p = p[(p["p_brand"] == "Brand#23") & (p["p_container"] == "CONTAINER 7")]
    m = l.merge(p, left_on="l_partkey", right_on="p_partkey")
    avg_qty = l.groupby("l_partkey")["l_quantity"].mean()
    thresh = m["l_partkey"].map(avg_qty) * 0.2
    m = m[m["l_quantity"] < thresh]
    return pd.DataFrame({"avg_yearly":
                         [m["l_extendedprice"].sum() / 7.0]})


def q19(path: str) -> pd.DataFrame:
    l = _read(path, "lineitem")
    p = _read(path, "part")
    m = l.merge(p, left_on="l_partkey", right_on="p_partkey")
    m = m[m["l_shipmode"].isin(["AIR", "AIR REG"])
          & (m["l_shipinstruct"] == "DELIVER IN PERSON")]
    c1 = ((m["p_brand"] == "Brand#12")
          & (m["l_quantity"] >= 1) & (m["l_quantity"] <= 11)
          & (m["p_size"] >= 1) & (m["p_size"] <= 5))
    c2 = ((m["p_brand"] == "Brand#23")
          & (m["l_quantity"] >= 10) & (m["l_quantity"] <= 20)
          & (m["p_size"] >= 1) & (m["p_size"] <= 10))
    c3 = ((m["p_brand"] == "Brand#34")
          & (m["l_quantity"] >= 20) & (m["l_quantity"] <= 30)
          & (m["p_size"] >= 1) & (m["p_size"] <= 15))
    m = m[c1 | c2 | c3]
    # SQL SUM over zero rows is NULL, not 0 (small SFs select nothing)
    rev = (m["l_extendedprice"] * (1 - m["l_discount"])).sum()
    return pd.DataFrame({"revenue": [rev if len(m) else np.nan]})


def q10(path: str) -> pd.DataFrame:
    c = _read(path, "customer")
    o = _read(path, "orders")
    l = _read(path, "lineitem")
    n = _read(path, "nation")
    o = o[(o["o_orderdate"] >= pd.Timestamp("1993-10-01").date())
          & (o["o_orderdate"] < pd.Timestamp("1994-01-01").date())]
    l = l[l["l_returnflag"] == "R"]
    m = (l.merge(o, left_on="l_orderkey", right_on="o_orderkey")
         .merge(c, left_on="o_custkey", right_on="c_custkey")
         .merge(n, left_on="c_nationkey", right_on="n_nationkey"))
    m = m.assign(revenue=m["l_extendedprice"] * (1 - m["l_discount"]))
    out = (m.groupby(["c_custkey", "c_name", "c_acctbal", "n_name",
                      "c_address", "c_phone", "c_comment"], as_index=False)
           .agg(revenue=("revenue", "sum"))
           .sort_values(["revenue", "c_custkey"],
                        ascending=[False, True]).head(20))
    cols = ["c_custkey", "c_name", "revenue", "c_acctbal", "n_name",
            "c_address", "c_phone", "c_comment"]
    return out[cols].reset_index(drop=True)


def q9(path: str) -> pd.DataFrame:
    l = _read(path, "lineitem")
    p = _read(path, "part")
    s = _read(path, "supplier")
    ps = _read(path, "partsupp")
    o = _read(path, "orders")
    n = _read(path, "nation")
    p = p[p["p_name"].str.contains("name 5", regex=False)]
    m = (l.merge(p, left_on="l_partkey", right_on="p_partkey")
         .merge(s, left_on="l_suppkey", right_on="s_suppkey")
         .merge(ps, left_on=["l_suppkey", "l_partkey"],
                right_on=["ps_suppkey", "ps_partkey"])
         .merge(o, left_on="l_orderkey", right_on="o_orderkey")
         .merge(n, left_on="s_nationkey", right_on="n_nationkey"))
    amount = (m["l_extendedprice"] * (1 - m["l_discount"])
              - m["ps_supplycost"] * m["l_quantity"])
    year = pd.to_datetime(m["o_orderdate"]).dt.year
    g = pd.DataFrame({"nation": m["n_name"], "o_year": year,
                      "amount": amount})
    out = (g.groupby(["nation", "o_year"], as_index=False)
           .agg(sum_profit=("amount", "sum"))
           .sort_values(["nation", "o_year"], ascending=[True, False]))
    return out.reset_index(drop=True)


def q7(path: str) -> pd.DataFrame:
    s = _read(path, "supplier")
    l = _read(path, "lineitem")
    o = _read(path, "orders")
    c = _read(path, "customer")
    n = _read(path, "nation")
    l = l[(l["l_shipdate"] >= pd.Timestamp("1995-01-01").date())
          & (l["l_shipdate"] <= pd.Timestamp("1996-12-31").date())]
    m = (l.merge(s, left_on="l_suppkey", right_on="s_suppkey")
         .merge(o, left_on="l_orderkey", right_on="o_orderkey")
         .merge(c, left_on="o_custkey", right_on="c_custkey")
         .merge(n.rename(columns=lambda x: x + "_1"),
                left_on="s_nationkey", right_on="n_nationkey_1")
         .merge(n.rename(columns=lambda x: x + "_2"),
                left_on="c_nationkey", right_on="n_nationkey_2"))
    cond = (((m["n_name_1"] == "FRANCE") & (m["n_name_2"] == "GERMANY"))
            | ((m["n_name_1"] == "GERMANY") & (m["n_name_2"] == "FRANCE")))
    m = m[cond]
    vol = m["l_extendedprice"] * (1 - m["l_discount"])
    year = pd.to_datetime(m["l_shipdate"]).dt.year
    g = pd.DataFrame({"supp_nation": m["n_name_1"],
                      "cust_nation": m["n_name_2"],
                      "l_year": year, "revenue": vol})
    out = (g.groupby(["supp_nation", "cust_nation", "l_year"],
                     as_index=False).agg(revenue=("revenue", "sum"))
           .sort_values(["supp_nation", "cust_nation", "l_year"]))
    return out.reset_index(drop=True)


def q8(path: str) -> pd.DataFrame:
    p = _read(path, "part")
    s = _read(path, "supplier")
    l = _read(path, "lineitem")
    o = _read(path, "orders")
    c = _read(path, "customer")
    n = _read(path, "nation")
    r = _read(path, "region")
    p = p[p["p_type"] == "TYPE 25"]
    o = o[(o["o_orderdate"] >= pd.Timestamp("1995-01-01").date())
          & (o["o_orderdate"] <= pd.Timestamp("1996-12-31").date())]
    m = (l.merge(p, left_on="l_partkey", right_on="p_partkey")
         .merge(s, left_on="l_suppkey", right_on="s_suppkey")
         .merge(o, left_on="l_orderkey", right_on="o_orderkey")
         .merge(c, left_on="o_custkey", right_on="c_custkey")
         .merge(n.rename(columns=lambda x: x + "_1"),
                left_on="c_nationkey", right_on="n_nationkey_1")
         .merge(r, left_on="n_regionkey_1", right_on="r_regionkey")
         .merge(n.rename(columns=lambda x: x + "_2"),
                left_on="s_nationkey", right_on="n_nationkey_2"))
    m = m[m["r_name"] == "AMERICA"]
    vol = m["l_extendedprice"] * (1 - m["l_discount"])
    year = pd.to_datetime(m["o_orderdate"]).dt.year
    g = pd.DataFrame({"o_year": year, "volume": vol,
                      "nation": m["n_name_2"]})
    def share(sub):
        tot = sub["volume"].sum()
        br = sub.loc[sub["nation"] == "BRAZIL", "volume"].sum()
        return br / tot if tot else np.nan
    out = (g.groupby("o_year").apply(share, include_groups=False)
           .reset_index(name="mkt_share").sort_values("o_year"))
    return out.reset_index(drop=True)


def q13(path: str) -> pd.DataFrame:
    c = _read(path, "customer")
    o = _read(path, "orders")
    o = o[~o["o_comment"].str.contains("comment 7", regex=False)]
    m = c.merge(o, left_on="c_custkey", right_on="o_custkey", how="left")
    per_cust = (m.groupby("c_custkey")["o_orderkey"].count()
                .reset_index(name="c_count"))
    out = (per_cust.groupby("c_count").size().reset_index(name="custdist")
           .sort_values(["custdist", "c_count"], ascending=[False, False]))
    return out[["c_count", "custdist"]].reset_index(drop=True)


def q18(path: str) -> pd.DataFrame:
    c = _read(path, "customer")
    o = _read(path, "orders")
    l = _read(path, "lineitem")
    big = l.groupby("l_orderkey")["l_quantity"].sum()
    keys = big[big > 300].index
    m = (o[o["o_orderkey"].isin(keys)]
         .merge(c, left_on="o_custkey", right_on="c_custkey")
         .merge(l, left_on="o_orderkey", right_on="l_orderkey"))
    out = (m.groupby(["c_name", "c_custkey", "o_orderkey", "o_orderdate",
                      "o_totalprice"], as_index=False)
           .agg(sum_qty=("l_quantity", "sum"))
           .sort_values(["o_totalprice", "o_orderdate"],
                        ascending=[False, True]).head(100))
    return out.reset_index(drop=True)


def q16(path: str) -> pd.DataFrame:
    ps = _read(path, "partsupp")
    p = _read(path, "part")
    s = _read(path, "supplier")
    p = p[(p["p_brand"] != "Brand#45")
          & ~p["p_type"].str.startswith("TYPE 3")
          & p["p_size"].isin([49, 14, 23, 45, 19, 3, 36, 9])]
    bad = s[s["s_comment"].str.contains("comment 5", regex=False)][
        "s_suppkey"]
    m = ps.merge(p, left_on="ps_partkey", right_on="p_partkey")
    m = m[~m["ps_suppkey"].isin(bad)]
    out = (m.groupby(["p_brand", "p_type", "p_size"])["ps_suppkey"]
           .nunique().reset_index(name="supplier_cnt")
           .sort_values(["supplier_cnt", "p_brand", "p_type", "p_size"],
                        ascending=[False, True, True, True]))
    return out[["p_brand", "p_type", "p_size", "supplier_cnt"]] \
        .reset_index(drop=True)


def q11(path: str) -> pd.DataFrame:
    ps = _read(path, "partsupp")
    s = _read(path, "supplier")
    n = _read(path, "nation")
    m = (ps.merge(s, left_on="ps_suppkey", right_on="s_suppkey")
         .merge(n, left_on="s_nationkey", right_on="n_nationkey"))
    m = m[m["n_name"] == "GERMANY"]
    m = m.assign(value=m["ps_supplycost"] * m["ps_availqty"])
    thresh = m["value"].sum() * 0.0001
    out = (m.groupby("ps_partkey", as_index=False)
           .agg(value=("value", "sum")))
    out = out[out["value"] > thresh] \
        .sort_values("value", ascending=False)
    return out[["ps_partkey", "value"]].reset_index(drop=True)


def q22(path: str) -> pd.DataFrame:
    c = _read(path, "customer")
    o = _read(path, "orders")
    codes = ["13", "31", "23", "29", "30", "18", "17"]
    c = c.assign(cntrycode=c["c_phone"].str[:2])
    cc = c[c["cntrycode"].isin(codes)]
    avg_bal = cc.loc[cc["c_acctbal"] > 0.0, "c_acctbal"].mean()
    sel = cc[(cc["c_acctbal"] > avg_bal)
             & ~cc["c_custkey"].isin(o["o_custkey"])]
    out = (sel.groupby("cntrycode", as_index=False)
           .agg(numcust=("c_custkey", "size"),
                totacctbal=("c_acctbal", "sum"))
           .sort_values("cntrycode"))
    return out[["cntrycode", "numcust", "totacctbal"]] \
        .reset_index(drop=True)


def q15(path: str) -> pd.DataFrame:
    l = _read(path, "lineitem")
    s = _read(path, "supplier")
    l = l[(l["l_shipdate"] >= pd.Timestamp("1996-01-01").date())
          & (l["l_shipdate"] < pd.Timestamp("1996-04-01").date())]
    rev = (l.assign(r=l["l_extendedprice"] * (1 - l["l_discount"]))
           .groupby("l_suppkey", as_index=False).agg(total_revenue=("r", "sum")))
    top = rev[rev["total_revenue"] == rev["total_revenue"].max()]
    m = s.merge(top, left_on="s_suppkey", right_on="l_suppkey")
    out = m[["s_suppkey", "s_name", "s_address", "s_phone",
             "total_revenue"]].sort_values("s_suppkey")
    return out.reset_index(drop=True)


def q2(path: str) -> pd.DataFrame:
    p = _read(path, "part")
    s = _read(path, "supplier")
    ps = _read(path, "partsupp")
    n = _read(path, "nation")
    r = _read(path, "region")
    r = r[r["r_name"] == "EUROPE"]
    base = (ps.merge(s, left_on="ps_suppkey", right_on="s_suppkey")
            .merge(n, left_on="s_nationkey", right_on="n_nationkey")
            .merge(r, left_on="n_regionkey", right_on="r_regionkey"))
    min_cost = base.groupby("ps_partkey")["ps_supplycost"].min()
    p = p[(p["p_size"] == 15) & p["p_type"].str.contains("TYPE 2",
                                                         regex=False)]
    m = base.merge(p, left_on="ps_partkey", right_on="p_partkey")
    m = m[m["ps_supplycost"] == m["ps_partkey"].map(min_cost)]
    out = (m.sort_values(["s_acctbal", "n_name", "s_name", "p_partkey"],
                         ascending=[False, True, True, True]).head(100))
    cols = ["s_acctbal", "s_name", "n_name", "p_partkey", "p_mfgr",
            "s_address", "s_phone", "s_comment"]
    return out[cols].reset_index(drop=True)


def q20(path: str) -> pd.DataFrame:
    s = _read(path, "supplier")
    n = _read(path, "nation")
    p = _read(path, "part")
    ps = _read(path, "partsupp")
    l = _read(path, "lineitem")
    parts = p[p["p_name"].str.startswith("part name 5")]["p_partkey"]
    l = l[(l["l_shipdate"] >= pd.Timestamp("1994-01-01").date())
          & (l["l_shipdate"] < pd.Timestamp("1995-01-01").date())]
    half = (l.groupby(["l_partkey", "l_suppkey"])["l_quantity"].sum()
            * 0.5)
    m = ps[ps["ps_partkey"].isin(parts)].copy()
    key = list(zip(m["ps_partkey"], m["ps_suppkey"]))
    m = m[m["ps_availqty"] > pd.Series(key, index=m.index).map(half)]
    sel = s[s["s_suppkey"].isin(m["ps_suppkey"])]
    sel = sel.merge(n, left_on="s_nationkey", right_on="n_nationkey")
    sel = sel[sel["n_name"] == "CANADA"]
    out = sel[["s_name", "s_address"]].sort_values("s_name")
    return out.reset_index(drop=True)


def q21(path: str) -> pd.DataFrame:
    s = _read(path, "supplier")
    l = _read(path, "lineitem")
    o = _read(path, "orders")
    n = _read(path, "nation")
    late = l[l["l_receiptdate"] > l["l_commitdate"]]
    n_supp = l.groupby("l_orderkey")["l_suppkey"].nunique()
    n_late_supp = late.groupby("l_orderkey")["l_suppkey"].nunique()
    m = (late.merge(s, left_on="l_suppkey", right_on="s_suppkey")
         .merge(o[o["o_orderstatus"] == "F"], left_on="l_orderkey",
                right_on="o_orderkey")
         .merge(n, left_on="s_nationkey", right_on="n_nationkey"))
    m = m[m["n_name"] == "SAUDI ARABIA"]
    m = m[(m["l_orderkey"].map(n_supp) > 1)
          & (m["l_orderkey"].map(n_late_supp) == 1)]
    out = (m.groupby("s_name").size().reset_index(name="numwait")
           .sort_values(["numwait", "s_name"], ascending=[False, True])
           .head(100))
    return out[["s_name", "numwait"]].reset_index(drop=True)


GOLDEN.update({"q2": q2, "q4": q4, "q7": q7, "q8": q8, "q9": q9,
               "q10": q10, "q11": q11, "q12": q12, "q13": q13, "q14": q14,
               "q15": q15, "q16": q16, "q17": q17, "q18": q18, "q19": q19,
               "q20": q20, "q21": q21, "q22": q22})
