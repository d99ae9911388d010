"""Independent pandas implementations of the TPC-DS tranche queries
(the port's copy of `spark_tpu/tpcds/golden.py`).

The trusted-engine role for parity checks, the `tpch/golden.py`
pattern: goldens are computed on THIS generator's data by a separate
pandas implementation, and `compare` (shared with the TPC-H harness)
checks row sets with a small float tolerance. Adaptations mirror
`sql_queries.py`'s documented list exactly — a golden implementing the
un-adapted official text would be checking a different query.

Tables are read once per data directory and kept, with decimal columns
cast to float64 in Arrow (as the port's `tpch/golden.py` reads them), so
the callers must not modify a frame `_read` returns in place."""

from __future__ import annotations

import datetime

import numpy as np
import pandas as pd

# shared comparison/normalization machinery (one definition — the TPC-H
# and TPC-DS harnesses must not drift on tolerance semantics)
from ..tpch.golden import _read, compare, normalize_decimals

__all__ = ["GOLDEN", "compare", "normalize_decimals"]


def _csum(series: pd.Series, cond: pd.Series) -> pd.Series:
    """sum(case when cond then x else null end) input column."""
    return series.where(cond)


def q1(path: str) -> pd.DataFrame:
    sr = _read(path, "store_returns")
    dd = _read(path, "date_dim")
    st = _read(path, "store")
    c = _read(path, "customer")
    m = sr.merge(dd[dd["d_year"] == 2000], left_on="sr_returned_date_sk",
                 right_on="d_date_sk")
    ctr = (m.groupby(["sr_customer_sk", "sr_store_sk"], dropna=False,
                     as_index=False)
           .agg(ctr_total_return=("sr_return_amt", "sum")))
    avg = (ctr.groupby("sr_store_sk", as_index=False)
           .agg(avg_return=("ctr_total_return", "mean")))
    avg["avg_return"] *= 1.2
    m = ctr.merge(avg, on="sr_store_sk")
    m = m[m["ctr_total_return"] > m["avg_return"]]
    m = m.merge(st[st["s_state"] == "TN"], left_on="sr_store_sk",
                right_on="s_store_sk")
    m = m.merge(c, left_on="sr_customer_sk", right_on="c_customer_sk")
    out = m[["c_customer_id"]].sort_values("c_customer_id").head(100)
    return out.reset_index(drop=True)


def _brand_month(path: str, manufact=None, manager=None, moy=11,
                 year=None):
    ss = _read(path, "store_sales")
    dd = _read(path, "date_dim")
    it = _read(path, "item")
    dd = dd[dd["d_moy"] == moy]
    if year is not None:
        dd = dd[dd["d_year"] == year]
    if manufact is not None:
        it = it[it["i_manufact_id"] == manufact]
    if manager is not None:
        it = it[it["i_manager_id"] == manager]
    return (ss.merge(dd, left_on="ss_sold_date_sk", right_on="d_date_sk")
            .merge(it, left_on="ss_item_sk", right_on="i_item_sk"))


def q3(path: str) -> pd.DataFrame:
    m = _brand_month(path, manufact=28)
    out = (m.groupby(["d_year", "i_brand_id", "i_brand"], as_index=False)
           .agg(sum_agg=("ss_ext_sales_price", "sum"))
           .rename(columns={"i_brand_id": "brand_id", "i_brand": "brand"})
           .sort_values(["d_year", "sum_agg", "brand_id"],
                        ascending=[True, False, True]).head(100))
    return out.reset_index(drop=True)


def q7(path: str) -> pd.DataFrame:
    ss = _read(path, "store_sales")
    cd = _read(path, "customer_demographics")
    dd = _read(path, "date_dim")
    it = _read(path, "item")
    pr = _read(path, "promotion")
    cd = cd[(cd["cd_gender"] == "M") & (cd["cd_marital_status"] == "S")
            & (cd["cd_education_status"] == "College")]
    pr = pr[(pr["p_channel_email"] == "N")
            | (pr["p_channel_event"] == "N")]
    m = (ss.merge(dd[dd["d_year"] == 2000], left_on="ss_sold_date_sk",
                  right_on="d_date_sk")
         .merge(cd, left_on="ss_cdemo_sk", right_on="cd_demo_sk")
         .merge(pr, left_on="ss_promo_sk", right_on="p_promo_sk")
         .merge(it, left_on="ss_item_sk", right_on="i_item_sk"))
    out = (m.groupby("i_item_id", as_index=False)
           .agg(agg1=("ss_quantity", "mean"),
                agg2=("ss_list_price", "mean"),
                agg3=("ss_coupon_amt", "mean"),
                agg4=("ss_sales_price", "mean"))
           .sort_values("i_item_id").head(100))
    return out.reset_index(drop=True)


def q19(path: str) -> pd.DataFrame:
    ss = _read(path, "store_sales")
    dd = _read(path, "date_dim")
    it = _read(path, "item")
    c = _read(path, "customer")
    ca = _read(path, "customer_address")
    st = _read(path, "store")
    dd = dd[(dd["d_moy"] == 11) & (dd["d_year"] == 1998)]
    it = it[it["i_manager_id"] == 8]
    m = (ss.merge(dd, left_on="ss_sold_date_sk", right_on="d_date_sk")
         .merge(it, left_on="ss_item_sk", right_on="i_item_sk")
         .merge(c, left_on="ss_customer_sk", right_on="c_customer_sk")
         .merge(ca, left_on="c_current_addr_sk", right_on="ca_address_sk")
         .merge(st, left_on="ss_store_sk", right_on="s_store_sk"))
    m = m[m["ca_gmt_offset"] != m["s_gmt_offset"]]
    out = (m.groupby(["i_brand_id", "i_brand", "i_manufact_id",
                      "i_manufact"], as_index=False)
           .agg(ext_price=("ss_ext_sales_price", "sum"))
           .rename(columns={"i_brand_id": "brand_id",
                            "i_brand": "brand"})
           .sort_values(["ext_price", "brand_id", "i_manufact_id"],
                        ascending=[False, True, True]).head(100))
    return out[["brand_id", "brand", "i_manufact_id", "i_manufact",
                "ext_price"]].reset_index(drop=True)


def q27(path: str) -> pd.DataFrame:
    ss = _read(path, "store_sales")
    cd = _read(path, "customer_demographics")
    dd = _read(path, "date_dim")
    st = _read(path, "store")
    it = _read(path, "item")
    cd = cd[(cd["cd_gender"] == "F") & (cd["cd_marital_status"] == "W")
            & (cd["cd_education_status"] == "Primary")]
    m = (ss.merge(dd[dd["d_year"] == 2002], left_on="ss_sold_date_sk",
                  right_on="d_date_sk")
         .merge(it, left_on="ss_item_sk", right_on="i_item_sk")
         .merge(st[st["s_state"].isin(["TN", "OH"])],
                left_on="ss_store_sk", right_on="s_store_sk")
         .merge(cd, left_on="ss_cdemo_sk", right_on="cd_demo_sk"))

    def agg(grouped) -> pd.DataFrame:
        return grouped.agg(agg1=("ss_quantity", "mean"),
                           agg2=("ss_list_price", "mean"),
                           agg3=("ss_coupon_amt", "mean"),
                           agg4=("ss_sales_price", "mean"))

    full = agg(m.groupby(["i_item_id", "s_state"], as_index=False))
    by_item = agg(m.groupby(["i_item_id"], as_index=False))
    by_item["s_state"] = None
    # the () grouping set: a global aggregate — one row even over an
    # empty input (all-NULL), matching the engine's union lowering
    total = pd.DataFrame([{
        "i_item_id": None, "s_state": None,
        "agg1": m["ss_quantity"].mean(),
        "agg2": m["ss_list_price"].mean(),
        "agg3": m["ss_coupon_amt"].mean(),
        "agg4": m["ss_sales_price"].mean()}])
    cols = ["i_item_id", "s_state", "agg1", "agg2", "agg3", "agg4"]
    out = pd.concat([full[cols], by_item[cols], total[cols]],
                    ignore_index=True)
    out = out.sort_values(["i_item_id", "s_state"], na_position="first") \
        .head(100)
    return out.reset_index(drop=True)


def q42(path: str) -> pd.DataFrame:
    m = _brand_month(path, manager=1, year=2000)
    out = (m.groupby(["d_year", "i_category_id", "i_category"],
                     as_index=False)
           .agg(total_sales=("ss_ext_sales_price", "sum"))
           .sort_values(["total_sales", "d_year", "i_category_id"],
                        ascending=[False, True, True]).head(100))
    return out.reset_index(drop=True)


def q43(path: str) -> pd.DataFrame:
    ss = _read(path, "store_sales")
    dd = _read(path, "date_dim")
    st = _read(path, "store")
    m = (ss.merge(dd[dd["d_year"] == 2000], left_on="ss_sold_date_sk",
                  right_on="d_date_sk")
         .merge(st[st["s_gmt_offset"] == -5.0], left_on="ss_store_sk",
                right_on="s_store_sk"))
    for day, col in (("Sunday", "sun_sales"), ("Monday", "mon_sales"),
                     ("Tuesday", "tue_sales"), ("Wednesday", "wed_sales"),
                     ("Thursday", "thu_sales"), ("Friday", "fri_sales"),
                     ("Saturday", "sat_sales")):
        m[col] = _csum(m["ss_sales_price"], m["d_day_name"] == day)
    out = (m.groupby(["s_store_name", "s_store_id"], as_index=False)
           .agg(**{c: (c, lambda s: s.sum(min_count=1))
                   for c in ("sun_sales", "mon_sales", "tue_sales",
                             "wed_sales", "thu_sales", "fri_sales",
                             "sat_sales")})
           .sort_values(["s_store_name", "s_store_id"]).head(100))
    return out.reset_index(drop=True)


def q48(path: str) -> pd.DataFrame:
    ss = _read(path, "store_sales")
    st = _read(path, "store")
    cd = _read(path, "customer_demographics")
    ca = _read(path, "customer_address")
    dd = _read(path, "date_dim")
    m = (ss.merge(st, left_on="ss_store_sk", right_on="s_store_sk")
         .merge(dd[dd["d_year"] == 2001], left_on="ss_sold_date_sk",
                right_on="d_date_sk")
         .merge(cd, left_on="ss_cdemo_sk", right_on="cd_demo_sk")
         .merge(ca, left_on="ss_addr_sk", right_on="ca_address_sk"))
    demo = (((m["cd_marital_status"] == "M")
             & (m["cd_education_status"] == "4 yr Degree")
             & m["ss_sales_price"].between(100.0, 150.0))
            | ((m["cd_marital_status"] == "D")
               & (m["cd_education_status"] == "2 yr Degree")
               & m["ss_sales_price"].between(50.0, 100.0))
            | ((m["cd_marital_status"] == "S")
               & (m["cd_education_status"] == "College")
               & m["ss_sales_price"].between(150.0, 200.0)))
    geo = (((m["ca_country"] == "United States")
            & m["ca_state"].isin(["CO", "OH", "TX"])
            & m["ss_net_profit"].between(0, 2000))
           | ((m["ca_country"] == "United States")
              & m["ca_state"].isin(["OR", "MN", "KY"])
              & m["ss_net_profit"].between(150, 3000))
           | ((m["ca_country"] == "United States")
              & m["ca_state"].isin(["VA", "CA", "MS"])
              & m["ss_net_profit"].between(50, 25000)))
    sel = m[demo & geo]
    total = sel["ss_quantity"].sum()
    return pd.DataFrame(
        {"quantity_sum": [float(total) if len(sel) else np.nan]})


def q52(path: str) -> pd.DataFrame:
    m = _brand_month(path, manager=1, year=2000)
    out = (m.groupby(["d_year", "i_brand_id", "i_brand"], as_index=False)
           .agg(ext_price=("ss_ext_sales_price", "sum"))
           .rename(columns={"i_brand_id": "brand_id", "i_brand": "brand"})
           .sort_values(["d_year", "ext_price", "brand_id"],
                        ascending=[True, False, True]).head(100))
    return out.reset_index(drop=True)


def q55(path: str) -> pd.DataFrame:
    m = _brand_month(path, manager=28, year=1999)
    out = (m.groupby(["i_brand_id", "i_brand"], as_index=False)
           .agg(ext_price=("ss_ext_sales_price", "sum"))
           .rename(columns={"i_brand_id": "brand_id", "i_brand": "brand"})
           .sort_values(["ext_price", "brand_id"],
                        ascending=[False, True]).head(100))
    return out.reset_index(drop=True)


_DAY_COLS = (("Sunday", "sun_sales"), ("Monday", "mon_sales"),
             ("Tuesday", "tue_sales"), ("Wednesday", "wed_sales"),
             ("Thursday", "thu_sales"), ("Friday", "fri_sales"),
             ("Saturday", "sat_sales"))


def q59(path: str) -> pd.DataFrame:
    ss = _read(path, "store_sales")
    dd = _read(path, "date_dim")
    st = _read(path, "store")
    m = ss.merge(dd, left_on="ss_sold_date_sk", right_on="d_date_sk")
    for day, col in _DAY_COLS:
        m[col] = _csum(m["ss_sales_price"], m["d_day_name"] == day)
    wss = (m.groupby(["d_week_seq", "ss_store_sk"], as_index=False)
           .agg(**{c: (c, lambda s: s.sum(min_count=1))
                   for _, c in _DAY_COLS}))
    weeks = dd[dd["d_dow"] == 0][["d_week_seq", "d_month_seq"]].rename(
        columns={"d_week_seq": "w_week_seq", "d_month_seq": "w_month_seq"})

    def half(lo, hi, suffix):
        h = (wss.merge(st, left_on="ss_store_sk", right_on="s_store_sk")
             .merge(weeks, left_on="d_week_seq", right_on="w_week_seq"))
        h = h[h["w_month_seq"].between(lo, hi)]
        cols = {"s_store_name": f"s_store_name{suffix}",
                "s_store_id": f"s_store_id{suffix}",
                "d_week_seq": f"d_week_seq{suffix}"}
        cols.update({c: f"{c}{suffix}" for _, c in _DAY_COLS})
        return h[list(cols)].rename(columns=cols)

    y = half(24, 35, "1")
    x = half(36, 47, "2")
    x = x.assign(join_week=x["d_week_seq2"] - 52)
    j = y.merge(x, left_on=["s_store_id1", "d_week_seq1"],
                right_on=["s_store_id2", "join_week"])
    for _, c in _DAY_COLS:
        j[f"r_{c[:3]}"] = j[f"{c}1"] / j[f"{c}2"]
    out = j[["s_store_name1", "s_store_id1", "d_week_seq1",
             "r_sun", "r_mon", "r_tue", "r_wed", "r_thu", "r_fri",
             "r_sat"]]
    out = out.sort_values(["s_store_name1", "s_store_id1",
                           "d_week_seq1"]).head(100)
    return out.reset_index(drop=True)


def q61(path: str) -> pd.DataFrame:
    ss = _read(path, "store_sales")
    st = _read(path, "store")
    pr = _read(path, "promotion")
    dd = _read(path, "date_dim")
    c = _read(path, "customer")
    ca = _read(path, "customer_address")
    it = _read(path, "item")
    base = (ss.merge(dd[(dd["d_year"] == 1998) & (dd["d_moy"] == 11)],
                     left_on="ss_sold_date_sk", right_on="d_date_sk")
            .merge(st[st["s_gmt_offset"] == -5.0], left_on="ss_store_sk",
                   right_on="s_store_sk")
            .merge(c, left_on="ss_customer_sk", right_on="c_customer_sk")
            .merge(ca[ca["ca_gmt_offset"] == -5.0],
                   left_on="c_current_addr_sk", right_on="ca_address_sk")
            .merge(it[it["i_category"] == "Jewelry"],
                   left_on="ss_item_sk", right_on="i_item_sk"))
    promo = base.merge(
        pr[(pr["p_channel_dmail"] == "Y") | (pr["p_channel_tv"] == "Y")
           | (pr["p_channel_event"] == "Y")],
        left_on="ss_promo_sk", right_on="p_promo_sk")
    p = promo["ss_ext_sales_price"].sum() if len(promo) else np.nan
    t = base["ss_ext_sales_price"].sum() if len(base) else np.nan
    return pd.DataFrame({"promotions": [p], "total": [t],
                         "ratio": [p / t * 100
                                   if len(base) and t else np.nan]})


def q63(path: str) -> pd.DataFrame:
    ss = _read(path, "store_sales")
    it = _read(path, "item")
    dd = _read(path, "date_dim")
    st = _read(path, "store")
    band = (((it["i_category"].isin(["Books", "Children", "Electronics"]))
             & (it["i_class"].isin(["Books class 1", "Children class 2",
                                    "Electronics class 3"])))
            | ((it["i_category"].isin(["Women", "Music", "Men"]))
               & (it["i_class"].isin(["Women class 1", "Music class 2",
                                      "Men class 3"]))))
    m = (ss.merge(it[band], left_on="ss_item_sk", right_on="i_item_sk")
         .merge(dd[dd["d_year"] == 2000], left_on="ss_sold_date_sk",
                right_on="d_date_sk")
         .merge(st, left_on="ss_store_sk", right_on="s_store_sk"))
    g = (m.groupby(["i_manager_id", "d_moy"], as_index=False)
         .agg(sum_sales=("ss_sales_price", "sum")))
    g["avg_monthly_sales"] = g.groupby("i_manager_id")[
        "sum_sales"].transform("mean")
    g = g[(g["avg_monthly_sales"] > 0)
          & ((g["sum_sales"] - g["avg_monthly_sales"]).abs()
             / g["avg_monthly_sales"] > 0.1)]
    out = g.sort_values(["i_manager_id", "avg_monthly_sales",
                         "sum_sales", "d_moy"]).head(100)
    return out[["i_manager_id", "d_moy", "sum_sales",
                "avg_monthly_sales"]].reset_index(drop=True)


def q65(path: str) -> pd.DataFrame:
    ss = _read(path, "store_sales")
    dd = _read(path, "date_dim")
    st = _read(path, "store")
    it = _read(path, "item")
    m = ss.merge(dd[dd["d_month_seq"].between(24, 35)],
                 left_on="ss_sold_date_sk", right_on="d_date_sk")
    sc = (m.groupby(["ss_store_sk", "ss_item_sk"], as_index=False)
          .agg(revenue=("ss_sales_price", "sum")))
    sb = (sc.groupby("ss_store_sk", as_index=False)
          .agg(ave=("revenue", "mean")))
    j = sc.merge(sb, on="ss_store_sk")
    j = j[j["revenue"] <= 0.1 * j["ave"]]
    j = (j.merge(st, left_on="ss_store_sk", right_on="s_store_sk")
         .merge(it, left_on="ss_item_sk", right_on="i_item_sk"))
    out = (j[["s_store_name", "i_item_desc", "revenue",
              "i_current_price", "i_wholesale_cost", "i_brand"]]
           .sort_values(["s_store_name", "i_item_desc", "i_brand",
                         "revenue", "i_current_price"]).head(100))
    return out.reset_index(drop=True)


def q68(path: str) -> pd.DataFrame:
    ss = _read(path, "store_sales")
    dd = _read(path, "date_dim")
    st = _read(path, "store")
    hd = _read(path, "household_demographics")
    ca = _read(path, "customer_address")
    c = _read(path, "customer")
    hd = hd[(hd["hd_dep_count"] == 4) | (hd["hd_vehicle_count"] == 3)]
    dd = dd[dd["d_dom"].between(1, 2) & dd["d_year"].isin(
        [1999, 2000, 2001])]
    m = (ss.merge(dd, left_on="ss_sold_date_sk", right_on="d_date_sk")
         .merge(st[st["s_city"].isin(["Midway", "Fairview"])],
                left_on="ss_store_sk", right_on="s_store_sk")
         .merge(hd, left_on="ss_hdemo_sk", right_on="hd_demo_sk")
         .merge(ca, left_on="ss_addr_sk", right_on="ca_address_sk"))
    dn = (m.groupby(["ss_ticket_number", "ss_customer_sk", "ss_addr_sk",
                     "ca_city"], dropna=False, as_index=False)
          .agg(extended_price=("ss_ext_sales_price", "sum"),
               list_price=("ss_ext_list_price", "sum"),
               extended_tax=("ss_ext_tax", "sum"))
          .rename(columns={"ca_city": "bought_city"}))
    j = (dn.merge(c, left_on="ss_customer_sk", right_on="c_customer_sk")
         .merge(ca, left_on="c_current_addr_sk",
                right_on="ca_address_sk"))
    j = j[j["ca_city"] != j["bought_city"]]
    out = (j[["c_last_name", "c_first_name", "ca_city", "bought_city",
              "ss_ticket_number", "extended_price", "extended_tax",
              "list_price"]]
           .sort_values(["c_last_name", "ss_ticket_number"]).head(100))
    return out.reset_index(drop=True)


def q73(path: str) -> pd.DataFrame:
    ss = _read(path, "store_sales")
    dd = _read(path, "date_dim")
    st = _read(path, "store")
    hd = _read(path, "household_demographics")
    c = _read(path, "customer")
    hd = hd[hd["hd_buy_potential"].isin([">10000", "Unknown"])
            & (hd["hd_vehicle_count"] > 0)]
    dd = dd[dd["d_dom"].between(1, 2)
            & dd["d_year"].isin([1999, 2000, 2001])]
    m = (ss.merge(dd, left_on="ss_sold_date_sk", right_on="d_date_sk")
         .merge(st[st["s_county"].isin(["Williamson County",
                                        "Franklin Parish"])],
                left_on="ss_store_sk", right_on="s_store_sk")
         .merge(hd, left_on="ss_hdemo_sk", right_on="hd_demo_sk"))
    dj = (m.groupby(["ss_ticket_number", "ss_customer_sk"], dropna=False,
                    as_index=False)
          .agg(cnt=("ss_ticket_number", "size")))
    dj = dj[dj["cnt"].between(1, 5)]
    j = dj.merge(c, left_on="ss_customer_sk", right_on="c_customer_sk")
    out = (j[["c_last_name", "c_first_name", "c_salutation",
              "c_preferred_cust_flag", "ss_ticket_number", "cnt"]]
           .sort_values(["cnt", "c_last_name", "ss_ticket_number"],
                        ascending=[False, True, True]).head(100))
    return out.reset_index(drop=True)


def q79(path: str) -> pd.DataFrame:
    ss = _read(path, "store_sales")
    dd = _read(path, "date_dim")
    st = _read(path, "store")
    hd = _read(path, "household_demographics")
    c = _read(path, "customer")
    hd = hd[(hd["hd_dep_count"] == 6) | (hd["hd_vehicle_count"] > 2)]
    dd = dd[(dd["d_dow"] == 1) & dd["d_year"].isin([1998, 1999, 2000])]
    st = st[st["s_number_employees"].between(200, 295)]
    m = (ss.merge(dd, left_on="ss_sold_date_sk", right_on="d_date_sk")
         .merge(st, left_on="ss_store_sk", right_on="s_store_sk")
         .merge(hd, left_on="ss_hdemo_sk", right_on="hd_demo_sk"))
    ms = (m.groupby(["ss_ticket_number", "ss_customer_sk", "ss_addr_sk",
                     "s_city"], dropna=False, as_index=False)
          .agg(amt=("ss_coupon_amt", "sum"),
               profit=("ss_net_profit", "sum")))
    j = ms.merge(c, left_on="ss_customer_sk", right_on="c_customer_sk")
    j = j.assign(city=j["s_city"].str[:30])
    out = (j[["c_last_name", "c_first_name", "city", "ss_ticket_number",
              "amt", "profit"]]
           .sort_values(["c_last_name", "c_first_name", "city", "profit",
                         "ss_ticket_number"]).head(100))
    return out.reset_index(drop=True)


def q89(path: str) -> pd.DataFrame:
    ss = _read(path, "store_sales")
    it = _read(path, "item")
    dd = _read(path, "date_dim")
    st = _read(path, "store")
    band = ((it["i_category"].isin(["Books", "Electronics", "Sports"])
             & it["i_class"].isin(["Books class 1", "Electronics class 2",
                                   "Sports class 3"]))
            | (it["i_category"].isin(["Men", "Jewelry", "Women"])
               & it["i_class"].isin(["Men class 4", "Jewelry class 1",
                                     "Women class 2"])))
    m = (ss.merge(it[band], left_on="ss_item_sk", right_on="i_item_sk")
         .merge(dd[dd["d_year"] == 1999], left_on="ss_sold_date_sk",
                right_on="d_date_sk")
         .merge(st, left_on="ss_store_sk", right_on="s_store_sk"))
    g = (m.groupby(["i_category", "i_class", "i_brand", "s_store_name",
                    "s_company_name", "d_moy"], as_index=False)
         .agg(sum_sales=("ss_sales_price", "sum")))
    g["avg_monthly_sales"] = g.groupby(
        ["i_category", "i_brand", "s_store_name", "s_company_name"]
    )["sum_sales"].transform("mean")
    g = g[(g["avg_monthly_sales"] != 0)
          & ((g["sum_sales"] - g["avg_monthly_sales"])
             / g["avg_monthly_sales"] < -0.1)]
    g = g.assign(_dev=g["sum_sales"] - g["avg_monthly_sales"])
    out = (g.sort_values(["_dev", "s_store_name", "i_category", "i_class",
                          "i_brand", "d_moy"]).head(100))
    return out[["i_category", "i_class", "i_brand", "s_store_name",
                "s_company_name", "d_moy", "sum_sales",
                "avg_monthly_sales"]].reset_index(drop=True)


def q93(path: str) -> pd.DataFrame:
    ss = _read(path, "store_sales")
    sr = _read(path, "store_returns")
    r = _read(path, "reason")
    m = ss.merge(sr, left_on=["ss_item_sk", "ss_ticket_number"],
                 right_on=["sr_item_sk", "sr_ticket_number"])
    m = m.merge(r[r["r_reason_desc"] == "reason 19"],
                left_on="sr_reason_sk", right_on="r_reason_sk")
    m = m.assign(act_sales=(m["ss_quantity"] - m["sr_return_quantity"])
                 * m["ss_sales_price"])
    out = (m.groupby("ss_customer_sk", dropna=False, as_index=False)
           .agg(sumsales=("act_sales", "sum")))
    out = out.sort_values(["sumsales", "ss_customer_sk"],
                          na_position="first").head(100)
    return out.reset_index(drop=True)


def q96(path: str) -> pd.DataFrame:
    ss = _read(path, "store_sales")
    hd = _read(path, "household_demographics")
    td = _read(path, "time_dim")
    st = _read(path, "store")
    m = (ss.merge(td[(td["t_hour"] == 20) & (td["t_minute"] >= 30)],
                  left_on="ss_sold_time_sk", right_on="t_time_sk")
         .merge(hd[hd["hd_dep_count"] == 7], left_on="ss_hdemo_sk",
                right_on="hd_demo_sk")
         .merge(st[st["s_store_name"] == "ese"], left_on="ss_store_sk",
                right_on="s_store_sk"))
    return pd.DataFrame({"cnt": [len(m)]})


def q98(path: str) -> pd.DataFrame:
    ss = _read(path, "store_sales")
    it = _read(path, "item")
    dd = _read(path, "date_dim")
    dd = dd[(dd["d_date"] >= datetime.date(1999, 2, 22))
            & (dd["d_date"] <= datetime.date(1999, 3, 24))]
    it = it[it["i_category"].isin(["Sports", "Books", "Home"])]
    m = (ss.merge(it, left_on="ss_item_sk", right_on="i_item_sk")
         .merge(dd, left_on="ss_sold_date_sk", right_on="d_date_sk"))
    g = (m.groupby(["i_item_id", "i_item_desc", "i_category", "i_class",
                    "i_current_price"], as_index=False)
         .agg(itemrevenue=("ss_ext_sales_price", "sum")))
    g["revenueratio"] = (g["itemrevenue"] * 100.0
                         / g.groupby("i_class")["itemrevenue"]
                         .transform("sum"))
    out = g.sort_values(["i_category", "i_class", "i_item_id",
                         "i_item_desc", "revenueratio"])
    return out[["i_item_id", "i_item_desc", "i_category", "i_class",
                "i_current_price", "itemrevenue",
                "revenueratio"]].reset_index(drop=True)


GOLDEN = {
    "q1": q1, "q3": q3, "q7": q7, "q19": q19, "q27": q27, "q42": q42,
    "q43": q43, "q48": q48, "q52": q52, "q55": q55, "q59": q59,
    "q61": q61, "q63": q63, "q65": q65, "q68": q68, "q73": q73,
    "q79": q79, "q89": q89, "q93": q93, "q96": q96, "q98": q98,
}
