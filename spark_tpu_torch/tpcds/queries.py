"""TPC-DS tranche queries as DataFrame programs (the port's copy of
`spark_tpu/tpcds/queries.py`).

DataFrame forms for a representative subset (the bench/preflight trio
plus the kernel-matrix pair); the full tranche lives in
`sql_queries.py`, the `tpch/` split. Join orders follow the frontend
convention — fact on the probe (left) side, dimensions on the build
side — which is exactly the order the cost-based reorder pass
(`plan/join_reorder.py`) revises when `spark_tpu.sql.cbo.joinReorder`
is on."""

from __future__ import annotations

import os

from .. import functions as F
from ..functions import col, lit
from ..io.sources import ParquetSource

TABLES = ("store_sales", "store_returns", "date_dim", "time_dim", "item",
          "customer", "customer_address", "customer_demographics",
          "household_demographics", "store", "promotion", "reason")


def register_tables(session, path: str) -> None:
    """Point the session catalog at the generated Parquet directory."""
    for name in TABLES:
        p = os.path.join(path, f"{name}.parquet")
        if os.path.exists(p):
            session.register_table(name, ParquetSource(p, name))


def q3(session):
    """Brand sales by year for one manufacturer (TPC-DS q3)."""
    ss = (session.table("store_sales")
          .join(session.table("date_dim").filter(col("d_moy") == lit(11)),
                left_on=col("ss_sold_date_sk"), right_on=col("d_date_sk"))
          .join(session.table("item")
                .filter(col("i_manufact_id") == lit(28)),
                left_on=col("ss_item_sk"), right_on=col("i_item_sk")))
    return (ss.group_by(col("d_year"), col("i_brand_id").alias("brand_id"),
                        col("i_brand").alias("brand"))
            .agg(F.sum(col("ss_ext_sales_price")).alias("sum_agg"))
            .sort(col("d_year").asc(), col("sum_agg").desc(),
                  col("brand_id").asc())
            .limit(100))


def q7(session):
    """Promotional item averages for one demographic (TPC-DS q7)."""
    cd = (session.table("customer_demographics")
          .filter((col("cd_gender") == lit("M"))
                  & (col("cd_marital_status") == lit("S"))
                  & (col("cd_education_status") == lit("College"))))
    promo = session.table("promotion").filter(
        (col("p_channel_email") == lit("N"))
        | (col("p_channel_event") == lit("N")))
    ss = (session.table("store_sales")
          .join(session.table("date_dim")
                .filter(col("d_year") == lit(2000)),
                left_on=col("ss_sold_date_sk"), right_on=col("d_date_sk"))
          .join(cd, left_on=col("ss_cdemo_sk"), right_on=col("cd_demo_sk"))
          .join(promo, left_on=col("ss_promo_sk"),
                right_on=col("p_promo_sk"))
          .join(session.table("item"), left_on=col("ss_item_sk"),
                right_on=col("i_item_sk")))
    return (ss.group_by(col("i_item_id"))
            .agg(F.avg(col("ss_quantity")).alias("agg1"),
                 F.avg(col("ss_list_price")).alias("agg2"),
                 F.avg(col("ss_coupon_amt")).alias("agg3"),
                 F.avg(col("ss_sales_price")).alias("agg4"))
            .sort(col("i_item_id").asc())
            .limit(100))


def q42(session):
    """Category sales for one month (TPC-DS q42)."""
    ss = (session.table("store_sales")
          .join(session.table("date_dim")
                .filter((col("d_moy") == lit(11))
                        & (col("d_year") == lit(2000))),
                left_on=col("ss_sold_date_sk"), right_on=col("d_date_sk"))
          .join(session.table("item")
                .filter(col("i_manager_id") == lit(1)),
                left_on=col("ss_item_sk"), right_on=col("i_item_sk")))
    return (ss.group_by(col("d_year"), col("i_category_id"),
                        col("i_category"))
            .agg(F.sum(col("ss_ext_sales_price")).alias("total_sales"))
            .sort(col("total_sales").desc(), col("d_year").asc(),
                  col("i_category_id").asc())
            .limit(100))


def q52(session):
    """Brand sales for one month (TPC-DS q52)."""
    ss = (session.table("store_sales")
          .join(session.table("date_dim")
                .filter((col("d_moy") == lit(11))
                        & (col("d_year") == lit(2000))),
                left_on=col("ss_sold_date_sk"), right_on=col("d_date_sk"))
          .join(session.table("item")
                .filter(col("i_manager_id") == lit(1)),
                left_on=col("ss_item_sk"), right_on=col("i_item_sk")))
    return (ss.group_by(col("d_year"),
                        col("i_brand_id").alias("brand_id"),
                        col("i_brand").alias("brand"))
            .agg(F.sum(col("ss_ext_sales_price")).alias("ext_price"))
            .sort(col("d_year").asc(), col("ext_price").desc(),
                  col("brand_id").asc())
            .limit(100))


def q55(session):
    """Brand sales for one manager-month (TPC-DS q55)."""
    ss = (session.table("store_sales")
          .join(session.table("date_dim")
                .filter((col("d_moy") == lit(11))
                        & (col("d_year") == lit(1999))),
                left_on=col("ss_sold_date_sk"), right_on=col("d_date_sk"))
          .join(session.table("item")
                .filter(col("i_manager_id") == lit(28)),
                left_on=col("ss_item_sk"), right_on=col("i_item_sk")))
    return (ss.group_by(col("i_brand_id").alias("brand_id"),
                        col("i_brand").alias("brand"))
            .agg(F.sum(col("ss_ext_sales_price")).alias("ext_price"))
            .sort(col("ext_price").desc(), col("brand_id").asc())
            .limit(100))


def q96(session):
    """Half-hour store traffic count (TPC-DS q96)."""
    td = (session.table("time_dim")
          .filter((col("t_hour") == lit(20))
                  & (col("t_minute") >= lit(30))))
    hd = session.table("household_demographics").filter(
        col("hd_dep_count") == lit(7))
    st = session.table("store").filter(
        col("s_store_name") == lit("ese"))
    ss = (session.table("store_sales")
          .join(td, left_on=col("ss_sold_time_sk"),
                right_on=col("t_time_sk"))
          .join(hd, left_on=col("ss_hdemo_sk"),
                right_on=col("hd_demo_sk"))
          .join(st, left_on=col("ss_store_sk"),
                right_on=col("s_store_sk")))
    return ss.agg(F.count().alias("cnt"))


QUERIES = {"q3": q3, "q7": q7, "q42": q42, "q52": q52, "q55": q55,
           "q96": q96}
