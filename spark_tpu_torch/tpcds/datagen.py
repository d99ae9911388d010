"""TPC-DS data generator (vectorized numpy -> pyarrow -> Parquet); the
port's copy of `spark_tpu/tpcds/datagen.py`, which it matches row for
row at every scale and seed.

The TPC-DS sibling of `tpch/datagen.py`: the core store-channel tables
with dsdgen-like shapes, types, and value distributions (row counts
scale with `sf`; store_sales ~= 2.88M rows/sf, grouped into multi-line
tickets so the per-ticket queries — q68/q73/q79 — have real ticket
structure). Not bit-identical to dsdgen: golden answers are computed on
THIS data by an independent pandas implementation (golden.py), the
pattern of the reference's golden-file suites
(`TPCDSQueryTestSuite.scala:54`).

Types follow the spec's shape: surrogate keys int64 (nullable on the
fact's dimension FKs, like dsdgen output), money DECIMAL(7,2), dates
DATE32 in date_dim, low-cardinality attributes dictionary strings —
exercising the decimal/date/dictionary ingest tiers end to end.

Fixed-size dimensions (date_dim, time_dim, the demographics tables,
reason) do not scale with `sf`, matching the spec."""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

EPOCH = np.datetime64("1970-01-01", "D")
#: date_dim coverage: 1996-01-01 .. 2003-12-31 (the sales window plus
#: margin for returns landing after the last sale)
D_START = np.datetime64("1996-01-01", "D")
D_END = np.datetime64("2004-01-01", "D")
#: surrogate key of the first date_dim row (spec base is 2415022 at
#: 1900-01-02; same idea, anchored to our window)
D_BASE_SK = 2450000

CATEGORIES = ["Books", "Children", "Electronics", "Home", "Jewelry",
              "Men", "Music", "Shoes", "Sports", "Women"]
CLASSES_PER_CATEGORY = 4
DAY_NAMES = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
             "Friday", "Saturday"]
STATES = ["TN", "OH", "TX", "OR", "MN", "KY", "VA", "CA", "MS", "CO",
          "IL", "GA", "NM", "WA", "FL", "MI", "NC", "PA", "SD", "WI"]
CITIES = ["Midway", "Fairview", "Oak Grove", "Glendale", "Centerville",
          "Riverside", "Salem", "Franklin", "Union", "Liberty",
          "Pleasant Hill", "Greenville", "Springdale", "Clinton",
          "Oakdale", "Lakeview"]
COUNTIES = ["Williamson County", "Franklin Parish", "Walker County",
            "Ziebach County", "Luce County", "Richland County",
            "Furnas County", "Daviess County"]
MARITAL = ["M", "S", "D", "W", "U"]
EDUCATION = ["Primary", "Secondary", "College", "2 yr Degree",
             "4 yr Degree", "Advanced Degree", "Unknown"]
CREDIT = ["Low Risk", "Good", "High Risk", "Unknown"]
BUY_POTENTIAL = [">10000", "5001-10000", "1001-5000", "501-1000",
                 "0-500", "Unknown"]
STORE_NAMES = ["ese", "ose", "ation", "bar", "able", "anti", "cally",
               "eing"]
PROMO_NAMES = ["ought", "able", "pri", "ese", "anti", "cally", "ation",
               "eing", "n st", "bar"]
COLORS = ["red", "blue", "green", "yellow", "black", "white", "navy",
          "ivory", "plum", "khaki"]
UNITS = ["Each", "Dozen", "Case", "Pallet", "Box", "Bunch"]
SIZES = ["small", "medium", "large", "extra large", "N/A"]
LOCATION_TYPES = ["apartment", "condo", "single family"]


def _dec(cents: np.ndarray, precision: int = 7, scale: int = 2) -> pa.Array:
    """int64 UNSCALED units (cents for scale 2) -> decimal128(p, s),
    built from the little-endian 128-bit buffer (a cast would treat the
    ints as whole units and rescale them) — same device path as the
    tpch generator's DECIMAL(15,2), at the DS spec's precision."""
    lo = np.ascontiguousarray(cents.astype(np.int64))
    raw = np.empty((len(lo), 2), dtype=np.int64)
    raw[:, 0] = lo
    raw[:, 1] = lo >> 63  # sign extension
    return pa.Array.from_buffers(pa.decimal128(precision, scale), len(lo),
                                 [None, pa.py_buffer(raw.tobytes())])


def _nullable_i64(values: np.ndarray, rs, null_frac: float) -> pa.Array:
    """int64 column with a deterministic sprinkle of NULLs (the fact
    table's dimension FKs are nullable in dsdgen output)."""
    if null_frac <= 0:
        return pa.array(values.astype(np.int64))
    mask = rs.rand(len(values)) < null_frac
    return pa.array(values.astype(np.int64), mask=mask)


def _date_dim() -> pa.Table:
    days = np.arange((D_END - D_START).astype(int), dtype=np.int64)
    abs_days = (D_START - EPOCH).astype(np.int64) + days
    dates = D_START + days
    years = dates.astype("datetime64[Y]").astype(int) + 1970
    months = dates.astype("datetime64[M]").astype(int) % 12 + 1
    month_start = dates.astype("datetime64[M]").astype("datetime64[D]")
    doms = (dates - month_start).astype(int) + 1
    # numpy day-of-week: 1970-01-01 was a Thursday (dow 4 with Sunday=0)
    dows = (abs_days + 4) % 7
    # week_seq increments at each Sunday boundary, starting at 1
    week_seq = (days + ((D_START - EPOCH).astype(np.int64) + 4) % 7) // 7 + 1
    month_seq = (years - years[0]) * 12 + months - 1
    quarters = (months - 1) // 3 + 1
    return pa.table({
        "d_date_sk": pa.array(D_BASE_SK + days),
        "d_date_id": pa.array([f"AAAAAAAA{int(s):08d}"
                               for s in D_BASE_SK + days]),
        "d_date": pa.array(abs_days.astype(np.int32),
                           type=pa.int32()).cast(pa.date32()),
        "d_year": pa.array(years.astype(np.int64)),
        "d_moy": pa.array(months.astype(np.int64)),
        "d_dom": pa.array(doms.astype(np.int64)),
        "d_dow": pa.array(dows.astype(np.int64)),
        "d_qoy": pa.array(quarters.astype(np.int64)),
        "d_week_seq": pa.array(week_seq.astype(np.int64)),
        "d_month_seq": pa.array(month_seq.astype(np.int64)),
        "d_day_name": pa.array(np.array(DAY_NAMES)[dows]),
    })


def _time_dim() -> pa.Table:
    secs = np.arange(86400, dtype=np.int64)
    return pa.table({
        "t_time_sk": pa.array(secs),
        "t_time": pa.array(secs),
        "t_hour": pa.array(secs // 3600),
        "t_minute": pa.array(secs % 3600 // 60),
        "t_second": pa.array(secs % 60),
    })


def generate(sf: float, seed: int = 42) -> Dict[str, pa.Table]:
    """Generate the store-channel tables at scale factor `sf`."""
    rs = np.random.RandomState(seed)
    n_item = max(18, int(18_000 * sf))
    n_cust = max(40, int(100_000 * sf))
    n_addr = max(20, int(50_000 * sf))
    n_store = max(4, int(12 * sf))
    n_promo = max(30, int(300 * sf))
    n_cd = 7200
    n_hd = 7200
    n_ticket = max(64, int(480_000 * sf))

    tables: Dict[str, pa.Table] = {}
    tables["date_dim"] = _date_dim()
    tables["time_dim"] = _time_dim()

    idx = np.arange(n_item, dtype=np.int64)
    cat_id = idx % len(CATEGORIES)
    class_id = idx % CLASSES_PER_CATEGORY
    brand_id = ((cat_id + 1) * 1000 + idx % 50 + 1).astype(np.int64)
    tables["item"] = pa.table({
        "i_item_sk": pa.array(idx + 1),
        "i_item_id": pa.array([f"AAAAAAAA{i + 1:08d}" for i in idx]),
        "i_item_desc": pa.array([f"item description {i % 251}"
                                 for i in idx]),
        "i_current_price": _dec(rs.randint(9, 10000, n_item)),
        "i_wholesale_cost": _dec(rs.randint(5, 8000, n_item)),
        "i_brand_id": pa.array(brand_id),
        "i_brand": pa.array([f"Brand#{b}" for b in brand_id]),
        "i_class_id": pa.array(class_id + 1),
        "i_class": pa.array([f"{CATEGORIES[c]} class {k + 1}"
                             for c, k in zip(cat_id, class_id)]),
        "i_category_id": pa.array(cat_id + 1),
        "i_category": pa.array(np.array(CATEGORIES)[cat_id]),
        "i_manufact_id": pa.array(idx % 100 + 1),
        "i_manufact": pa.array([f"Manufacturer#{i % 100 + 1}"
                                for i in idx]),
        "i_manager_id": pa.array(idx % 100 + 1),
        "i_size": pa.array(np.array(SIZES)[idx % len(SIZES)]),
        "i_color": pa.array(np.array(COLORS)[idx % len(COLORS)]),
        "i_units": pa.array(np.array(UNITS)[idx % len(UNITS)]),
    })

    idx = np.arange(n_addr, dtype=np.int64)
    tables["customer_address"] = pa.table({
        "ca_address_sk": pa.array(idx + 1),
        "ca_address_id": pa.array([f"AAAAAAAA{i + 1:08d}" for i in idx]),
        "ca_street_number": pa.array([str(100 + i % 899) for i in idx]),
        "ca_street_name": pa.array([f"Street {i % 61}" for i in idx]),
        "ca_city": pa.array(np.array(CITIES)[idx % len(CITIES)]),
        "ca_county": pa.array(np.array(COUNTIES)[idx % len(COUNTIES)]),
        "ca_state": pa.array(np.array(STATES)[idx % len(STATES)]),
        "ca_zip": pa.array([f"{10000 + int(i) * 7 % 89999:05d}"
                            for i in idx]),
        "ca_country": pa.array(["United States"] * n_addr),
        "ca_gmt_offset": _dec(
            np.array([-500, -600, -700, -800],
                     dtype=np.int64)[idx % 4], precision=5),
        "ca_location_type": pa.array(
            np.array(LOCATION_TYPES)[idx % len(LOCATION_TYPES)]),
    })

    idx = np.arange(n_cd, dtype=np.int64)
    tables["customer_demographics"] = pa.table({
        "cd_demo_sk": pa.array(idx + 1),
        "cd_gender": pa.array(np.array(["M", "F"])[idx % 2]),
        "cd_marital_status": pa.array(
            np.array(MARITAL)[idx // 2 % len(MARITAL)]),
        "cd_education_status": pa.array(
            np.array(EDUCATION)[idx // 10 % len(EDUCATION)]),
        "cd_purchase_estimate": pa.array(idx % 20 * 500 + 500),
        "cd_credit_rating": pa.array(
            np.array(CREDIT)[idx // 70 % len(CREDIT)]),
        "cd_dep_count": pa.array(idx % 7),
        "cd_dep_employed_count": pa.array(idx // 7 % 7),
        "cd_dep_college_count": pa.array(idx // 49 % 7),
    })

    idx = np.arange(n_hd, dtype=np.int64)
    tables["household_demographics"] = pa.table({
        "hd_demo_sk": pa.array(idx + 1),
        "hd_income_band_sk": pa.array(idx % 20 + 1),
        "hd_buy_potential": pa.array(
            np.array(BUY_POTENTIAL)[idx % len(BUY_POTENTIAL)]),
        "hd_dep_count": pa.array(idx // 6 % 10),
        "hd_vehicle_count": pa.array(idx % 6 - 1),
    })

    idx = np.arange(n_cust, dtype=np.int64)
    c_addr = rs.randint(1, n_addr + 1, n_cust).astype(np.int64)
    tables["customer"] = pa.table({
        "c_customer_sk": pa.array(idx + 1),
        "c_customer_id": pa.array([f"AAAAAAAA{i + 1:08d}" for i in idx]),
        "c_current_cdemo_sk": pa.array(
            rs.randint(1, n_cd + 1, n_cust).astype(np.int64)),
        "c_current_hdemo_sk": pa.array(
            rs.randint(1, n_hd + 1, n_cust).astype(np.int64)),
        "c_current_addr_sk": pa.array(c_addr),
        "c_salutation": pa.array(
            np.array(["Mr.", "Mrs.", "Ms.", "Dr.", "Sir"])[idx % 5]),
        "c_first_name": pa.array([f"First{i % 499}" for i in idx]),
        "c_last_name": pa.array([f"Last{i % 997}" for i in idx]),
        "c_preferred_cust_flag": pa.array(np.array(["Y", "N"])[idx % 2]),
        "c_birth_year": pa.array(idx % 68 + 1925),
        "c_birth_month": pa.array(idx % 12 + 1),
        "c_birth_day": pa.array(idx % 28 + 1),
        "c_email_address": pa.array([f"c{i}@example.com" for i in idx]),
    })

    idx = np.arange(n_store, dtype=np.int64)
    tables["store"] = pa.table({
        "s_store_sk": pa.array(idx + 1),
        "s_store_id": pa.array([f"AAAAAAAA{i + 1:08d}" for i in idx]),
        "s_store_name": pa.array(
            np.array(STORE_NAMES)[idx % len(STORE_NAMES)]),
        "s_number_employees": pa.array(200 + idx * 13 % 100),
        "s_floor_space": pa.array((5_000_000 + idx * 997_000 % 5_000_000)
                                  .astype(np.int64)),
        "s_hours": pa.array(np.array(["8AM-8PM", "8AM-4PM",
                                      "8AM-12AM"])[idx % 3]),
        "s_manager": pa.array([f"Manager {i % 50}" for i in idx]),
        "s_market_id": pa.array(idx % 10 + 1),
        "s_city": pa.array(np.array(CITIES)[idx % len(CITIES)]),
        "s_county": pa.array(np.array(COUNTIES)[idx % len(COUNTIES)]),
        "s_state": pa.array(np.array(STATES)[idx % 8]),
        "s_zip": pa.array([f"{20000 + int(i) * 11 % 79999:05d}"
                           for i in idx]),
        "s_company_id": pa.array(np.ones(n_store, dtype=np.int64)),
        "s_company_name": pa.array(["Unknown"] * n_store),
        "s_gmt_offset": _dec(
            np.array([-500, -600], dtype=np.int64)[idx % 2], precision=5),
        "s_tax_precentage": _dec(idx % 12, precision=5),
    })

    idx = np.arange(n_promo, dtype=np.int64)
    tables["promotion"] = pa.table({
        "p_promo_sk": pa.array(idx + 1),
        "p_promo_id": pa.array([f"AAAAAAAA{i + 1:08d}" for i in idx]),
        "p_promo_name": pa.array(
            np.array(PROMO_NAMES)[idx % len(PROMO_NAMES)]),
        "p_channel_dmail": pa.array(np.array(["Y", "N"])[idx % 2]),
        "p_channel_email": pa.array(
            np.where(idx % 5 == 4, "Y", "N")),
        "p_channel_tv": pa.array(np.where(idx % 3 == 2, "Y", "N")),
        "p_channel_event": pa.array(np.where(idx % 4 == 3, "Y", "N")),
        "p_cost": _dec(rs.randint(50000, 200000, n_promo), precision=15,
                       scale=2),
    })

    idx = np.arange(35, dtype=np.int64)
    tables["reason"] = pa.table({
        "r_reason_sk": pa.array(idx + 1),
        "r_reason_id": pa.array([f"AAAAAAAA{i + 1:08d}" for i in idx]),
        "r_reason_desc": pa.array([f"reason {i + 1}" for i in idx]),
    })

    # -- store_sales: ticket-structured fact -------------------------------
    # sales dates span 1998-01-02 .. 2002-12-31 of the date_dim window
    lo = int((np.datetime64("1998-01-02", "D") - D_START).astype(int))
    hi = int((np.datetime64("2003-01-01", "D") - D_START).astype(int))
    t_date = rs.randint(lo, hi, n_ticket).astype(np.int64)
    t_time = rs.randint(8 * 3600, 22 * 3600, n_ticket).astype(np.int64)
    t_store = rs.randint(1, n_store + 1, n_ticket).astype(np.int64)
    t_cust = rs.randint(1, n_cust + 1, n_ticket).astype(np.int64)
    # half the tickets are bought at the customer's current address,
    # half somewhere else (q68's bought_city <> current city filter)
    t_addr = np.where(rs.rand(n_ticket) < 0.5, c_addr[t_cust - 1],
                      rs.randint(1, n_addr + 1, n_ticket)).astype(np.int64)
    t_hdemo = rs.randint(1, n_hd + 1, n_ticket).astype(np.int64)
    t_cdemo = rs.randint(1, n_cd + 1, n_ticket).astype(np.int64)
    n_lines = rs.randint(1, 12, n_ticket)  # 1..11 lines, avg 6

    ticket = np.repeat(np.arange(1, n_ticket + 1, dtype=np.int64), n_lines)
    n_ss = len(ticket)
    date_sk = D_BASE_SK + np.repeat(t_date, n_lines)
    time_sk = np.repeat(t_time, n_lines)
    store_sk = np.repeat(t_store, n_lines)
    cust_sk = np.repeat(t_cust, n_lines)
    addr_sk = np.repeat(t_addr, n_lines)
    hdemo_sk = np.repeat(t_hdemo, n_lines)
    cdemo_sk = np.repeat(t_cdemo, n_lines)
    item_sk = rs.randint(1, n_item + 1, n_ss).astype(np.int64)
    promo_sk = rs.randint(1, n_promo + 1, n_ss).astype(np.int64)

    qty = rs.randint(1, 101, n_ss).astype(np.int64)
    wholesale = rs.randint(100, 10000, n_ss).astype(np.int64)  # cents
    list_p = (wholesale * rs.randint(110, 160, n_ss) // 100).astype(np.int64)
    sales_p = (list_p * rs.randint(20, 101, n_ss) // 100).astype(np.int64)
    ext_sales = qty * sales_p
    ext_list = qty * list_p
    ext_wholesale = qty * wholesale
    ext_discount = ext_list - ext_sales
    ext_tax = ext_sales * 8 // 100
    coupon = np.where(rs.rand(n_ss) < 0.1,
                      ext_sales * rs.randint(5, 40, n_ss) // 100,
                      0).astype(np.int64)
    net_paid = ext_sales - coupon
    net_paid_tax = net_paid + ext_tax
    net_profit = net_paid - ext_wholesale

    tables["store_sales"] = pa.table({
        "ss_sold_date_sk": pa.array(date_sk),
        "ss_sold_time_sk": pa.array(time_sk),
        "ss_item_sk": pa.array(item_sk),
        "ss_customer_sk": _nullable_i64(cust_sk, rs, 0.02),
        "ss_cdemo_sk": _nullable_i64(cdemo_sk, rs, 0.02),
        "ss_hdemo_sk": _nullable_i64(hdemo_sk, rs, 0.02),
        "ss_addr_sk": _nullable_i64(addr_sk, rs, 0.02),
        "ss_store_sk": pa.array(store_sk),
        "ss_promo_sk": _nullable_i64(promo_sk, rs, 0.35),
        "ss_ticket_number": pa.array(ticket),
        "ss_quantity": pa.array(qty),
        "ss_wholesale_cost": _dec(wholesale),
        "ss_list_price": _dec(list_p),
        "ss_sales_price": _dec(sales_p),
        "ss_ext_discount_amt": _dec(ext_discount),
        "ss_ext_sales_price": _dec(ext_sales),
        "ss_ext_wholesale_cost": _dec(ext_wholesale),
        "ss_ext_list_price": _dec(ext_list),
        "ss_ext_tax": _dec(ext_tax),
        "ss_coupon_amt": _dec(coupon),
        "ss_net_paid": _dec(net_paid),
        "ss_net_paid_inc_tax": _dec(net_paid_tax),
        "ss_net_profit": _dec(net_profit),
    })

    # -- store_returns: ~8% of sale lines come back ------------------------
    ret_mask = rs.rand(n_ss) < 0.08
    ri = np.nonzero(ret_mask)[0]
    n_sr = len(ri)
    ret_delay = rs.randint(1, 91, n_sr).astype(np.int64)
    ret_date = np.minimum(date_sk[ri] - D_BASE_SK + ret_delay,
                          int((D_END - D_START).astype(int)) - 1)
    ret_qty = rs.randint(1, qty[ri] + 1).astype(np.int64)
    ret_amt = ret_qty * sales_p[ri]
    ret_tax = ret_amt * 8 // 100
    fee = rs.randint(50, 10000, n_sr).astype(np.int64)
    net_loss = ret_amt // 2 + fee
    # a tenth of returns come back through a different customer account
    sr_cust = np.where(rs.rand(n_sr) < 0.1,
                       rs.randint(1, n_cust + 1, n_sr),
                       cust_sk[ri]).astype(np.int64)
    tables["store_returns"] = pa.table({
        "sr_returned_date_sk": pa.array(D_BASE_SK + ret_date),
        "sr_item_sk": pa.array(item_sk[ri]),
        "sr_customer_sk": _nullable_i64(sr_cust, rs, 0.02),
        "sr_ticket_number": pa.array(ticket[ri]),
        "sr_store_sk": pa.array(store_sk[ri]),
        "sr_reason_sk": pa.array(
            rs.randint(1, 36, n_sr).astype(np.int64)),
        "sr_return_quantity": pa.array(ret_qty),
        "sr_return_amt": _dec(ret_amt),
        "sr_return_tax": _dec(ret_tax),
        "sr_return_amt_inc_tax": _dec(ret_amt + ret_tax),
        "sr_fee": _dec(fee),
        "sr_net_loss": _dec(net_loss),
    })
    return tables


def write_parquet(path: str, sf: float, seed: int = 42,
                  overwrite: bool = False) -> str:
    """Write all tables under `path/<table>.parquet`; returns `path`.
    Skips generation when the directory is already populated (same
    marker protocol as tpch.datagen.write_parquet)."""
    os.makedirs(path, exist_ok=True)
    marker = os.path.join(path, f".sf_{sf}_{seed}")
    if os.path.exists(marker) and not overwrite:
        return path
    tables = generate(sf, seed)
    for name, table in tables.items():
        pq.write_table(table, os.path.join(path, f"{name}.parquet"))
    with open(marker, "w") as f:
        f.write("ok\n")
    return path
