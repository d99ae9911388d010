"""TPC-H Q3, the shipping priority query, in NumPy: the exact revenue of
every qualifying order, the ten largest with every tie kept."""

import numpy as np

from yardstick import (Expected, as_date, day, dec, dec_from_float,
                       float_sums, group_sums, hundredths, positions,
                       result_bytes, scan_bytes, top_rows)

TABLES = {"customer": ("c_custkey", "c_mktsegment"),
          "orders": ("o_orderkey", "o_custkey", "o_orderdate",
                     "o_shippriority"),
          "lineitem": ("l_orderkey", "l_extendedprice", "l_discount",
                       "l_shipdate")}
LIMIT = 10


def _masks(t, p):
    d = day(p["DATE"])
    cm = t.equals("customer", "c_mktsegment", p["SEGMENT"])
    om = t.ints("orders", "o_orderdate") < d
    lm = t.ints("lineitem", "l_shipdate") > d
    return cm, om, lm


def _joined(t, p):
    """The qualifying lines: their order's row among the kept orders."""
    cm, om, lm = _masks(t, p)
    o_rows = np.nonzero(om)[0]
    o_rows = o_rows[positions(t.ints("customer", "c_custkey")[cm],
                              t.ints("orders", "o_custkey")[o_rows]) >= 0]
    at = positions(t.ints("orders", "o_orderkey")[o_rows],
                   t.ints("lineitem", "l_orderkey")[lm])
    lines = np.nonzero(lm)[0][at >= 0]
    return o_rows, at[at >= 0], lines


def _rows(t, o_rows, revenue, cast):
    """The result rows of the orders whose revenue could reach the top."""
    present = np.arange(len(revenue))
    order_key = t.ints("orders", "o_orderkey")[o_rows]
    odate = t.ints("orders", "o_orderdate")[o_rows]
    prio = t.ints("orders", "o_shippriority")[o_rows]
    vals = np.array([float(v) for v in revenue])
    if len(vals) > LIMIT:
        cut = np.partition(vals, len(vals) - LIMIT)[len(vals) - LIMIT]
        present = present[vals >= cut - 1.0]
    return [(int(order_key[i]), cast(revenue[i]), as_date(odate[i]),
             int(prio[i])) for i in present]


def _expected(rows):
    return top_rows(rows, key=lambda r: (-r[1], r[2]), limit=LIMIT,
                    sort_key=(1, 2))


def answer(t, p) -> Expected:
    o_rows, grp, lines = _joined(t, p)
    n = len(o_rows)
    rev = t.ints("lineitem", "l_extendedprice")[lines] \
        * (100 - t.ints("lineitem", "l_discount")[lines])
    sums = group_sums(grp, rev, n)
    hit = np.bincount(grp, minlength=n) > 0
    return _expected(_rows(t, o_rows[hit], sums[hit],
                           lambda v: dec(v, 4)))


def control(t, p, dtype=np.float64) -> Expected:
    o_rows, grp, lines = _joined(t, p)
    n = len(o_rows)
    rev = hundredths(t.ints("lineitem", "l_extendedprice")[lines], dtype) \
        * (1 - hundredths(t.ints("lineitem", "l_discount")[lines], dtype))
    sums = float_sums(grp, rev, n)
    hit = np.bincount(grp, minlength=n) > 0
    return _expected(_rows(t, o_rows[hit], sums[hit],
                           lambda v: dec_from_float(v, 4)))


def bytes_moved(t, p, widths, expected: Expected) -> int:
    cm, om, lm = _masks(t, p)
    return (scan_bytes(widths, "customer", cm.sum(), ("c_custkey",))
            + scan_bytes(widths, "orders", om.sum(), TABLES["orders"])
            + scan_bytes(widths, "lineitem", lm.sum(),
                         TABLES["lineitem"][:-1])
            + result_bytes(expected.rows))
