"""TPC-H Q10, the returned item reporting query, in NumPy: exact revenue
lost by each customer, the twenty largest."""

import numpy as np

from yardstick import (Expected, add_months, day, dec, dec_from_float,
                       float_sums, group_sums, hundredths, positions,
                       result_bytes, scan_bytes, top_rows)

TABLES = {"customer": ("c_custkey", "c_name", "c_address", "c_nationkey",
                       "c_phone", "c_acctbal", "c_comment"),
          "orders": ("o_orderkey", "o_custkey", "o_orderdate"),
          "lineitem": ("l_orderkey", "l_extendedprice", "l_discount",
                       "l_returnflag"),
          "nation": ("n_nationkey", "n_name")}
LIMIT = 20


def _masks(t, p):
    od = t.ints("orders", "o_orderdate")
    om = (od >= day(p["DATE"])) & (od < add_months(p["DATE"], 3))
    lm = t.equals("lineitem", "l_returnflag", "R")
    return om, lm


def _joined(t, p):
    """The qualifying lines and the customer row of each."""
    om, lm = _masks(t, p)
    o_rows = np.nonzero(om)[0]
    at = positions(t.ints("orders", "o_orderkey")[o_rows],
                   t.ints("lineitem", "l_orderkey")[lm])
    lines = np.nonzero(lm)[0][at >= 0]
    c_row = positions(t.ints("customer", "c_custkey"),
                      t.ints("orders", "o_custkey")[o_rows[at[at >= 0]]])
    n_row = positions(t.ints("nation", "n_nationkey"),
                      t.ints("customer", "c_nationkey")[np.maximum(c_row, 0)])
    ok = (c_row >= 0) & (n_row >= 0)
    return lines[ok], c_row[ok]


def _expected(t, sums, counts, cast):
    hit = np.nonzero(counts > 0)[0]
    vals = np.array([float(sums[i]) for i in hit])
    if len(vals) > LIMIT:
        cut = np.partition(vals, len(vals) - LIMIT)[len(vals) - LIMIT]
        hit = hit[vals >= cut - 1.0]
    n_row = positions(t.ints("nation", "n_nationkey"),
                      t.ints("customer", "c_nationkey")[hit])
    s = {c: t.strings("customer", c) for c in
         ("c_name", "c_address", "c_phone", "c_comment")}
    names = t.strings("nation", "n_name")
    key = t.ints("customer", "c_custkey")
    bal = t.ints("customer", "c_acctbal")
    rows = [(int(key[i]), s["c_name"][i], cast(sums[i]), dec(bal[i], 2),
             names[n], s["c_address"][i], s["c_phone"][i],
             s["c_comment"][i]) for i, n in zip(hit, n_row)]
    return top_rows(rows, key=lambda r: (-r[2], r[0]), limit=LIMIT,
                    sort_key=(2, 0))


def answer(t, p) -> Expected:
    lines, grp = _joined(t, p)
    n = t.rows("customer")
    rev = t.ints("lineitem", "l_extendedprice")[lines] \
        * (100 - t.ints("lineitem", "l_discount")[lines])
    return _expected(t, group_sums(grp, rev, n),
                     np.bincount(grp, minlength=n), lambda v: dec(v, 4))


def control(t, p, dtype=np.float64) -> Expected:
    lines, grp = _joined(t, p)
    n = t.rows("customer")
    rev = hundredths(t.ints("lineitem", "l_extendedprice")[lines], dtype) \
        * (1 - hundredths(t.ints("lineitem", "l_discount")[lines], dtype))
    return _expected(t, float_sums(grp, rev, n),
                     np.bincount(grp, minlength=n),
                     lambda v: dec_from_float(v, 4))


def bytes_moved(t, p, widths, expected: Expected) -> int:
    om, lm = _masks(t, p)
    return (scan_bytes(widths, "customer", t.rows("customer"),
                       TABLES["customer"])
            + scan_bytes(widths, "orders", om.sum(), TABLES["orders"][:2])
            + scan_bytes(widths, "lineitem", lm.sum(),
                         TABLES["lineitem"][:3])
            + scan_bytes(widths, "nation", t.rows("nation"),
                         TABLES["nation"])
            + result_bytes(expected.rows))
