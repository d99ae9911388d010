"""TPC-H Q5, the local supplier volume query, in NumPy: exact revenue by
nation of the lines whose customer and supplier share a nation of the
region."""

import numpy as np

from yardstick import (Expected, add_months, day, dec, dec_from_float,
                       float_sums, group_sums, hundredths, positions,
                       result_bytes, scan_bytes, top_rows)

TABLES = {"customer": ("c_custkey", "c_nationkey"),
          "orders": ("o_orderkey", "o_custkey", "o_orderdate"),
          "lineitem": ("l_orderkey", "l_suppkey", "l_extendedprice",
                       "l_discount"),
          "supplier": ("s_suppkey", "s_nationkey"),
          "nation": ("n_nationkey", "n_name", "n_regionkey"),
          "region": ("r_regionkey", "r_name")}


def _masks(t, p):
    od = t.ints("orders", "o_orderdate")
    om = (od >= day(p["DATE"])) & (od < add_months(p["DATE"], 12))
    rm = t.equals("region", "r_name", p["REGION"])
    return om, rm


def _joined(t, p):
    """The qualifying lines and the nation row of each."""
    om, rm = _masks(t, p)
    o_rows = np.nonzero(om)[0]
    at = positions(t.ints("orders", "o_orderkey")[o_rows],
                   t.ints("lineitem", "l_orderkey"))
    lines = np.nonzero(at >= 0)[0]
    cust = t.ints("orders", "o_custkey")[o_rows[at[lines]]]
    c_row = positions(t.ints("customer", "c_custkey"), cust)
    s_row = positions(t.ints("supplier", "s_suppkey"),
                      t.ints("lineitem", "l_suppkey")[lines])
    ok = (c_row >= 0) & (s_row >= 0)
    lines, c_row, s_row = lines[ok], c_row[ok], s_row[ok]
    c_nat = t.ints("customer", "c_nationkey")[c_row]
    s_nat = t.ints("supplier", "s_nationkey")[s_row]
    n_row = positions(t.ints("nation", "n_nationkey"), s_nat)
    regions = t.ints("region", "r_regionkey")[rm]
    in_region = np.isin(t.ints("nation", "n_regionkey")[
        np.maximum(n_row, 0)], regions) & (n_row >= 0)
    keep = (c_nat == s_nat) & in_region
    return lines[keep], n_row[keep]


def _expected(t, sums, counts, cast):
    names = t.strings("nation", "n_name")
    rows = [(names[i], cast(sums[i])) for i in range(len(names))
            if counts[i] > 0]
    return top_rows(rows, key=lambda r: -r[1], limit=None, sort_key=(1,))


def answer(t, p) -> Expected:
    lines, grp = _joined(t, p)
    n = t.rows("nation")
    rev = t.ints("lineitem", "l_extendedprice")[lines] \
        * (100 - t.ints("lineitem", "l_discount")[lines])
    return _expected(t, group_sums(grp, rev, n),
                     np.bincount(grp, minlength=n), lambda v: dec(v, 4))


def control(t, p, dtype=np.float64) -> Expected:
    lines, grp = _joined(t, p)
    n = t.rows("nation")
    rev = hundredths(t.ints("lineitem", "l_extendedprice")[lines], dtype) \
        * (1 - hundredths(t.ints("lineitem", "l_discount")[lines], dtype))
    return _expected(t, float_sums(grp, rev, n),
                     np.bincount(grp, minlength=n),
                     lambda v: dec_from_float(v, 4))


def bytes_moved(t, p, widths, expected: Expected) -> int:
    om, rm = _masks(t, p)
    return (scan_bytes(widths, "customer", t.rows("customer"),
                       TABLES["customer"])
            + scan_bytes(widths, "orders", om.sum(), TABLES["orders"])
            + scan_bytes(widths, "lineitem", t.rows("lineitem"),
                         TABLES["lineitem"])
            + scan_bytes(widths, "supplier", t.rows("supplier"),
                         TABLES["supplier"])
            + scan_bytes(widths, "nation", t.rows("nation"),
                         TABLES["nation"])
            + scan_bytes(widths, "region", rm.sum(), ("r_regionkey",))
            + result_bytes(expected.rows))
