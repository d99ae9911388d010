"""TPC-H Q1, the pricing summary report, in NumPy: exact decimal sums,
averages rounded half up at scale 6 (Spark's avg of DECIMAL(15,2))."""

import numpy as np

from yardstick import (Expected, day, dec, dec_from_float, div_half_up,
                       float_sums, group_sums, hundredths, result_bytes,
                       scan_bytes)

TABLES = {"lineitem": ("l_returnflag", "l_linestatus", "l_quantity",
                       "l_extendedprice", "l_discount", "l_tax",
                       "l_shipdate")}


def _keep(t, p):
    return t.ints("lineitem", "l_shipdate") <= \
        day("1998-12-01") - int(p["DELTA"])


def _groups(t, p):
    keep = _keep(t, p)
    rf, rf_names = t.codes("lineitem", "l_returnflag")
    ls, ls_names = t.codes("lineitem", "l_linestatus")
    g = (rf.astype(np.int64) * len(ls_names) + ls)[keep]
    names = [(a, b) for a in rf_names for b in ls_names]
    cols = {c: t.ints("lineitem", c)[keep] for c in
            ("l_quantity", "l_extendedprice", "l_discount", "l_tax")}
    return keep, g, names, cols


def answer(t, p) -> Expected:
    _, g, names, c = _groups(t, p)
    n = len(names)
    ext, disc, tax = c["l_extendedprice"], c["l_discount"], c["l_tax"]
    disc_price = ext * (100 - disc)
    sums = {"qty": group_sums(g, c["l_quantity"], n),
            "base": group_sums(g, ext, n),
            "disc_price": group_sums(g, disc_price, n),
            "charge": group_sums(g, disc_price * (100 + tax), n),
            "disc": group_sums(g, disc, n)}
    counts = np.bincount(g, minlength=n)
    rows = []
    for i, (rf, ls) in enumerate(names):
        k = int(counts[i])
        if k == 0:
            continue
        rows.append((rf, ls, dec(sums["qty"][i], 2), dec(sums["base"][i], 2),
                     dec(sums["disc_price"][i], 4), dec(sums["charge"][i], 6),
                     dec(div_half_up(sums["qty"][i] * 10**4, k), 6),
                     dec(div_half_up(sums["base"][i] * 10**4, k), 6),
                     dec(div_half_up(sums["disc"][i] * 10**4, k), 6), k))
    return Expected(rows)


def control(t, p, dtype=np.float64) -> Expected:
    """The same query with every decimal computed in `dtype`."""
    _, g, names, c = _groups(t, p)
    n = len(names)
    qty, ext, disc, tax = (hundredths(c[k], dtype) for k in (
        "l_quantity", "l_extendedprice", "l_discount", "l_tax"))
    disc_price = ext * (1 - disc)
    sums = {"qty": float_sums(g, qty, n), "base": float_sums(g, ext, n),
            "disc_price": float_sums(g, disc_price, n),
            "charge": float_sums(g, disc_price * (1 + tax), n),
            "disc": float_sums(g, disc, n)}
    counts = np.bincount(g, minlength=n)
    rows = []
    for i, (rf, ls) in enumerate(names):
        k = int(counts[i])
        if k == 0:
            continue
        rows.append((rf, ls, dec_from_float(sums["qty"][i], 2),
                     dec_from_float(sums["base"][i], 2),
                     dec_from_float(sums["disc_price"][i], 4),
                     dec_from_float(sums["charge"][i], 6),
                     dec_from_float(sums["qty"][i] / k, 6),
                     dec_from_float(sums["base"][i] / k, 6),
                     dec_from_float(sums["disc"][i] / k, 6), k))
    return Expected(rows)


def bytes_moved(t, p, widths, expected: Expected) -> int:
    return scan_bytes(widths, "lineitem", int(_keep(t, p).sum()),
                      TABLES["lineitem"][:-1]) + result_bytes(expected.rows)
