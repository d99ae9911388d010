"""TPC-H Q6, the forecasting revenue change, in NumPy: an exact decimal
sum at scale 4."""

import numpy as np

from yardstick import (Expected, add_months, day, dec, dec_from_float,
                       float_sums, group_sums, hundredths, result_bytes,
                       scan_bytes)

TABLES = {"lineitem": ("l_extendedprice", "l_discount", "l_shipdate",
                       "l_quantity")}


def _keep(t, p):
    ship = t.ints("lineitem", "l_shipdate")
    disc = t.ints("lineitem", "l_discount")
    d = round(float(p["DISCOUNT"]) * 100)
    return ((ship >= day(p["DATE"])) & (ship < add_months(p["DATE"], 12))
            & (disc >= d - 1) & (disc <= d + 1)
            & (t.ints("lineitem", "l_quantity") < int(p["QUANTITY"]) * 100))


def answer(t, p) -> Expected:
    keep = _keep(t, p)
    if not keep.any():
        return Expected([(None,)])
    v = t.ints("lineitem", "l_extendedprice")[keep] \
        * t.ints("lineitem", "l_discount")[keep]
    total = group_sums(np.zeros(len(v), dtype=np.int64), v, 1)[0]
    return Expected([(dec(total, 4),)])


def control(t, p, dtype=np.float64) -> Expected:
    keep = _keep(t, p)
    v = hundredths(t.ints("lineitem", "l_extendedprice")[keep], dtype) \
        * hundredths(t.ints("lineitem", "l_discount")[keep], dtype)
    total = float_sums(np.zeros(len(v), dtype=np.int64), v, 1)[0]
    return Expected([(dec_from_float(total, 4),)])


def bytes_moved(t, p, widths, expected: Expected) -> int:
    return scan_bytes(widths, "lineitem", int(_keep(t, p).sum()),
                      ("l_extendedprice", "l_discount")) \
        + result_bytes(expected.rows)
