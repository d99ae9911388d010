"""The byte bound: column widths from the data, and a query's bytes on a
table whose widths are known."""

import datetime
from decimal import Decimal

import numpy as np
import pyarrow as pa

import harness
from yardstick import Tables, Widths, scan_bytes, width_bytes


def test_width_bytes():
    assert width_bytes(np.arange(256)) == 1
    assert width_bytes(np.arange(257)) == 2
    assert width_bytes(np.array([0, 256])) == 1           # two levels
    assert width_bytes(np.arange(100, 5001, 100)) == 1    # quantities
    assert width_bytes(np.array([0, 65536])) == 1
    assert width_bytes(np.array([-1, 0, 65535])) == 3
    assert width_bytes(np.array([7, 7])) == 1
    assert width_bytes(np.array([0, 1, 2**40])) == 6


def test_q1_bytes_on_a_known_table():
    d = lambda xs: pa.array([Decimal(x) for x in xs], pa.decimal128(15, 2))
    t = Tables({"lineitem": pa.table({
        "l_returnflag": ["A", "A", "N", "R"],
        "l_linestatus": ["F", "F", "O", "F"],
        "l_quantity": d(["1.00", "2.00", "3.00", "4.00"]),
        "l_extendedprice": d(["10.00", "20.00", "30.01", "40.00"]),
        "l_discount": d(["0.10", "0.00", "0.05", "0.00"]),
        "l_tax": d(["0.05", "0.00", "0.08", "0.00"]),
        "l_shipdate": pa.array([datetime.date(1998, 1, 1)] * 2
                               + [datetime.date(1998, 8, 1),
                                  datetime.date(1998, 12, 1)],
                               pa.date32())})})
    w = Widths(t)
    # flags 1 B each; quantity 4 levels 1 B; price 3001 levels 2 B;
    # discount 0/5/10 1 B; tax 0..8 1 B
    assert [w("lineitem", c) for c in (
        "l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
        "l_discount", "l_tax")] == [1, 1, 1, 2, 1, 1]
    q1 = harness.load_module("reference", "q1")
    want = q1.answer(t, {"DELTA": "90"})
    # three rows survive the date predicate, 7 bytes each; the result's
    # two rows hold two 1-byte strings and eight numbers of 8 bytes
    assert q1.bytes_moved(t, {"DELTA": "90"}, w, want) == 3 * 7 + 2 * 66
    assert scan_bytes(w, "lineitem", 10, ["l_extendedprice"]) == 20
