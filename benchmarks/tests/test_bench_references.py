"""Each plain reference against an answer worked out by hand on a tiny
table, and the exact arithmetic under them."""

import datetime
from decimal import Decimal

import numpy as np
import pyarrow as pa
import pytest

import harness
from yardstick import Tables, div_half_up, group_sums, wrong_values

D = Decimal


def dec(values):
    return pa.array([D(v) for v in values], pa.decimal128(15, 2))


def dates(values):
    return pa.array([datetime.date.fromisoformat(v) for v in values],
                    pa.date32())


def ref(q):
    return harness.load_module("reference", q)


def test_exact_sums_and_half_up():
    g = np.array([0, 1, 0, 1, 1])
    v = np.array([2**62, -5, 2**62, 7, 1], dtype=np.int64)
    assert list(group_sums(g, v, 2)) == [2**63, 3]
    assert div_half_up(3125, 10) == 313
    assert div_half_up(3124, 10) == 312
    assert div_half_up(-3125, 10) == -313


def test_q1_by_hand():
    t = Tables({"lineitem": pa.table({
        "l_returnflag": ["A", "A", "N", "R"],
        "l_linestatus": ["F", "F", "O", "F"],
        "l_quantity": dec(["1.00", "2.00", "3.00", "4.00"]),
        "l_extendedprice": dec(["10.00", "20.00", "30.01", "40.00"]),
        "l_discount": dec(["0.10", "0.00", "0.05", "0.00"]),
        "l_tax": dec(["0.05", "0.00", "0.08", "0.00"]),
        "l_shipdate": dates(["1998-01-01", "1998-01-01", "1998-08-01",
                             "1998-12-01"])})})
    got = ref("q1").answer(t, {"DELTA": "90"}).rows
    assert got == [
        ("A", "F", D("3.00"), D("30.00"), D("29.0000"), D("29.450000"),
         D("1.500000"), D("15.000000"), D("0.050000"), 2),
        ("N", "O", D("3.00"), D("30.01"), D("28.5095"), D("30.790260"),
         D("3.000000"), D("30.010000"), D("0.050000"), 1)]


def test_q6_by_hand():
    t = Tables({"lineitem": pa.table({
        "l_extendedprice": dec(["100.00", "200.00", "300.00", "400.00",
                                "500.00"]),
        "l_discount": dec(["0.05", "0.07", "0.08", "0.06", "0.06"]),
        "l_shipdate": dates(["1994-03-01", "1994-12-31", "1994-05-01",
                             "1995-01-01", "1994-06-01"]),
        "l_quantity": dec(["10", "23", "5", "5", "24"])})})
    p = {"DATE": "1994-01-01", "DISCOUNT": "0.06", "QUANTITY": "24"}
    assert ref("q6").answer(t, p).rows == [(D("19.0000"),)]


def test_q3_by_hand():
    t = Tables({
        "customer": pa.table({"c_custkey": [1, 2],
                              "c_mktsegment": ["BUILDING", "AUTOMOBILE"]}),
        "orders": pa.table({
            "o_orderkey": [10, 11, 12], "o_custkey": [1, 2, 1],
            "o_orderdate": dates(["1995-03-10", "1995-03-01",
                                  "1995-03-20"]),
            "o_shippriority": pa.array([0, 0, 0], pa.int32())}),
        "lineitem": pa.table({
            "l_orderkey": [10, 10, 10, 11, 12],
            "l_extendedprice": dec(["100.00", "50.00", "10.00", "1000.00",
                                    "500.00"]),
            "l_discount": dec(["0.10", "0.00", "0.00", "0.00", "0.00"]),
            "l_shipdate": dates(["1995-03-20", "1995-03-16", "1995-03-14",
                                 "1995-04-01", "1995-04-01"])})})
    got = ref("q3").answer(t, {"SEGMENT": "BUILDING", "DATE": "1995-03-15"})
    assert got.rows == [(10, D("140.0000"), datetime.date(1995, 3, 10), 0)]


def _q5_tables():
    return Tables({
        "region": pa.table({"r_regionkey": [0, 1],
                            "r_name": ["AFRICA", "ASIA"]}),
        "nation": pa.table({"n_nationkey": [0, 1, 2],
                            "n_name": ["KENYA", "JAPAN", "CHINA"],
                            "n_regionkey": [0, 1, 1]}),
        "customer": pa.table({"c_custkey": [1, 2, 3],
                              "c_nationkey": [1, 2, 0]}),
        "supplier": pa.table({"s_suppkey": [1, 2, 3],
                              "s_nationkey": [1, 2, 1]}),
        "orders": pa.table({
            "o_orderkey": [100, 101, 102, 103],
            "o_custkey": [1, 2, 3, 1],
            "o_orderdate": dates(["1994-02-01", "1994-05-01", "1994-06-01",
                                  "1995-02-01"])}),
        "lineitem": pa.table({
            "l_orderkey": [100, 100, 101, 101, 102, 103],
            "l_suppkey": [1, 2, 2, 3, 1, 1],
            "l_extendedprice": dec(["100.00", "50.00", "200.00", "10.00",
                                    "70.00", "1000.00"]),
            "l_discount": dec(["0.10", "0.00", "0.05", "0.00", "0.00",
                               "0.00"])})})


def test_q5_by_hand():
    got = ref("q5").answer(_q5_tables(), {"REGION": "ASIA",
                                          "DATE": "1994-01-01"})
    assert got.rows == [("CHINA", D("190.0000")), ("JAPAN", D("90.0000"))]


def test_q10_by_hand():
    t = Tables({
        "nation": pa.table({"n_nationkey": [0, 1],
                            "n_name": ["KENYA", "JAPAN"]}),
        "customer": pa.table({
            "c_custkey": [1, 2], "c_name": ["C1", "C2"],
            "c_address": ["a1", "a2"], "c_nationkey": [1, 0],
            "c_phone": ["p1", "p2"], "c_acctbal": dec(["10.00", "-5.00"]),
            "c_comment": ["k1", "k2"]}),
        "orders": pa.table({
            "o_orderkey": [10, 11, 12], "o_custkey": [1, 2, 2],
            "o_orderdate": dates(["1993-10-05", "1993-11-01",
                                  "1994-01-01"])}),
        "lineitem": pa.table({
            "l_orderkey": [10, 10, 11, 12],
            "l_extendedprice": dec(["100.00", "30.00", "50.00", "999.00"]),
            "l_discount": dec(["0.10", "0.00", "0.00", "0.00"]),
            "l_returnflag": ["R", "A", "R", "R"]})})
    got = ref("q10").answer(t, {"DATE": "1993-10-01"})
    assert got.rows == [
        (1, "C1", D("90.0000"), D("10.00"), "JAPAN", "a1", "p1", "k1"),
        (2, "C2", D("50.0000"), D("-5.00"), "KENYA", "a2", "p2", "k2")]


def test_comparison_counts_values_and_accepts_ties():
    want = ref("q5").answer(_q5_tables(), {"REGION": "ASIA",
                                           "DATE": "1994-01-01"})
    assert wrong_values(list(want.rows), want) == 0
    assert wrong_values([("CHINA", D("190.0001")), want.rows[1]], want) == 1
    assert wrong_values([want.rows[0]], want) == 2
    assert wrong_values([("CHINA", 190.0), want.rows[1]], want) == 1
    from yardstick import top_rows
    rows = [(1, D("5")), (2, D("5")), (3, D("1"))]
    exp = top_rows(rows, key=lambda r: -r[1], limit=1, sort_key=(1,))
    assert wrong_values([(2, D("5"))], exp) == 0
    assert wrong_values([(3, D("5"))], exp) == 1


@pytest.mark.parametrize("q", ["q1", "q3", "q5", "q6", "q10"])
def test_reference_imports_nothing_of_the_program(q):
    import ast
    src = (harness.HERE / "reference" / f"{q}.py").read_text()
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"numpy", "yardstick"}, names
