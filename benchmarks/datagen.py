"""TPC-H tables in host memory, generated in pieces over a thread pool.

A frozen copy of the value distributions of the port's generator
(`spark_tpu_torch/tpch/datagen.py`: `generate` and `lineitem_piece`),
rebuilt so that any scale factor is made in parallel and in bulk:

- every table is cut into pieces of a fixed number of rows (orders and
  lineitem by orders, so that piece k of lineitem holds exactly the lines
  of piece k of orders), however many workers make them;
- every column of a piece draws from its own stream,
  `SeedSequence([seed, table, column, piece])`, so a seed of any size
  gives the same tables whatever the number of workers, and leaving a
  column out changes no other column;
- strings are built from small value arrays by `take` or by Arrow's
  string kernels, never one Python string per row;
- the pieces are made by threads of this process: NumPy's generators,
  its array operations and Arrow's kernels release the interpreter lock,
  and threads hand their tables over without copying them (a process
  pool would pickle every piece back, several GB at SF10).

Only the tables and columns asked for are generated. Types follow the
port's generator: keys int64, money DECIMAL(15,2), dates DATE32, flags
and names strings. The values follow dbgen's shapes but are not dbgen's
bytes (see the configuration files' `assumed`).

Importing this module imports numpy and pyarrow only.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

EPOCH = np.datetime64("1970-01-01", "D")
START = int((np.datetime64("1992-01-01", "D") - EPOCH).astype(np.int64))
END = int((np.datetime64("1998-08-02", "D") - EPOCH).astype(np.int64))
CUTOFF = int((np.datetime64("1995-06-17", "D") - EPOCH).astype(np.int64))

NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
SHIPINSTRUCT = ["DELIVER IN PERSON", "COLLECT COD", "NONE",
                "TAKE BACK RETURN"]
STATUSES = ["O", "F", "P"]
RETURNFLAGS = ["A", "N", "R"]
LINESTATUS = ["F", "O"]

#: rows of a piece: orders (and their lines) and customers per piece
PIECE_ROWS = 250_000

#: every table and its columns, in schema order; the stream ids of the
#: columns are their positions here
SCHEMA: Dict[str, Tuple[str, ...]] = {
    "region": ("r_regionkey", "r_name", "r_comment"),
    "nation": ("n_nationkey", "n_name", "n_regionkey", "n_comment"),
    "customer": ("c_custkey", "c_name", "c_address", "c_nationkey",
                 "c_phone", "c_acctbal", "c_mktsegment", "c_comment"),
    "supplier": ("s_suppkey", "s_name", "s_address", "s_nationkey",
                 "s_phone", "s_acctbal", "s_comment"),
    "orders": ("o_orderkey", "o_custkey", "o_orderstatus", "o_totalprice",
               "o_orderdate", "o_orderpriority", "o_clerk",
               "o_shippriority", "o_comment"),
    "lineitem": ("l_orderkey", "l_partkey", "l_suppkey", "l_linenumber",
                 "l_quantity", "l_extendedprice", "l_discount", "l_tax",
                 "l_returnflag", "l_linestatus", "l_shipdate",
                 "l_commitdate", "l_receiptdate", "l_shipinstruct",
                 "l_shipmode", "l_comment"),
}
TABLE_IDS = {name: i for i, name in enumerate(SCHEMA)}
#: draws that several columns share, with stream ids past the columns'
DRAW_IDS = {"n_line": 100, "price_per_unit": 101, "ship_days": 102,
            "receipt_days": 103, "flag_coin": 104}


def sizes(sf: float) -> Dict[str, int]:
    """Rows of the tables that scale (lineitem follows the orders)."""
    return {"customer": max(1, int(150_000 * sf)),
            "orders": max(1, int(1_500_000 * sf)),
            "supplier": max(1, int(10_000 * sf)),
            "part": max(1, int(200_000 * sf))}


def n_pieces(sf: float, table: str) -> int:
    """Pieces of a table: fixed by the scale factor, never by workers."""
    if table in ("region", "nation", "supplier"):
        return 1
    base = "orders" if table == "lineitem" else table
    return -(-sizes(sf)[base] // PIECE_ROWS)


class _Streams:
    """The random streams of one piece of one table."""

    def __init__(self, seed: int, table: str, piece: int):
        self.key = (int(seed), TABLE_IDS[table], int(piece))

    def __call__(self, stream: int) -> np.random.Generator:
        seq = np.random.SeedSequence([abs(self.key[0]), self.key[0] < 0,
                                      self.key[1], stream, self.key[2]])
        return np.random.Generator(np.random.PCG64(seq))

    def col(self, name: str, table: str) -> np.random.Generator:
        return self(SCHEMA[table].index(name))


def _dec(units: np.ndarray, scale: int = 2) -> pa.Array:
    """int64 unscaled units -> decimal128(15, scale), from the 128-bit
    little-endian buffer."""
    lo = units.astype(np.int64)
    raw = np.empty((len(lo), 2), dtype=np.int64)
    raw[:, 0] = lo
    raw[:, 1] = lo >> 63
    return pa.Array.from_buffers(pa.decimal128(15, scale), len(lo),
                                 [None, pa.py_buffer(raw)])


def _date(days: np.ndarray) -> pa.Array:
    return pa.array(days.astype(np.int32), type=pa.int32()).cast(pa.date32())


def _take(values: Sequence[str], codes: np.ndarray) -> pa.Array:
    """Plain strings: `values[codes]`, by Arrow's take."""
    return pa.array(list(values), type=pa.string()).take(
        pa.array(codes.astype(np.int32)))


def _cycled(fmt: str, period: int, index: np.ndarray) -> pa.Array:
    """`fmt.format(i % period)` for each index, by take."""
    return _take([fmt.format(i) for i in range(period)], index % period)


def _numbered(prefix: str, numbers: np.ndarray, width: int) -> pa.Array:
    """`f"{prefix}{n:0{width}d}"` for each number, in Arrow."""
    digits = pc.utf8_lpad(pc.cast(pa.array(numbers), pa.string()), width,
                          padding="0")
    return pc.binary_join_element_wise(prefix, digits, "")


def _phones(index: np.ndarray, suffix: str) -> pa.Array:
    """`f"{10 + i % 25}-{i % 1000:03d}-{suffix}"` for each index."""
    head = pc.cast(pa.array(10 + index % 25), pa.string())
    mid = pc.utf8_lpad(pc.cast(pa.array(index % 1000), pa.string()), 3,
                       padding="0")
    return pc.binary_join_element_wise(head, mid, suffix, "-")


def _orders_draws(sf: float, k: int, seed: int, need: Iterable[str]
                  ) -> Dict[str, np.ndarray]:
    """The per-order draws of orders piece k that lineitem also uses."""
    n_total = sizes(sf)["orders"]
    o0 = k * PIECE_ROWS
    n = max(0, min(PIECE_ROWS, n_total - o0))
    st = _Streams(seed, "orders", k)
    out = {"o0": np.int64(o0), "n": n}
    need = set(need)
    if "o_orderdate" in need:
        out["o_orderdate"] = st.col("o_orderdate", "orders").integers(
            START, END - 121, n).astype(np.int32)
    if "n_line" in need:
        out["n_line"] = st(DRAW_IDS["n_line"]).integers(1, 8, n)
    return out


def _orders(sf: float, k: int, seed: int, columns) -> Dict[str, pa.Array]:
    d = _orders_draws(sf, k, seed, ("o_orderdate",))
    n, o0 = d["n"], d["o0"]
    st = _Streams(seed, "orders", k)
    idx = np.arange(o0, o0 + n, dtype=np.int64)
    n_cust = sizes(sf)["customer"]
    make = {
        "o_orderkey": lambda: pa.array(idx + 1),
        "o_custkey": lambda: pa.array(st.col("o_custkey", "orders").integers(
            1, n_cust + 1, n).astype(np.int64)),
        "o_orderstatus": lambda: _take(STATUSES, st.col(
            "o_orderstatus", "orders").integers(0, 3, n)),
        "o_totalprice": lambda: _dec(st.col("o_totalprice", "orders")
                                     .integers(85000, 55528600, n)),
        "o_orderdate": lambda: _date(d["o_orderdate"]),
        "o_orderpriority": lambda: _take(PRIORITIES, st.col(
            "o_orderpriority", "orders").integers(0, 5, n)),
        "o_clerk": lambda: _numbered("Clerk#", idx % 1000, 9),
        "o_shippriority": lambda: pa.array(np.zeros(n, dtype=np.int32)),
        "o_comment": lambda: _cycled("order comment {}", 79, idx),
    }
    return {c: make[c]() for c in columns}


def _lineitem(sf: float, k: int, seed: int, columns) -> Dict[str, pa.Array]:
    d = _orders_draws(sf, k, seed, ("o_orderdate", "n_line"))
    n_line, o0 = d["n_line"], d["o0"]
    st = _Streams(seed, "lineitem", k)
    n_li = int(n_line.sum())
    sz = sizes(sf)
    memo: Dict[str, np.ndarray] = {}

    def draw(name, fn):
        if name not in memo:
            memo[name] = fn()
        return memo[name]

    def ship():
        odate = np.repeat(d["o_orderdate"], n_line)
        return draw("ship", lambda: odate + st(DRAW_IDS["ship_days"])
                    .integers(1, 122, n_li).astype(np.int32))

    def receipt():
        return draw("receipt", lambda: ship() + st(DRAW_IDS["receipt_days"])
                    .integers(1, 31, n_li).astype(np.int32))

    def qty():
        return draw("qty", lambda: st.col("l_quantity", "lineitem")
                    .integers(1, 51, n_li).astype(np.int64))

    def linenumber():
        starts = np.zeros(len(n_line), dtype=np.int64)
        starts[1:] = np.cumsum(n_line)[:-1]
        return (np.arange(n_li, dtype=np.int64)
                - np.repeat(starts, n_line) + 1).astype(np.int32)

    def returnflag():
        coin = st(DRAW_IDS["flag_coin"]).random(n_li) < 0.5
        return np.where(receipt() <= CUTOFF, np.where(coin, 2, 0), 1)

    def commit():
        odate = np.repeat(d["o_orderdate"], n_line)
        return odate + st.col("l_commitdate", "lineitem").integers(
            30, 91, n_li).astype(np.int32)

    make = {
        "l_orderkey": lambda: pa.array(np.repeat(
            np.arange(o0 + 1, o0 + len(n_line) + 1, dtype=np.int64), n_line)),
        "l_partkey": lambda: pa.array(st.col("l_partkey", "lineitem")
                                      .integers(1, sz["part"] + 1, n_li)),
        "l_suppkey": lambda: pa.array(st.col("l_suppkey", "lineitem")
                                      .integers(1, sz["supplier"] + 1, n_li)),
        "l_linenumber": lambda: pa.array(linenumber()),
        "l_quantity": lambda: _dec(qty() * 100),
        "l_extendedprice": lambda: _dec(qty() * (
            st(DRAW_IDS["price_per_unit"]).integers(90001, 2100001, n_li)
            // 100)),
        "l_discount": lambda: _dec(st.col("l_discount", "lineitem")
                                   .integers(0, 11, n_li)),
        "l_tax": lambda: _dec(st.col("l_tax", "lineitem")
                              .integers(0, 9, n_li)),
        "l_returnflag": lambda: _take(RETURNFLAGS, returnflag()),
        "l_linestatus": lambda: _take(LINESTATUS,
                                      (ship() > CUTOFF).astype(np.int32)),
        "l_shipdate": lambda: _date(ship()),
        "l_commitdate": lambda: _date(commit()),
        "l_receiptdate": lambda: _date(receipt()),
        "l_shipinstruct": lambda: _take(SHIPINSTRUCT, st.col(
            "l_shipinstruct", "lineitem").integers(0, 4, n_li)),
        "l_shipmode": lambda: _take(SHIPMODES, st.col(
            "l_shipmode", "lineitem").integers(0, 7, n_li)),
        "l_comment": lambda: _cycled("li {}", 71, np.arange(
            n_li, dtype=np.int64) + 4 * o0),
    }
    return {c: make[c]() for c in columns}


def _customer(sf: float, k: int, seed: int, columns) -> Dict[str, pa.Array]:
    n_total = sizes(sf)["customer"]
    c0 = k * PIECE_ROWS
    n = max(0, min(PIECE_ROWS, n_total - c0))
    st = _Streams(seed, "customer", k)
    idx = np.arange(c0, c0 + n, dtype=np.int64)
    make = {
        "c_custkey": lambda: pa.array(idx + 1),
        "c_name": lambda: _numbered("Customer#", idx + 1, 9),
        "c_address": lambda: _cycled("addr{}", 1000, idx),
        "c_nationkey": lambda: pa.array(st.col("c_nationkey", "customer")
                                        .integers(0, 25, n)),
        "c_phone": lambda: _phones(idx, "0000"),
        "c_acctbal": lambda: _dec(st.col("c_acctbal", "customer")
                                  .integers(-99999, 999999, n)),
        "c_mktsegment": lambda: _take(SEGMENTS, st.col(
            "c_mktsegment", "customer").integers(0, 5, n)),
        "c_comment": lambda: _cycled("cust comment {}", 97, idx),
    }
    return {c: make[c]() for c in columns}


def _supplier(sf: float, k: int, seed: int, columns) -> Dict[str, pa.Array]:
    n = sizes(sf)["supplier"]
    st = _Streams(seed, "supplier", k)
    idx = np.arange(n, dtype=np.int64)
    make = {
        "s_suppkey": lambda: pa.array(idx + 1),
        "s_name": lambda: _numbered("Supplier#", idx + 1, 9),
        "s_address": lambda: _cycled("saddr{}", 500, idx),
        "s_nationkey": lambda: pa.array(st.col("s_nationkey", "supplier")
                                        .integers(0, 25, n)),
        "s_phone": lambda: _phones(idx, "1111"),
        "s_acctbal": lambda: _dec(st.col("s_acctbal", "supplier")
                                  .integers(-99999, 999999, n)),
        "s_comment": lambda: _cycled("supp comment {}", 89, idx),
    }
    return {c: make[c]() for c in columns}


def _fixed(table: str, columns) -> Dict[str, pa.Array]:
    if table == "region":
        make = {"r_regionkey": lambda: pa.array(np.arange(5, dtype=np.int64)),
                "r_name": lambda: pa.array(REGIONS),
                "r_comment": lambda: pa.array([f"region {r}"
                                               for r in REGIONS])}
    else:
        names = [n for n, _ in NATIONS]
        make = {"n_nationkey": lambda: pa.array(np.arange(25,
                                                          dtype=np.int64)),
                "n_name": lambda: pa.array(names),
                "n_regionkey": lambda: pa.array(np.array(
                    [r for _, r in NATIONS], dtype=np.int64)),
                "n_comment": lambda: pa.array([f"nation {n}"
                                               for n in names])}
    return {c: make[c]() for c in columns}


_MAKERS = {"orders": _orders, "lineitem": _lineitem,
           "customer": _customer, "supplier": _supplier}


def piece(sf: float, table: str, k: int, seed: int,
          columns: Sequence[str]) -> pa.Table:
    """Piece k of `table` at scale `sf`, holding `columns` in schema
    order."""
    columns = [c for c in SCHEMA[table] if c in set(columns)]
    if table in ("region", "nation"):
        arrays = _fixed(table, columns)
    else:
        arrays = _MAKERS[table](sf, k, seed, columns)
    return pa.table({c: arrays[c] for c in columns})


def generate(sf: float, seed: int, columns: Dict[str, Sequence[str]],
             workers: Optional[int] = None) -> Dict[str, pa.Table]:
    """The tables named in `columns` ({table: columns}), each with the
    columns asked for, at scale `sf` from `seed`. Pieces go to `workers`
    threads (default: the cores this process may run on). The result
    does not depend on `workers`."""
    for table, cols in columns.items():
        unknown = set(cols) - set(SCHEMA[table])
        if unknown:
            raise ValueError(f"{table} has no columns {sorted(unknown)}")
    jobs = [(t, k) for t in columns for k in range(n_pieces(sf, t))]
    # the largest pieces first, so the pool's tail is short
    jobs.sort(key=lambda j: (j[0] != "lineitem", j[1]))
    workers = workers or len(os.sched_getaffinity(0)) or 1
    with ThreadPoolExecutor(min(workers, len(jobs))) as pool:
        made = list(pool.map(
            lambda j: piece(sf, j[0], j[1], seed, columns[j[0]]), jobs))
    parts: Dict[str, List[Tuple[int, pa.Table]]] = {t: [] for t in columns}
    for (table, k), t in zip(jobs, made):
        parts[table].append((k, t))
    return {t: pa.concat_tables([p for _, p in sorted(ps, key=lambda x: x[0])])
            for t, ps in parts.items()}
