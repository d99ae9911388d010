"""TPC-H data generator (vectorized numpy -> pyarrow -> Parquet).

Produces the eight TPC-H tables with dbgen-like shapes, types, and value
distributions (row counts scale with `sf`; lineitem ~= 6M rows/sf).
Not bit-identical to dbgen — golden answers are computed on THIS data by
an independent pandas implementation (golden.py), so parity checks are
self-consistent, the pattern of the reference's golden-file SQL tests
(`SQLQueryTestSuite.scala:124`).

Types follow the spec: keys int64, money DECIMAL(15,2), dates DATE32,
flags/names dictionary strings — exercising the engine's scaled-int64
decimal path, date arithmetic, and dictionary tier end to end.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

EPOCH = np.datetime64("1970-01-01", "D")
START = (np.datetime64("1992-01-01", "D") - EPOCH).astype(np.int32)
END = (np.datetime64("1998-08-02", "D") - EPOCH).astype(np.int32)

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


def _dec(x: np.ndarray, scale: int = 2) -> pa.Array:
    """int64 UNSCALED units (cents for scale 2) -> decimal128(15, scale),
    built directly from the little-endian 128-bit buffer (a cast would
    treat the ints as whole units and rescale them)."""
    lo = x.astype(np.int64)
    raw = np.empty((len(lo), 2), dtype=np.int64)
    raw[:, 0] = lo
    raw[:, 1] = lo >> 63  # sign extension
    return pa.Array.from_buffers(pa.decimal128(15, scale), len(lo),
                                 [None, pa.py_buffer(raw.tobytes())])


def _date(days: np.ndarray) -> pa.Array:
    return pa.array(days.astype(np.int32), type=pa.int32()).cast(pa.date32())


def _pick(rs, values, n) -> pa.Array:
    return pa.array(np.array(values)[rs.randint(0, len(values), n)])


def generate(sf: float, seed: int = 42) -> Dict[str, pa.Table]:
    """Generate all eight tables at scale factor `sf`."""
    rs = np.random.RandomState(seed)
    n_cust = max(1, int(150_000 * sf))
    n_ord = max(1, int(1_500_000 * sf))
    n_supp = max(1, int(10_000 * sf))
    n_part = max(1, int(200_000 * sf))

    tables: Dict[str, pa.Table] = {}

    tables["region"] = pa.table({
        "r_regionkey": pa.array(np.arange(5, dtype=np.int64)),
        "r_name": pa.array(REGIONS),
        "r_comment": pa.array([f"region {r}" for r in REGIONS]),
    })

    n_names = [n for n, _ in NATIONS]
    tables["nation"] = pa.table({
        "n_nationkey": pa.array(np.arange(25, dtype=np.int64)),
        "n_name": pa.array(n_names),
        "n_regionkey": pa.array(np.array([r for _, r in NATIONS],
                                         dtype=np.int64)),
        "n_comment": pa.array([f"nation {n}" for n in n_names]),
    })

    c_nation = rs.randint(0, 25, n_cust).astype(np.int64)
    tables["customer"] = pa.table({
        "c_custkey": pa.array(np.arange(1, n_cust + 1, dtype=np.int64)),
        "c_name": pa.array([f"Customer#{i:09d}" for i in range(1, n_cust + 1)]),
        "c_address": pa.array([f"addr{i % 1000}" for i in range(n_cust)]),
        "c_nationkey": pa.array(c_nation),
        "c_phone": pa.array([f"{10 + i % 25}-{i % 1000:03d}-0000"
                             for i in range(n_cust)]),
        "c_acctbal": _dec(rs.randint(-99999, 999999, n_cust)),
        "c_mktsegment": _pick(rs, SEGMENTS, n_cust),
        "c_comment": pa.array([f"cust comment {i % 97}"
                               for i in range(n_cust)]),
    })

    s_nation = rs.randint(0, 25, n_supp).astype(np.int64)
    tables["supplier"] = pa.table({
        "s_suppkey": pa.array(np.arange(1, n_supp + 1, dtype=np.int64)),
        "s_name": pa.array([f"Supplier#{i:09d}"
                            for i in range(1, n_supp + 1)]),
        "s_address": pa.array([f"saddr{i % 500}" for i in range(n_supp)]),
        "s_nationkey": pa.array(s_nation),
        "s_phone": pa.array([f"{10 + i % 25}-{i % 1000:03d}-1111"
                             for i in range(n_supp)]),
        "s_acctbal": _dec(rs.randint(-99999, 999999, n_supp)),
        "s_comment": pa.array([f"supp comment {i % 89}"
                               for i in range(n_supp)]),
    })

    p_retail = (90000 + (np.arange(1, n_part + 1) % 20001) * 10
                + (np.arange(1, n_part + 1) % 1000) * 100).astype(np.int64)
    tables["part"] = pa.table({
        "p_partkey": pa.array(np.arange(1, n_part + 1, dtype=np.int64)),
        "p_name": pa.array([f"part name {i % 1000}" for i in range(n_part)]),
        "p_mfgr": pa.array([f"Manufacturer#{1 + i % 5}"
                            for i in range(n_part)]),
        "p_brand": pa.array([f"Brand#{11 + i % 45}" for i in range(n_part)]),
        "p_type": pa.array([f"TYPE {i % 150}" for i in range(n_part)]),
        "p_size": pa.array((1 + rs.randint(0, 50, n_part)).astype(np.int32)),
        "p_container": pa.array([f"CONTAINER {i % 40}"
                                 for i in range(n_part)]),
        "p_retailprice": _dec(p_retail),
        "p_comment": pa.array([f"part comment {i % 83}"
                               for i in range(n_part)]),
    })

    o_custkey = rs.randint(1, n_cust + 1, n_ord).astype(np.int64)
    o_date = rs.randint(START, END - 121, n_ord).astype(np.int32)
    n_line = rs.randint(1, 8, n_ord)  # 1..7 lines per order, avg 4
    tables["orders"] = pa.table({
        "o_orderkey": pa.array(np.arange(1, n_ord + 1, dtype=np.int64)),
        "o_custkey": pa.array(o_custkey),
        "o_orderstatus": _pick(rs, ["O", "F", "P"], n_ord),
        "o_totalprice": _dec(rs.randint(85000, 55528600, n_ord)),
        "o_orderdate": _date(o_date),
        "o_orderpriority": _pick(rs, PRIORITIES, n_ord),
        "o_clerk": pa.array([f"Clerk#{i % 1000:09d}" for i in range(n_ord)]),
        "o_shippriority": pa.array(np.zeros(n_ord, dtype=np.int32)),
        "o_comment": pa.array([f"order comment {i % 79}"
                               for i in range(n_ord)]),
    })

    # lineitem: expand orders by per-order line counts
    l_orderkey = np.repeat(np.arange(1, n_ord + 1, dtype=np.int64), n_line)
    l_odate = np.repeat(o_date, n_line)
    n_li = len(l_orderkey)
    # linenumber: position within order, vectorized
    starts = np.zeros(n_ord, dtype=np.int64)
    starts[1:] = np.cumsum(n_line)[:-1]
    l_linenumber = (np.arange(n_li, dtype=np.int64)
                    - np.repeat(starts, n_line) + 1).astype(np.int32)

    l_partkey = rs.randint(1, n_part + 1, n_li).astype(np.int64)
    l_suppkey = rs.randint(1, n_supp + 1, n_li).astype(np.int64)
    qty = rs.randint(1, 51, n_li).astype(np.int64)
    price_per_unit = rs.randint(90001, 2100001, n_li).astype(np.int64) // 100
    extended = qty * price_per_unit  # cents
    discount = rs.randint(0, 11, n_li).astype(np.int64)  # 0.00..0.10
    tax = rs.randint(0, 9, n_li).astype(np.int64)  # 0.00..0.08
    ship = l_odate + rs.randint(1, 122, n_li).astype(np.int32)
    commit = l_odate + rs.randint(30, 91, n_li).astype(np.int32)
    receipt = ship + rs.randint(1, 31, n_li).astype(np.int32)
    cutoff = (np.datetime64("1995-06-17", "D") - EPOCH).astype(np.int32)
    returnflag = np.where(receipt <= cutoff,
                          np.where(rs.rand(n_li) < 0.5, "R", "A"), "N")
    linestatus = np.where(ship > cutoff, "O", "F")

    tables["lineitem"] = pa.table({
        "l_orderkey": pa.array(l_orderkey),
        "l_partkey": pa.array(l_partkey),
        "l_suppkey": pa.array(l_suppkey),
        "l_linenumber": pa.array(l_linenumber),
        "l_quantity": _dec(qty * 100),
        "l_extendedprice": _dec(extended),
        "l_discount": _dec(discount),
        "l_tax": _dec(tax),
        "l_returnflag": pa.array(returnflag),
        "l_linestatus": pa.array(linestatus),
        "l_shipdate": _date(ship),
        "l_commitdate": _date(commit),
        "l_receiptdate": _date(receipt),
        "l_shipinstruct": _pick(rs, SHIPINSTRUCT, n_li),
        "l_shipmode": _pick(rs, SHIPMODES, n_li),
        "l_comment": pa.array([f"li {i % 71}" for i in range(n_li)]),
    })

    # partsupp (Q2/Q9/Q11/Q16/Q20 family)
    n_ps = n_part * 4
    ps_part = np.repeat(np.arange(1, n_part + 1, dtype=np.int64), 4)
    ps_supp = ((ps_part + np.tile(np.arange(4, dtype=np.int64), n_part)
                * max(1, n_supp // 4)) % n_supp + 1).astype(np.int64)
    tables["partsupp"] = pa.table({
        "ps_partkey": pa.array(ps_part),
        "ps_suppkey": pa.array(ps_supp),
        "ps_availqty": pa.array(rs.randint(1, 10000, n_ps).astype(np.int32)),
        "ps_supplycost": _dec(rs.randint(100, 100100, n_ps)),
        "ps_comment": pa.array([f"ps comment {i % 67}" for i in range(n_ps)]),
    })
    return tables


def write_parquet(path: str, sf: float, seed: int = 42,
                  overwrite: bool = False) -> str:
    """Write all tables under `path/<table>.parquet`; returns `path`.
    Skips generation when the directory is already populated."""
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


#: the dictionaries of lineitem's string columns in the streamed writer
RETURNFLAGS = ["A", "N", "R"]
LINESTATUS = ["F", "O"]
LINE_COMMENTS = [f"li {i}" for i in range(71)]


def _dict(codes: np.ndarray, values) -> pa.Array:
    return pa.DictionaryArray.from_arrays(
        pa.array(codes.astype(np.int32)), pa.array(values))


def lineitem_piece(sf: float, k: int, pieces: int, seed: int = 42) -> Dict:
    """Piece `k` of `pieces` of a lineitem table at scale `sf`, as numpy
    arrays: the lines of the k-th slice of the orders (keys offset by the
    slice), drawn from `RandomState(seed + k)` with `generate`'s
    distributions. Strings are codes into RETURNFLAGS, LINESTATUS,
    SHIPINSTRUCT, SHIPMODES and LINE_COMMENTS, so no Python string is
    built per row. Money and rates are integer cents/hundredths."""
    n_ord_total = max(1, int(1_500_000 * sf))
    n_part = max(1, int(200_000 * sf))
    n_supp = max(1, int(10_000 * sf))
    per = -(-n_ord_total // pieces)
    o0 = k * per
    n_ord = max(0, min(per, n_ord_total - o0))
    rs = np.random.RandomState(seed + k)
    o_date = rs.randint(START, END - 121, n_ord).astype(np.int32)
    n_line = rs.randint(1, 8, n_ord)
    orderkey = np.repeat(np.arange(o0 + 1, o0 + n_ord + 1, dtype=np.int64),
                         n_line)
    odate = np.repeat(o_date, n_line)
    n_li = len(orderkey)
    starts = np.zeros(n_ord, dtype=np.int64)
    starts[1:] = np.cumsum(n_line)[:-1]
    linenumber = (np.arange(n_li, dtype=np.int64)
                  - np.repeat(starts, n_line) + 1).astype(np.int32)
    partkey = rs.randint(1, n_part + 1, n_li).astype(np.int64)
    suppkey = rs.randint(1, n_supp + 1, n_li).astype(np.int64)
    qty = rs.randint(1, 51, n_li).astype(np.int64)
    extended = qty * (rs.randint(90001, 2100001, n_li).astype(np.int64)
                      // 100)
    discount = rs.randint(0, 11, n_li).astype(np.int64)
    tax = rs.randint(0, 9, n_li).astype(np.int64)
    ship = odate + rs.randint(1, 122, n_li).astype(np.int32)
    commit = odate + rs.randint(30, 91, n_li).astype(np.int32)
    receipt = ship + rs.randint(1, 31, n_li).astype(np.int32)
    cutoff = (np.datetime64("1995-06-17", "D") - EPOCH).astype(np.int32)
    returnflag = np.where(receipt <= cutoff,
                          np.where(rs.rand(n_li) < 0.5, 2, 0), 1)
    linestatus = (ship > cutoff).astype(np.int32)
    return {
        "orderkey": orderkey, "partkey": partkey, "suppkey": suppkey,
        "linenumber": linenumber, "qty": qty, "extended": extended,
        "discount": discount, "tax": tax, "ship": ship, "commit": commit,
        "receipt": receipt, "returnflag": returnflag,
        "linestatus": linestatus,
        "shipinstruct": rs.randint(0, len(SHIPINSTRUCT), n_li),
        "shipmode": rs.randint(0, len(SHIPMODES), n_li),
        "comment": (np.arange(n_li, dtype=np.int64) + o0) % 71}


def lineitem_table(p: Dict) -> pa.Table:
    """A lineitem piece as an Arrow table with `generate`'s schema (the
    string columns dictionary-encoded)."""
    return pa.table({
        "l_orderkey": pa.array(p["orderkey"]),
        "l_partkey": pa.array(p["partkey"]),
        "l_suppkey": pa.array(p["suppkey"]),
        "l_linenumber": pa.array(p["linenumber"]),
        "l_quantity": _dec(p["qty"] * 100),
        "l_extendedprice": _dec(p["extended"]),
        "l_discount": _dec(p["discount"]),
        "l_tax": _dec(p["tax"]),
        "l_returnflag": _dict(p["returnflag"], RETURNFLAGS),
        "l_linestatus": _dict(p["linestatus"], LINESTATUS),
        "l_shipdate": _date(p["ship"]),
        "l_commitdate": _date(p["commit"]),
        "l_receiptdate": _date(p["receipt"]),
        "l_shipinstruct": _dict(p["shipinstruct"], SHIPINSTRUCT),
        "l_shipmode": _dict(p["shipmode"], SHIPMODES),
        "l_comment": _dict(p["comment"], LINE_COMMENTS),
    })


def write_lineitem_pieces(path: str, sf: float, seed: int = 42,
                          pieces: int = 0, on_piece=None,
                          row_group_rows: int = 1 << 20) -> str:
    """Write lineitem alone at scale `sf` to `path` (one Parquet file) in
    pieces of about one scale-factor unit each, so that host memory stays
    bounded at any scale: SF10 is ten pieces of about 6M rows, written as
    row groups of `row_group_rows` through one ParquetWriter.
    `on_piece(arrays)` sees each piece's numpy arrays
    (`lineitem_piece`), for answers computed alongside. `generate` and
    `write_parquet` are untouched: this table is not theirs row for
    row."""
    pieces = pieces or max(1, int(round(sf)))
    writer = None
    try:
        for k in range(pieces):
            p = lineitem_piece(sf, k, pieces, seed)
            if on_piece is not None:
                on_piece(p)
            table = lineitem_table(p)
            if writer is None:
                writer = pq.ParquetWriter(path, table.schema)
            writer.write_table(table, row_group_size=row_group_rows)
    finally:
        if writer is not None:
            writer.close()
    return path
