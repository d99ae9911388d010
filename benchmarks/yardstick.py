"""The benchmark's yardstick: exact arithmetic for the plain references,
the comparison that decides `correct`, and the byte bound of a query.

Plain NumPy and pyarrow. Nothing here imports the program under test, so
a change to the program cannot move what it is measured against.
"""

from __future__ import annotations

import datetime
import math
from dataclasses import dataclass, field
from decimal import Decimal
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

#: one H100 SXM's HBM3 bandwidth (NVIDIA data sheet), bytes a second
PEAK_BYTES_PER_S = 3.35e12
EPOCH = datetime.date(1970, 1, 1)


def day(text: str) -> int:
    """Days since 1970-01-01 of an ISO date."""
    return (datetime.date.fromisoformat(text) - EPOCH).days


def add_months(text: str, months: int) -> int:
    d = datetime.date.fromisoformat(text)
    m = d.month - 1 + months
    return (datetime.date(d.year + m // 12, m % 12 + 1, d.day) - EPOCH).days


def as_date(days: int) -> datetime.date:
    return EPOCH + datetime.timedelta(days=int(days))


class Tables:
    """The generated Arrow tables with memoised NumPy views of their
    columns: integers as int64, decimals as their unscaled int64 units,
    dates as int32 days, strings as codes into a sorted dictionary."""

    def __init__(self, tables: Dict[str, pa.Table]):
        self.arrow = tables
        self._memo: Dict[Tuple[str, str, str], object] = {}

    def rows(self, table: str) -> int:
        return self.arrow[table].num_rows

    def _column(self, table: str, col: str) -> pa.Array:
        return self.arrow[table].column(col).combine_chunks()

    def ints(self, table: str, col: str) -> np.ndarray:
        key = (table, col, "ints")
        if key not in self._memo:
            chunks = self.arrow[table].column(col).chunks
            typ = self.arrow[table].schema.field(col).type
            if pa.types.is_decimal(typ):
                parts = []
                for arr in chunks:
                    raw = np.frombuffer(arr.buffers()[1], dtype=np.int64)
                    pairs = raw.reshape(-1, 2)[
                        arr.offset:arr.offset + len(arr)]
                    if not np.array_equal(pairs[:, 1], pairs[:, 0] >> 63):
                        raise ValueError(f"{table}.{col} exceeds int64 units")
                    parts.append(pairs[:, 0])
                out = np.concatenate(parts) if parts else \
                    np.zeros(0, dtype=np.int64)
            elif pa.types.is_date32(typ):
                out = np.concatenate(
                    [a.cast(pa.int32()).to_numpy(zero_copy_only=False)
                     for a in chunks] or [np.zeros(0, np.int32)])
            else:
                out = np.concatenate(
                    [a.to_numpy(zero_copy_only=False).astype(np.int64)
                     for a in chunks] or [np.zeros(0, np.int64)])
            self._memo[key] = out
        return self._memo[key]

    def codes(self, table: str, col: str) -> Tuple[np.ndarray, List[str]]:
        """(codes, dictionary): `dictionary[codes[i]]` is row i's value;
        the dictionary is sorted."""
        key = (table, col, "codes")
        if key not in self._memo:
            enc = pc.dictionary_encode(self._column(table, col))
            values = enc.dictionary.to_pylist()
            order = sorted(range(len(values)), key=values.__getitem__)
            rank = np.empty(len(values), dtype=np.int32)
            rank[order] = np.arange(len(values), dtype=np.int32)
            codes = rank[enc.indices.to_numpy(zero_copy_only=False)]
            self._memo[key] = (codes, [values[i] for i in order])
        return self._memo[key]

    def equals(self, table: str, col: str, value: str) -> np.ndarray:
        codes, values = self.codes(table, col)
        if value not in values:
            return np.zeros(len(codes), dtype=bool)
        return codes == values.index(value)

    def strings(self, table: str, col: str) -> List[str]:
        key = (table, col, "strings")
        if key not in self._memo:
            self._memo[key] = self._column(table, col).to_pylist()
        return self._memo[key]


def positions(keys: np.ndarray, lookup: np.ndarray) -> np.ndarray:
    """For each value of `lookup`, its row in `keys` (a unique key
    column), or -1 where the key is absent."""
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    if len(sk) > 1 and np.any(sk[1:] == sk[:-1]):
        raise ValueError("join key is not unique")
    at = np.searchsorted(sk, lookup)
    at_c = np.minimum(at, max(len(sk) - 1, 0))
    hit = (at < len(sk)) & (sk[at_c] == lookup) if len(sk) else \
        np.zeros(len(lookup), dtype=bool)
    return np.where(hit, order[at_c], -1)


def group_sums(groups: np.ndarray, values: np.ndarray, n_groups: int
               ) -> np.ndarray:
    """Exact sums of int64 `values` by group id (0..n_groups-1), as an
    object array of Python ints. Float64 adds integers exactly while
    every partial sum stays under 2^53, so the values are summed whole
    where they are small enough, and otherwise cut into limbs that are."""
    total = np.zeros(n_groups, dtype=object)
    n = len(values)
    if n == 0:
        return total
    if n >= 1 << 31:
        raise ValueError("too many rows for exact sums")
    lo, hi = int(values.min()), int(values.max())
    if max(abs(lo), abs(hi)) * n < 1 << 53:
        sums = np.bincount(groups, weights=values.astype(np.float64),
                           minlength=n_groups)
        return sums.astype(np.int64).astype(object)
    bits = 53 - n.bit_length()
    shifted = (values - lo).astype(np.uint64)
    for limb in range(-(-(hi - lo).bit_length() // bits)):
        part = ((shifted >> np.uint64(bits * limb))
                & np.uint64((1 << bits) - 1)).astype(np.float64)
        sums = np.bincount(groups, weights=part, minlength=n_groups)
        total = total + (sums.astype(np.int64).astype(object)
                         << (bits * limb))
    counts = np.bincount(groups, minlength=n_groups).astype(object)
    return total + counts * lo


def float_sums(groups: np.ndarray, values: np.ndarray, n_groups: int
               ) -> np.ndarray:
    """Sums of float `values` by group id, accumulated in their own
    precision, row after row (the control)."""
    if values.dtype == np.float64:
        return np.bincount(groups, weights=values, minlength=n_groups)
    out = np.zeros(n_groups, dtype=values.dtype)
    if len(values) == 0:
        return out
    order = np.argsort(groups, kind="stable")
    g = groups[order]
    starts = np.nonzero(np.r_[True, g[1:] != g[:-1]])[0]
    out[g[starts]] = np.add.reduceat(values[order], starts)
    return out


def hundredths(units: np.ndarray, dtype) -> np.ndarray:
    """Scale-2 decimal units as floats of `dtype` (the control's
    inputs)."""
    return units.astype(dtype) / dtype(100)


def div_half_up(num: int, den: int) -> int:
    """num / den rounded half away from zero (Spark's HALF_UP)."""
    q, r = divmod(abs(num), abs(den))
    if 2 * r >= abs(den):
        q += 1
    return q if (num >= 0) == (den > 0) else -q


def dec(units: int, scale: int) -> Decimal:
    """Unscaled integer units as a Decimal of that scale."""
    return Decimal(int(units)).scaleb(-scale)


def dec_from_float(x: float, scale: int) -> Decimal:
    """A float rounded half up to `scale` places (the control's cast)."""
    return Decimal(float(x)).quantize(Decimal(1).scaleb(-scale),
                               rounding="ROUND_HALF_UP")


@dataclass
class Expected:
    """A query's exact answer: its rows in order, and, where the order
    leaves ties, the positions of the sort key (`sort_key`) with every
    reference row that shares a returned row's key (`ties`), any of which
    is a right answer there."""
    rows: List[tuple]
    sort_key: Optional[Sequence[int]] = None
    ties: Dict[tuple, set] = field(default_factory=dict)


def to_rows(table: pa.Table) -> List[tuple]:
    return [tuple(r.values()) for r in table.to_pylist()]


def _same(a, b) -> bool:
    return type(a) is type(b) and a == b


def wrong_values(got: List[tuple], want: Expected) -> int:
    """Values of `got` that differ from the exact answer: every value of
    a row that is missing, extra or wrong counts once; a row that differs
    from its place's row only among rows tied on the sort key, and is one
    of them, is right."""
    width = max([len(r) for r in want.rows] + [len(r) for r in got] + [1])
    bad = abs(len(got) - len(want.rows)) * width
    for g, w in zip(got, want.rows):
        if len(g) == len(w) and all(_same(a, b) for a, b in zip(g, w)):
            continue
        if want.sort_key is not None and len(g) == len(w):
            key = tuple(w[i] for i in want.sort_key)
            if tuple(g[i] for i in want.sort_key) == key and \
                    any(all(_same(a, b) for a, b in zip(g, t))
                        for t in want.ties.get(key, ())):
                continue
        bad += sum(1 for a, b in zip(g, w) if not _same(a, b)) \
            + abs(len(g) - len(w))
    return bad


def top_rows(rows: List[tuple], key, limit: Optional[int],
             sort_key: Sequence[int]) -> Expected:
    """The first `limit` of `rows` by `key`, with the rows that tie with
    them on the positions `sort_key`."""
    ordered = sorted(rows, key=key)
    chosen = ordered if limit is None else ordered[:limit]
    keys = {tuple(r[i] for i in sort_key) for r in chosen}
    ties: Dict[tuple, set] = {}
    for r in ordered:
        k = tuple(r[i] for i in sort_key)
        if k in keys:
            ties.setdefault(k, set()).add(r)
    return Expected(chosen, list(sort_key), ties)


def width_bytes(values: np.ndarray) -> int:
    """The fewest whole bytes that hold every value of an integer column:
    the count of steps between its least and greatest value, in units of
    the greatest common divisor of its differences."""
    if len(values) == 0:
        return 0
    lo, hi = int(values.min()), int(values.max())
    if lo == hi:
        return 1
    diffs = values - lo
    step = int(np.gcd.reduce(diffs[:1 << 16]))
    if step > 1 and np.any(diffs % step):
        step = int(np.gcd.reduce(diffs))
    levels = (hi - lo) // max(step, 1) + 1
    return max(1, math.ceil(math.log2(levels) / 8))


class Widths:
    """Byte widths of the columns of generated tables, memoised: an
    integer, decimal or date column by `width_bytes`, a string column by
    the codes of its distinct values."""

    def __init__(self, tables: Tables):
        self.t = tables
        self._memo: Dict[Tuple[str, str], int] = {}

    def __call__(self, table: str, col: str) -> int:
        key = (table, col)
        if key not in self._memo:
            typ = self.t.arrow[table].schema.field(col).type
            if pa.types.is_string(typ) or pa.types.is_large_string(typ):
                n = len(self.t.codes(table, col)[1])
                self._memo[key] = max(1, math.ceil(math.log2(max(n, 2)) / 8))
            else:
                self._memo[key] = width_bytes(self.t.ints(table, col))
        return self._memo[key]


def scan_bytes(widths: Widths, table: str, rows: int,
               columns: Sequence[str]) -> int:
    """`rows` surviving rows of `table`, each column read once."""
    return int(rows) * sum(widths(table, c) for c in columns)


def result_bytes(rows: List[tuple]) -> int:
    """The result written once: 8 bytes a number or date, a string's
    UTF-8 length."""
    total = 0
    for r in rows:
        for v in r:
            total += len(v.encode()) if isinstance(v, str) else 8
    return total
