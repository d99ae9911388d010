"""Differential optimizer fuzzer: seed-deterministic query generation
and optimizer-on / optimizer-off / per-rule-ablated execution parity
(the port of `spark_tpu/testing/plan_fuzz.py`).

Each seed deterministically generates a small table set (nulls
everywhere, NaN / -0.0 / +-inf floats, decimals, dictionary-encodable
strings, dates) and a random query tree (project / filter / join /
aggregate / sort / limit / union / distinct, with a SQL-text round-trip
for a slice of seeds), then runs it:

- optimizer OFF (`spark_tpu.sql.optimizer.excludedRules=*`), the
  semantics baseline;
- optimizer ON;
- per-rule ABLATED: rules that were effective in the ON run are
  excluded one at a time, so a wrong rewrite shows up as a parity break
  attributable to the excluded rule;
- planned twice: the optimized tree and the physical `tree_string()`
  must be identical across repeated planning.

For one seed the generator makes the same draws from
`random.Random(seed)` as the JAX package's copy, so both packages build
the same tables and the same query: a seed replays across packages.
The JAX package also validates every rule application
(`planChangeValidation`); the port has no validator yet.

Results compare via a canonical byte serialization: rows sorted by a
total order built from value BIT PATTERNS (so -0.0 vs 0.0 and value
drift are caught; NaN payloads are canonicalized). Schema names and
arrow types compare; arrow-level nullability does not. `same_result`
decides the same equality with Arrow sorts over the same keys, which
keeps results of millions of rows (a join on the shared key `k` at a
large maxRows) cheap to compare.
"""

from __future__ import annotations

import datetime
import decimal
import math
import random
import struct
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

SEEDS_KEY = "spark_tpu.sql.fuzz.seeds"
MAX_ROWS_KEY = "spark_tpu.sql.fuzz.maxRows"
EXCLUDED_KEY = "spark_tpu.sql.optimizer.excludedRules"

#: column-name pool shared across generated tables ON PURPOSE: name
#: collisions exercise the join `_r` rename chains
_COL_POOL = ("a", "b", "c", "d", "e", "f")
_STR_VOCAB = ("", "x", "y", "zz", "AA", "x", "mixed", "Mixed", "q")
_FLOAT_SPECIALS = (float("nan"), -0.0, 0.0, float("inf"), float("-inf"),
                   1.5, -2.25, 1e300, -1e-300)


class FuzzMismatch(AssertionError):
    """One seed's differential failure: which comparison broke and how."""

    def __init__(self, seed: int, stage: str, message: str):
        self.seed = seed
        self.stage = stage
        super().__init__(f"seed {seed} [{stage}]: {message}")


# ---------------------------------------------------------------------------
# Deterministic data generation
# ---------------------------------------------------------------------------


def _gen_column(rng: random.Random, dtype: str, n: int):
    """(values, arrow type) with ~15% nulls and adversarial values."""
    null_p = rng.choice((0.0, 0.15, 0.3))
    vals: list = []
    for _ in range(n):
        if rng.random() < null_p:
            vals.append(None)
        elif dtype == "int32":
            vals.append(rng.randint(-50, 50))
        elif dtype == "int64":
            vals.append(rng.choice((rng.randint(-1000, 1000),
                                    rng.randint(-3, 3))))
        elif dtype == "float64":
            vals.append(rng.choice(_FLOAT_SPECIALS)
                        if rng.random() < 0.4 else
                        rng.uniform(-100, 100))
        elif dtype == "decimal":
            vals.append(decimal.Decimal(rng.randint(-10**6, 10**6))
                        .scaleb(-2))
        elif dtype == "string":
            vals.append(rng.choice(_STR_VOCAB))
        else:  # date
            vals.append(datetime.date(1970, 1, 1)
                        + datetime.timedelta(days=rng.randint(-400, 400)))
    at = {"int32": pa.int32(), "int64": pa.int64(),
          "float64": pa.float64(), "decimal": pa.decimal128(12, 2),
          "string": pa.string(), "date": pa.date32()}[dtype]
    return vals, at


def gen_tables(rng: random.Random, max_rows: int
               ) -> Dict[str, pa.Table]:
    """1-3 tables over a shared column-name pool. Every table carries an
    int32 join key `k` over a small domain so generated joins always
    have a type-compatible, collision-rich key."""
    tables: Dict[str, pa.Table] = {}
    for ti in range(rng.randint(1, 3)):
        n_rows = rng.randint(3, max(3, max_rows))
        cols = rng.sample(_COL_POOL, rng.randint(2, 4))
        arrays, fields = [], []
        kvals = [None if rng.random() < 0.1 else rng.randint(0, 7)
                 for _ in range(n_rows)]
        arrays.append(pa.array(kvals, pa.int32()))
        fields.append(pa.field("k", pa.int32()))
        for cn in cols:
            dtype = rng.choice(("int32", "int64", "float64", "decimal",
                                "string", "date"))
            vals, at = _gen_column(rng, dtype, n_rows)
            arrays.append(pa.array(vals, at))
            fields.append(pa.field(cn, at))
        tables[f"fz{ti}"] = pa.Table.from_arrays(
            arrays, schema=pa.schema(fields))
    return tables


# ---------------------------------------------------------------------------
# Deterministic query generation
# ---------------------------------------------------------------------------


def _numeric_cols(df) -> List[str]:
    from .. import types as T
    return [f.name for f in df.schema.fields
            if isinstance(f.dtype, T.NumericType)]


def _int_cols(df) -> List[str]:
    from .. import types as T
    return [f.name for f in df.schema.fields
            if isinstance(f.dtype, T.IntegralType)]


def _gen_predicate(rng: random.Random, df):
    from .. import functions as F
    from .. import types as T
    from ..expr import And, Or
    fields = list(df.schema.fields)
    rng.shuffle(fields)

    def one(f):
        c = F.col(f.name)
        if isinstance(f.dtype, T.StringType):
            return c == F.lit(rng.choice(_STR_VOCAB))
        if isinstance(f.dtype, T.DateType):
            pivot = datetime.date(1970, 1, 1) + datetime.timedelta(
                days=rng.randint(-400, 400))
            return rng.choice((c < F.lit(pivot), c >= F.lit(pivot)))
        if isinstance(f.dtype, T.DecimalType):
            lit = F.lit(decimal.Decimal(rng.randint(-10**6, 10**6))
                        .scaleb(-2), f.dtype)
            return rng.choice((c <= lit, c > lit))
        lit = F.lit(rng.randint(-40, 40))
        op = rng.randrange(4)
        return (c > lit if op == 0 else c < lit if op == 1
                else c == lit if op == 2 else c != lit)

    pred = one(fields[0])
    if len(fields) > 1 and rng.random() < 0.4:
        combine = And if rng.random() < 0.7 else Or
        pred = combine(pred, one(fields[1]))
    return pred


def _gen_aggs(rng: random.Random, df, tag: int) -> list:
    """Aggregate list with `tag`-qualified aliases so stacked
    aggregations can't collide with group columns produced by an
    earlier aggregation step."""
    from .. import functions as F
    aggs = [F.count("*").alias(f"cnt{tag}")]
    nums = _numeric_cols(df)
    rng.shuffle(nums)
    for i, cn in enumerate(nums[:2]):
        fn = rng.choice((F.sum, F.min, F.max, F.avg))
        aggs.append(fn(F.col(cn)).alias(f"ag{tag}_{i}"))
    return aggs


def gen_query(rng: random.Random, session, tables: Dict[str, pa.Table]):
    """One random DataFrame query over the registered tables; the op
    sequence, expressions and literals are all drawn from `rng`, so a
    seed fully determines the plan."""
    from .. import functions as F
    names = sorted(tables)
    df = session.table(rng.choice(names))
    n_ops = rng.randint(1, 5)
    joined = False
    for step in range(n_ops):
        op = rng.choice(("project", "filter", "filter", "join", "agg",
                         "sort", "limit", "union", "distinct"))
        cols = df.columns
        if op == "project":
            keep = rng.sample(cols, rng.randint(1, len(cols)))
            exprs = [F.col(c) for c in keep]
            nums = _numeric_cols(df)
            if nums and rng.random() < 0.6:
                cn = rng.choice(nums)
                e = F.col(cn) + F.lit(rng.randint(1, 5)) \
                    if rng.random() < 0.5 else \
                    F.col(cn) * F.lit(rng.randint(-3, 3))
                exprs.append(e.alias(f"p{step}"))
            df = df.select(*exprs)
        elif op == "filter":
            df = df.filter(_gen_predicate(rng, df))
        elif op == "join" and not joined and "k" in cols:
            other = session.table(rng.choice(names))
            if "k" not in other.columns:
                continue
            how = rng.choice(("inner", "inner", "left", "right", "full",
                              "left_semi", "left_anti"))
            if rng.random() < 0.5:
                df = df.join(other, on="k", how=how)
            else:
                df = df.join(other, left_on=F.col("k"),
                             right_on=F.col("k"), how=how)
            joined = True
        elif op == "agg":
            group_pool = [c for c in cols
                          if rng.random() < 0.8] or cols[:1]
            groups = [F.col(c) for c in
                      rng.sample(group_pool,
                                 rng.randint(1, min(2, len(group_pool))))]
            df = df.group_by(*groups).agg(*_gen_aggs(rng, df, step))
        elif op == "sort":
            from ..expr import SortOrder
            keys = rng.sample(cols, rng.randint(1, min(2, len(cols))))
            df = df.sort(*[SortOrder(F.col(c),
                                     ascending=rng.random() < 0.7)
                           for c in keys])
        elif op == "limit":
            df = df.limit(rng.randint(0, 30))
        elif op == "union":
            df = df.union(df.filter(_gen_predicate(rng, df))
                          if rng.random() < 0.5 else df)
        elif op == "distinct":
            df = df.distinct()
    return df


def gen_sql(rng: random.Random, tables: Dict[str, pa.Table]
            ) -> Optional[str]:
    """A SQL-text round-trip case over the same generated tables:
    single-table select/where/group/order/limit or a two-table
    key-equi-join — the frontend slice the parser supports."""
    names = sorted(tables)
    t0 = rng.choice(names)
    # exclude `k` — the SELECT templates already project k, and a
    # duplicate projection (`SELECT k, k`) is legal but defeats the
    # zero-findings assertion the fuzzer makes about its own queries
    int_cols = [f.name for f in tables[t0].schema
                if pa.types.is_integer(f.type) and f.name != "k"]
    if not int_cols:
        return None
    key = rng.choice(int_cols)
    if len(names) > 1 and rng.random() < 0.4:
        t1 = rng.choice([n for n in names if n != t0])
        if "k" not in [f.name for f in tables[t1].schema]:
            return None
        return (f"SELECT {t0}.k, COUNT(*) AS cnt FROM {t0} "
                f"JOIN {t1} ON {t0}.k = {t1}.k "
                f"GROUP BY {t0}.k ORDER BY {t0}.k")
    shape = rng.randrange(3)
    if shape == 0:
        return (f"SELECT k, {key} FROM {t0} "
                f"WHERE {key} > {rng.randint(-20, 20)} ORDER BY k, {key}")
    if shape == 1:
        return (f"SELECT k, COUNT(*) AS cnt, SUM({key}) AS s FROM {t0} "
                f"GROUP BY k ORDER BY k")
    return (f"SELECT {key} + 1 AS kp FROM {t0} ORDER BY kp "
            f"LIMIT {rng.randint(0, 20)}")


# ---------------------------------------------------------------------------
# Canonical result serialization
# ---------------------------------------------------------------------------


def _keyval(v) -> tuple:
    """Total-order sort/serialization key distinguishing bit patterns
    (-0.0 vs 0.0) while canonicalizing NaN payloads."""
    if v is None:
        return (0,)
    if isinstance(v, bool):
        return (1, int(v))
    if isinstance(v, int):
        return (2, v)
    if isinstance(v, float):
        if v != v:
            return (3, "nan")
        return (3, struct.pack("<d", v).hex())
    if isinstance(v, decimal.Decimal):
        return (4, str(v))
    if isinstance(v, str):
        return (5, v)
    if isinstance(v, datetime.datetime):
        return (6, v.isoformat())
    if isinstance(v, datetime.date):
        return (6, v.isoformat())
    return (9, repr(v))


def _header(table: pa.Table) -> str:
    return repr([(f.name, str(f.type)) for f in table.schema])


def _canonical_rows(table: pa.Table) -> Tuple[str, list]:
    cols = [table.column(i).to_pylist()
            for i in range(table.num_columns)]
    return _header(table), sorted(tuple(_keyval(c[r]) for c in cols)
                                  for r in range(table.num_rows))


def canonical_bytes(table: pa.Table) -> bytes:
    """Order-independent, bit-exact serialization of a result table:
    schema (names + arrow types), then rows sorted by total-order keys."""
    header, rows = _canonical_rows(table)
    return (header + "|" + repr(rows)).encode()


#: the one bit pattern every NaN gets in `canonical_table`
_NAN_BITS = np.array([np.nan]).view(np.int64)[0]


def _key_columns(col) -> Optional[list]:
    """Sort-key arrays of one result column, which are equal exactly
    where `_keyval` is: a NULL flag, then floats as their bit patterns
    (NaN payloads canonicalized), decimals as their unscaled 128-bit
    values, strings as themselves and the other types as int64. None for
    a type without such a form."""
    arr = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
    t = arr.type
    valid = arr.is_valid().to_numpy(zero_copy_only=False)
    keys: list = [(~valid).astype(np.int8)]
    if pa.types.is_floating(t):
        x = pc.fill_null(arr, 0).to_numpy(zero_copy_only=False) \
            .astype(np.float64)
        bits = x.view(np.int64).copy()
        bits[np.isnan(x)] = _NAN_BITS
        keys.append(bits)
    elif pa.types.is_decimal(t) and t.bit_width == 128:
        filled = pc.fill_null(arr, pa.scalar(0, t))
        raw = np.frombuffer(filled.buffers()[1], dtype=np.int64)[
            2 * filled.offset:2 * (filled.offset + len(filled))]
        keys += [raw[1::2].copy(), raw[0::2].copy()]
    elif pa.types.is_string(t) or pa.types.is_large_string(t):
        keys.append(pc.fill_null(arr, ""))
    elif pa.types.is_integer(t) or pa.types.is_boolean(t) \
            or pa.types.is_date32(t):
        ints = arr.view(pa.int32()) if pa.types.is_date32(t) else arr
        keys.append(pc.fill_null(ints.cast(pa.int64()), 0)
                    .to_numpy(zero_copy_only=False))
    else:
        return None
    return keys


def canonical_table(table: pa.Table) -> Optional[pa.Table]:
    """The rows of `table` as sort keys (`_key_columns`) in a total order:
    two results have equal canonical tables exactly when their
    `canonical_bytes` are equal, but the work is Arrow sorts and numpy
    views rather than Python objects per value. None when a column's
    type has no key form."""
    arrays = []
    for i in range(table.num_columns):
        keys = _key_columns(table.column(i))
        if keys is None:
            return None
        arrays += keys
    t = pa.table({f"c{i}": a for i, a in enumerate(arrays)})
    order = pc.sort_indices(t, sort_keys=[(n, "ascending")
                                          for n in t.column_names])
    return t.take(order)


def same_result(a: pa.Table, b: pa.Table) -> bool:
    """`canonical_bytes(a) == canonical_bytes(b)`, fast for large
    results."""
    if _header(a) != _header(b) or a.num_rows != b.num_rows:
        return False
    ka, kb = canonical_table(a), canonical_table(b)
    if ka is None or kb is None:
        return canonical_bytes(a) == canonical_bytes(b)
    return ka.equals(kb)


#: float tolerance across packages and devices: sums and averages add in
#: another order there, so their last bits may differ
FLOAT_RTOL = 1e-12
FLOAT_ATOL = 1e-9


def _float_close(a: tuple, b: tuple, rtol: float, atol: float) -> bool:
    """Two float keyvals within tolerance. NaN, infinities and zeros
    must match bit for bit (-0.0 against 0.0 is a difference)."""
    if a[0] != 3 or b[0] != 3 or "nan" in (a[1], b[1]):
        return False
    x = struct.unpack("<d", bytes.fromhex(a[1]))[0]
    y = struct.unpack("<d", bytes.fromhex(b[1]))[0]
    if not (math.isfinite(x) and math.isfinite(y)) or x == 0.0 or y == 0.0:
        return False
    return abs(x - y) <= atol + rtol * abs(y)


def result_mismatch(got: pa.Table, want: pa.Table,
                    rtol: float = FLOAT_RTOL,
                    atol: float = FLOAT_ATOL) -> Optional[str]:
    """None when `got` equals `want` as `canonical_bytes` compares them,
    except that finite nonzero floats may differ within `atol + rtol *
    |want|`; else a description of the first difference."""
    if same_result(got, want):
        return None
    g_head, g_rows = _canonical_rows(got)
    w_head, w_rows = _canonical_rows(want)
    if g_head != w_head:
        return f"schema {g_head} != {w_head}"
    if len(g_rows) != len(w_rows):
        return f"{len(g_rows)} rows != {len(w_rows)}"
    for g, w in zip(g_rows, w_rows):
        for gv, wv in zip(g, w):
            if gv != wv and not _float_close(gv, wv, rtol, atol):
                return f"row {g} != {w}"
    return None


# ---------------------------------------------------------------------------
# The differential harness
# ---------------------------------------------------------------------------


def gen_case(rng: random.Random, session, max_rows: int):
    """(tables, sql or None, DataFrame) of one seed: generate the tables,
    register them, then draw a SQL text for about a quarter of the seeds
    and a DataFrame query for the rest (the JAX package's draw order)."""
    tables = gen_tables(rng, max_rows)
    for name, tbl in tables.items():
        session.register_table(name, tbl)
    sql = None
    if rng.random() < 0.25:
        sql = gen_sql(rng, tables)
    df = session.sql(sql) if sql else gen_query(rng, session, tables)
    return tables, sql, df


def _collect(df) -> Tuple[pa.Table, object, str]:
    """Collect one fresh QueryExecution; the physical `tree_string()` is
    captured BEFORE execution because the re-plan loop legitimately
    changes node state after the fact."""
    qe = df._qe()
    desc = qe.executed_plan.tree_string()
    table = qe.collect()
    return table, qe, desc


def run_seed(session, seed: int, ablate: str = "effective",
             max_rows: Optional[int] = None) -> Dict:
    """Run one seed's differential checks. Returns a summary dict;
    raises `FuzzMismatch` on a parity or stability break. Session conf
    is snapshotted and restored."""
    if ablate not in ("none", "one", "effective", "all"):
        raise ValueError(f"invalid ablate mode {ablate!r}")
    conf = session.conf
    saved = dict(conf._settings)
    rng = random.Random(seed)
    try:
        _, sql, df = gen_case(rng, session, int(
            max_rows if max_rows is not None else conf.get(MAX_ROWS_KEY)))

        # baseline: optimizer off
        conf.set(EXCLUDED_KEY, "*")
        base, _, _ = _collect(df)

        conf.set(EXCLUDED_KEY, "")
        on, qe, on_desc = _collect(df)
        if not same_result(on, base):
            raise FuzzMismatch(
                seed, "optimizer-parity",
                f"optimizer-on result differs from optimizer-off "
                f"baseline\nplan:\n{qe.optimized_plan.tree_string()}\n"
                f"sql: {sql!r}")
        trace = qe.rule_trace or []

        # repeated planning: optimized tree and physical plan string
        # must be identical run to run
        qe2 = df._qe()
        if qe2.optimized_plan.tree_string() != \
                qe.optimized_plan.tree_string():
            raise FuzzMismatch(seed, "plan-stability",
                               "optimized plan differs across planning "
                               "runs")
        if qe2.executed_plan.tree_string() != on_desc:
            raise FuzzMismatch(seed, "physical-plan-stability",
                               "physical tree_string() differs across "
                               "planning runs")

        effective = [r["rule"] for r in trace if r["effective"] > 0]
        if ablate == "none":
            targets: List[str] = []
        elif ablate == "one":
            targets = effective[:1]
        elif ablate == "effective":
            targets = effective
        else:
            targets = sorted({r["rule"] for r in trace})
        for rule_name in targets:
            conf.set(EXCLUDED_KEY, rule_name)
            abl, abl_qe, _ = _collect(df)
            if not same_result(abl, base):
                raise FuzzMismatch(
                    seed, f"ablation:{rule_name}",
                    f"result with rule {rule_name!r} ablated differs "
                    f"from baseline\nplan:\n"
                    f"{abl_qe.optimized_plan.tree_string()}\n"
                    f"sql: {sql!r}")
        return {"seed": seed, "sql": bool(sql),
                "effective_rules": effective,
                "ablations": len(targets)}
    finally:
        conf._settings.clear()
        conf._settings.update(saved)


def run_campaign(session, seeds: Optional[Iterable[int]] = None,
                 ablate: str = "effective",
                 max_rows: Optional[int] = None,
                 stop_on_fail: bool = False,
                 progress=None) -> Dict:
    """Run many seeds (by default 0 up to the session's
    `spark_tpu.sql.fuzz.seeds`); collect failures instead of dying on the
    first (unless `stop_on_fail`). Returns {"ok": [...], "failures":
    [(seed, repr(error))...], "effective_counts": {rule: n}}."""
    if seeds is None:
        seeds = range(int(session.conf.get(SEEDS_KEY)))
    ok: List[int] = []
    failures: List[Tuple[int, str]] = []
    eff: Dict[str, int] = {}
    for seed in seeds:
        try:
            res = run_seed(session, seed, ablate=ablate,
                           max_rows=max_rows)
            ok.append(seed)
            for r in res["effective_rules"]:
                eff[r] = eff.get(r, 0) + 1
        except Exception as e:  # noqa: BLE001 — campaign collects
            failures.append((seed, f"{type(e).__name__}: {e}"))
            if stop_on_fail:
                break
        if progress is not None:
            progress(seed, not failures or failures[-1][0] != seed)
    return {"ok": ok, "failures": failures, "effective_counts": eff}
