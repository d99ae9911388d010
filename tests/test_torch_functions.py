"""The port's function library (`spark_tpu_torch/expr_fns.py`, the SQL
registry and `functions.py`) against the JAX package, on the CPU.

Each group of `expr_fns` runs through SQL over one seeded table with
NULLs in every column: math (NaN, +-inf, -0.0, off-domain inputs),
bitwise (negative values, shift counts of 63 and above, negative
counts), NULL and NaN handling, dates (before 1970, month ends, leap
days, invalid make_date arguments) and strings over dictionaries that
hold duplicates, NULLs and values that collapse into one another after
the function. Results must be equal, floats within rtol 1e-12 (torch's
and XLA's transcendental functions may differ in the last bits; XLA
also turns a division by a constant into a multiplication, ROADMAP
Queue 3); the executed plans must print the same before and after the
run.
"""

import decimal

import numpy as np
import pyarrow as pa
import pytest

from spark_tpu.io.sources import ArrowTableSource as RefSource
from spark_tpu.session import SparkTpuSession as RefSession
from spark_tpu_torch import SparkTpuSession
from spark_tpu_torch.io.sources import ArrowTableSource
from torch_sql_parity import assert_tables_match

N = 64

GROUPS = {
    "math": (
        "sqrt(d) AS a1, cbrt(d) AS a2, exp(e) AS a3, expm1(e) AS a4, "
        "ln(d) AS a5, log10(d) AS a6, log2(d) AS a7, log1p(d) AS a8, "
        "log(2.0, d) AS a9, log(d) AS a10, pow(d, 2) AS a11, "
        "power(m, 3) AS a12, sin(d) AS a13, cos(d) AS a14, tan(e) AS a15, "
        "cot(e) AS a16, asin(e) AS a17, acos(e) AS a18, atan(d) AS a19, "
        "atan2(d, e) AS a20, sinh(e) AS a21, cosh(e) AS a22, "
        "tanh(d) AS a23, hypot(d, e) AS a24, degrees(d) AS a25, "
        "radians(d) AS a26, rint(d) AS a27, sign(d) AS a28, "
        "signum(n) AS a29"),
    "rounding": (
        "ceil(d) AS r1, ceiling(dec) AS r2, floor(d) AS r3, "
        "floor(dec) AS r4, round(d, 2) AS r5, round(dec, 1) AS r6, "
        "round(n, -2) AS r7, round(m) AS r8, factorial(m) AS r9, "
        "pmod(n, 7) AS r10, mod(n, 5) AS r11, abs(dec) AS r12, "
        "abs(n) AS r13, round(e * 100) AS r14"),
    "bitwise": (
        "shiftleft(n, sh) AS b1, shiftright(n, sh) AS b2, "
        "shiftleft(m, sh) AS b3, shiftright(m, 31) AS b4, "
        "bit_count(n) AS b5, bit_count(m) AS b6, shiftleft(n, 63) AS b7, "
        "shiftright(n, 64) AS b8"),
    "null_nan": (
        "nullif(s, 'ab12') AS z1, nullif(n, 3) AS z2, nvl(d, 0.0) AS z3, "
        "ifnull(n, -1) AS z4, nvl2(s, 1, 0) AS z5, if(b, n, m) AS z6, "
        "greatest(d, e, 1.5) AS z7, least(n, m) AS z8, "
        "greatest(d, e) AS z9, least(d, e) AS z10, isnan(d) AS z11, "
        "isnan(n) AS z12, nanvl(d, e) AS z13, coalesce(d, e, 7.0) AS z14, "
        "isnull(s) AS z15, isnotnull(d) AS z16, greatest(dec, n) AS z17"),
    "dates": (
        "quarter(dt) AS t1, dayofweek(dt) AS t2, weekday(dt) AS t3, "
        "dayofyear(dt) AS t4, weekofyear(dt) AS t5, last_day(dt) AS t6, "
        "next_day(dt, 'MON') AS t7, next_day(dt, 'sunday') AS t8, "
        "add_months(dt, mo) AS t9, add_months(dt, -13) AS t10, "
        "months_between(dt, dt2) AS t11, datediff(dt, dt2) AS t12, "
        "trunc(dt, 'year') AS t13, trunc(dt, 'quarter') AS t14, "
        "trunc(dt, 'MM') AS t15, trunc(dt, 'week') AS t16, "
        "make_date(y, mo, da) AS t17, year(dt) AS t18, month(dt) AS t19, "
        "day(dt) AS t20, dayofmonth(dt2) AS t21, date_add(dt, 40) AS t22, "
        "date_sub(dt, mo) AS t23"),
    "strings": (
        "ltrim(s) AS s1, rtrim(s) AS s2, reverse(s) AS s3, initcap(s) AS s4, "
        "lpad(s, 6, 'xy') AS s5, rpad(s, 3) AS s6, "
        "replace(s, 'b', 'BB') AS s7, replace(s, '1') AS s8, "
        "translate(s, 'ab', 'x') AS s9, repeat(s, 2) AS s10, "
        "regexp_replace(s, '([a-z])([0-9])', '$2$1') AS s11, "
        "regexp_extract(s, '([0-9]+)', 1) AS s12, "
        "regexp_extract(s, '[a-z]+', 0) AS s13, instr(s, '1') AS s14, "
        "locate('b', s) AS s15, ascii(s) AS s16, rlike(s, '^[A-Z]') AS s17, "
        "regexp_like(s, '[0-9]$') AS s18, contains(s, 'b1') AS s19, "
        "startswith(s, ' ') AS s20, endswith(s, '2') AS s21, "
        "length(s) AS s22, upper(s) AS s23, lcase(s) AS s24, "
        "char_length(s) AS s25, ucase(s) AS s26, trim(s) AS s27, "
        "concat('<', s, '>') AS s28, rpad(s, 0) AS s29"),
}

WORDS = ["  Ab12 ", "ab12", "AB12", None, "x-y_z", "", "ab1x", "Zz9",
         "ab12", "hello world", "b1b1", None]


def make_table(seed: int = 3) -> pa.Table:
    rng = np.random.default_rng(seed)
    n = N

    def nulls(p=0.1):
        return rng.random(n) < p

    d = rng.normal(0, 4, n)
    d[:6] = [np.nan, np.inf, -np.inf, -0.0, 0.0, -1.0]
    e = rng.uniform(-1.2, 1.2, n)
    sh = rng.integers(-2, 70, n)
    sh[:5] = [63, 64, 70, -1, 0]
    dt = rng.integers(-1000, 20000, n)
    # month ends, a leap day, the day before 1970, the epoch
    dt[:6] = [10956, 11016, 11017, -1, 0, 10988]
    years = rng.integers(1890, 2030, n)
    months = rng.integers(1, 13, n)
    days = rng.integers(1, 32, n)
    months[:2], days[:2] = [2, 2], [30, 29]  # 2023-02-30 NULL; leap days
    years[:2] = [2023, 2000]
    n_vals = rng.integers(-1000, 1000, n)
    n_vals[:4] = [-(1 << 63), (1 << 63) - 1, -1, 3]
    return pa.table({
        "d": pa.array(d, mask=nulls()),
        "e": pa.array(e, mask=nulls()),
        "n": pa.array(n_vals.astype(np.int64), mask=nulls()),
        "m": pa.array(rng.integers(-3, 22, n).astype(np.int32),
                      mask=nulls()),
        "sh": pa.array(sh.astype(np.int64), mask=nulls(0.05)),
        "dec": pa.array([decimal.Decimal(int(v)).scaleb(-3)
                         for v in rng.integers(-10**6, 10**6, n)],
                        type=pa.decimal128(10, 3), mask=nulls()),
        "dt": pa.array(dt.astype(np.int32), mask=nulls()).cast(pa.date32()),
        "dt2": pa.array(rng.integers(-1000, 20000, n).astype(np.int32),
                        mask=nulls()).cast(pa.date32()),
        "y": pa.array(years.astype(np.int32), mask=nulls(0.05)),
        "mo": pa.array(months.astype(np.int32), mask=nulls(0.05)),
        "da": pa.array(days.astype(np.int32), mask=nulls(0.05)),
        "s": pa.array([WORDS[j] for j in rng.integers(0, len(WORDS), n)]),
        "b": pa.array(rng.random(n) < 0.5, mask=nulls()),
    })


@pytest.fixture(scope="module")
def table():
    return make_table()


def both(table, tag):
    port = SparkTpuSession.builder().device("cpu").get_or_create()
    ref = RefSession(register_active=False)
    port.register_table("t", ArrowTableSource(f"t_{tag}", table))
    ref.register_table("t", RefSource(f"t_{tag}", table))
    return port, ref


def run(port, ref, make):
    pqe, rqe = make(port)._qe(), make(ref)._qe()
    assert pqe.executed_plan.tree_string() == rqe.executed_plan.tree_string()
    got, want = pqe.collect(), rqe.collect()
    assert pqe.executed_plan.tree_string() == rqe.executed_plan.tree_string()
    return got, want


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_group_matches_reference(table, group):
    port, ref = both(table, group)
    text = f"SELECT {GROUPS[group]} FROM t"
    got, want = run(port, ref, lambda s: s.sql(text))
    assert got.num_rows == N
    assert_tables_match(got, want)


@pytest.mark.parametrize("fn", ["initcap(s)", "rpad(s, 3)",
                                "regexp_extract(s, '[a-z]+', 0)",
                                "translate(s, 'ab', 'x')", "ltrim(s)"])
def test_string_results_group_and_filter_alike(table, fn):
    """A string function's result is a deduplicated dictionary in the
    JAX package's order: grouping by it gives the same groups in the
    same order, and filtering on it the same rows."""
    port, ref = both(table, f"g_{fn[:6]}")
    text = (f"SELECT {fn} AS v, count(*) AS c, min(n) AS mn FROM t "
            f"WHERE {fn} <> 'zz' OR n > 0 GROUP BY {fn}")
    got, want = run(port, ref, lambda s: s.sql(text))
    assert_tables_match(got, want)


def test_literal_arguments_fold_alike(table):
    """Functions of literals fold to the same literals in both packages
    (the F2 program's `add_months(DATE '1994-01-01', 12)` bound), so the
    filters push down the same."""
    port, ref = both(table, "fold")
    text = ("SELECT dt FROM t WHERE dt < add_months(DATE '1994-01-01', 12) "
            "AND dt >= make_date(1970, 1, 1) "
            "AND datediff(DATE '2003-01-02', dt) > quarter(DATE '2001-05-05')")
    got, want = run(port, ref, lambda s: s.sql(text))
    assert_tables_match(got, want)


def test_dataframe_wrappers_match_reference(table):
    """The `functions.py` wrappers, the bitwise classes with no SQL name,
    and when/otherwise, through the DataFrame API."""
    from spark_tpu import expr_fns as RX
    from spark_tpu import functions as RF
    from spark_tpu_torch import expr_fns as PX
    from spark_tpu_torch import functions as PF

    def program(s):
        F, X = (PF, PX) if isinstance(s, SparkTpuSession) else (RF, RX)
        c = F.col
        return s.table("t").select(
            F.sqrt(c("d")).alias("w1"), F.round(c("d"), 1).alias("w2"),
            F.bit_count(c("n")).alias("w3"),
            F.bitwise_not(c("m")).alias("w4"),
            X.BitwiseAnd(c("n"), c("m")).alias("w5"),
            X.BitwiseOr(c("n"), F.lit(6)).alias("w6"),
            X.BitwiseXor(c("m"), c("sh")).alias("w7"),
            F.shiftright(c("n"), c("sh")).alias("w8"),
            F.greatest(c("d"), c("e")).alias("w9"),
            F.nanvl(c("d"), F.lit(1.0)).alias("w10"),
            F.nullif(c("s"), F.lit("AB12")).alias("w11"),
            F.expr_if(c("b"), c("d"), c("e")).alias("w12"),
            F.add_months(c("dt"), 1).alias("w13"),
            F.months_between(c("dt"), c("dt2")).alias("w14"),
            F.trunc(c("dt"), "quarter").alias("w15"),
            F.make_date(c("y"), c("mo"), c("da")).alias("w16"),
            F.next_day(c("dt"), "fri").alias("w17"),
            F.lpad(c("s"), 4, "-").alias("w18"),
            F.regexp_replace(c("s"), "[0-9]", "#").alias("w19"),
            F.instr(c("s"), "b").alias("w20"),
            F.rlike(c("s"), "^a").alias("w21"),
            F.replace(c("s"), "1", "one").alias("w22"),
            F.concat(F.lit("["), c("s")).alias("w23"),
            F.when(c("n") > 0, c("n")).otherwise(F.lit(0)).alias("w24"),
            F.coalesce(c("d"), F.lit(2.5)).alias("w25"),
            F.date_sub(c("dt"), 3).alias("w26"),
            F.eq_null_safe(c("s"), F.lit("ab12")).alias("w27"),
            F.pmod(c("n"), F.lit(9)).alias("w28"),
            F.factorial(c("m")).alias("w29"),
            F.weekofyear(c("dt")).alias("w30"),
            F.initcap(F.lower(c("s"))).alias("w31"),
            F.ascii(c("s")).alias("w32"),
            F.log(c("d")).alias("w33"),
            F.hypot(c("d"), c("e")).alias("w34"))

    port, ref = both(table, "df")
    got, want = run(port, ref, program)
    assert_tables_match(got, want)


def test_every_reference_wrapper_is_exported():
    """functions.py exports every wrapper of the JAX package's, the
    event-time `window` included, with the same parameters."""
    import inspect

    from spark_tpu import functions as RF
    from spark_tpu_torch import functions as PF
    ref_names = {n for n, v in vars(RF).items()
                 if not n.startswith("_") and callable(v)
                 and not inspect.isclass(v)
                 and getattr(v, "__module__", "").startswith("spark_tpu")}
    missing = sorted(ref_names - set(vars(PF)))
    assert missing == []
    for name in sorted(ref_names):
        want = inspect.signature(getattr(RF, name))
        got = inspect.signature(getattr(PF, name))
        assert list(got.parameters) == list(want.parameters), name


def test_registry_resolves_every_reference_name():
    """The port's SQL registry has every name of the JAX package's, the
    seven array functions included, with the same arities."""
    from spark_tpu.sql.registry import REGISTRY as REF
    from spark_tpu_torch.expr import AnalysisError
    from spark_tpu_torch.sql.registry import REGISTRY
    arrays = {"ARRAY", "SIZE", "CARDINALITY", "ARRAY_CONTAINS",
              "ELEMENT_AT", "EXPLODE", "EXPLODE_OUTER"}
    assert set(REF) == set(REGISTRY)
    assert arrays <= set(REGISTRY)
    for name, (_b, lo, hi) in REGISTRY.items():
        assert (lo, hi) == REF[name][1:], name
    from spark_tpu_torch.sql.registry import lookup
    with pytest.raises(AnalysisError, match="size expects 1 arguments"):
        lookup("size", [])


def test_decimal_to_double_is_correctly_rounded():
    """The port casts a decimal to DOUBLE by dividing the scaled integer
    by 10^scale, which IEEE rounds correctly, as the reference's
    BigDecimal.doubleValue does. XLA rewrites the JAX package's
    division by the constant 10^scale into a multiplication by its
    reciprocal, which is off by one ulp on some values (ROADMAP
    Queue 3): both stay within one ulp of the exact quotient."""
    vals = [decimal.Decimal(int(v)).scaleb(-2) for v in
            np.random.default_rng(5).integers(-10**9, 10**9, 2000)]
    tbl = pa.table({"v": pa.array(vals, type=pa.decimal128(12, 2))})
    port, ref = both(tbl, "cast")
    text = "SELECT CAST(v AS DOUBLE) AS f FROM t"
    got, want = run(port, ref, lambda s: s.sql(text))
    exact = np.array([float(v) for v in vals])
    g = got.column("f").to_numpy()
    w = want.column("f").to_numpy()
    assert np.array_equal(g, exact)
    assert np.all(np.abs(w - exact) <= np.spacing(np.abs(exact)))


@pytest.mark.parametrize("text,match", [
    ("SELECT regexp_extract(s, '[a-z]+') AS v FROM t", "group 1 out of"),
    ("SELECT trunc(dt, 'day') AS v FROM t", "unsupported trunc format"),
    ("SELECT next_day(dt, 'someday') AS v FROM t", "unknown day-of-week"),
    ("SELECT greatest(s, s) AS v FROM t", "over strings"),
    ("SELECT lpad(s, n) AS v FROM t", "integer literal"),
])
def test_errors_match_reference(table, text, match):
    """Both packages refuse the same calls with the same message."""
    from spark_tpu.expr import AnalysisError as RefError
    from spark_tpu_torch.expr import AnalysisError
    port, ref = both(table, "errors")
    for session, error in ((port, AnalysisError), (ref, RefError)):
        with pytest.raises(error, match=match):
            session.sql(text).collect()
