"""The SQL slice's expressions against the JAX package's, on identical
batches.

Each expression is built twice, once from each package's `expr` module,
and evaluated on the same columns: the reference on a
`spark_tpu.columnar.Batch`, the port on the `interop.batch_from_numpy`
copy of it. Data, validity and the string dictionary must be equal (data
is compared where the row is valid: a NULL row's data is unspecified).
The table has NULLs in every column, dates and timestamps from before
1970 (Hinnant's civil-from-days floors negative day counts), strings
that collide after upper/trim/substring (the dictionary is deduplicated
and the codes remapped) and an all-NULL string column, whose dictionary
is empty.
"""

import datetime
from decimal import Decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_tpu import columnar as RC
from spark_tpu import expr as RE
from spark_tpu import types as RT
from spark_tpu_torch import expr as PE
from spark_tpu_torch import interop
from spark_tpu_torch import types as PT


def _exprs(E, T):
    c, lit = E.ColumnRef, E.Literal
    return {
        "year": E.ExtractYear(c("dt")),
        "month": E.ExtractMonth(c("dt")),
        "day": E.ExtractDay(c("dt")),
        "year_of_timestamp": E.ExtractYear(c("ts")),
        "day_of_timestamp": E.ExtractDay(c("ts")),
        "date_add": E.DateAdd(c("dt"), c("n")),
        "date_sub_literal": E.DateAdd(c("dt"), E.Neg(lit(40))),
        "date_add_timestamp": E.DateAdd(c("ts"), lit(3)),
        "eq_null_safe": E.EqNullSafe(c("n"), c("m")),
        "eq_null_safe_literal": E.EqNullSafe(c("n"), lit(2)),
        "eq_null_safe_string": E.EqNullSafe(c("s"), lit("b ")),
        "upper": E.Upper(c("s")),
        "lower": E.Lower(c("s")),
        "trim": E.Trim(c("s")),
        "concat": E.ConcatLit(c("s"), "<", ">"),
        "length": E.StringLength(c("s")),
        "like_prefix": E.Like(c("s"), "b%"),
        "like_infix": E.Like(c("s"), "%a%"),
        "substring": E.Substring(c("s"), 1, 1),
        "substring_past_end": E.Substring(c("s"), 3, 5),
        "upper_of_empty_dictionary": E.Upper(c("z")),
        "coalesce": E.Coalesce(c("n"), c("m"), lit(0)),
        "coalesce_all_nullable": E.Coalesce(c("n"), c("m")),
        "coalesce_decimal": E.Coalesce(c("d"), lit(1)),
        "coalesce_string": E.Coalesce(c("s"), c("t"), lit("none")),
        "coalesce_empty_dictionary": E.Coalesce(c("z"), lit("x")),
        "case_int": E.CaseWhen([(c("n") > lit(2), lit(1))], lit(0)),
        "case_no_else": E.CaseWhen([(c("n") > lit(2), c("m")),
                                    (c("n") < lit(0), lit(-1))]),
        "case_decimal": E.CaseWhen(
            [(E.Like(c("s"), "a%"), c("d") * (lit(1) - c("d")))], lit(0)),
        "case_string": E.CaseWhen([(c("n") > lit(2), lit("hi")),
                                   (c("n") < lit(0), lit(None, T.STRING))],
                                  lit("lo")),
        "case_string_no_else": E.CaseWhen([(c("s") == lit("a"), lit("A"))]),
        "case_of_substring": E.In(E.Substring(c("t"), 1, 2), ("13", "31")),
    }


def _table(n=613, seed=11):
    rs = np.random.RandomState(seed)

    def nulls(arr, frac=0.15, type=None):
        return pa.array(arr, mask=rs.rand(n) < frac, type=type)

    # days from 1600-01-01 to 2100-01-01, and a few before 0000-03-01,
    # where Hinnant's era goes negative
    days = np.where(rs.rand(n) < 0.05, rs.randint(-900_000, -719_469, n),
                    rs.randint(-135_140, 47_482, n))
    us = rs.randint(-3 * 10**9, 3 * 10**9, n).astype(np.int64) * 10**6
    words = np.array(["a", "b ", " b", "B", "ab", "ba", "", "abc"], object)
    return pa.table({
        "dt": nulls(days.astype(np.int32)).cast(pa.date32()),
        "ts": nulls(us, type=pa.int64()).cast(pa.timestamp("us")),
        "n": nulls(rs.randint(-3, 6, n).astype(np.int32)),
        "m": nulls(rs.randint(-3, 6, n).astype(np.int32)),
        "d": nulls([None if rs.rand() < 0.1 else
                    Decimal(int(v)).scaleb(-2)
                    for v in rs.randint(-9999, 9999, n)],
                   type=pa.decimal128(12, 2)),
        "s": nulls(rs.choice(words, n)),
        "t": nulls(rs.choice(["13-5", "31-0", "99-1", "1"], n).astype(object)),
        "z": pa.array([None] * n, type=pa.string()),
    })


def _batches(table):
    ref = RC.Batch.from_arrow(table)
    cols = {}
    for name, c in ref.columns.items():
        cols[name] = (c.dtype.simple_string(), np.asarray(c.data),
                      None if c.validity is None else np.asarray(c.validity),
                      c.dictionary)
    sel = None if ref.selection is None else np.asarray(ref.selection)
    return ref, interop.batch_from_numpy(cols, sel, ref.capacity, "cpu")


@pytest.fixture(scope="module")
def batches():
    return _batches(_table())


def test_table_covers_the_edge_cases(batches):
    ref, _port = batches
    assert len(ref.columns["z"].dictionary) == 0
    days = np.asarray(ref.columns["dt"].data)
    assert (days < -719468).any() and (days > 0).any()
    assert (np.asarray(ref.columns["ts"].data) < 0).any()


@pytest.mark.parametrize("name", sorted(_exprs(PE, PT)))
def test_expression_matches_reference(batches, name):
    ref, port = batches
    cap = ref.capacity
    rv = _exprs(RE, RT)[name].eval(ref)
    pv = _exprs(PE, PT)[name].eval(port)
    assert pv.dtype == PT.parse_type(rv.dtype.simple_string()), name
    r_valid = np.ones(cap, bool) if rv.validity is None else \
        np.broadcast_to(np.asarray(rv.validity), (cap,))
    p_valid = np.ones(cap, bool) if pv.validity is None else \
        np.broadcast_to(pv.validity.numpy(), (cap,))
    np.testing.assert_array_equal(p_valid, r_valid, err_msg=name)
    r_data = np.broadcast_to(np.asarray(rv.data), (cap,))
    p_data = np.broadcast_to(pv.data.numpy(), (cap,))
    assert p_data.dtype == r_data.dtype, name
    np.testing.assert_array_equal(p_data[r_valid], r_data[r_valid],
                                  err_msg=name)
    if rv.dictionary is not None or pv.dictionary is not None:
        assert pv.dictionary.equals(rv.dictionary), name


@pytest.mark.parametrize("name", sorted(_exprs(PE, PT)))
def test_expression_types_and_names_match_reference(batches, name):
    ref, port = batches
    re_, pe = _exprs(RE, RT)[name], _exprs(PE, PT)[name]
    assert repr(pe) == repr(re_)
    assert pe.dtype(port.schema()).simple_string() == \
        re_.dtype(ref.schema()).simple_string()
    assert pe.nullable(port.schema()) == re_.nullable(ref.schema())


def test_civil_from_days_matches_the_calendar():
    """year/month/day of every 97th day from 1600 to 2100 against
    Python's proleptic Gregorian calendar."""
    epoch = datetime.date(1970, 1, 1)
    days = np.arange(-135_140, 47_482, 97, dtype=np.int64)
    y, m, d = PE._civil_from_days(torch.from_numpy(days))
    want = [epoch + datetime.timedelta(days=int(x)) for x in days]
    assert y.tolist() == [w.year for w in want]
    assert m.tolist() == [w.month for w in want]
    assert d.tolist() == [w.day for w in want]


def test_case_when_map_children_rebuilds_branches():
    case = PE.CaseWhen([(PE.ColumnRef("a"), PE.ColumnRef("b"))],
                       PE.ColumnRef("c"))
    renamed = case.map_children(
        lambda e: PE.ColumnRef(e.name().upper()))
    assert repr(renamed) == "CASE [(A, B)] ELSE C"
    assert renamed.branches[0][0].name() == "A"


@pytest.mark.parametrize("kind", ["like", "length"])
def test_dictionary_lookups_on_an_all_null_column(batches, kind):
    """An all-NULL string column has an empty dictionary. The port's
    lookup gives an all-NULL result; the JAX package's `jnp.take` from
    the empty table raises instead."""
    ref, port = batches

    def build(E):
        z = E.ColumnRef("z")
        return E.Like(z, "%") if kind == "like" else E.StringLength(z)

    pv = build(PE).eval(port)
    assert not pv.validity.any()
    assert pv.data.shape == (port.capacity,)
    with pytest.raises(IndexError):
        build(RE).eval(ref)


def test_decimal_division_past_the_float_bound_is_exact():
    """Decimal quotients whose scaled dividend passes 2^53, where the
    JAX package gives NULL (TPC-H Q8's mkt_share from SF 0.3 on): the
    port's are Python's Decimal quotients rounded HALF_UP; inside the
    bound they equal the JAX package's, and past int64 they are NULL."""
    import decimal
    rs = np.random.RandomState(5)
    n = 400
    # scale 4 over scale 4 gives scale 8: the bound on the dividend is
    # 2^53 / 10^8, about 9.0e7 unscaled; int64 ends at about 9.2e10
    lo = rs.randint(-10**8, 10**8, n)
    hi = rs.randint(-9 * 10**10, 9 * 10**10, n, dtype=np.int64)
    num = np.where(rs.rand(n) < 0.5, lo, hi)
    num[:2] = [10**12, -10**12]  # past int64 once scaled
    den = rs.randint(-10**9, 10**9, n)
    den[2] = 0
    table = pa.table({
        "a": pa.array([Decimal(int(v)).scaleb(-4) for v in num],
                      type=pa.decimal128(18, 4)),
        "b": pa.array([Decimal(int(v)).scaleb(-4) for v in den],
                      type=pa.decimal128(18, 4))})
    ref, port = _batches(table)
    pv = PE.Div(PE.ColumnRef("a"), PE.ColumnRef("b")).eval(port)
    rv = RE.Div(RE.ColumnRef("a"), RE.ColumnRef("b")).eval(ref)
    assert pv.dtype == PT.parse_type(rv.dtype.simple_string())
    assert pv.dtype.scale == 8
    p_valid = pv.validity.numpy()[:n]
    r_valid = np.asarray(rv.validity)[:n]
    p_data, r_data = pv.data.numpy()[:n], np.asarray(rv.data)[:n]
    np.testing.assert_array_equal(p_data[r_valid], r_data[r_valid])
    assert not p_valid[:3].any()
    assert (p_valid & ~r_valid).sum() > 100
    ctx = decimal.Context(prec=60, rounding=decimal.ROUND_HALF_UP)
    for i in np.flatnonzero(p_valid):
        want = ctx.divide(Decimal(int(num[i])), Decimal(int(den[i]))) \
            .quantize(Decimal("1e-8"), context=ctx).scaleb(8)
        assert p_data[i] == int(want), i
