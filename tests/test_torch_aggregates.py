"""The statistical, boolean, position-packed and positional aggregates
of the port (`spark_tpu_torch/expr_agg.py`, `execution/aggregate.py`'s
positional sort) against the JAX package, on the CPU.

One seeded table with NULLs, NaN, -0.0, a single-row group and
decimal, date, string, int64-extreme and float32 children goes through
both packages, each family of aggregates grouped three ways: by a
dictionary string key (the dense path, whose sums reach the group-by
kernel wrapper), by an int64 key (the sort aggregate) and globally; in
SQL and in DataFrame form. The executed plans must print the same
before and after the run; results are held as `function_queries`
holds them: ints, decimals, strings, dates, booleans and validity
exactly, the moments within the data-derived bound of
`function_queries.moment_tolerance` (each group's n*u times the scale
its power-sum formula cancels), other floats within rtol 1e-12.

Under `aggregate.kernelMode=matmul` the JAX package runs its Pallas
kernel in interpret mode, which is only float32-accurate (ROADMAP
Queue 3), so that case sums small integers whose float32 partial sums
are exact, and holds the results within rtol 1e-12.
"""

import decimal

import numpy as np
import pyarrow as pa
import pytest

from spark_tpu.io.sources import ArrowTableSource as RefSource
from spark_tpu.session import SparkTpuSession as RefSession
from spark_tpu_torch import SparkTpuSession
from spark_tpu_torch.io.sources import ArrowTableSource
from spark_tpu_torch.testing import function_queries as FQ
from torch_sql_parity import assert_tables_match

N = 240
SEED = 7

#: family -> SELECT list; moment columns name their kind and children
FAMILIES = {
    "moments": ("stddev(x) AS sd, stddev_pop(x) AS sdp, variance(x) AS v, "
                "var_pop(x) AS vp, stddev_samp(dec) AS sdd, "
                "var_samp(i) AS vi"),
    "two_child": ("corr(x, y) AS c, covar_samp(x, y) AS cs, "
                  "covar_pop(dec, i) AS cp"),
    "higher": "skewness(x) AS sk, kurtosis(y) AS ku, skewness(dec) AS skd",
    "bool": ("bool_and(b) AS ba, bool_or(b) AS bo, every(i > 3) AS ev, "
             "some(x > 12) AS so, count_if(b) AS ci, count_if(x > 10) AS cx"),
    "first_last": ("first(x) AS fx, last(x) AS lx, first(dec) AS fd, "
                   "last(dt) AS ld, first(s) AS fs, last(s) AS ls, "
                   "any_value(i) AS av, first(big) AS fb, last(big) AS lb, "
                   "first_value(b) AS fbo, last_value(f) AS lf"),
    "percentile": ("percentile(x, 0.25) AS p25, median(dec) AS md, "
                   "percentile_approx(i, 0.9) AS pa, "
                   "approx_percentile(y, 1.0) AS pmax, count(*) AS n, "
                   "max(x) AS mx, first(s) AS fs, stddev(y) AS sy"),
}
MOMENTS = {
    "sd": ("stddev_samp", "x", None), "sdp": ("stddev_pop", "x", None),
    "v": ("var_samp", "x", None), "vp": ("var_pop", "x", None),
    "sdd": ("stddev_samp", "dec", None), "vi": ("var_samp", "i", None),
    "c": ("corr", "x", "y"), "cs": ("covar_samp", "x", "y"),
    "cp": ("covar_pop", "dec", "i"), "sk": ("skewness", "x", None),
    "ku": ("kurtosis", "y", None), "skd": ("skewness", "dec", None),
    "sy": ("stddev_samp", "y", None),
}
GROUPINGS = {"dense": "kd", "sort": "ks", "global": None}


def make_table(seed: int = SEED) -> pa.Table:
    rng = np.random.default_rng(seed)
    n = N

    def nulls(p):
        return rng.random(n) < p

    x = rng.normal(10, 3, n)
    x[5] = np.nan          # in ks group 5: its moments are NaN or NULL
    x[7] = -0.0
    ks = rng.integers(0, 40, n)
    ks[ks == 39] = 38
    ks[0] = 39             # a single-row group: sample variance NULL
    words = ["apple", "pear", None, "fig", "apple", "kiwi"]
    s = [words[j] for j in rng.integers(0, len(words), n)]
    big = rng.integers(-(1 << 62), 1 << 62, n)
    big[:4] = [-(1 << 63), (1 << 63) - 1, -1, 0]
    f = rng.normal(0, 1, n).astype(np.float32)
    f[3], f[9] = np.float32(np.nan), np.float32(-0.0)
    return pa.table({
        "kd": pa.array([["a", "b", "c", None][j]
                        for j in rng.integers(0, 4, n)]),
        "ks": pa.array(ks.astype(np.int64), mask=nulls(0.05)),
        "x": pa.array(x, mask=nulls(0.1)),
        "y": pa.array(rng.normal(-2, 5, n)),
        "dec": pa.array([decimal.Decimal(int(v)).scaleb(-2)
                         for v in rng.integers(-10**6, 10**6, n)],
                        type=pa.decimal128(12, 2), mask=nulls(0.1)),
        "dt": pa.array(rng.integers(-800, 20000, n).astype(np.int32),
                       mask=nulls(0.1)).cast(pa.date32()),
        "s": pa.array(s),
        "i": pa.array(rng.integers(-5, 20, n).astype(np.int32),
                      mask=nulls(0.1)),
        "big": pa.array(big.astype(np.int64)),
        "b": pa.array(rng.random(n) < 0.7, mask=nulls(0.1)),
        "f": pa.array(f),
        "xi": pa.array(rng.integers(0, 16, n).astype(np.float64),
                       mask=nulls(0.1)),
        "yi": pa.array(rng.integers(-8, 8, n).astype(np.float64)),
    })


@pytest.fixture(scope="module")
def table():
    return make_table()


def both(table, tag, confs=()):
    port = SparkTpuSession.builder().device("cpu").get_or_create()
    ref = RefSession(register_active=False)
    for key, value in confs:
        port.conf.set(key, value)
        ref.conf.set(key, value)
    port.register_table("t", ArrowTableSource(f"t_{tag}", table))
    ref.register_table("t", RefSource(f"t_{tag}", table))
    return port, ref


def sql_text(family, key):
    if key is None:
        return f"SELECT {FAMILIES[family]} FROM t"
    return (f"SELECT {key}, {FAMILIES[family]} FROM t GROUP BY {key} "
            f"ORDER BY {key}")


def _values(table, name):
    col = table.column(name)
    if pa.types.is_decimal(col.type):
        col = col.cast(pa.float64())
    valid = col.is_valid().to_numpy(zero_copy_only=False)
    return col.to_numpy(zero_copy_only=False).astype(np.float64), valid


def moment_bounds(table, key, result):
    """Per result row, the absolute bound of each moment column in it."""
    if key is None:
        groups = [np.ones(table.num_rows, dtype=bool)]
    else:
        keys = table.column(key).to_pylist()
        groups = [np.array([k == v for k in keys])
                  for v in result.column(key).to_pylist()]
    bounds = {}
    for name in result.column_names:
        if name not in MOMENTS:
            continue
        kind, xc, yc = MOMENTS[name]
        x, xv = _values(table, xc)
        y, yv = _values(table, yc) if yc else (None, True)
        col = []
        for g in groups:
            m = g & xv & yv
            with np.errstate(all="ignore"):
                col.append(FQ.moment_tolerance(
                    kind, x[m], None if y is None else y[m]))
        bounds[name] = col
    import pandas as pd
    return pd.DataFrame(bounds)


def run(port, ref, make):
    """Run one program in both packages, plans equal before and after."""
    pqe, rqe = make(port)._qe(), make(ref)._qe()
    assert pqe.executed_plan.tree_string() == rqe.executed_plan.tree_string()
    got, want = pqe.collect(), rqe.collect()
    assert pqe.executed_plan.tree_string() == rqe.executed_plan.tree_string()
    return got, want


def check(table, key, got, want):
    assert got.schema == want.schema
    assert got.num_rows > 0
    FQ.compare_tables(got, want, moment_bounds(table, key, want),
                      "port against the JAX package")


@pytest.mark.parametrize("grouping", sorted(GROUPINGS))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_sql_matches_reference(table, family, grouping):
    key = GROUPINGS[grouping]
    port, ref = both(table, f"{family}_{grouping}")
    got, want = run(port, ref, lambda s: s.sql(sql_text(family, key)))
    check(table, key, got, want)


def dataframe_program(F, session, key):
    """Every aggregate family at once through the DataFrame API."""
    c = F.col
    aggs = [F.stddev(c("x")).alias("sd"), F.var_pop(c("x")).alias("vp"),
            F.stddev_pop(c("dec")).alias("sdd"),
            F.variance(c("i")).alias("vi"),
            F.corr(c("x"), c("y")).alias("c"),
            F.covar_samp(c("x"), c("y")).alias("cs"),
            F.covar_pop(c("dec"), c("i")).alias("cp"),
            F.skewness(c("x")).alias("sk"), F.kurtosis(c("y")).alias("ku"),
            F.bool_and(c("b")).alias("ba"), F.bool_or(c("b")).alias("bo"),
            F.count_if(c("x") > 10).alias("cx"),
            F.first(c("x"), ignorenulls=True).alias("fx"),
            F.last(c("s"), ignorenulls=True).alias("ls"),
            F.first(c("dt")).alias("fdt"), F.last(c("dec")).alias("ld"),
            F.any_value(c("big")).alias("av"),
            F.percentile(c("x"), 0.75).alias("p75"),
            F.median(c("dec")).alias("md"),
            F.percentile_approx(c("y"), 0.1).alias("pa")]
    df = session.table("t")
    if key is None:
        return df.agg(*aggs)
    return df.group_by(c(key)).agg(*aggs).sort(c(key))


@pytest.mark.parametrize("grouping", sorted(GROUPINGS))
def test_dataframe_matches_reference(table, grouping):
    from spark_tpu import functions as RF
    from spark_tpu_torch import functions as PF
    key = GROUPINGS[grouping]
    port, ref = both(table, f"df_{grouping}")
    got, want = run(port, ref, lambda s: dataframe_program(
        PF if s is port else RF, s, key))
    check(table, key, got, want)


@pytest.mark.parametrize("family", ["moments", "two_child", "higher",
                                    "bool"])
def test_kernel_path_under_matmul(table, family, monkeypatch):
    """kernelMode=matmul on a dense key: the port's sums go through the
    group-by kernel wrapper (its plain version on the CPU), the JAX
    package's through its Pallas kernel in interpret mode. Small
    integers keep every float32 partial sum exact."""
    from spark_tpu_torch.execution import dense_groupby as D
    calls = []
    original = D.dense_groupby_sums

    def recording(idx, int_rows, float_rows, domain, int_widths=None):
        calls.append((len(int_rows), len(float_rows)))
        return original(idx, int_rows, float_rows, domain, int_widths)

    monkeypatch.setattr(D, "dense_groupby_sums", recording)
    select = FAMILIES[family].replace("(x", "(xi").replace(", y)", ", yi)") \
        .replace("(y)", "(yi)").replace("(dec", "(xi").replace("x >", "xi >")
    port, ref = both(table, f"mm_{family}",
                     (("spark_tpu.sql.aggregate.kernelMode", "matmul"),))
    text = f"SELECT kd, {select} FROM t GROUP BY kd ORDER BY kd"
    got, want = run(port, ref, lambda s: s.sql(text))
    assert_tables_match(got, want)
    if family != "bool":  # bool_and/bool_or reduce by min/max: scatter
        assert calls and all(f > 0 for _i, f in calls)


def test_negative_zero_nan_and_single_rows():
    """-0.0 and NaN through min/max/first/last/sum/percentile, a group of
    one row (sample moments NULL, population moments 0), and an all-NULL
    group, bit for bit against the JAX package (the sign of zero
    included)."""
    nz = -0.0
    tbl = pa.table({
        "k": pa.array([1, 1, 2, 3, 3, 3, 4, 4], type=pa.int64()),
        "x": pa.array([nz, nz, 5.0, np.nan, 1.0, nz, None, None],
                      type=pa.float64()),
    })
    port, ref = both(tbl, "zeros")
    text = ("SELECT k, min(x) AS mn, max(x) AS mx, first(x) AS fx, "
            "last(x) AS lx, sum(x) AS sx, percentile(x, 0.5) AS p, "
            "stddev(x) AS sd, var_pop(x) AS vp, skewness(x) AS sk, "
            "count_if(x > 0) AS ci, bool_or(x = 0) AS bo "
            "FROM t GROUP BY k ORDER BY k")
    got, want = run(port, ref, lambda s: s.sql(text))
    assert got.schema == want.schema
    for name in got.column_names:
        g, w = got.column(name), want.column(name)
        assert g.is_valid().equals(w.is_valid()), name
        if pa.types.is_floating(w.type):
            gv = g.to_numpy(zero_copy_only=False)
            wv = w.to_numpy(zero_copy_only=False)
            assert np.array_equal(gv.view(np.int64), wv.view(np.int64)) or \
                np.array_equal(gv, wv, equal_nan=True) and \
                np.array_equal(np.signbit(gv), np.signbit(wv)), name
        else:
            assert g.equals(w), name


def test_first_last_words_round_trip():
    """The packed words of first/last on every child type give back the
    exact value the row holds (the int64 extremes, negative decimals,
    dates before 1970, float32 NaN and -0.0, dictionary strings), as
    the JAX package's unpacking does."""
    tbl = make_table(11)
    port, ref = both(tbl, "words")
    cols = ["big", "dec", "dt", "f", "s", "i", "b"]
    text = ("SELECT ks, " + ", ".join(
        f"first({c}) AS f_{c}, last({c}) AS l_{c}" for c in cols)
        + " FROM t GROUP BY ks ORDER BY ks")
    got, want = run(port, ref, lambda s: s.sql(text))
    assert got.schema == want.schema
    for name in got.column_names:
        g, w = got.column(name), want.column(name)
        if pa.types.is_floating(w.type):
            assert g.is_valid().equals(w.is_valid()), name
            gv = g.to_numpy(zero_copy_only=False)
            wv = w.to_numpy(zero_copy_only=False)
            assert np.array_equal(gv.view(np.int32), wv.view(np.int32)), name
        else:
            assert g.equals(w), name
    # each first/last is some row's value of its group
    rows = tbl.to_pandas()
    for r in got.to_pylist():
        grp = rows[rows["ks"] == r["ks"]] if r["ks"] is not None \
            else rows[rows["ks"].isna()]
        assert r["f_big"] == grp["big"].iloc[0]
        assert r["l_big"] == grp["big"].iloc[-1]


def test_positional_forces_complete_mode_and_sorts_by_value(table):
    """Percentile's plan: one complete-mode aggregate; its value sort
    puts NULLs at each group's tail and NaN above +inf, so a group's
    percentile of 1.0 is NaN when it holds a NaN."""
    port, ref = both(table, "pos")
    text = ("SELECT ks, percentile(x, 1.0) AS top, max(x) AS mx FROM t "
            "GROUP BY ks ORDER BY ks")
    got, want = run(port, ref, lambda s: s.sql(text))
    assert_tables_match(got, want)
    plan = port.sql(text)._qe().executed_plan.tree_string()
    assert "mode=complete" in plan
    top = dict(zip(got.column("ks").to_pylist(),
                   got.column("top").to_pylist()))
    ks = table.column("ks").to_pylist()
    assert np.isnan(top[ks[5]])  # row 5 holds the NaN


def test_collect_aggregates_still_raise(table):
    """Written while collect_list, collect_set and array_agg still
    raised in the port. They are ported now, so the case holds each to
    the reference's rows instead: lists of decimals, strings, int64
    extremes, dates and doubles, NULL elements dropped, by the sparse
    int key with its NULL group."""
    port, ref = both(table, "collect")
    for fn in ("collect_list", "collect_set", "array_agg"):
        text = (f"SELECT ks, {fn}(dec) AS cd, {fn}(s) AS cs, "
                f"{fn}(big) AS cb, {fn}(dt) AS ct, {fn}(y) AS cy "
                f"FROM t GROUP BY ks ORDER BY ks")
        got, want = run(port, ref, lambda s: s.sql(text))
        assert got.equals(want), fn
        assert got.num_rows > 30


def test_first_of_doubles_outside_float32():
    """first/last carry a double as a (hi, lo) float32 pair in both
    packages (ROADMAP Queue 3): a value past float32's range comes back
    NaN, and 0.1 keeps about 48 bits. A subnormal double comes back as
    a zero of its sign in the port; the JAX package's XLA CPU code
    flushes subnormals and returns +0.0."""
    tbl = pa.table({"k": pa.array([1, 2, 3], type=pa.int64()),
                    "x": pa.array([1e300, 0.1, -2.5e-310])})
    port, ref = both(tbl, "f32pair")
    text = "SELECT k, first(x) AS f FROM t GROUP BY k ORDER BY k"
    got, want = run(port, ref, lambda s: s.sql(text))
    g = got.column("f").to_numpy()
    w = want.column("f").to_numpy()
    assert np.isnan(g[0]) and np.isnan(w[0])
    assert g[1] == w[1] == np.float64(np.float32(0.1)) + np.float64(
        np.float32(0.1 - np.float64(np.float32(0.1))))
    assert g[1] != 0.1
    assert g[2] == 0.0 and np.signbit(g[2])
    assert w[2] == 0.0 and not np.signbit(w[2])
