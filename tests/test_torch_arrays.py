"""Array columns, explode and the collect aggregates of the port
(`spark_tpu_torch/expr_array.py`, `GenerateExec`, `positional_collect`)
against the JAX package, on the CPU.

The cases of the reference's `tests/test_arrays.py` (all but the mesh
one) and the four collect cases of `tests/test_positional_agg.py`, each
run through both packages on the same seeded tables, in SQL and in
DataFrame form: list columns of int, float and string elements with
empty arrays, NULL arrays and NULL elements; size, array_contains,
element_at (negative indices too) and array(); explode and
explode_outer, after a filter and before an aggregate; collect_list
and collect_set by a dense key, by a sort key and globally, then
exploded back. The Arrow results must be equal (lists, strings, ints
and validity exactly, floats within rtol 1e-12), collect_list's
element order included, and the executed plans must print the same.
"""

import numpy as np
import pyarrow as pa
import pytest

from spark_tpu import functions as RF
from spark_tpu.session import SparkTpuSession as RefSession
from spark_tpu_torch import SparkTpuSession
from spark_tpu_torch import functions as PF
from spark_tpu_torch.expr import AnalysisError
from torch_sql_parity import assert_tables_match

SEED = 11


def _lists(rng, n, make):
    """n arrays: about 1 in 8 NULL, 1 in 8 empty, the rest 1-5 elements
    drawn by `make(count)` with about 1 in 10 NULL elements."""
    out = []
    for _ in range(n):
        r = rng.random()
        if r < 0.125:
            out.append(None)
        elif r < 0.25:
            out.append([])
        else:
            vals = make(int(rng.integers(1, 6)))
            out.append([None if rng.random() < 0.1 else v for v in vals])
    return out


def _tables():
    rng = np.random.default_rng(SEED)
    n = 60
    arr = pa.table({
        "k": pa.array(np.arange(n, dtype=np.int64)),
        "g": pa.array(rng.integers(0, 4, n).astype(np.int64)),
        "v": pa.array(rng.normal(size=n)),
        "ai": pa.array(_lists(rng, n, lambda c: [int(x) for x in
                                                 rng.integers(-5, 6, c)]),
                       type=pa.list_(pa.int64())),
        "af": pa.array(_lists(rng, n, lambda c: [float(x) for x in
                                                 rng.normal(size=c)]),
                       type=pa.list_(pa.float64())),
        "as_": pa.array(_lists(rng, n, lambda c: list(
            rng.choice(["aa", "bb", "cc", "dd"], c))),
            type=pa.list_(pa.string())),
    })
    m = 200
    v = rng.normal(size=m)
    v[::17] = np.nan
    vmask = np.zeros(m, bool)
    vmask[5::23] = True
    pos = pa.table({
        "g": pa.array(rng.integers(0, 5, m).astype(np.int64)),
        "s": pa.array(rng.choice(["x", "y", "z"], m)),
        "big": pa.array(rng.integers(0, 10**12, m).astype(np.int64)
                        % 7 * 10**11),
        "i": pa.array(rng.integers(0, 10, m).astype(np.int64),
                      mask=vmask),
        "v": pa.array(v),
        "w": pa.array(rng.choice(["aa", "bb", "cc"], m)),
    })
    return {"arr_t": arr, "pos_t": pos}


@pytest.fixture(scope="module")
def both():
    port = SparkTpuSession.builder().device("cpu").get_or_create()
    ref = RefSession(register_active=False)
    for name, table in _tables().items():
        port.register_table(name, table)
        ref.register_table(name, table)
    return port, ref


def assert_match(got: pa.Table, want: pa.Table) -> None:
    """`assert_tables_match`, with list columns of floats compared by
    their offsets, validity and elements (NaN equal to NaN, other floats
    within rtol 1e-12) — Arrow's `equals` holds NaN unequal to itself."""
    assert got.schema == want.schema
    floats = [n for n, f in zip(want.column_names, want.schema)
              if pa.types.is_list(f.type)
              and pa.types.is_floating(f.type.value_type)]
    for name in floats:
        g = got.column(name).combine_chunks()
        w = want.column(name).combine_chunks()
        assert g.is_valid().equals(w.is_valid()), name
        assert g.value_lengths().fill_null(0).equals(
            w.value_lengths().fill_null(0)), name
        gf, wf = g.flatten(), w.flatten()
        assert gf.is_valid().equals(wf.is_valid()), name
        np.testing.assert_allclose(
            gf.to_numpy(zero_copy_only=False),
            wf.to_numpy(zero_copy_only=False), rtol=1e-12, err_msg=name)
    rest = [n for n in want.column_names if n not in floats]
    assert_tables_match(got.select(rest), want.select(rest))


def run(both, build) -> pa.Table:
    """`build(session, functions)` in both packages: the executed plans
    must print the same, the results must match; the port's result."""
    port, ref = both
    pdf, rdf = build(port, PF), build(ref, RF)
    pqe, rqe = pdf._qe(), rdf._qe()
    assert pqe.executed_plan.tree_string() == \
        rqe.executed_plan.tree_string()
    got, want = pqe.collect(), rqe.collect()
    assert_match(got, want)
    return got


def sql(both, text) -> pa.Table:
    return run(both, lambda s, F: s.sql(text))


def test_list_roundtrip_ingest_egress(both):
    got = run(both, lambda s, F: s.table("arr_t"))
    assert got.equals(_tables()["arr_t"])


@pytest.mark.parametrize("column", ["ai", "af", "as_"])
def test_size_contains_element_at(both, column):
    needle = {"ai": 3, "af": 0.5, "as_": "bb"}[column]
    got = run(both, lambda s, F: s.table("arr_t").select(
        F.col("k"), F.size(F.col(column)).alias("n"),
        F.array_contains(F.col(column), needle).alias("c"),
        F.element_at(F.col(column), 2).alias("e2"),
        F.element_at(F.col(column), -1).alias("last"),
        F.element_at(F.col(column), 0).alias("e0")))
    want = _tables()["arr_t"].column(column).to_pylist()
    assert got.column("n").to_pylist() == [
        -1 if a is None else len(a) for a in want]
    assert got.column("last").to_pylist() == [
        a[-1] if a else None for a in want]
    assert got.column("e0").null_count == got.num_rows


def test_sql_array_functions(both):
    got = sql(both, """
        SELECT k, size(ai) AS n, cardinality(as_) AS m,
               array_contains(ai, 1) AS c, element_at(af, -2) AS e,
               element_at(as_, 1) AS s1, size(array(k, g, k * 2)) AS three
        FROM arr_t WHERE k < 40 ORDER BY k""")
    assert got.column("three").to_pylist() == [3] * got.num_rows


def test_make_array_and_explode_roundtrip(both):
    got = run(both, lambda s, F: s.table("arr_t")
              .select(F.col("k"), F.array(F.col("k"), F.col("g"))
                      .alias("a"))
              .select(F.col("k"), F.explode(F.col("a")).alias("e"))
              .sort(F.col("k"), F.col("e")))
    assert got.num_rows == 2 * 60


@pytest.mark.parametrize("column", ["ai", "af", "as_"])
def test_explode_replicates_and_drops_empty(both, column):
    got = run(both, lambda s, F: s.table("arr_t").select(
        F.col("k"), F.col("v"), F.explode(F.col(column)).alias("e")))
    want = _tables()["arr_t"].column(column).to_pylist()
    assert got.num_rows == sum(len(a) for a in want if a)


@pytest.mark.parametrize("column", ["ai", "as_"])
def test_explode_outer_keeps_empty_rows(both, column):
    got = run(both, lambda s, F: s.table("arr_t").select(
        F.col("k"), F.explode_outer(F.col(column)).alias("e")))
    want = _tables()["arr_t"].column(column).to_pylist()
    assert got.num_rows == sum(len(a) if a else 1 for a in want)


def test_explode_after_filter(both):
    got = run(both, lambda s, F: s.table("arr_t")
              .filter(F.col("g") != 1)
              .select(F.col("k"), F.explode(F.col("ai")).alias("e")))
    assert got.num_rows > 0


def test_explode_then_aggregate(both):
    got = run(both, lambda s, F: s.table("arr_t")
              .select(F.col("g"), F.explode(F.col("ai")).alias("e"))
              .group_by(F.col("g"))
              .agg(F.sum(F.col("e")).alias("s"), F.count().alias("c"))
              .sort(F.col("g")))
    assert got.num_rows == 4


def test_sql_explode(both):
    got = sql(both, "SELECT k, explode(as_) AS w FROM arr_t WHERE k <> 4 "
                    "ORDER BY k, w")
    flat = [w for k, a in enumerate(
        _tables()["arr_t"].column("as_").to_pylist()) if a and k != 4
        for w in a]
    assert sorted(got.column("w").to_pylist(),
                  key=lambda x: (x is None, x)) == \
        sorted(flat, key=lambda x: (x is None, x))


def test_sql_explode_outer_and_default_name(both):
    got = sql(both, "SELECT k, explode_outer(af) FROM arr_t ORDER BY k")
    assert got.column_names == ["k", "col"]


def test_explode_errors_match_reference(both):
    port, ref = both
    for s in both:
        with pytest.raises(Exception, match="one explode"):
            s.sql("SELECT explode(ai) AS a, explode(af) AS b FROM arr_t")
    with pytest.raises(AnalysisError, match="GROUP BY"):
        port.sql("SELECT g, explode(ai) AS e FROM arr_t GROUP BY g")


#: how each collect case groups: a dense int key (domain 5), a sparse
#: int64 key (the sort path) and none
GROUPINGS = {"dense": "g", "sort": "big", "global": None}


@pytest.mark.parametrize("grouping", sorted(GROUPINGS))
def test_collect_list_and_set(both, grouping):
    key = GROUPINGS[grouping]

    def build(s, F):
        df = s.table("pos_t")
        aggs = (F.collect_list(F.col("i")).alias("li"),
                F.collect_set(F.col("i")).alias("se"),
                F.collect_list(F.col("v")).alias("lv"),
                F.collect_set(F.col("v")).alias("sv"))
        if key is None:
            return df.agg(*aggs)
        return df.group_by(F.col(key)).agg(*aggs).sort(F.col(key))
    got = run(both, build)
    pdf = _tables()["pos_t"].to_pandas()
    groups = [pdf] if key is None else [
        pdf[pdf[key] == k] for k in got.column(key).to_pylist()]
    for row, grp in zip(got.to_pylist(), groups):
        vals = grp["i"].dropna().astype(int).tolist()
        assert row["li"] == sorted(vals)
        assert row["se"] == sorted(set(vals))


@pytest.mark.parametrize("grouping", sorted(GROUPINGS))
def test_collect_list_strings(both, grouping):
    key = GROUPINGS[grouping]
    by = f"{key}, " if key else ""
    text = (f"SELECT {by}collect_set(w) AS ss, collect_list(s) AS ls "
            f"FROM pos_t" + (f" GROUP BY {key} ORDER BY {key}"
                             if key else ""))
    got = sql(both, text)
    pdf = _tables()["pos_t"].to_pandas()
    groups = [pdf] if key is None else [
        pdf[pdf[key] == k] for k in got.column(key).to_pylist()]
    for row, grp in zip(got.to_pylist(), groups):
        assert sorted(row["ss"]) == sorted(set(grp["w"]))
        assert sorted(row["ls"]) == sorted(grp["s"])


def test_collect_then_explode_roundtrip(both):
    got = run(both, lambda s, F: s.table("pos_t").group_by(F.col("g"))
              .agg(F.collect_list(F.col("i")).alias("li"))
              .select(F.explode(F.col("li")).alias("e"))
              .agg(F.count().alias("c"), F.sum(F.col("e")).alias("s")))
    pdf = _tables()["pos_t"].to_pandas()
    assert got.column("c").to_pylist() == [int(pdf["i"].notna().sum())]


def test_mixed_with_regular_aggs_and_sql_collect(both):
    got = sql(both, """
        SELECT g, sum(i) AS si, median(v) AS m, collect_set(i) AS cs,
               array_agg(s) AS a, size(collect_list(v)) AS n
        FROM pos_t GROUP BY g ORDER BY g""")
    pdf = _tables()["pos_t"].to_pandas()
    for row in got.to_pylist():
        grp = pdf[pdf["g"] == row["g"]]
        assert row["cs"] == sorted(set(grp["i"].dropna().astype(int)))


def test_collect_of_a_filtered_frame_and_sorted_lists(both):
    got = sql(both, """
        SELECT s, collect_list(g) AS gs FROM pos_t WHERE v > 0
        GROUP BY s ORDER BY s DESC""")
    assert got.column("s").to_pylist() == ["z", "y", "x"]


def test_collect_empty_input(both):
    got = sql(both, "SELECT collect_list(i) AS li, count(*) AS c "
                    "FROM pos_t WHERE g > 100")
    assert got.column("c").to_pylist() == [0]


def test_plans_print_the_same_with_a_generate(both):
    text = ("SELECT k, explode(ai) AS e FROM arr_t WHERE g = 2 "
            "ORDER BY k, e")
    port, ref = both
    assert port.sql(text)._qe().optimized_plan.tree_string() == \
        ref.sql(text)._qe().optimized_plan.tree_string()
    assert "GenerateExec(explode(ai) AS e)" in \
        port.sql(text)._qe().executed_plan.tree_string()
