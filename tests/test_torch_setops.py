"""Set operations and grouping sets of the port against the JAX package,
on the CPU: the single-device cases of `tests/test_setops_misc.py`
(INTERSECT/EXCEPT with NULLs, SQL set operations and their precedence,
ROLLUP/CUBE/GROUPING SETS, NULL group keys after a union), UNION of
string columns with different dictionaries, `drop_duplicates`, and
`abs`. Each program runs through both packages over the same tables:
the Arrow results must be equal and the executed plans print the same;
each case keeps its original check.
"""

import numpy as np
import pandas as pd
import pytest

from spark_tpu import functions as RF
from spark_tpu.session import SparkTpuSession as RefSession
from spark_tpu_torch import SparkTpuSession
from spark_tpu_torch import functions as PF
from spark_tpu_torch.expr import AnalysisError
from torch_sql_parity import assert_tables_match

PKGS = {"port": PF, "ref": RF}


def run_both(tables: dict, build, sort_by=None):
    """`build(session, F)` in each package over `tables` ({name:
    pandas}); asserts equal results (rows ordered by `sort_by` first when
    the program leaves them unordered) and plans."""
    out = {}
    for label, session in (
            ("port", SparkTpuSession.builder().device("cpu").get_or_create()),
            ("ref", RefSession(register_active=False))):
        for name, pdf in tables.items():
            session.register_table(name, pdf)
        out[label] = build(session, PKGS[label])._qe()
    assert out["port"].executed_plan.tree_string() == \
        out["ref"].executed_plan.tree_string()
    got, want = out["port"].collect(), out["ref"].collect()
    if sort_by:
        keys = [(c, "ascending") for c in sort_by]
        got = got.sort_by(keys)
        want = want.sort_by(keys)
    assert_tables_match(got, want)
    return got.to_pandas()


def sql_both(tables: dict, text: str, sort_by=None):
    return run_both(tables, lambda s, F: s.sql(text), sort_by)


def _two_frames(tag):
    l = pd.DataFrame({"k": [1, 2, None, 3], "s": ["a", "b", None, "c"]})
    r = pd.DataFrame({"k": [2, None, 4], "s": ["b", None, "d"]})
    return {f"so_l_{tag}": l, f"so_r_{tag}": r}


def test_intersect_with_nulls():
    t = _two_frames("i")
    out = run_both(t, lambda s, F: s.table("so_l_i").intersect(
        s.table("so_r_i")), sort_by=["k"])
    out = out.sort_values("k", na_position="last").reset_index(drop=True)
    assert out["k"].tolist()[0] == 2.0
    assert pd.isna(out["k"][1]) and pd.isna(out["s"][1])
    assert len(out) == 2  # NULL row matches NULL row


def test_except_and_subtract():
    t = _two_frames("e")
    out = run_both(t, lambda s, F: s.table("so_l_e").except_(
        s.table("so_r_e")), sort_by=["k"])
    assert sorted(out["k"].tolist()) == [1.0, 3.0]
    sub = run_both(t, lambda s, F: s.table("so_l_e").subtract(
        s.table("so_r_e")), sort_by=["k"])
    assert sub.shape == out.shape


def test_sql_intersect_except():
    t = _two_frames("q")
    out = sql_both(t, "SELECT k FROM so_l_q INTERSECT SELECT k FROM so_r_q",
                   sort_by=["k"])
    got = sorted([x for x in out["k"] if not pd.isna(x)])
    assert got == [2.0] and out["k"].isna().sum() == 1
    out2 = sql_both(t, "SELECT k FROM so_l_q EXCEPT SELECT k FROM so_r_q",
                    sort_by=["k"])
    assert sorted(out2["k"].dropna()) == [1.0, 3.0]


def test_rollup_cube_grouping_sets():
    pdf = pd.DataFrame({"a": ["x", "x", "y", "y"], "b": [1, 2, 1, 2],
                        "v": [10.0, 20.0, 30.0, 40.0]})
    t = {"ga_t": pdf}
    roll = sql_both(t, "SELECT a, b, sum(v) AS s FROM ga_t "
                       "GROUP BY ROLLUP(a, b) ORDER BY a, b")
    assert len(roll) == 7  # 4 leaves + 2 subtotals + 1 grand total
    grand = roll[roll["a"].isna() & roll["b"].isna()]
    assert grand["s"].tolist() == [100.0]
    sub_x = roll[(roll["a"] == "x") & roll["b"].isna()]
    assert sub_x["s"].tolist() == [30.0]

    cube = sql_both(t, "SELECT a, b, sum(v) AS s FROM ga_t "
                       "GROUP BY CUBE(a, b) ORDER BY a, b, s")
    assert len(cube) == 9  # 4 + 2 + 2 + 1
    b_only = cube[cube["a"].isna() & (cube["b"] == 1)]
    assert b_only["s"].tolist() == [40.0]

    gs = sql_both(t, "SELECT a, sum(v) AS s FROM ga_t "
                     "GROUP BY GROUPING SETS((a), ()) ORDER BY a")
    assert sorted(gs["s"]) == [30.0, 70.0, 100.0]


def test_rollup_with_count_and_avg_over_two_tables():
    """ROLLUP over a join, with count and avg, ordered and limited."""
    rs = np.random.RandomState(3)
    fact = pd.DataFrame({"k": rs.randint(0, 5, 300).astype(np.int64),
                         "c": rs.choice(["p", "q", "r"], 300),
                         "v": rs.randint(0, 100, 300).astype(np.int64)})
    dim = pd.DataFrame({"k": np.arange(5, dtype=np.int64),
                        "name": ["zero", "one", "two", "three", "four"]})
    out = sql_both({"gs_fact": fact, "gs_dim": dim},
                   "SELECT name, c, count(*) AS n, avg(v) AS a "
                   "FROM gs_fact f JOIN gs_dim d ON f.k = d.k "
                   "GROUP BY ROLLUP(name, c) ORDER BY name, c LIMIT 12")
    assert len(out) == 12
    assert out["n"].iloc[0] == 300  # the grand total sorts first


def test_null_group_keys_merge_after_union():
    """Two NULL group keys with different dead payloads (after the union
    remapped the dictionaries) land in ONE group."""
    l = pd.DataFrame({"s": ["a", None], "v": [1.0, 2.0]})
    r = pd.DataFrame({"s": ["b", None], "v": [4.0, 8.0]})

    def build(s, F):
        u = s.create_dataframe(l, "ng_l").union(
            s.create_dataframe(r, "ng_r"))
        return u.group_by(F.col("s")).agg(F.sum(F.col("v")).alias("sv"))
    out = run_both({}, build, sort_by=["s"])
    null_rows = out[out["s"].isna()]
    assert len(null_rows) == 1
    assert null_rows["sv"].tolist() == [10.0]


def test_union_of_strings_with_different_dictionaries():
    """UNION ALL of string columns whose dictionaries differ (in order
    and in content): the right side's codes are remapped onto the merged
    dictionary, so every string survives and groups across sides."""
    l = pd.DataFrame({"s": ["pear", "apple", "fig", "apple", None],
                      "v": np.arange(5, dtype=np.int64)})
    r = pd.DataFrame({"s": ["fig", "kiwi", "pear", None, "kiwi", "date"],
                      "v": np.arange(10, 16, dtype=np.int64)})
    t = {"us_l": l, "us_r": r}
    both = sql_both(t, "SELECT s, v FROM us_l UNION ALL SELECT s, v FROM us_r")
    assert both["s"].tolist() == l["s"].tolist() + r["s"].tolist()
    grouped = sql_both(t, "SELECT s, count(*) AS n, sum(v) AS sv FROM "
                          "(SELECT s, v FROM us_l UNION ALL "
                          "SELECT s, v FROM us_r) u GROUP BY s ORDER BY s")
    want = (pd.concat([l, r]).groupby("s", dropna=False)
            .agg(n=("v", "size"), sv=("v", "sum")).reset_index()
            .sort_values("s", na_position="first"))
    assert grouped["s"].tolist()[1:] == want["s"].tolist()[1:]
    assert grouped["n"].tolist() == want["n"].tolist()
    assert grouped["sv"].tolist() == want["sv"].tolist()

    def build(s, F):
        return (s.table("us_l").union(s.table("us_r"))
                .filter(F.col("s") == F.lit("kiwi")))
    kiwi = run_both(t, build)
    assert kiwi["v"].tolist() == [11, 14]


def test_intersect_binds_tighter_than_union():
    """Standard SQL precedence — INTERSECT before UNION:
    A UNION ALL B INTERSECT C == A UNION ALL (B INTERSECT C)."""
    t = {"p1": pd.DataFrame({"a": [1, 2, 2]}),
         "p2": pd.DataFrame({"a": [2, 5]}),
         "p3": pd.DataFrame({"a": [1, 5]})}
    out = sql_both(t, "SELECT a FROM p1 UNION ALL SELECT a FROM p2 "
                      "INTERSECT SELECT a FROM p3", sort_by=["a"])
    assert sorted(out["a"].tolist()) == [1, 2, 2, 5]


def test_rollup_with_qualified_ref_and_bare_grouping_set():
    t = {"q1t": pd.DataFrame({"a": [1, 2, 2]})}
    out = sql_both(t, "SELECT q1t.a, count(*) AS c FROM q1t "
                      "GROUP BY ROLLUP(a) ORDER BY a")
    assert out["c"].tolist() == [3, 1, 2]
    out2 = sql_both(t, "SELECT a, sum(a) AS s FROM q1t "
                       "GROUP BY GROUPING SETS (a, ()) ORDER BY a")
    assert out2["s"].tolist() == [5, 1, 4]


def test_except_all_clear_error():
    session = SparkTpuSession.builder().device("cpu").get_or_create()
    for name, pdf in _two_frames("x").items():
        session.register_table(name, pdf)
    with pytest.raises(AnalysisError, match="EXCEPT ALL"):
        session.table("so_l_x").exceptAll(session.table("so_r_x"))


@pytest.mark.parametrize("subset", [None, ["k"], ["k", "s"], ["s"]])
def test_drop_duplicates(subset):
    pdf = pd.DataFrame({"k": [1, 1, 2, 2, 2, 3],
                        "s": ["a", "a", "b", "c", "b", "a"],
                        "v": [5, 5, 6, 7, 6, 8]})
    out = run_both({"dd_t": pdf},
                   lambda s, F: s.table("dd_t").drop_duplicates(subset),
                   sort_by=["k", "s", "v"])
    want = pdf.drop_duplicates(subset)
    assert len(out) == len(want)
    assert set(map(tuple, out[list(subset or pdf.columns)].values)) == \
        set(map(tuple, want[list(subset or pdf.columns)].values))


def test_distinct():
    pdf = pd.DataFrame({"k": [1, 1, 2, None], "s": ["a", "a", "b", None]})
    out = run_both({"dist_t": pdf}, lambda s, F: s.table("dist_t").distinct(),
                   sort_by=["k"])
    assert len(out) == 3


def test_abs():
    import decimal
    import pyarrow as pa
    t = pa.table({"i": pa.array([-3, 0, 7, None], pa.int64()),
                  "f": pa.array([-1.5, 2.0, None, -0.0]),
                  "d": pa.array([decimal.Decimal("-1.25"), None,
                                 decimal.Decimal("3.10"),
                                 decimal.Decimal("0.00")],
                                pa.decimal128(7, 2))}).to_pandas()
    out = sql_both({"abs_t": t}, "SELECT abs(i) AS i, abs(f) AS f, "
                                 "abs(d) AS d, abs(i - 5) AS j FROM abs_t")
    assert out["i"].fillna(-1).tolist() == [3, 0, 7, -1]
    assert out["j"].fillna(-1).tolist() == [8, 5, 2, -1]

    def build(s, F):
        return s.table("abs_t").select(F.abs(F.col("f")).alias("af"))
    assert run_both({"abs_t": t}, build)["af"].fillna(-1).tolist() == \
        [1.5, 2.0, -1, 0.0]
