"""The port's SQL front door against the JAX package's, on small tables.

The parser and lowering cases of `tests/test_sql.py` that the port
covers — projections, GROUP BY/HAVING, positions and aliases, explicit
and comma joins, left-join NULL extension, CASE/IN/LIKE/BETWEEN, FROM
subqueries, date/interval folding, scalar/IN/EXISTS subqueries, WITH
clauses and the error messages — each run through both packages on the
same tables: the port's Arrow result must equal the reference's, and
the values the reference's test expects. Features the JAX package has
and the port does not yet raise AnalysisError naming them.
"""

import decimal

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

from spark_tpu.expr import AnalysisError as RefAnalysisError
from spark_tpu.session import SparkTpuSession as RefSession
from spark_tpu.sql.lexer import ParseError as RefParseError
from spark_tpu_torch import SparkTpuSession
from spark_tpu_torch import types as T
from spark_tpu_torch.expr import AnalysisError
from spark_tpu_torch.sql.lexer import ParseError
from spark_tpu_torch.sql.parser import Parser
from torch_sql_parity import assert_tables_match

TABLES = {
    "tiny": pd.DataFrame({
        "k": [1, 2, 1, 3, 2, 1],
        "v": [10.0, 20.0, 30.0, 40.0, 50.0, 60.0],
        "s": ["a", "b", "a", "c", "b", "a"]}),
    "other": pd.DataFrame({"k": [1, 2, 4], "w": [100, 200, 400]}),
    "bounds": pd.DataFrame({
        "bk": [1, 2, 3], "lo": [15, 100, 35], "hi": [100, 10, 45]}),
    "t2": pd.DataFrame({"k": [1, 2, 3, 4], "v": [10.0, 30.0, 50.0, 99.0]}),
    "ord3": pd.DataFrame({"a": [2, 1, 3], "b": [7, 8, 9], "c": [0, 0, 1]}),
    "bigdec": pa.table({"d": pa.array(
        [decimal.Decimal(6 * 10**17), decimal.Decimal(4 * 10**17)],
        type=pa.decimal128(19, 0))}),
}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    port = SparkTpuSession.builder().device("cpu").get_or_create()
    ref = RefSession(register_active=False)
    # each package its own warehouse: CREATE TABLE writes there
    for s, name in ((port, "port_wh"), (ref, "ref_wh")):
        s.conf.set("spark_tpu.sql.warehouse.dir",
                   str(tmp_path_factory.mktemp(name)))
    for name, data in TABLES.items():
        port.register_table(name, data)
        ref.register_table(name, data)
    return port, ref


def run(both, text) -> pd.DataFrame:
    """The port's result of `text`, after holding it to the reference's."""
    port, ref = both
    got = port.sql(text).collect()
    assert_tables_match(got, ref.sql(text).collect())
    return got.to_pandas()


def test_select_project_filter(both):
    got = run(both, "SELECT k, v * 2 AS dv FROM tiny WHERE v > 15 "
                    "ORDER BY dv")
    assert got["dv"].tolist() == [40.0, 60.0, 80.0, 100.0, 120.0]
    assert got.columns.tolist() == ["k", "dv"]


def test_select_star(both):
    got = run(both, "SELECT * FROM tiny ORDER BY v LIMIT 2")
    assert got["v"].tolist() == [10.0, 20.0]
    assert got.columns.tolist() == ["k", "v", "s"]


def test_group_by_having_order(both):
    got = run(both, """
        SELECT k, sum(v) AS sv, count(*) AS c
        FROM tiny GROUP BY k HAVING count(*) > 1 ORDER BY sv DESC""")
    assert got["k"].tolist() == [1, 2]
    assert got["sv"].tolist() == [100.0, 70.0]
    assert got["c"].tolist() == [3, 2]


def test_agg_inside_arithmetic(both):
    got = run(both, "SELECT sum(v) / count(v) AS mean, "
                    "max(v) - min(v) AS spread FROM tiny")
    assert got["mean"].tolist() == [35.0]
    assert got["spread"].tolist() == [50.0]


def test_group_by_position_and_alias(both):
    by_pos = run(both, "SELECT k, count(*) AS c FROM tiny GROUP BY 1 "
                       "ORDER BY 1")
    by_alias = run(both, "SELECT k AS kk, count(*) AS c FROM tiny "
                         "GROUP BY kk ORDER BY kk")
    assert by_pos["c"].tolist() == by_alias["c"].tolist() == [3, 2, 1]


def test_explicit_join_on(both):
    got = run(both, "SELECT t.k, t.v, o.w FROM tiny t JOIN other o "
                    "ON t.k = o.k ORDER BY v")
    assert got["w"].tolist() == [100, 200, 100, 200, 100]


def test_left_join_null_extension(both):
    got = run(both, "SELECT tiny.k, w FROM tiny LEFT JOIN other "
                    "ON tiny.k = other.k ORDER BY tiny.k, w")
    k3 = got[got["k"] == 3]
    assert len(k3) == 1 and np.isnan(k3["w"].iloc[0])


def test_implicit_comma_join(both):
    got = run(both, "SELECT s, sum(w) AS sw FROM tiny, other "
                    "WHERE tiny.k = other.k GROUP BY s ORDER BY s")
    assert got["s"].tolist() == ["a", "b"]
    assert got["sw"].tolist() == [300, 400]


def test_case_when_in_like_between(both):
    got = run(both, """
        SELECT k, CASE WHEN v >= 30 THEN 1 ELSE 0 END AS big
        FROM tiny WHERE k IN (1, 2) AND s LIKE 'a%' AND v BETWEEN 5 AND 35
        ORDER BY v""")
    assert got["big"].tolist() == [0, 1]


def test_case_string_result_and_functions(both):
    got = run(both, """
        SELECT upper(s) AS u, length(s) AS n, concat('<', s, '>') AS c,
               CASE WHEN k = 1 THEN 'one' WHEN k = 2 THEN 'two' END AS w,
               coalesce(CASE WHEN k = 3 THEN 'c' END, 'none') AS z
        FROM tiny ORDER BY v""")
    assert got["u"].tolist() == ["A", "B", "A", "C", "B", "A"]
    assert got["w"].fillna("-").tolist() == \
        ["one", "two", "one", "-", "two", "one"]
    assert got["z"].tolist() == ["none"] * 3 + ["c"] + ["none"] * 2


def test_subquery_in_from(both):
    got = run(both, """
        SELECT kk, c FROM (
            SELECT k AS kk, count(*) AS c FROM tiny GROUP BY k
        ) sub WHERE c > 1 ORDER BY kk""")
    assert got["kk"].tolist() == [1, 2]


def test_case_with_qualified_refs(both):
    got = run(both, "SELECT CASE WHEN tiny.v > 25 THEN tiny.k ELSE 0 END "
                    "AS kk FROM tiny ORDER BY v")
    assert got["kk"].tolist() == [0, 0, 1, 3, 2, 1]


def test_case_with_join_refs(both):
    got = run(both, "SELECT CASE WHEN o.w > 150 THEN 1 ELSE 0 END AS big "
                    "FROM tiny t, other o WHERE t.k = o.k ORDER BY t.v")
    assert got["big"].tolist() == [0, 1, 0, 1, 0]


def test_order_by_ordinal_with_hidden_key(both):
    got = run(both, "SELECT b, a FROM ord3 ORDER BY c, 2")
    assert got["a"].tolist() == [1, 2, 3]
    assert got["b"].tolist() == [8, 7, 9]


def test_decimal_float_compare_large_values(both):
    got = run(both, "SELECT d FROM bigdec WHERE d > 5e17")
    assert len(got) == 1


def test_count_distinct(both):
    got = run(both, "SELECT s, count(DISTINCT k) AS n FROM tiny "
                    "GROUP BY s ORDER BY s")
    assert got["n"].tolist() == [1, 1, 1]
    got = run(both, "SELECT count(DISTINCT k) AS n, sum(DISTINCT k) AS t "
                    "FROM tiny")
    assert got["n"].tolist() == [3] and got["t"].tolist() == [6]


def test_uncorrelated_scalar_subquery(both):
    got = run(both, "SELECT k, v FROM tiny WHERE v > "
                    "(SELECT avg(v) FROM tiny) ORDER BY v")
    assert got["v"].tolist() == [40.0, 50.0, 60.0]


def test_in_subquery(both):
    got = run(both, "SELECT v FROM tiny WHERE k IN "
                    "(SELECT k FROM other WHERE w < 300) ORDER BY v")
    assert got["v"].tolist() == [10.0, 20.0, 30.0, 50.0, 60.0]
    got = run(both, "SELECT v FROM tiny WHERE k NOT IN "
                    "(SELECT k FROM other) ORDER BY v")
    assert got["v"].tolist() == [40.0]


def test_two_correlated_scalar_subqueries(both):
    got = run(both, """
        SELECT v FROM t2
        WHERE v < (SELECT min(hi) FROM bounds WHERE bk = k)
          AND v > (SELECT max(lo) FROM bounds WHERE bk = k) - 10
        ORDER BY v""")
    assert got["v"].tolist() == [10.0]


def test_correlated_scalar_left_join_semantics(both):
    got = run(both, """
        SELECT v FROM t2
        WHERE v = 99 OR v > (SELECT min(lo) FROM bounds WHERE bk = k)
        ORDER BY v""")
    assert got["v"].tolist() == [50.0, 99.0]


def test_qualified_correlation(both):
    got = run(both, """
        SELECT v FROM t2
        WHERE v > (SELECT min(bounds.lo) FROM bounds
                   WHERE bounds.bk = t2.k)
        ORDER BY v""")
    assert got["v"].tolist() == [50.0]


def test_exists_with_qualified_local_conjunct(both):
    got = run(both, """
        SELECT v FROM t2 t
        WHERE EXISTS (SELECT * FROM bounds b
                      WHERE b.bk = t.k AND b.lo < 50)
        ORDER BY v""")
    assert got["v"].tolist() == [10.0, 50.0]
    got = run(both, """
        SELECT v FROM t2 t
        WHERE NOT EXISTS (SELECT * FROM bounds b
                          WHERE b.bk = t.k AND b.hi <> t.v)
        ORDER BY v""")
    assert got["v"].tolist() == [99.0]


def test_cte_referenced_twice_is_computed_once(both):
    port, ref = both
    text = """
        WITH agg AS (SELECT k, sum(v) AS sv FROM tiny GROUP BY k)
        SELECT k, sv FROM agg WHERE sv = (SELECT max(sv) FROM agg)"""
    got = run(both, text)
    assert got["k"].tolist() == [1] and got["sv"].tolist() == [100.0]
    pqe, rqe = port.sql(text)._qe(), ref.sql(text)._qe()
    plan = pqe.executed_plan.tree_string()
    assert plan == rqe.executed_plan.tree_string()
    assert "ScanExec(__cached__" in plan
    # statement-scoped: nothing stays materialized after the statement
    pqe.collect()
    assert len(port._data_cache) == 0 and port._exec_depth == 0


def test_date_interval_folding():
    sel = Parser("SELECT 1 AS one FROM t WHERE d <= date '1998-12-01' - "
                 "interval '90' day").parse_statement()
    lit = sel.where.children[1]
    days = (np.datetime64("1998-09-02", "D")
            - np.datetime64("1970-01-01", "D")).astype(int)
    assert lit.value == days and isinstance(lit._dtype, T.DateType)


@pytest.mark.parametrize("bad", [
    "SELECT", "SELECT FROM t", "SELECT a FROM t WHERE",
    "SELECT a FROM t GROUP", "SELECT min(DISTINCT a) FROM t"])
def test_parse_errors(bad):
    with pytest.raises(ParseError):
        Parser(bad).parse_statement()


#: each package's exception class of an error kind
ERRORS = {"analysis": (AnalysisError, RefAnalysisError),
          "parse": (ParseError, RefParseError),
          "runtime": (RuntimeError, RuntimeError)}


@pytest.mark.parametrize("text,kind,match", [
    ("SELECT k FROM tiny t, other o WHERE t.k = o.k", "analysis",
     "ambiguous"),
    ("SELECT k FROM tiny HAVING k > 1", "analysis", "HAVING"),
    ("SELECT * FROM tiny RIGHT SEMI JOIN other ON tiny.k = other.k",
     "parse", "RIGHT SEMI"),
    ("SELECT v FROM t2 WHERE v > (SELECT lo, hi FROM bounds)",
     "runtime", "one column"),
    ("SELECT v FROM t2 WHERE EXISTS "
     "(SELECT count(*) FROM bounds WHERE bk = k)", "analysis",
     "aggregates inside"),
    ("SELECT k FROM missing", "analysis", "table 'missing' not found"),
    ("SELECT nope(k) FROM tiny", "parse", "unknown function"),
])
def test_errors_match_reference(both, text, kind, match):
    for session, error in zip(both, ERRORS[kind]):
        with pytest.raises(error, match=match):
            session.sql(text).collect()


@pytest.mark.parametrize("text,named", [
    ("SELECT k FROM tiny UNION ALL SELECT k FROM other", "UNION ALL"),
    ("SELECT k FROM tiny INTERSECT SELECT k FROM other", "INTERSECT"),
    ("SELECT k FROM tiny EXCEPT SELECT k FROM other", "EXCEPT"),
    ("SELECT k, sum(v) AS sv FROM tiny GROUP BY ROLLUP(k)",
     "grouping sets"),
    ("SELECT k, row_number() OVER (ORDER BY v) AS r FROM tiny",
     "window functions"),
    ("SELECT stddev(v) AS sd FROM tiny", "stddev"),
    ("SELECT k, first(v) AS f FROM tiny GROUP BY k", "first"),
    ("SELECT percentile(v, 0.5) AS p FROM tiny", "percentile"),
    ("SELECT k, collect_list(v) AS c FROM tiny GROUP BY k", "collect_list"),
    ("SELECT abs(v) AS a FROM tiny", "abs"),
    ("SELECT explode(array(k)) AS e FROM tiny", "array"),
    ("CREATE TABLE x AS SELECT * FROM tiny", "CREATE"),
])
def test_features_not_yet_ported_raise(both, text, named):
    """A feature the port lacks raises AnalysisError naming it. The
    features ported since (set operations, grouping sets, window
    functions, abs, the statistical, first/last, percentile and collect
    aggregates, arrays, DDL) must instead give the reference's rows."""
    port, ref = both
    if named in PORTED_SINCE:
        got, want = port.sql(text).collect(), ref.sql(text).collect()
        # sorted by every column but the list ones, which do not order
        keys = [(c, "ascending") for c, f in zip(want.column_names,
                                                  want.schema)
                if not pa.types.is_list(f.type)]
        assert_tables_match(got.sort_by(keys), want.sort_by(keys))
        return
    with pytest.raises(AnalysisError, match=f"{named}.*not yet ported"):
        port.sql(text).collect()


#: features of `test_features_not_yet_ported_raise` that are ported now
PORTED_SINCE = ("UNION ALL", "INTERSECT", "EXCEPT", "grouping sets",
                "window functions", "abs", "stddev", "first", "percentile",
                "collect_list", "array", "CREATE")
