"""The port's writer, data cache, checkpoints, explain, count and show
(`spark_tpu_torch/dataframe.py`, `session.py`, `result_cache.py`, the
executor's `_apply_cache` and `explain`) against the JAX package, on the
CPU.

The cases of the reference's `tests/test_write_cache.py` — the Parquet
round trip of every engine type, the five write modes, a computed
frame, a cached subtree replacing its plan — and the data cache's
lifetimes: an explicit `cache()` outlives its statement and counts its
hits, a WITH-clause view is dropped when its statement ends (and
computed once again the next time), `register_table` drops the marks
over the replaced table. Then `checkpoint()` with and without a
checkpoint directory, `explain()`'s sections as strings (rule timings
aside), `count()`, `show()` and the accumulators. Each case runs in a
port session and a reference session with their own directories under
`tmp_path`; results must be equal as `torch_sql_parity` holds them.
"""

import contextlib
import decimal
import io
import re

import numpy as np
import pyarrow as pa
import pytest

from spark_tpu import functions as RF
from spark_tpu.session import SparkTpuSession as RefSession
from spark_tpu_torch import SparkTpuSession
from spark_tpu_torch import functions as PF
from torch_sql_parity import assert_tables_match

CKPT_KEY = "spark_tpu.sql.checkpoint.dir"


def _typed_table():
    return pa.table({
        "i": pa.array([1, 2, 3, 4], type=pa.int64()),
        "d": pa.array([decimal.Decimal("1.25"), decimal.Decimal("-2.50"),
                       decimal.Decimal("3.75"), decimal.Decimal("0.00")],
                      type=pa.decimal128(10, 2)),
        "dt": pa.array([18000, 18001, None, 18003], type=pa.date32()),
        "s": pa.array(["aa", "bb", None, "aa"]),
        "f": pa.array([1.5, None, 3.5, 4.5], type=pa.float64()),
        "b": pa.array([True, False, None, True]),
        "a": pa.array([[1, 2], [], None, [3]], type=pa.list_(pa.int64())),
    })


def _kv_table(seed=5, n=40):
    rng = np.random.default_rng(seed)
    return pa.table({"k": pa.array(rng.integers(0, 4, n).astype(np.int64)),
                     "v": pa.array(rng.integers(0, 100, n).astype(np.int64)),
                     "x": pa.array(rng.normal(size=n))})


@pytest.fixture
def both(tmp_path):
    port = SparkTpuSession.builder().device("cpu").get_or_create()
    ref = RefSession(register_active=False)
    for s, sub in ((port, "port"), (ref, "ref")):
        s.conf.set("spark_tpu.sql.warehouse.dir", str(tmp_path / sub / "wh"))
        s.register_table("wt", _typed_table())
        s.register_table("ct", _kv_table())
    return port, ref


def pair(both, build):
    """`build(session, functions)` for each package."""
    port, ref = both
    return build(port, PF), build(ref, RF)


def test_write_read_round_trip(both, tmp_path):
    pdf, rdf = pair(both, lambda s, F: s.table("wt"))
    pdf.write.parquet(str(tmp_path / "port_out"))
    rdf.write.parquet(str(tmp_path / "ref_out"))
    port, ref = both
    got = port.read_parquet(str(tmp_path / "port_out")).collect()
    assert_tables_match(got, ref.read_parquet(str(tmp_path / "ref_out"))
                        .collect())
    # decimals leave the engine at precision 19 or more
    assert got.cast(_typed_table().schema).equals(_typed_table())
    # each package reads the other's output
    assert_tables_match(
        port.read_parquet(str(tmp_path / "ref_out")).collect(), got)


@pytest.mark.parametrize("mode", ["error", "errorifexists", "overwrite",
                                  "append", "ignore"])
def test_write_modes(both, tmp_path, mode):
    counts = []
    for df, s, sub in zip(pair(both, lambda s, F: s.table("wt")), both,
                          ("port", "ref")):
        path = str(tmp_path / sub / "modes")
        df.write.parquet(path)
        w = df.write.mode(mode)
        if mode in ("error", "errorifexists"):
            with pytest.raises(FileExistsError, match="already exists"):
                w.parquet(path)
        else:
            w.parquet(path)
        counts.append(s.read_parquet(path).collect().num_rows)
    assert counts[0] == counts[1] == (8 if mode == "append" else 4)
    with pytest.raises(ValueError, match="unknown write mode"):
        both[0].table("wt").write.mode("upsert")


def test_write_computed_frame(both, tmp_path):
    frames = pair(both, lambda s, F: s.range(100)
                  .select((F.col("id") * 2).alias("x"))
                  .filter(F.col("x") >= 100))
    outs = []
    for df, s, sub in zip(frames, both, ("port", "ref")):
        df.write.parquet(str(tmp_path / sub / "computed"))
        outs.append(s.read_parquet(str(tmp_path / sub / "computed"))
                    .collect())
    assert_tables_match(*outs)
    assert outs[0].column("x").to_pylist() == list(range(100, 200, 2))


def test_cache_hit_replaces_subtree(both):
    frames = pair(both, lambda s, F: s.table("ct").group_by(F.col("k"))
                  .agg(F.sum(F.col("v")).alias("s")))
    firsts = []
    for df in frames:
        df.cache()
        firsts.append(df.collect().sort_by("k"))
    assert_tables_match(*firsts)
    for df, first in zip(frames, firsts):
        # the second run plans against the cached scan
        assert "__cached__" in df._qe().optimized_plan.tree_string()
        assert df.collect().sort_by("k").equals(first)
    tops = pair(both, lambda s, F: s.table("ct").group_by(F.col("k"))
                .agg(F.sum(F.col("v")).alias("s"))
                .filter(F.col("s") > 10))
    for top in tops:
        assert "__cached__" in top._qe().optimized_plan.tree_string()
    assert_tables_match(tops[0].collect().sort_by("k"),
                        tops[1].collect().sort_by("k"))
    for df in frames:
        df.unpersist()
        assert "__cached__" not in df._qe().optimized_plan.tree_string()


def test_explicit_cache_survives_the_statement(both):
    port, _ = both
    df = port.table("ct").filter(PF.col("v") > 20).select(
        PF.col("k"), PF.col("v"))
    df.cache()
    first = df.collect()
    # the statement ended: the table stays and the next query reads it
    assert len(port._data_cache) == 1
    hits = port.result_cache_hits
    q = df.group_by(PF.col("k")).agg(PF.count().alias("c"))
    assert "ScanExec(__cached__" in q._qe().executed_plan.tree_string()
    # planning alone reads no cached data: a hit counts on execution
    assert port.result_cache_hits == hits
    got = q.collect().sort_by("k")
    assert port.result_cache_hits == hits + 1
    want = port.table("ct").filter(PF.col("v") > 20).group_by(
        PF.col("k")).agg(PF.count().alias("c"))
    df.unpersist()
    assert len(port._data_cache) == 0
    assert got.equals(want.collect().sort_by("k"))
    assert df.collect().equals(first)


def test_with_view_does_not_survive_the_statement(both):
    text = """
        WITH agg AS (SELECT k, sum(v) AS sv FROM ct GROUP BY k)
        SELECT k, sv FROM agg WHERE sv = (SELECT max(sv) FROM agg)"""
    port, ref = both
    got = port.sql(text).collect()
    assert_tables_match(got, ref.sql(text).collect())
    assert len(port._data_cache) == 0 and port._exec_depth == 0
    assert len(port._implicit_cache_fps) == 1
    # run again: the mark stayed, so the view is computed once more, and
    # read from the cache by its second reference
    qe = port.sql(text)._qe()
    assert "ScanExec(__cached__" in qe.executed_plan.tree_string()
    assert qe.collect().equals(got)
    assert len(port._data_cache) == 0


def test_register_table_drops_a_cached_plan(both):
    port, ref = both
    outs = []
    for s, F in ((port, PF), (ref, RF)):
        df = s.table("ct").group_by(F.col("k")).agg(
            F.max(F.col("v")).alias("m"))
        df.cache()
        df.collect()
        s.register_table("ct", _kv_table(seed=6))
        assert len(s._cache_requests) == 0
        assert "__cached__" not in df._qe().optimized_plan.tree_string()
        outs.append(s.table("ct").group_by(F.col("k")).agg(
            F.max(F.col("v")).alias("m")).collect().sort_by("k"))
    assert_tables_match(*outs)
    assert len(port._data_cache) == 0


def test_checkpoint_without_and_with_a_directory(both, tmp_path):
    build = lambda s, F: s.table("ct").filter(F.col("v") > 50) \
        .select(F.col("k"), (F.col("v") * 2).alias("v2"))
    outs = []
    for df in pair(both, build):
        local = df.checkpoint()  # no directory: in memory
        assert "__checkpoint_" in local.plan.tree_string()
        outs.append(local.collect())
    assert_tables_match(*outs)
    on_disk = []
    for s, df, sub in zip(both, pair(both, build), ("port", "ref")):
        s.conf.set(CKPT_KEY, str(tmp_path / sub / "ckpt"))
        ck = df.checkpoint()
        assert "ckpt-" in ck.plan.tree_string()
        assert (tmp_path / sub / "ckpt").is_dir()
        on_disk.append(ck.collect())
    assert_tables_match(*on_disk)
    assert_tables_match(on_disk[0], outs[0])
    lc = pair(both, build)[0].local_checkpoint()
    assert "__checkpoint_" in lc.plan.tree_string()


def _explain(df, **kw) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        df.explain(**kw)
    # rule timings are host clock
    return re.sub(r", [0-9.]+ms$", "", buf.getvalue(), flags=re.M)


@pytest.mark.parametrize("kw", [{}, {"extended": True},
                                {"extended": True, "runtime": True},
                                {"rules": True}])
def test_explain_sections_match_reference(both, kw):
    for s in both:
        s.register_table("dim", pa.table({
            "k": pa.array([0, 1, 2, 3], type=pa.int64()),
            "name": pa.array(["a", "b", "c", "d"])}))
        s.register_table("third", pa.table({
            "name": pa.array(["a", "c"]), "w": pa.array([1.0, 2.0])}))
    texts = [_explain(df, **kw) for df in pair(
        both, lambda s, F: s.sql(
            "SELECT d.name, sum(c.v) AS sv, sum(t.w) AS sw FROM ct c "
            "JOIN dim d ON c.k = d.k JOIN third t ON d.name = t.name "
            "WHERE c.v > 5 GROUP BY d.name ORDER BY d.name"))]
    port, ref = texts
    # the reference may add an XLA stage-cost section, which the port
    # has no counterpart for
    ref = re.sub(r"== Stage cost \(XLA\) ==\n(  .*\n)*", "", ref)
    assert port == ref
    assert "== Join Reorder ==\n  reorder:" in port
    if kw.get("runtime"):
        assert "rows out: " in port
    if kw.get("rules"):
        assert "JoinReorder.CostBasedJoinReorder: effective" in port


def test_explain_analysis_is_not_ported(both):
    """The name dates from before the port had the analyzer, when this
    raised; the analyzer is ported now (slice 12b), so explain's static-
    analysis section is the JAX package's, word for word."""
    sections = []
    for s in both:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            s.table("ct").explain(analysis=True)
        sections.append(buf.getvalue().split("== Static Analysis ==")[1])
    assert sections[0] == sections[1] == "\n  no findings\n"


def test_count_and_show(both):
    port, ref = both
    for build in (lambda s, F: s.table("ct"),
                  lambda s, F: s.table("ct").filter(F.col("v") > 30),
                  lambda s, F: s.table("wt")):
        pdf, rdf = pair(both, build)
        assert pdf.count() == rdf.count()
        shown = []
        for df in (pdf, rdf):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                df.show(3)
            shown.append(buf.getvalue())
        assert shown[0] == shown[1]
    assert port.table("ct").count() == 40


def test_accumulators_and_result_cache_bound(both):
    port, _ = both
    acc = port.long_accumulator("n")
    for v in (1, 2, 3):
        acc.add(v)
    assert acc.value == 6 and repr(acc) == "Accumulator(n=6)"
    acc.reset()
    dacc = port.double_accumulator()
    dacc.add(0.5)
    assert acc.value == 0 and dacc.value == 0.5
    bounded = SparkTpuSession.builder().device("cpu").config(
        "spark_tpu.service.resultCacheBytes", 1).get_or_create()
    assert bounded._data_cache.max_bytes == 1
    assert port._data_cache.max_bytes == 0
    bounded.register_table("ct", _kv_table())
    df = bounded.table("ct").select(PF.col("k"))
    df.cache()
    df.collect()
    assert len(bounded._data_cache) == 0
    assert bounded._data_cache.rejected == 1


def test_cached_decimals_widen_as_in_the_reference(both):
    """A cached table holds decimals at egress precision (19), so a
    decimal sum over it types wider than over the source, in both
    packages; the values are the same."""
    build = lambda s, F: s.table("wt").filter(F.col("i") > 1)
    agg = lambda df, F: df.group_by(F.col("s")).agg(
        F.sum(F.col("d")).alias("sd")).sort(F.col("s"))
    outs = []
    for (df, F) in zip(pair(both, build), (PF, RF)):
        plain = agg(df, F).collect()
        df.cache()
        cached = agg(df, F).collect()
        assert cached.schema.field("sd").type == pa.decimal128(29, 2)
        assert plain.schema.field("sd").type == pa.decimal128(20, 2)
        assert cached.cast(plain.schema).equals(plain)
        outs.append(cached)
    assert_tables_match(*outs)
