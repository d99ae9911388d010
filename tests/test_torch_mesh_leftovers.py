"""The mesh halves of earlier slices against the JAX package at mesh 8:
a Python UDF below a mesh-sharded aggregate (`tests/test_udf.py:112`),
First/Last merged across shards (`tests/test_correctness_fixes.py:254`),
sliding window frames (`tests/test_window.py:248`), explode
(`tests/test_arrays.py:119`) and the positional aggregates
(`tests/test_positional_agg.py:77`, `:119`), each held as
`tests/torch_mesh_parity.py` says."""

import numpy as np
import pandas as pd
import pytest

from torch_mesh_parity import check, sessions


@pytest.fixture(scope="module")
def pair():
    return sessions()


def _register(pair, name, pdf):
    for s in pair:
        s.register_table(name, pdf)


def test_udf_on_mesh(pair):
    pdf = pd.DataFrame({"x": np.array([1.0, 2.0, np.nan, 4.0]),
                        "i": np.array([10, 20, 30, 40], dtype=np.int64),
                        "s": ["aa", "bb", None, "dd"]})
    _register(pair, "udf_t", pdf)

    def build(s, x):
        twice = x.F.udf(lambda v: v * 2, "long")
        return (s.table("udf_t").select(twice(x.col("i")).alias("t"))
                .agg(x.F.sum(x.col("t")).alias("s")))

    pq, _ = check(*pair, build)
    assert "InputExec(python_udf" in pq.spliced_plan.tree_string()
    assert pq.collect().column("s").to_pylist() == [2 * pdf["i"].sum()]


def test_first_mesh_merge_picks_genuine_rows(pair):
    v1, v2 = (2 << 32) | 1, (1 << 32) | 5
    n = 4096
    x = np.full(n, v2, np.int64)
    x[:512] = v1  # shard 0 holds the v1 rows; shards 1..7 hold v2
    _register(pair, "first_mesh",
              pd.DataFrame({"k": np.zeros(n, np.int64), "x": x}))
    pq, _ = check(*pair, lambda s, x: s.table("first_mesh")
                  .group_by(x.col("k"))
                  .agg(x.F.first(x.col("x")).alias("f"),
                       x.F.last(x.col("x")).alias("l")))
    out = pq.collect().to_pandas()
    assert int(out["f"][0]) in (v1, v2) and int(out["l"][0]) in (v1, v2)


def test_window_frames_on_mesh(pair):
    rs = np.random.RandomState(11)
    n = 500
    _register(pair, "wf_mesh", pd.DataFrame({
        "g": rs.randint(0, 7, n).astype(np.int64),
        "t": rs.permutation(n).astype(np.int64),
        "v": rs.randn(n)}))

    def build(s, x):
        w = (x.Window.partition_by(x.col("g")).order_by(x.col("t"))
             .rows_between(-2, 0))
        return s.table("wf_mesh").select(
            x.col("g"), x.col("t"), x.F.sum(x.col("v")).over(w).alias("s"))

    check(*pair, build)


def test_explode_on_mesh(pair):
    _register(pair, "arr_t", pd.DataFrame({
        "k": np.array([1, 2, 3, 4], np.int64),
        "a": [[1, 2, 3], [], [4, 5], None],
        "v": np.array([10.0, 20.0, 30.0, 40.0])}))
    pq, _ = check(*pair, lambda s, x: s.table("arr_t").select(
        x.col("k"), x.F.explode(x.col("a")).alias("e"))
        .agg(x.F.sum(x.col("e")).alias("s")))
    assert "InputExec(generated" in pq.spliced_plan.tree_string()
    assert pq.collect().column("s").to_pylist() == [15]


@pytest.fixture(scope="module")
def pos(pair):
    rs = np.random.RandomState(9)
    d = pd.DataFrame({
        "g": rs.randint(0, 5, 200).astype(np.int64),
        "v": rs.randn(200),
        "i": rs.randint(0, 10, 200).astype(np.int64),
        "s": rs.choice(["aa", "bb", "cc"], 200)})
    d.loc[::17, "v"] = np.nan  # NULLs must be ignored
    _register(pair, "pos_t", d)
    return d


def test_positional_on_mesh(pair, pos):
    check(*pair, lambda s, x: s.table("pos_t").group_by(x.col("g")).agg(
        x.F.median(x.col("v")).alias("m")))


def test_positional_computed_group_key_on_mesh(pair, pos):
    check(*pair, lambda s, x: s.table("pos_t")
          .group_by((x.col("g") % 2).alias("gb"))
          .agg(x.F.median(x.col("v")).alias("m")))


def test_list_columns_on_mesh(pair):
    """A global collect_list on the mesh gives the one-device list (the
    stripes keep their offsets); a list column that would cross an
    exchange (collect_list by key, then ORDER BY) raises a named
    AnalysisError. The JAX package moves a list column's flat values
    through the collectives without its offsets and returns flat
    integers for both queries at mesh 8 (ROADMAP Queue 3)."""
    from spark_tpu_torch.expr import AnalysisError
    from torch_mesh_parity import MESH, PORT
    port, _ = pair
    _register(pair, "cl_t", pd.DataFrame({"k": np.arange(40) % 3,
                                          "v": np.arange(40)}))
    glob = lambda: port.table("cl_t").agg(
        PORT.F.collect_list(PORT.col("v")).alias("l")).collect()
    want = glob()
    port.conf.set(MESH, 8)
    try:
        assert glob().equals(want)
        assert want.column("l").to_pylist() == [list(range(40))]
        with pytest.raises(AnalysisError, match="array column 'l'"):
            (port.table("cl_t").group_by(PORT.col("k"))
             .agg(PORT.F.collect_list(PORT.col("v")).alias("l"))
             .sort(PORT.col("k")).collect())
    finally:
        port.conf.set(MESH, 0)
