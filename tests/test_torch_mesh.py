"""The mesh (slice 10a) against the JAX package: the non-streaming shapes
of `tests/test_multichip.py` at mesh 8, each through the port (8 shard
threads on the CPU device) and the JAX package (8 virtual CPU devices),
results in the reference's order, executed plans printed the same, and
the port's mesh-0 rows (`tests/torch_mesh_parity.py`)."""

import numpy as np
import pandas as pd
import pytest

from torch_mesh_parity import check, sessions

BCAST = "spark_tpu.sql.autoBroadcastJoinThreshold"


@pytest.fixture(scope="module")
def pair():
    return sessions()


def frame(s, pdf, name):
    return s.create_dataframe(pdf, name)


def test_groupby_direct(pair):
    check(*pair, lambda s, x: s.range(10_000)
          .group_by((x.col("id") % 97).alias("k"))
          .agg(x.F.count().alias("c"), x.F.sum(x.col("id")).alias("s")))


def test_groupby_sort_path(pair):
    pdf = pd.DataFrame({
        "k": np.random.RandomState(0).randint(0, 1000, 5000) * 1_000_003,
        "v": np.arange(5000, dtype=np.int64)})
    check(*pair, lambda s, x: frame(s, pdf, "gsp").group_by(x.col("k")).agg(
        x.F.sum(x.col("v")).alias("s"), x.F.count().alias("c"),
        x.F.min(x.col("v")).alias("mn"), x.F.max(x.col("v")).alias("mx")))


def test_global_aggregate(pair):
    check(*pair, lambda s, x: s.range(12_345).agg(
        x.F.sum(x.col("id")).alias("s"), x.F.count().alias("c"),
        x.F.min(x.col("id")).alias("mn"), x.F.max(x.col("id")).alias("mx"),
        x.F.avg(x.col("id")).alias("a")))


def test_join_shuffle(pair):
    rs = np.random.RandomState(1)
    left = pd.DataFrame({"k": rs.randint(0, 500, 2000).astype(np.int64),
                         "lv": np.arange(2000, dtype=np.int64)})
    right = pd.DataFrame({"k": np.arange(500, dtype=np.int64),
                          "rv": np.arange(500, dtype=np.int64) * 10})
    check(*pair, lambda s, x: frame(s, left, "jsl").join(
        frame(s, right, "jsr"), on="k"))


@pytest.mark.parametrize("how", ["inner", "left", "right", "outer"])
def test_join_many_to_many_outer(pair, how):
    left = pd.DataFrame({"k": np.array([1, 2, 2, 3, 9], dtype=np.int64),
                         "lv": np.array([1, 2, 3, 4, 5], dtype=np.int64)})
    right = pd.DataFrame({"k": np.array([2, 2, 3, 7], dtype=np.int64),
                          "rv": np.array([20, 21, 30, 70], dtype=np.int64)})
    check(*pair, lambda s, x: frame(s, left, f"mml_{how}").join(
        frame(s, right, f"mmr_{how}"), on="k", how=how))


def test_string_join_broadcast(pair):
    fact = pd.DataFrame({"s": [f"key{i % 7}" for i in range(1000)],
                         "v": np.arange(1000, dtype=np.int64)})
    dim = pd.DataFrame({"s": [f"key{i}" for i in range(7)],
                        "dv": np.arange(7, dtype=np.int64) * 100})
    check(*pair, lambda s, x: frame(s, fact, "sjf").join(
        frame(s, dim, "sjd"), on="s"))


def test_broadcast_strategy_planned(pair):
    port, ref = pair
    fact = pd.DataFrame({"k": np.arange(1000, dtype=np.int64) % 7,
                         "v": np.arange(1000, dtype=np.int64)})
    dim = pd.DataFrame({"k": np.arange(7, dtype=np.int64),
                        "dv": np.arange(7, dtype=np.int64)})
    pq, _ = check(port, ref, lambda s, x: frame(s, fact, "bsf").join(
        frame(s, dim, "bsd"), on="k"))
    plan = pq.executed_plan.tree_string()
    assert "strategy=broadcast" in plan and "Replicated" in plan


def test_sort_global_order(pair):
    pdf = pd.DataFrame({"x": np.random.RandomState(2).permutation(4000)
                        .astype(np.int64)})
    pq, _ = check(*pair, lambda s, x: frame(s, pdf, "sgo").sort(
        x.col("x").desc()))
    out = pq.collect().column("x").to_pylist()
    assert out == sorted(pdf["x"].tolist(), reverse=True)


def test_sort_limit(pair):
    pq, _ = check(*pair, lambda s, x: s.range(1000).sort(
        x.col("id").desc()).limit(5))
    assert pq.collect().column("id").to_pylist() == [999, 998, 997, 996, 995]


def test_string_groupby(pair):
    pdf = pd.DataFrame({"s": [f"g{i % 13}" for i in range(3000)],
                        "v": np.arange(3000, dtype=np.int64)})
    check(*pair, lambda s, x: frame(s, pdf, "sgb").group_by(x.col("s"))
          .agg(x.F.sum(x.col("v")).alias("sv")))


def test_join_copartition_subset_keys(pair):
    port, ref = pair
    rs = np.random.RandomState(3)
    base = pd.DataFrame({"a": rs.randint(0, 40, 600).astype(np.int64),
                         "b": rs.randint(0, 5, 600).astype(np.int64)})
    rdf = pd.DataFrame({"a": np.arange(40, dtype=np.int64),
                        "b": np.arange(40, dtype=np.int64) % 5,
                        "rv": np.arange(40, dtype=np.int64)})
    port.conf.set(BCAST, 0)
    ref.conf.set(BCAST, 0)
    try:
        check(port, ref, lambda s, x: frame(s, base, "csl")
              .group_by(x.col("a")).agg(x.F.max(x.col("b")).alias("b"))
              .join(frame(s, rdf, "csr"), on=["a", "b"]))
    finally:
        port.conf.unset(BCAST)
        ref.conf.unset(BCAST)


def test_full_outer_then_groupby(pair):
    left = pd.DataFrame({"k": np.array([1, 2, 3], dtype=np.int64),
                         "lv": np.array([1, 2, 3], dtype=np.int64)})
    right = pd.DataFrame({"k": np.array([3, 4, 5, 6], dtype=np.int64),
                          "rv": np.array([30, 40, 50, 60], dtype=np.int64)})
    check(*pair, lambda s, x: frame(s, left, "fol").join(
        frame(s, right, "for"), left_on=x.col("k"), right_on=x.col("k"),
        how="full").group_by(x.col("k")).agg(x.F.count().alias("c")))


def test_cross_join(pair):
    a = pd.DataFrame({"x": np.arange(20, dtype=np.int64)})
    b = pd.DataFrame({"y": np.arange(7, dtype=np.int64)})
    check(*pair, lambda s, x: frame(s, a, "cja").cross_join(
        frame(s, b, "cjb")))


def test_filter_project(pair):
    check(*pair, lambda s, x: s.range(5000)
          .filter((x.col("id") % 7) == x.lit(3))
          .select((x.col("id") * 2).alias("x")))


def test_union(pair):
    a = pd.DataFrame({"k": np.arange(12, dtype=np.int64)})
    b = pd.DataFrame({"k": np.arange(100, 108, dtype=np.int64)})
    check(*pair, lambda s, x: frame(s, a, "ua").union(frame(s, b, "ub")))


def test_union_then_groupby(pair):
    a = pd.DataFrame({"k": np.arange(20, dtype=np.int64) % 5})
    b = pd.DataFrame({"k": np.arange(20, dtype=np.int64) % 3})
    check(*pair, lambda s, x: frame(s, a, "uga").union(frame(s, b, "ugb"))
          .group_by(x.col("k")).agg(x.F.count().alias("c")))


def test_full_join_computed_key(pair):
    left = pd.DataFrame({"x": np.arange(8, dtype=np.int64)})
    right = pd.DataFrame({"y": np.arange(4, 12, dtype=np.int64)})
    check(*pair, lambda s, x: frame(s, left, "fl").join(
        frame(s, right, "fr"), left_on=x.col("x") + 0, right_on=x.col("y"),
        how="outer"))


def test_skewed_exchange_retry(pair):
    pdf = pd.DataFrame({"k": np.zeros(4000, dtype=np.int64),
                        "v": np.arange(4000, dtype=np.int64)})
    check(*pair, lambda s, x: frame(s, pdf, "skewed").group_by(x.col("k"))
          .agg(x.F.sum(x.col("v")).alias("s"), x.F.count().alias("c")))


def test_skewed_join_exchange(pair):
    port, ref = pair
    rs = np.random.RandomState(7)
    left = pd.DataFrame({"k": np.where(rs.rand(3000) < 0.9, 1,
                                       rs.randint(0, 50, 3000))
                         .astype(np.int64),
                         "lv": np.arange(3000, dtype=np.int64)})
    right = pd.DataFrame({"k": np.arange(50, dtype=np.int64),
                          "rv": np.arange(50, dtype=np.int64) * 3})
    port.conf.set(BCAST, 0)
    ref.conf.set(BCAST, 0)
    try:
        check(port, ref, lambda s, x: frame(s, left, "skl").join(
            frame(s, right, "skr"), on="k"))
    finally:
        port.conf.unset(BCAST)
        ref.conf.unset(BCAST)


def test_union_mixed_partitioning(pair):
    a = pd.DataFrame({"k": np.arange(6, dtype=np.int64)})
    b = pd.DataFrame({"k": np.arange(50, 70, dtype=np.int64)})
    check(*pair, lambda s, x: frame(s, a, "mua").sort(x.col("k")).union(
        frame(s, b, "mub")))


def test_range_sort(pair):
    rs = np.random.RandomState(3)
    pdf = pd.DataFrame({"k": rs.randint(-1000, 1000, 5000).astype(np.int64),
                        "v": np.arange(5000, dtype=np.int64)})
    pq, _ = check(*pair, lambda s, x: frame(s, pdf, "rsort").sort(
        x.col("k"), x.col("v")))
    assert "RangePartitioning" in pq.executed_plan.tree_string()
    want = pdf.sort_values(["k", "v"]).reset_index(drop=True)
    got = pq.collect().to_pandas()
    assert got["k"].tolist() == want["k"].tolist()
    assert got["v"].tolist() == want["v"].tolist()


def test_sort_desc_limit(pair):
    pdf = pd.DataFrame({"k": np.random.RandomState(4).randint(
        0, 10**9, 3000).astype(np.int64)})
    pq, _ = check(*pair, lambda s, x: frame(s, pdf, "rsl").sort(
        x.col("k").desc()).limit(7))
    want = pdf.sort_values("k", ascending=False).head(7)
    assert pq.collect().column("k").to_pylist() == want["k"].tolist()


def test_sort_skewed_keys(pair):
    pdf = pd.DataFrame({"k": np.concatenate([
        np.zeros(2500, dtype=np.int64), np.arange(100, dtype=np.int64) + 1])})
    pq, _ = check(*pair, lambda s, x: frame(s, pdf, "rskew").sort(
        x.col("k")))
    assert pq.collect().column("k").to_pylist() == sorted(pdf["k"].tolist())


def test_dryrun_mesh():
    """The port's counterpart of `__graft_entry__.dryrun_multichip`: the
    whole distributed path at small shapes against one device."""
    from spark_tpu_torch.parallel.dryrun import dryrun_mesh
    done = dryrun_mesh(8, "cpu")
    assert len(done) == 11


def test_stripes_follow_the_reference_layout():
    """A leaf pads to a multiple of the shards after its bucketed load
    and each shard takes a contiguous stripe, as the JAX package's
    `pad_batch_to_multiple` and `P('data')` do: 600 rows in a capacity
    of 1,024 leave the last of 4 shards with padding alone."""
    import pyarrow as pa
    from spark_tpu.columnar import Batch as RefBatch
    from spark_tpu.parallel.shuffle import pad_batch_to_multiple
    from spark_tpu_torch.columnar import Batch
    from spark_tpu_torch.parallel.shuffle import shard_stripes
    table = pa.table({"x": pa.array(range(600), pa.int64())})
    stripes = shard_stripes(Batch.from_arrow(table, "cpu"), 4)
    live = [int(b.selection_mask().sum()) for b in stripes]
    assert live == [256, 256, 88, 0]
    ref = pad_batch_to_multiple(RefBatch.from_arrow(table), 4)
    ref_sel = np.asarray(ref.selection_mask()).reshape(4, -1).sum(axis=1)
    assert live == ref_sel.tolist()
    got = np.concatenate([b.columns["x"].data.numpy() for b in stripes])
    assert np.array_equal(got, np.asarray(ref.columns["x"].data))
