"""The mesh's adaptive re-planning against the JAX package (the cases of
`tests/test_adaptive_skew.py` at mesh 8): a skewed shuffle join re-plans
to broadcast, a build past the skew limit keeps the shuffle and grows
its blocks, and range-sort bounds sample live rows."""

import numpy as np
import pandas as pd
import pytest

from torch_mesh_parity import MESH, check, sessions

BCAST = "spark_tpu.sql.autoBroadcastJoinThreshold"
SKEW_LIMIT = "spark_tpu.sql.adaptive.skewJoin.broadcastThreshold"


@pytest.fixture(scope="module")
def pair():
    return sessions()


def _register(pair, name, pdf):
    for s in pair:
        s.register_table(name, pdf)


def test_skewed_join_replans_to_broadcast(pair):
    port, ref = pair
    rs = np.random.RandomState(3)
    n = 80_000
    k = rs.randint(0, 1000, n).astype(np.int64)
    k[: int(n * 0.9)] = 7  # 90% of rows share one key
    _register(pair, "skew_fact", pd.DataFrame({"k": k, "v": np.ones(n)}))
    _register(pair, "skew_dim", pd.DataFrame({
        "k": np.arange(1000, dtype=np.int64),
        "w": np.arange(1000, dtype=np.float64)}))
    for s in pair:
        s.conf.set(BCAST, 0)  # the first plan shuffles
    try:
        pq, rq = check(port, ref, lambda s, x: s.table("skew_fact").join(
            s.table("skew_dim"), left_on=x.col("k"), right_on=x.col("k"))
            .agg(x.F.sum(x.col("v") * x.col("w")).alias("s"),
                 x.F.count().alias("c")))
    finally:
        for s in pair:
            s.conf.unset(BCAST)
    assert pq._join_overrides == rq._join_overrides == {"j0": "broadcast"}
    assert "strategy=broadcast" in pq.executed_plan.tree_string()
    assert pq.collect().column("c").to_pylist() == [n]


def test_skew_replan_respects_build_size_limit(pair):
    port, ref = pair
    rs = np.random.RandomState(4)
    n = 40_000
    k = rs.randint(0, 500, n).astype(np.int64)
    k[: int(n * 0.9)] = 3
    _register(pair, "skew_fact2", pd.DataFrame({"k": k, "v": np.ones(n)}))
    _register(pair, "skew_dim2", pd.DataFrame({
        "k": np.arange(500, dtype=np.int64), "w": np.ones(500)}))
    for s in pair:
        s.conf.set(BCAST, 0)
        s.conf.set(SKEW_LIMIT, 1)  # nothing may broadcast
    try:
        pq, rq = check(port, ref, lambda s, x: s.table("skew_fact2").join(
            s.table("skew_dim2"), left_on=x.col("k"), right_on=x.col("k"))
            .agg(x.F.count().alias("c")))
    finally:
        for s in pair:
            s.conf.unset(BCAST)
            s.conf.unset(SKEW_LIMIT)
    assert not pq._join_overrides and not rq._join_overrides
    assert pq.attempts > 1  # the receive blocks grew instead


def test_range_sort_balanced_under_clustered_selection(pair):
    port, ref = pair
    n = 40_000
    _register(pair, "clus_t", pd.DataFrame({
        "pos": np.arange(n, dtype=np.int64),
        "key": np.random.RandomState(5).permutation(n).astype(np.int64)}))
    pq, rq = check(port, ref, lambda s, x: s.table("clus_t")
                   .filter(x.col("pos") < n // 20).sort(x.col("key")))
    exch_max = {k: v for k, v in pq.last_metrics.items()
                if k.startswith("exch_max_e")}
    assert exch_max and exch_max == {
        k: v for k, v in rq.last_metrics.items()
        if k.startswith("exch_max_e")}
    live = n // 20
    assert max(exch_max.values()) <= 2 * (live / 8)
    got = pq.collect().column("key").to_pylist()
    assert len(got) == live and got == sorted(got)


def test_range_sort_tiny_live_counts(pair):
    n = 4_000
    _register(pair, "tiny_live", pd.DataFrame({
        "pos": np.arange(n, dtype=np.int64),
        "key": np.random.RandomState(6).permutation(n).astype(np.int64)}))
    pq, _ = check(*pair, lambda s, x: s.table("tiny_live")
                  .filter(x.col("pos") % 100 == 3).sort(x.col("key")))
    got = pq.collect().column("key").to_pylist()
    assert len(got) == n // 100 and got == sorted(got)


def test_mesh_metrics_reduce_as_the_reference(pair):
    """Flags sum and the capacity-sizing metrics take the worst shard,
    the rest sum: the port's last_metrics equal the JAX package's."""
    port, ref = pair
    pdf = pd.DataFrame({"k": np.arange(3000, dtype=np.int64) % 11,
                        "v": np.arange(3000, dtype=np.int64)})
    _register(pair, "mred", pdf)
    pq, rq = check(port, ref, lambda s, x: s.table("mred")
                   .group_by(x.col("k")).agg(x.F.sum(x.col("v")).alias("s")))
    keys = [k for k in rq.last_metrics
            if k.startswith(("exch_", "agg_groups"))]
    assert keys
    assert {k: pq.last_metrics[k] for k in keys} == \
        {k: rq.last_metrics[k] for k in keys}
    assert port.conf.get(MESH) == 0
