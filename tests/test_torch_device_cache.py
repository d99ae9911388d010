"""The port's device table cache (`spark_tpu_torch/io/device_cache.py`)
and the capacities it keeps across executions (`session._aqe_caps`), on
the CPU.

The first seven cases are `tests/test_device_cache.py`'s, on a port
session. Then: the torch device is part of a cache key; no query writes
into a cached tensor; `register_table` drops the replaced source's
batches; an execution loads each scan once, however many re-plan
attempts it makes and whether the cache is on or not; a second run
returns the same Arrow bytes with the cache on as with it off; and a
query that re-plans runs a second time in one attempt, in the port as
in the JAX package, with the same plans printed in both.
"""

import decimal
import hashlib
import itertools

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_tpu import functions as RF
from spark_tpu.observability.listener import QueryListener
from spark_tpu_torch import SparkTpuSession
from spark_tpu_torch import functions as F
from spark_tpu_torch.execution.executor import plan_nodes
from spark_tpu_torch.functions import col
from spark_tpu_torch.io.device_cache import (CACHE, is_cached, load_scan,
                                             scan_cache_key)
from spark_tpu_torch.io.sources import ArrowTableSource
from spark_tpu_torch.plan import physical as P
from spark_tpu_torch.window import Window

KEY_BUDGET = "spark_tpu.sql.io.deviceCacheBytes"
_NAMES = itertools.count()


@pytest.fixture(autouse=True)
def clear_cache():
    CACHE.clear()
    yield
    CACHE.clear()


@pytest.fixture
def port():
    return SparkTpuSession.builder().device("cpu").get_or_create()


def fresh(name: str) -> str:
    return f"{name}_{next(_NAMES)}"


# -- the JAX package's seven cases (tests/test_device_cache.py) -------------

def test_parquet_scan_cached_across_queries(port, tmp_path):
    p = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"k": np.arange(1000, dtype=np.int64) % 7,
                             "v": np.arange(1000, dtype=np.int64)}), p)
    q = lambda: (port.read_parquet(p).group_by(col("k"))
                 .agg(F.sum(col("v")).alias("s")).to_pandas()
                 .sort_values("k").reset_index(drop=True))
    first = q()
    h0 = CACHE.hits
    second = q()
    assert CACHE.hits > h0  # the warm run hit the device cache
    assert first.equals(second)


def test_parquet_rewrite_invalidates(port, tmp_path):
    p = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"v": np.arange(10, dtype=np.int64)}), p)
    s1 = port.read_parquet(p).agg(F.sum(col("v")).alias("s")) \
        .to_pandas()["s"][0]
    assert s1 == 45
    pq.write_table(pa.table({"v": np.arange(100, dtype=np.int64)}), p)
    s2 = port.read_parquet(p).agg(F.sum(col("v")).alias("s")) \
        .to_pandas()["s"][0]
    assert s2 == 4950  # (size, mtime) stamp changed -> cache miss


def test_reregister_table_not_stale(port):
    port.register_table("dc_t", pd.DataFrame(
        {"v": np.array([1, 2, 3], dtype=np.int64)}))
    a = port.table("dc_t").agg(F.sum(col("v")).alias("s")) \
        .to_pandas()["s"][0]
    port.register_table("dc_t", pd.DataFrame(
        {"v": np.array([10, 20], dtype=np.int64)}))
    b = port.table("dc_t").agg(F.sum(col("v")).alias("s")) \
        .to_pandas()["s"][0]
    assert (a, b) == (6, 30)  # fresh source token -> no stale hit


def test_budget_eviction(port, tmp_path):
    port.conf.set(KEY_BUDGET, 64 << 10)  # 64 KB
    paths = []
    for i in range(3):
        p = str(tmp_path / f"t{i}.parquet")
        pq.write_table(pa.table(
            {"v": np.arange(4000, dtype=np.int64) + i}), p)
        paths.append(p)
    for p in paths:  # each table ~32KB: the third load evicts the first
        port.read_parquet(p).agg(F.sum(col("v")).alias("s")).to_pandas()
    assert CACHE.nbytes <= 64 << 10
    assert len(CACHE._entries) < 3


def test_eviction_squeeze_recompute_parity(port, tmp_path):
    """A budget holding about one of three tables churns the LRU across
    a query loop: every reload recomputes the evicted batch from source,
    results stay correct, and the eviction counter moves."""
    port.conf.set(KEY_BUDGET, 48 << 10)  # each table is ~32KB
    paths, want = [], []
    for i in range(3):
        p = str(tmp_path / f"sq{i}.parquet")
        v = np.arange(4000, dtype=np.int64) + i
        pq.write_table(pa.table({"v": v}), p)
        paths.append(p)
        want.append(int(v.sum()))
    ev0 = CACHE.evictions
    for _round in range(3):
        for i, p in enumerate(paths):
            got = port.read_parquet(p).agg(
                F.sum(col("v")).alias("s")).to_pandas()["s"][0]
            assert int(got) == want[i], (i, _round)
    assert CACHE.evictions > ev0  # budget pressure did evict
    assert CACHE.nbytes <= 48 << 10


def test_rewrite_detected_through_eviction_churn(port, tmp_path):
    """A Parquet rewrite of the same size (a fresh mtime only) misses the
    cache, whether the old entry was evicted or is still cached."""
    p = str(tmp_path / "target.parquet")
    other = str(tmp_path / "churn.parquet")

    def total(path):
        return int(port.read_parquet(path).agg(
            F.sum(col("v")).alias("s")).to_pandas()["s"][0])

    port.conf.set(KEY_BUDGET, 48 << 10)
    pq.write_table(pa.table({"v": np.arange(1000, dtype=np.int64)}), p)
    pq.write_table(pa.table({"v": np.arange(4000, dtype=np.int64)}), other)
    assert total(p) == sum(range(1000))
    total(other)  # churn: the big table evicts the target entry
    pq.write_table(pa.table({"v": np.arange(1000, dtype=np.int64) + 7}), p)
    assert total(p) == sum(range(1000)) + 7 * 1000
    pq.write_table(pa.table({"v": np.arange(1000, dtype=np.int64) + 11}), p)
    assert total(p) == sum(range(1000)) + 11 * 1000


def test_cache_disabled_matches(port, tmp_path):
    p = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"k": np.arange(100, dtype=np.int64) % 3,
                             "v": np.arange(100, dtype=np.int64)}), p)
    q = lambda: (port.read_parquet(p).group_by(col("k"))
                 .agg(F.count().alias("c")).to_pandas()
                 .sort_values("k").reset_index(drop=True))
    warm = q()
    port.conf.set(KEY_BUDGET, 0)
    cold = q()
    assert warm.equals(cold)


# -- the port's own cases ---------------------------------------------------

def every_type_table(n: int = 300) -> pa.Table:
    """One column of each type the port loads, with NULLs, NaN, -0.0
    and infinities among the floats."""
    rs = np.random.RandomState(3)
    mask = rs.rand(n) < 0.1
    f = rs.standard_normal(n) * 50
    f[::17] = np.nan
    f[::23] = -0.0
    f[::29] = np.inf
    return pa.table({
        "i": pa.array(rs.randint(-20, 20, n), pa.int32()),
        "l": pa.array(rs.randint(-10**6, 10**6, n), pa.int64(), mask=mask),
        "f": pa.array(f, pa.float64(), mask=np.roll(mask, 3)),
        "d": pa.array([None if m else decimal.Decimal(int(x)).scaleb(-2)
                       for x, m in
                       zip(rs.randint(-10**5, 10**5, n), np.roll(mask, 5))],
                      pa.decimal128(12, 2)),
        "s": pa.array([None if m else f"s{x}" for x, m in
                       zip(rs.randint(0, 9, n), np.roll(mask, 7))]),
        "dt": pa.array(rs.randint(0, 900, n).astype("datetime64[D]")
                       .astype(object), pa.date32()),
        "b": pa.array(rs.rand(n) < 0.5, mask=np.roll(mask, 9)),
    })


def cached_checksums():
    """sha256 of every tensor of every cached batch, by key."""
    out = {}
    for key, (batch, _) in CACHE._entries.items():
        tensors = [batch.selection] + [t for c in batch.columns.values()
                                       for t in (c.data, c.validity)]
        h = hashlib.sha256()
        for t in tensors:
            if t is not None:
                h.update(t.contiguous().numpy().tobytes())
        out[key] = h.hexdigest()
    return out


def test_key_holds_the_device(port):
    name = fresh("dev")
    port.register_table(name, every_type_table())
    df = port.table(name).select(col("i"), col("s"))
    scan = plan_nodes(df._qe().executed_plan, P.ScanExec)[0]
    batch = load_scan(scan, port.conf, torch.device("cpu"))
    assert is_cached(scan, torch.device("cpu"))
    # the same scan for another device is another key: never a hit
    assert scan_cache_key(scan, torch.device("cpu")) != \
        scan_cache_key(scan, torch.device("cuda", 0))
    assert not is_cached(scan, torch.device("cuda", 0))
    assert batch.device == torch.device("cpu")
    # an execution keys its scans by the session's device
    df.collect()
    assert all(k[-1] == "cpu" for k in CACHE._entries)


def test_queries_never_write_into_cached_tensors(port):
    name, other = fresh("mut"), fresh("mut_r")
    table = every_type_table()
    port.register_table(name, table)
    port.register_table(other, table.slice(0, 120))
    t = lambda: port.table(name)
    w = Window.partition_by(col("s")).order_by(col("i"), col("l"))
    programs = [
        lambda: t().select(*[col(c) for c in table.column_names]),
        lambda: t().filter(col("i") > 0).select(
            (col("i") + 1).alias("i1"), (col("l") * 3).alias("l3"),
            (col("f") * 2.0).alias("f2"), (col("d") + col("d")).alias("d2"),
            col("s"), col("dt"), col("b")),
        lambda: t().group_by(col("s")).agg(
            F.sum(col("l")), F.min(col("f")), F.max(col("d")),
            F.avg(col("i")), F.count(), F.min(col("dt"))),
        lambda: t().group_by(col("l")).agg(F.sum(col("f")),
                                           F.max(col("i"))),
        lambda: t().group_by(col("b"), col("i")).agg(F.sum(col("d"))),
        lambda: t().join(port.table(other), on="i", how="full"),
        lambda: t().join(t(), on="s", how="left"),
        lambda: t().join(port.table(other), left_on=col("l"),
                         right_on=col("l"), how="left_anti"),
        lambda: t().sort(col("f"), col("s"), col("d")),
        lambda: t().select(col("s"), col("i"),
                           F.row_number().over(w).alias("rn"),
                           F.lag(col("f")).over(w).alias("lf"),
                           F.sum(col("l")).over(w.rows_between(-2, 0))
                           .alias("sl")),
        lambda: t().union(t().filter(col("b"))).distinct(),
        lambda: t().limit(17),
    ]
    for program in programs:
        program().collect()
    before = cached_checksums()
    assert len(before) >= 2
    for program in programs:
        program().collect()
    assert cached_checksums() == before


def test_register_table_drops_the_replaced_batches(port):
    name = fresh("reg")
    port.register_table(name, every_type_table())
    port.table(name).collect()
    old = port.catalog[name].cache_token()
    assert any(k[0] == old for k in CACHE._entries)
    port.register_table(name, every_type_table(50))
    assert not any(k[0] == old for k in CACHE._entries)
    assert port.table(name).collect().num_rows == 50


class CountingSource(ArrowTableSource):
    """An in-memory table that counts its loads."""

    def __init__(self, name, table):
        super().__init__(name, table)
        self.loads = 0

    def load(self, required_columns, pushed_filters, device):
        self.loads += 1
        return super().load(required_columns, pushed_filters, device)


def hot_key_tables():
    """16 probe rows and 40 build rows on one key: the unique build fails,
    then the expansion overflows the probe capacity (3 attempts)."""
    probe = pa.table({"k": pa.array([0] * 16 + [1, 2], pa.int64()),
                      "v": pa.array(np.arange(18, dtype=np.int64))})
    build = pa.table({"k2": pa.array([0] * 40 + [2], pa.int64()),
                      "w": pa.array(np.arange(41, dtype=np.int64))})
    return probe, build


@pytest.mark.parametrize("budget", [6 << 30, 0])
def test_scans_load_once_per_execution(port, budget):
    port.conf.set(KEY_BUDGET, budget)
    probe, build = hot_key_tables()
    sources = [CountingSource(fresh("probe"), probe),
               CountingSource(fresh("build"), build)]
    for s in sources:
        port.register_table(s.name, s)
    qe = port.table(sources[0].name).join(
        port.table(sources[1].name), left_on=col("k"),
        right_on=col("k2"))._qe()
    assert qe.collect().num_rows == 16 * 40 + 1
    assert qe.attempts == 3
    assert [s.loads for s in sources] == [1, 1]
    # a second execution loads again only without the cache
    port.table(sources[0].name).join(
        port.table(sources[1].name), left_on=col("k"),
        right_on=col("k2")).collect()
    assert [s.loads for s in sources] == ([1, 1] if budget else [2, 2])


def test_shared_scan_node_loads_once(port):
    """A runtime filter's creation chain is the join build side's scan
    node itself: that one node loads once."""
    rs = np.random.RandomState(8)
    fact = CountingSource(fresh("fact"), pa.table({
        "k": pa.array(rs.randint(0, 5000, 20000), pa.int64()),
        "v": pa.array(np.arange(20000, dtype=np.int64))}))
    dim = CountingSource(fresh("dim"), pa.table({
        "k2": pa.array(np.arange(5000, dtype=np.int64)),
        "g": pa.array(np.arange(5000, dtype=np.int64) % 50)}))
    port.register_table(fact.name, fact)
    port.register_table(dim.name, dim)
    qe = port.table(fact.name).join(
        port.table(dim.name).filter(col("g") == 3), left_on=col("k"),
        right_on=col("k2")).agg(F.sum(col("v")))._qe()
    qe.collect()
    assert plan_nodes(qe.executed_plan, P.RuntimeFilterExec)
    assert [fact.loads, dim.loads] == [1, 1]


def test_second_run_with_the_cache_equals_a_run_without(port):
    probe, build = hot_key_tables()
    names = [fresh("p"), fresh("b")]
    port.register_table(names[0], probe)
    port.register_table(names[1], build)

    def run():
        return port.table(names[0]).join(
            port.table(names[1]), left_on=col("k"), right_on=col("k2")) \
            .group_by(col("k")).agg(F.sum(col("w")), F.count()).collect()

    run()
    warm = run()
    assert CACHE.hits >= 2
    port.conf.set(KEY_BUDGET, 0)
    cold = run()
    assert warm.equals(cold)


class StageAttempts(QueryListener):
    """Counts the JAX package's stage runs (one per re-plan attempt)."""

    def __init__(self):
        self.runs = 0

    def on_stage_completed(self, event) -> None:
        self.runs += 1


def test_second_run_starts_from_saved_capacities(port, session):
    """The hot-key join re-plans twice on its first run in both
    packages; the second run of the same query starts from the kept
    capacities and takes one attempt in both, and both packages print
    the same plans before and after each run."""
    probe, build = hot_key_tables()
    names = [fresh("hp"), fresh("hb")]
    for s in (port, session):
        s.register_table(names[0], probe)
        s.register_table(names[1], build)
    listener = StageAttempts()
    session.add_listener(listener)
    try:
        for attempts in (3, 1):
            listener.runs = 0
            pqe = port.table(names[0]).join(
                port.table(names[1]), left_on=F.col("k"),
                right_on=F.col("k2"))._qe()
            rqe = session.table(names[0]).join(
                session.table(names[1]), left_on=RF.col("k"),
                right_on=RF.col("k2"))._qe()
            assert pqe.executed_plan.tree_string() == \
                rqe.executed_plan.tree_string()
            got, want = pqe.collect(), rqe.collect()
            assert got.equals(want)
            assert pqe.executed_plan.tree_string() == \
                rqe.executed_plan.tree_string()
            assert "cap=1024" in pqe.executed_plan.tree_string()
            assert (pqe.attempts, listener.runs) == (attempts, attempts)
    finally:
        session.remove_listener(listener)
    assert len(port._aqe_caps) == 1


def test_stats_counts_hits_misses_and_bytes(port):
    """hits and misses count from the process start; bytes and entries
    are what the cache holds now."""
    name = fresh("st")
    port.register_table(name, every_type_table())
    start = CACHE.stats()
    port.table(name).collect()
    first = CACHE.stats()
    port.table(name).collect()
    second = CACHE.stats()
    assert first["misses"] == start["misses"] + 1
    assert first["entries"] == 1
    assert second["hits"] == first["hits"] + 1
    assert second["bytes"] == first["bytes"] > 0


def test_cache_key_is_stable_across_plannings(port):
    """Two plannings of one query give their scans the same key: the
    pushed filters print without object ids (dates, decimals, strings
    and IN lists among them)."""
    name = fresh("stable")
    port.register_table(name, every_type_table())

    def keys():
        df = port.table(name).filter(
            (col("dt") >= F.to_date("1970-03-01"))
            & (col("d") > F.lit(decimal.Decimal("1.25"), col("d").dtype(
                port.table(name).schema)))
            & (col("s") == F.lit("s3")) & col("i").isin(1, 2, 3)) \
            .select(col("l"), col("f"))
        scans = plan_nodes(df._qe().executed_plan, P.ScanExec)
        return [scan_cache_key(s, torch.device("cpu")) for s in scans]

    first = keys()
    assert first == keys()
    assert first[0][2], "the filters were pushed into the scan"


def test_estimated_scan_bytes_matches_reference(port, session):
    from spark_tpu.io.device_cache import estimated_scan_bytes as ref_est
    from spark_tpu.plan import physical as RP
    from spark_tpu_torch.io.device_cache import estimated_scan_bytes
    name = fresh("est")
    port.register_table(name, every_type_table())
    session.register_table(name, every_type_table())
    pscan = plan_nodes(port.table(name).select(col("s"), col("d"), col("b"))
                       ._qe().executed_plan, P.ScanExec)[0]
    rplan = session.table(name).select(
        RF.col("s"), RF.col("d"), RF.col("b"))._qe().executed_plan
    rscans = []

    def walk(node):
        if isinstance(node, RP.ScanExec):
            rscans.append(node)
        for c in node.children:
            walk(c)

    walk(rplan)
    assert estimated_scan_bytes(pscan) == ref_est(rscans[0]) > 0


def test_pins_survive_eviction():
    """Pinned entries (in use by a running query) are skipped by budget
    eviction and by `evict_bytes`; unpinned, they go first in LRU order."""
    from spark_tpu_torch.columnar import Batch, Column
    from spark_tpu_torch import types as T
    from spark_tpu_torch.io.device_cache import DeviceTableCache

    def batch():  # 8,000 bytes of data
        return Batch({"v": Column(torch.zeros(1000, dtype=torch.int64),
                                  T.LONG)})

    cache = DeviceTableCache()
    cache.put(("a",), batch(), budget=20_000)
    cache.put(("b",), batch(), budget=20_000)
    assert cache.pin(("a",)) and not cache.pin(("zz",))
    cache.put(("c",), batch(), budget=20_000)  # evicts b, not pinned a
    assert cache.contains(("a",)) and not cache.contains(("b",))
    assert cache.evict_bytes(1 << 20) == 8_000  # only c could go
    assert cache.contains(("a",)) and cache.nbytes == 8_000
    cache.unpin(("a",))
    assert cache.evict_bytes(1) == 8_000 and cache.nbytes == 0
    assert cache.stats()["evictions"] == 3
