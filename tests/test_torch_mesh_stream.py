"""The port's mesh stream (`streaming_agg.stream_scan_aggregate_mesh`) and
its checkpoints against the JAX package's, on the CPU: the port at mesh
8 pinned to the CPU, the JAX package at mesh 8 on its virtual devices,
over TPC-H SF 0.002 in chunks of 1,024 rows with the device cache off.

- `tests/test_multichip.py::test_distributed_streaming_aggregate`
  through both packages (the stream must engage in each);
- DataFrame Q1 and Q6 and SQL Q1 streamed per shard: the same rows in
  the same order, the same executed and spliced plans
  (`InputExec(streamed_partial_agg,...)`) and `describe()`, the port's
  golden, and the port's mesh-0 stream's rows;
- the mesh cases of `tests/test_recovery.py`: a shard lost at the 2nd
  snapshot with the gang restart off resumes on one device from the
  checkpoint, everyChunks=0 and a loss at the first snapshot fall back
  from chunk 0, a clean run takes checkpoints and no recovery action, a
  checkpoint under other chunk boundaries is never restored, and
  predicate values separate checkpoint keys;
- the per-shard telemetry fed by the real stream: one compute record
  per (shard, chunk) with the stripe's live rows, as in the JAX package;
- first/last over the mesh stream (the packed row base: chunk base plus
  shard times the stripe's capacity) against pandas and the JAX package;
- `PrefetchChunkIterator.skip_chunks`, which raises once the worker has
  started.
"""

import warnings

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

import spark_tpu.execution.streaming_agg as RSA
import spark_tpu_torch.execution.streaming_agg as PSA
from spark_tpu import functions as RF
from spark_tpu.execution import executor as REX
from spark_tpu_torch import SparkTpuSession
from spark_tpu_torch import functions as PF
from spark_tpu_torch.execution import executor as PEX
from spark_tpu_torch.io.sources import (ArrowTableSource,
                                        PrefetchChunkIterator)
from spark_tpu_torch.plan import physical as P
from spark_tpu_torch.tpch.sql_queries import SQL_QUERIES

import torch_ooc_parity as H
from torch_elastic_parity import assert_rows_equal, both

MESH_KEY = "spark_tpu.sql.mesh.size"
CKPT_KEY = "spark_tpu.execution.checkpoint.everyChunks"
RESTART_KEY = "spark_tpu.execution.meshRestart.enabled"
SPANS_KEY = "spark_tpu.sql.observability.shardSpans"


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return H.Pair(H.write_data(tmp_path_factory, "mesh_stream"),
                  "mesh_stream")


@pytest.fixture(autouse=True)
def streaming(pair):
    pair.reset()
    yield
    pair.reset()


def F(session):
    return PF if isinstance(session, SparkTpuSession) else RF


class Spy:
    """Counts the mesh stream's engagements in one package."""

    def __init__(self, monkeypatch, mod):
        self.calls = []
        orig = mod.stream_scan_aggregate_mesh

        def spy(*args, **kwargs):
            out = orig(*args, **kwargs)
            self.calls.append(out is not None)
            return out

        monkeypatch.setattr(mod, "stream_scan_aggregate_mesh", spy)


def test_distributed_streaming_aggregate(pair, monkeypatch):
    """Per-shard accumulator tables carried across host-ingested chunks,
    count and sum by v % 37 over 5,000 random rows, against mesh 0."""
    rs = np.random.RandomState(9)
    pdf = pd.DataFrame({"v": rs.randint(0, 10**6, 5000).astype(np.int64)})
    spies = (Spy(monkeypatch, PSA), Spy(monkeypatch, RSA))

    def make(session):
        f = F(session)
        session.register_table("stream_t", pdf)
        return (session.table("stream_t")
                .group_by((f.col("v") % 37).alias("k"))
                .agg(f.count().alias("c"), f.sum(f.col("v")).alias("s")))

    port, ref = both(pair, lambda s: make(s)._qe(), confs=((MESH_KEY, 8),))
    assert all(any(s.calls) for s in spies), "the mesh stream never engaged"
    for r in (port, ref):
        got = r.got.to_pandas().sort_values("k").reset_index(drop=True)
        want = pdf.assign(k=pdf.v % 37).groupby("k")["v"].agg(
            c="count", s="sum").reset_index()
        assert got["c"].tolist() == want["c"].tolist()
        assert got["s"].tolist() == want["s"].tolist()
    pair.set((MESH_KEY, 0))
    one = make(pair.port).collect().sort_by("k")
    assert_rows_equal(port.got.sort_by("k"), one)


def _query(name, sql):
    if sql:
        return lambda s: s.sql(SQL_QUERIES[name])._qe()
    mk = H.query(name)
    return lambda s: mk(s)._qe()


@pytest.mark.parametrize("name,sql", [("q1", False), ("q6", False),
                                      ("q1", True)])
def test_tpch_mesh_streamed(pair, name, sql):
    with H.spliced() as seen:
        port, ref = both(pair, _query(name, sql), confs=((MESH_KEY, 8),))
    text = port.qe.spliced_plan.tree_string()
    assert "InputExec(streamed_partial_agg," in text
    assert text == seen[-1].tree_string()
    assert port.qe.executed_plan.tree_string() == \
        ref.qe.executed_plan.tree_string()
    assert port.qe.executed_plan.describe() == \
        ref.qe.executed_plan.describe()
    assert port.qe.fault_summary == {}
    H.check_golden(port.got, name, pair.path)
    pair.set((MESH_KEY, 0))
    one = _query(name, sql)(pair.port)
    assert_rows_equal(port.got, one.collect())
    assert "InputExec(streamed_agg," in one.spliced_plan.tree_string()


# -- the mesh cases of tests/test_recovery.py ----------------------------------

def test_checkpoint_restore_resumes_at_cursor(pair):
    """A shard lost at the 2nd snapshot point with the gang restart off:
    the single-device fallback resumes at the chunk-2 checkpoint."""
    runs = both(pair, _query("q1", False), "mesh_checkpoint:fatal:2",
                ((RESTART_KEY, False), (MESH_KEY, 8), (CKPT_KEY, 2)))
    for r in runs:
        assert r.plan.fired_log == [("mesh_checkpoint", 2, "fatal")]
        assert r.qe.fault_summary.get("mesh_fallback") == 1
        assert r.qe.fault_summary.get("checkpoint_restore") == 1
        restore = next(ev for ev in r.qe.fault_events
                       if ev["action"] == "checkpoint_restore")
        assert restore["cursor"] == 2 and restore["ckpt_rows"] > 0
        assert r.delta["rec_ckpt_bytes"] > 0
    assert [e["action"] for e in runs[0].qe.fault_events] == \
        [e["action"] for e in runs[1].qe.fault_events]
    H.check_golden(runs[0].got, "q1", pair.path)


@pytest.mark.parametrize("every,spec", [(0, "mesh:fatal:1"),
                                        (3, "mesh_checkpoint:fatal:1")])
def test_fallback_without_checkpoint_restarts(pair, every, spec):
    """everyChunks=0 (the fault rides the mesh site) and a loss at the
    first snapshot attempt: nothing to resume from, the fallback streams
    from chunk 0."""
    runs = both(pair, _query("q1", False), spec,
                ((RESTART_KEY, False), (MESH_KEY, 8), (CKPT_KEY, every)))
    for r in runs:
        assert r.plan.fired_log == [(spec.split(":")[0], 1, "fatal")]
        assert r.qe.fault_summary.get("mesh_fallback") == 1
        assert "checkpoint_restore" not in r.qe.fault_summary
    H.check_golden(runs[0].got, "q1", pair.path)


def test_clean_run_records_no_recovery_actions(pair):
    runs = both(pair, _query("q1", False),
                confs=((MESH_KEY, 8), (CKPT_KEY, 2)))
    for r in runs:
        assert r.qe.fault_summary == {}
        assert r.delta["rec_ckpt_bytes"] > 0  # the checkpoints were taken
    H.check_golden(runs[0].got, "q1", pair.path)


def test_checkpoint_chunk_size_mismatch_ignored(pair, monkeypatch):
    """A checkpoint under other chunk boundaries (the chunk size shrank
    between save and restore) is never restored."""
    for mod in (PEX, REX):
        orig = mod.QueryExecution._handle_failure

        def shrink_then_handle(self, e, orig=orig):
            self.session.conf.set(H.CHUNK_KEY, 512)
            return orig(self, e)

        monkeypatch.setattr(mod.QueryExecution, "_handle_failure",
                            shrink_then_handle)
    runs = both(pair, _query("q1", False), "mesh_checkpoint:fatal:3",
                ((RESTART_KEY, False), (MESH_KEY, 8), (CKPT_KEY, 2)))
    for r in runs:
        assert r.qe.fault_summary.get("mesh_fallback") == 1
        assert "checkpoint_restore" not in r.qe.fault_summary
    H.check_golden(runs[0].got, "q1", pair.path)


def test_checkpoint_key_distinguishes_filter_values(pair):
    def agg_and_leaf(df):
        plan = df._qe().executed_plan
        nodes = []

        def walk(n):
            nodes.append(n)
            for c in n.children:
                walk(c)
        walk(plan)
        agg = [n for n in nodes if type(n).__name__ == "HashAggregateExec"]
        leaf = [n for n in nodes if type(n).__name__ == "ScanExec"]
        return agg[0], leaf[0]

    keys = {}
    for s, mod in ((pair.port, PSA), (pair.ref, RSA)):
        f, base = F(s), s.table("lineitem")
        k = [mod.checkpoint_key(*agg_and_leaf(base.filter(
            f.col("l_quantity") < lim).agg(
                f.sum(f.col("l_quantity")).alias("s"))), 1024)
            for lim in (10, 20, 10)]
        assert k[0] != k[1] and k[0] == k[2]
        keys[s is pair.port] = k
    # the keys name the same source, columns, filters and aggregates
    strip = [[x.split("|", 1)[1] for x in ks] for ks in keys.values()]
    assert strip[0] == strip[1]


# -- telemetry, first/last, skip ---------------------------------------------

def test_shard_telemetry_fed_by_the_stream(pair):
    """One compute record per (shard, chunk) whose rows are the stripe's
    live rows, the same in both packages, summing to the scan's rows."""
    make = _query("q1", False)
    port, ref = both(pair, make, confs=((MESH_KEY, 8), (SPANS_KEY, "on")))
    recs = []
    for r in (port, ref):
        comp = sorted((x["chunk"], x["shard"], x["rows"])
                      for x in r.qe.spans.shard_records
                      if x["phase"] == "compute")
        chunks = {c for c, _, _ in comp}
        assert len(comp) == 8 * len(chunks) and len(chunks) > 1
        assert len({(c, s) for c, s, _ in comp}) == len(comp)
        ingest = [x for x in r.qe.spans.shard_records
                  if x["phase"] == "ingest"]
        assert len(ingest) == len(chunks)
        recs.append(comp)
    assert recs[0] == recs[1]


def test_first_last_over_mesh_stream(pair):
    """first/last by a dense key over the mesh stream are each group's
    first and last rows in table order: positions pack the chunk base
    plus the shard times the stripe's capacity."""
    rs = np.random.RandomState(3)
    pdf = pd.DataFrame({"k": rs.randint(0, 50, 9000).astype(np.int64),
                        "v": rs.randint(0, 10**6, 9000).astype(np.int64)})

    def make(session):
        f = F(session)
        session.register_table("fl_t", pdf)
        return (session.table("fl_t").group_by((f.col("k") % 5).alias("g"))
                .agg(f.first(f.col("v")).alias("f"),
                     f.last(f.col("v")).alias("l"),
                     f.sum(f.col("v")).alias("s")))._qe()

    port, ref = both(pair, make, confs=((MESH_KEY, 8),))
    assert "InputExec(streamed_partial_agg," in \
        port.qe.spliced_plan.tree_string()
    want = pdf.assign(g=pdf.k % 5).groupby("g")["v"].agg(
        f=lambda x: x.iloc[0], l=lambda x: x.iloc[-1], s="sum")
    out = port.got.to_pandas().set_index("g").sort_index()
    for col in ("f", "l", "s"):
        assert out[col].tolist() == want[col].tolist(), col


def test_prefetch_skip_chunks_before_and_after_start():
    table = pa.table({"v": np.arange(5000, dtype=np.int64)})
    src = ArrowTableSource("skip_t", table)
    from spark_tpu_torch.config import Conf
    it = PrefetchChunkIterator(src.load_chunks(None, [], 1024, "cpu"),
                               Conf())
    try:
        assert it.skip_chunks(2) == 2
        first = next(it)
        assert int(first.columns["v"].data[0]) == 2048
        with pytest.raises(RuntimeError, match="after prefetch started"):
            it.skip_chunks(1)
        rest = list(it)
        assert len(rest) == 2  # chunks 3 and 4 (the last one short)
    finally:
        it.close()
    it = PrefetchChunkIterator(src.load_chunks(None, [], 1024, "cpu"),
                               Conf())
    try:
        assert it.skip_chunks(9) == 5  # the stream ends first
        assert next(it, None) is None
    finally:
        it.close()


def test_spliced_leaf_keeps_shards_on_their_devices(pair):
    """The spliced leaf hands each shard its own partial batch (no
    gather and re-stripe): the batches `load_shards` gives are the
    stream's own objects."""
    pair.set((MESH_KEY, 8))
    qe = _query("q1", False)(pair.port)
    qe.collect()
    leaf = [n for n in PEX.plan_nodes(qe.spliced_plan, P.InputExec)][0]
    assert leaf.shards is not None and len(leaf.shards) == 8
    from spark_tpu_torch.parallel.mesh import get_mesh
    mesh = get_mesh(pair.port.conf, "cpu")
    loaded = PEX.load_shards(qe.spliced_plan, pair.port.conf, mesh)
    assert all(loaded[i][id(leaf)] is leaf.shards[i] for i in range(8))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert leaf.load().capacity == sum(b.capacity for b in leaf.shards)
