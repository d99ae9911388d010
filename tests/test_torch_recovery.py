"""The port's partial-progress recovery (`spark_tpu_torch/execution/
recovery.py`) against the JAX package's, on the CPU: the single-device
cases of `tests/test_recovery.py`.

A transient fault at chunk k of a stream replays only chunk k (one
`chunk_retry`, `rec_chunks_replayed` up by one, no whole-query retry) on
the direct stream and the partial-spill path; the per-chunk budget, a
chunk that fails twice, chunk retry off or at zero budget (the whole
query retries instead), a fatal fault, external collect (a chunk
replayed, or the whole stream restarted when a chunk spends its
budget); the stage-output memo (a downstream fault reuses the streamed
stage, counted once per attempt; an OOM evicts it; the OOM ladder's
re-plan invalidates it); a reader that dies mid-stream never truncates
the result; the bounded fault-event list and the ladder's
non-convergence diagnostic. Each case runs in both packages under the
same fault spec: the same Arrow bytes, the same fault_summary and the
same fired rules. The mesh checkpoints and the event-log history are
not ported.
"""

import warnings

import pyarrow as pa
import pytest

from spark_tpu import functions as RF
from spark_tpu.io.sources import (ArrowTableSource as RefArrowSource,
                                  ChunkIterator as RefChunkIterator)
from spark_tpu_torch import SparkTpuSession
from spark_tpu_torch import functions as PF
from spark_tpu_torch.execution.recovery import RecoveryContext
from spark_tpu_torch.io.sources import ArrowTableSource, ChunkIterator
from spark_tpu_torch.testing.faults import FaultInjected

import torch_ooc_parity as H

RETRY_ON_KEY = "spark_tpu.execution.chunkRetry.enabled"
RETRY_MAX_KEY = "spark_tpu.execution.chunkRetry.maxRetries"


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return H.Pair(H.write_data(tmp_path_factory, "recovery"), "recovery")


@pytest.fixture(autouse=True)
def streaming(pair):
    pair.reset()
    warnings.simplefilter("ignore")  # the retry warnings
    yield
    pair.reset()


def F(session):
    return PF if isinstance(session, SparkTpuSession) else RF


def replayed(pair):
    return (pair.port.metrics.counter("rec_chunks_replayed").value,
            pair.ref.metrics.counter("rec_chunks_replayed").value)


def run_parity(pair, make, spec, qname=None):
    """The same bytes, fault_summary and fired rules in both packages;
    returns the port's result, qe and fault plan."""
    got, pqe, want, rqe, pplan, rplan = pair.run(make, spec)
    H.assert_same(got, want)
    assert pqe.fault_summary == rqe.fault_summary
    assert pplan.fired_log == rplan.fired_log
    if qname is not None:
        H.check_golden(got, qname, pair.path)
    return got, pqe, pplan


#: (id, query, extra conf): the direct stream (q1), the spill path with
#: Q1's domain collapsed (q1 under maxDirectDomain 1) and with unbounded
#: keys (q3)
_PATHS = [
    ("streaming", "q1", ()),
    ("spill", "q1", ((H.BUDGET_KEY, 1), (H.DOMAIN_KEY, 1))),
    ("spill", "q3", ((H.BUDGET_KEY, 1),)),
]


@pytest.mark.parametrize("path_id,qname,extra", _PATHS,
                         ids=[p[0] + "-" + p[1] for p in _PATHS])
def test_chunk_retry_replays_one_chunk(pair, path_id, qname, extra):
    pair.set(*extra)
    before = replayed(pair)
    _, pqe, plan = run_parity(pair, H.query(qname),
                              "stream_chunk:unavailable:3", qname)
    assert plan.fired_log == [("stream_chunk", 3, "unavailable")]
    assert plan.hits["stream_chunk"] > 3
    assert pqe.fault_summary.get("chunk_retry") == 1
    assert "transient_retry" not in pqe.fault_summary
    after = replayed(pair)
    assert (after[0] - before[0], after[1] - before[1]) == (1, 1)


@pytest.mark.parametrize("spec,retries", [
    ("stream_chunk:unavailable:2,stream_chunk:unavailable:6", 2),
    ("stream_chunk:unavailable:3,stream_chunk:unavailable:4", 2)],
    ids=["two-chunks", "same-chunk-twice"])
def test_chunk_retry_budget_per_chunk(pair, spec, retries):
    """Faults on two chunks, or twice on one chunk: both recover within
    the per-chunk budget (maxRetries 2)."""
    _, pqe, plan = run_parity(pair, H.query("q1"), spec, "q1")
    assert len(plan.fired_log) == 2
    assert pqe.fault_summary.get("chunk_retry") == retries


@pytest.mark.parametrize("conf", [(RETRY_ON_KEY, False), (RETRY_MAX_KEY, 0)],
                         ids=["disabled", "zero-budget"])
def test_chunk_retry_off_restarts_the_stream(pair, conf):
    """Without chunk retry the fault reaches the whole-query ladder,
    which restarts the stream (transient_retry, no chunk_retry)."""
    pair.set(conf)
    _, pqe, plan = run_parity(pair, H.query("q1"),
                              "stream_chunk:unavailable:3", "q1")
    assert plan.fired_log
    assert "chunk_retry" not in pqe.fault_summary
    assert pqe.fault_summary.get("transient_retry", 0) >= 1


def test_chunk_retry_fatal_not_absorbed(pair):
    got, _, want, _, _, _ = pair.run(H.query("q1"), "stream_chunk:fatal:2")
    assert isinstance(got, FaultInjected) and "INTERNAL" in str(got)
    assert type(want).__name__ == "FaultInjected" and \
        str(got) == str(want)


def _external_order_by(s):
    c = F(s).col
    return s.table("lineitem").select(c("l_orderkey"), c("l_quantity")) \
        .order_by(c("l_orderkey"))


def test_chunk_retry_external_collect(pair):
    """ORDER BY over a scan past the budget (external collect) replays
    one chunk after a flake."""
    pair.set((H.BUDGET_KEY, 1))
    got, pqe, plan = run_parity(pair, _external_order_by,
                                "stream_chunk:unavailable:2")
    assert plan.fired_log
    assert pqe.fault_summary.get("chunk_retry") == 1
    keys = got.column("l_orderkey").to_pylist()
    assert keys == sorted(keys)


def test_external_collect_exhausted_chunk_budget_restarts_stream(pair):
    """A chunk that spends its whole budget (hits 1-3) restarts the
    external stream once, under the whole-query budget."""
    pair.set((H.BUDGET_KEY, 1))
    spec = ",".join(f"stream_chunk:unavailable:{n}" for n in (1, 2, 3))
    got, pqe, plan = run_parity(pair, _external_order_by, spec)
    assert len(plan.fired_log) == 3
    assert pqe.fault_summary.get("chunk_retry") == 2
    assert pqe.fault_summary.get("transient_retry") == 1
    assert got.num_rows == len(pair.port.table("lineitem").to_pandas())


def test_stage_reuse_upstream_runs_once(pair, monkeypatch):
    """A transient fault in the stage after the spilled aggregate runs
    the query again, and the completed stream splices from the memo:
    the spill loop runs once."""
    import spark_tpu_torch.execution.streaming_agg as SA
    pair.set((H.BUDGET_KEY, 1))
    calls = []
    orig = SA.try_stream_aggregate_spill

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(SA, "try_stream_aggregate_spill", counting)
    reused0 = pair.port.metrics.counter("rec_stages_reused").value
    _, pqe, plan = run_parity(pair, H.query("q3"), "stage_run:unavailable:1",
                              "q3")
    assert plan.fired_log == [("stage_run", 1, "unavailable")]
    assert len(calls) == 1
    assert pqe.fault_summary.get("transient_retry") == 1
    assert pqe.fault_summary.get("stage_reuse", 0) >= 1
    assert pair.port.metrics.counter("rec_stages_reused").value > reused0


def test_stage_reuse_counted_once_per_attempt():
    recorded = []
    rc = RecoveryContext(record=lambda a, e=None, **kw: recorded.append(a))
    rc.memo_put(("build", 1), "b")
    assert rc.memo_get(("build", 1)) == "b"
    assert recorded == []  # before a failure: dedup, not recovery
    rc.begin_recovery_attempt()
    assert rc.memo_get(("build", 1)) == "b"
    assert rc.memo_get(("build", 1)) == "b"
    assert recorded == ["stage_reuse"]
    rc.begin_recovery_attempt()
    assert rc.memo_get(("build", 1)) == "b"
    assert recorded == ["stage_reuse", "stage_reuse"]
    rc.invalidate()
    assert rc.memo_get(("build", 1)) is None


@pytest.mark.parametrize("spec,action", [
    ("stage_run:resource_exhausted:1", "oom_cache_evict"),
    ("stage_run:resource_exhausted:1,stage_run:resource_exhausted:2",
     "oom_spill_reroute")], ids=["evict", "reroute"])
def test_oom_drops_memoized_stage_outputs(pair, spec, action):
    """OOM rung 1 evicts the memo's device batches with the cache (the
    retry streams again, no stage_reuse); rung 2's re-plan invalidates
    it (a stale splice would break the result)."""
    extra = ((H.BUDGET_KEY, 1),) if action == "oom_cache_evict" else ()
    pair.set(*extra)
    qname = "q3" if extra else "q1"
    _, pqe, plan = run_parity(pair, H.query(qname), spec, qname)
    assert plan.fired_log
    assert pqe.fault_summary.get(action, 0) >= 1
    assert "stage_reuse" not in pqe.fault_summary


def test_ingest_reader_failure_never_truncates(pair):
    """A batch reader that dies mid-stream poisons the chunk iterator:
    the whole-query ladder restarts the stream on a fresh reader and the
    result is complete, not the buffered prefix."""
    table = pa.table({"v": list(range(10000))})
    fails = {"port": True, "ref": True}

    def flaky(base, iterator, key):
        class FlakyOnce(base):
            def load_chunks(self, required_columns, pushed_filters,
                            chunk_rows, *device):
                def batches():
                    for i, rb in enumerate(self.table.to_batches(
                            max_chunksize=1024)):
                        if i == 3 and fails[key]:
                            fails[key] = False
                            raise RuntimeError(
                                "UNAVAILABLE: reader connection reset")
                        yield rb
                return iterator(batches(), chunk_rows, *device)
        return FlakyOnce("flaky_t", table)

    pair.port.register_table("flaky_t",
                             flaky(ArrowTableSource, ChunkIterator, "port"))
    pair.ref.register_table("flaky_t",
                            flaky(RefArrowSource, RefChunkIterator, "ref"))
    got, pqe, want, rqe, _, _ = pair.run(lambda s: s.table("flaky_t")
                                         .group_by((F(s).col("v") % 7)
                                                   .alias("k"))
                                         .agg(F(s).sum(F(s).col("v"))
                                              .alias("s")))
    H.assert_same(got, want)
    assert not fails["port"] and not fails["ref"]
    assert sum(got.column("s").to_pylist()) == sum(range(10000))
    # the prefetcher's per-chunk retries meet the poisoned iterator, then
    # the whole query restarts the stream once
    assert pqe.fault_summary == rqe.fault_summary
    assert pqe.fault_summary.get("transient_retry") == 1


def test_fault_events_cap_counts_drops(pair):
    qe = pair.port.range(10)._qe()
    for i in range(40):
        qe._record_fault("transient_retry", RuntimeError(f"e{i}"))
    assert len(qe.fault_events) == 32
    assert qe.fault_summary["transient_retry"] == 40
    assert qe.fault_summary["events_dropped"] == 8


def test_recovery_nonconvergence_diagnostic(pair):
    qe = pair.port.range(10)._qe()
    qe.fault_summary = {"transient_retry": 5}

    def boom():
        raise RuntimeError("UNAVAILABLE: flaky backend endpoint")

    qe._execute_batch = boom
    qe._handle_failure = lambda e: None  # every action "applies"
    with pytest.raises(RuntimeError, match="did not converge") as ei:
        qe._execute_recover()
    msg = str(ei.value)
    assert "transient_retry" in msg and "flaky backend endpoint" in msg
