"""The port's query lifecycle control (`spark_tpu_torch/execution/
lifecycle.py`) against the JAX package's, on the CPU (the single-device
cases of `tests/test_lifecycle.py`).

Tokens and deadlines; a cancel during a retry backoff returns at once; a
deadline shorter than the stage timeout stops the ladder; a deadline
cuts a backoff short; Q3 cancelled mid-stream and run again gives the
uncancelled bytes; the cancel-point matrix over a chunked single-device
query (a cancel at the nth cooperative boundary, for every n the query
crosses) ends each cancelled cell with QueryCancelledError, no worker
thread left and a byte-identical rerun; and the cancellable wait for a
stage's device work, held against a fake CUDA event whose `query()`
turns true late or never. Each query case compares its bytes and
fault_summary with the JAX package's. The SQL service and its arbiter
leases are not ported.
"""

import threading
import time
import warnings

import numpy as np
import pytest

from spark_tpu.execution import lifecycle as ref_lifecycle
from spark_tpu_torch.config import Conf
from spark_tpu_torch.execution import lifecycle
from spark_tpu_torch.execution.executor import (DISPATCH_POLL_KEY,
                                                _sync_dispatched)
from spark_tpu_torch.execution.failures import FailureClass, classify
from spark_tpu_torch.testing import faults

import torch_ooc_parity as H

DEADLINE_KEY = "spark_tpu.execution.queryDeadlineMs"
STAGE_TIMEOUT_KEY = "spark_tpu.execution.stageTimeoutMs"


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return H.Pair(H.write_data(tmp_path_factory, "lifecycle"), "lifecycle")


@pytest.fixture(autouse=True)
def clean(pair):
    pair.reset(((H.BACKOFF_KEY, 1),))
    warnings.simplefilter("ignore")
    yield
    pair.reset()
    assert not _prefetch_threads()


def _prefetch_threads():
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        alive = [t for t in threading.enumerate()
                 if t.name.startswith("spark-tpu-torch-ingest")]
        if not alive:
            return []
        time.sleep(0.01)
    return alive


def _cancel_when_registered(session, qid, mod=lifecycle, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if mod.cancel(session.app_id, qid):
            return True
        time.sleep(0.002)
    return False


def _run_in_thread(qe):
    out = {}

    def run():
        try:
            out["table"] = qe.collect()
        except Exception as e:  # noqa: BLE001 — asserted by callers
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, out


# -- tokens ------------------------------------------------------------------

def test_token_cancel_and_deadline_classify_cancelled():
    tok = lifecycle.CancelToken()
    tok.cancel()
    with pytest.raises(lifecycle.QueryCancelledError) as exc:
        tok.check("chunk")
    assert "chunk" in str(exc.value)
    assert classify(exc.value) is FailureClass.CANCELLED
    tok2 = lifecycle.CancelToken(deadline_ms=1)
    time.sleep(0.01)
    with pytest.raises(lifecycle.QueryDeadlineError) as exc2:
        tok2.check()
    assert classify(exc2.value) is FailureClass.CANCELLED
    assert lifecycle.QueryCancelledError.code == \
        ref_lifecycle.QueryCancelledError.code


def test_token_wait_wakes_on_cross_thread_cancel():
    tok = lifecycle.CancelToken()
    threading.Timer(0.05, tok.cancel).start()
    t0 = time.perf_counter()
    with pytest.raises(lifecycle.QueryCancelledError):
        tok.wait(30.0)
    assert time.perf_counter() - t0 < 5.0
    slice_ctx = lifecycle.install(lifecycle.CancelToken(deadline_ms=20))
    try:
        assert lifecycle.wait_slice(10.0) <= 0.05
    finally:
        lifecycle.uninstall(slice_ctx)
    assert lifecycle.wait_slice(10.0) == 10.0


def test_session_cancel_unknown_query_returns_false(pair):
    assert pair.port.cancel(999999) is False
    assert pair.ref.cancel(999999) is False


# -- backoff and deadlines ---------------------------------------------------

@pytest.mark.parametrize("which", ["port", "ref"])
def test_cancel_during_backoff_returns_promptly(pair, which):
    """One transient fault, then a 15 s minimum backoff: the cancel from
    another thread must not wait it out."""
    s = getattr(pair, which)
    mod = lifecycle if which == "port" else ref_lifecycle
    inj = faults if which == "port" else H.ref_faults
    s.conf.set(H.BACKOFF_KEY, 30000.0)
    with inj.inject(s.conf, "stage_run:unavailable:1"):
        qe = H.query("q1")(s)._qe()
        t, out = _run_in_thread(qe)
        assert _cancel_when_registered(s, qe.query_id, mod)
        t0 = time.perf_counter()
        t.join(10)
        assert not t.is_alive()
        assert time.perf_counter() - t0 < 10
    assert isinstance(out.get("error"), mod.QueryCancelledError)
    assert qe.fault_summary.get("cancel") == 1
    assert qe.fault_summary.get("transient_retry") is None


def test_deadline_beats_stage_timeout_and_stops_ladder(pair):
    """A 5 s slow fault at the stage seam under a 350 ms deadline and a
    500 ms stage timeout: the deadline error, never a timeout retry."""
    pair.set((STAGE_TIMEOUT_KEY, 500), (DEADLINE_KEY, 350.0))
    t0 = time.perf_counter()
    got, pqe, want, rqe, _, _ = pair.run(H.query("q1"),
                                         "stage_run:slow:1:5000")
    assert time.perf_counter() - t0 < 8.0
    assert isinstance(got, lifecycle.QueryDeadlineError)
    assert isinstance(want, ref_lifecycle.QueryDeadlineError)
    assert pqe.fault_summary == rqe.fault_summary == {"cancel": 1}
    assert pair.port.metrics.counter("query_deadline_exceeded").value >= 1


def test_deadline_fires_inside_retry_backoff(pair):
    pair.set((H.BACKOFF_KEY, 60000.0), (DEADLINE_KEY, 400.0))
    t0 = time.perf_counter()
    got, pqe, _, rqe, _, _ = pair.run(H.query("q1"),
                                      "stage_run:unavailable:1")
    assert time.perf_counter() - t0 < 8.0
    assert isinstance(got, lifecycle.QueryDeadlineError)
    assert pqe.fault_summary == rqe.fault_summary


# -- cancellation mid-stream -------------------------------------------------

def test_post_cancel_rerun_byte_parity_q3(pair):
    """Q3 on the chunked spill path, cancelled from another thread while
    it runs: the structured error (when the cancel landed before the
    end), no worker left, and the rerun's bytes equal the uncancelled
    run's and the JAX package's."""
    pair.set((H.CHUNK_KEY, 1024), (H.BUDGET_KEY, 1))
    baseline, _, want, _, _, _ = pair.run(H.query("q3"))
    H.assert_same(baseline, want)
    qe = H.query("q3")(pair.port)._qe()
    t, out = _run_in_thread(qe)
    assert _cancel_when_registered(pair.port, qe.query_id)
    t.join(30)
    assert not t.is_alive()
    if "error" in out:
        assert isinstance(out["error"], lifecycle.QueryCancelledError)
    assert not _prefetch_threads()
    again = H.query("q3")(pair.port)._qe().collect()
    assert again.equals(baseline)


def test_cancel_matrix_single_chip_chunked(pair):
    """cancel_point:cancel:n for every boundary n a chunked Q1 crosses
    (dense at first, then every 4th): each cancelled cell raises
    QueryCancelledError and leaves no worker thread, and each rerun
    gives the uncancelled bytes."""
    pair.set((H.CHUNK_KEY, 1024), (H.BUDGET_KEY, 1))
    s = pair.port
    baseline, _, want, _, _, _ = pair.run(H.query("q1"))
    H.assert_same(baseline, want)
    cancelled, n = 0, 1
    while n <= 48:
        with faults.inject(s.conf, f"cancel_point:cancel:{n}") as plan:
            qe = H.query("q1")(s)._qe()
            try:
                table = qe.collect()
                if not plan.fired_log:
                    break  # n outran the query's boundaries
                assert table.equals(baseline)
            except lifecycle.QueryCancelledError:
                cancelled += 1
                assert qe.fault_summary.get("cancel") == 1
                assert not _prefetch_threads()
        assert H.query("q1")(s)._qe().collect().equals(baseline)
        n += 1 if n < 8 else 4
    assert cancelled >= 2


def test_deadline_mid_stream_joins_the_worker(pair):
    """A deadline that runs out between chunks (each chunk's host decode
    slowed by 30 ms) stops the stream at a chunk boundary and joins the
    prefetch worker."""
    pair.set(*H.STREAMING)
    pair.set((DEADLINE_KEY, 150.0))
    spec = ",".join(f"ingest_prefetch:slow:{n}:30" for n in range(1, 13))
    with faults.inject(pair.port.conf, spec):
        qe = H.query("q1")(pair.port)._qe()
        t0 = time.perf_counter()
        with pytest.raises(lifecycle.QueryDeadlineError):
            qe.collect()
        assert time.perf_counter() - t0 < 5.0
    assert qe.fault_summary == {"cancel": 1}
    assert not _prefetch_threads()


def test_chunk_work_stops_between_columns():
    """Inside one chunk: a cancelled token stops the copy to the device
    before its next column, and a prefetcher's stop event stops the
    dictionary unify before its next column."""
    import pyarrow as pa
    from spark_tpu_torch.io.sources import ChunkIterator, DictUnifier
    table = pa.table({"a": [1, 2, 3], "s": ["x", "y", "x"]})
    chunks = ChunkIterator(iter(table.to_batches()), 4, "cpu")
    tok = lifecycle.CancelToken()
    tok.cancel()
    ctx = lifecycle.install(tok)
    try:
        with pytest.raises(lifecycle.QueryCancelledError,
                           match="chunk_copy"):
            next(chunks)
    finally:
        lifecycle.uninstall(ctx)
    stop = threading.Event()
    stop.set()
    with pytest.raises(RuntimeError, match="stopped by close"):
        DictUnifier().unify(table, stop)


# -- the cancellable wait for a stage's device work --------------------------

class _FakeEvent:
    """Stands in for a torch.cuda.Event: query() turns true after
    `ready_after_s`; synchronize() is the blocking wait."""

    def __init__(self, ready_after_s=0.0):
        self._ready_ts = time.monotonic() + ready_after_s
        self.synced = False

    def query(self):
        return time.monotonic() >= self._ready_ts

    def synchronize(self):
        while not self.query():
            time.sleep(0.001)
        self.synced = True


@pytest.mark.parametrize("mode", ["cancel", "deadline"])
def test_dispatch_poll_lands_mid_stage(mode):
    """A never-ready stage: a cancel from another thread, or a deadline,
    lands within about one poll tick instead of waiting for the card."""
    conf = Conf().set(DISPATCH_POLL_KEY, 20)
    tok = lifecycle.CancelToken(deadline_ms=150 if mode == "deadline"
                                else None)
    ctx = lifecycle.install(tok)
    timer = threading.Timer(0.15, tok.cancel)
    try:
        if mode == "cancel":
            timer.start()
        t0 = time.monotonic()
        err = lifecycle.QueryCancelledError if mode == "cancel" \
            else lifecycle.QueryDeadlineError
        with pytest.raises(err):
            _sync_dispatched([_FakeEvent(ready_after_s=3600)], conf)
        assert time.monotonic() - t0 < 2.0
    finally:
        timer.cancel()
        lifecycle.uninstall(ctx)


def test_dispatch_poll_returns_when_ready():
    conf = Conf().set(DISPATCH_POLL_KEY, 20)
    ctx = lifecycle.install(lifecycle.CancelToken())
    try:
        ev = _FakeEvent(ready_after_s=0.1)
        t0 = time.monotonic()
        _sync_dispatched([ev], conf)
        assert 0.05 < time.monotonic() - t0 < 2.0
        assert ev.synced
    finally:
        lifecycle.uninstall(ctx)
    _sync_dispatched([], conf)  # the CPU: nothing to wait for


def test_dispatch_poll_disabled_blocks_straight_through():
    conf = Conf().set(DISPATCH_POLL_KEY, 0)
    ev = _FakeEvent(ready_after_s=0.05)
    _sync_dispatched([ev], conf)
    assert ev.synced and ev.query()
    assert np.isclose(float(conf.get(DISPATCH_POLL_KEY)), 0.0)
