"""Unattended streaming of the port against the JAX package, case for
case with `tests/test_streaming_unattended.py` (but for its SQL-service
case, which waits for the port's service): the socket source, the
supervised trigger loop and the host-spilled keyed state.

The crash matrix kills the stream at every unattended seam
(`stream_net_connect`, `stream_net_recv`, `trigger_tick`, `state_spill`)
for stateless, stateful and spilled event-time queries against a live
socket producer, and proves a fresh query over the same checkpoint
recovers the uninterrupted output. The other cases pin reconnects with
zero loss and zero duplication, poison frames, skip-don't-queue pacing
under an injected clock, the restart ladder under injected sleep and
jitter, FATAL parking with no orphan thread, the deadline, the spilled
state's parity with resident state, and the trigger records of the
event log. Each case runs through both packages
(`tests/torch_stream_parity.py`), makes the JAX test's assertions on
each, and holds the port's outputs to the reference's.
"""

import importlib.util
import json
import os
import socket
import time

import numpy as np
import pandas as pd
import pytest

from spark_tpu.testing.lockwatch import LockWatch

from torch_stream_parity import PORT, TRIGGER_PREFIX, check

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SEAMS = ("stream_net_connect", "stream_net_recv", "trigger_tick",
         "state_spill")

#: "spilled" = the event-time shape with a 1-byte budget for resident
#: keyed state, so every batch runs through the host-spill backend
SHAPES = ("stateless", "stateful", "spilled")


# -- harness ----------------------------------------------------------------


def _schema_df(shape):
    if shape == "spilled":
        return pd.DataFrame({"ts": [pd.Timestamp("2024-01-01")],
                             "v": [0.0]})
    return pd.DataFrame({"k": pd.Series([], dtype=np.int64),
                         "v": pd.Series([], dtype=np.int64)})


def _round_df(shape, i):
    if shape == "spilled":
        base = pd.Timestamp("2024-01-01") + pd.Timedelta(seconds=30 * i)
        return pd.DataFrame(
            {"ts": [base, base + pd.Timedelta(seconds=4)],
             "v": [float(i + 1), float(2 * i + 1)]})
    return pd.DataFrame(
        {"k": np.arange(6, dtype=np.int64) + i,
         "v": np.arange(6, dtype=np.int64) * (i + 1)})


def _plan(P, shape, src):
    F, col = P.F, P.col
    df = src.to_df()
    if shape == "stateless":
        return df.filter(col("v") >= 0), "append"
    if shape == "stateful":
        return (df.group_by(F.pmod(col("k"), 5).alias("g"))
                .agg(F.sum(col("v")).alias("s"),
                     F.count().alias("c")), "complete")
    return (df.with_watermark("ts", "10 seconds")
            .group_by(F.window(col("ts"), "10 seconds").alias("w"))
            .agg(F.sum(col("v")).alias("s"),
                 F.count().alias("c")), "complete")


def _norm(shape, pdf):
    if pdf is None or not len(pdf):
        return pdf
    key = {"stateful": "g", "spilled": "w"}.get(shape)
    if key is not None and key in pdf.columns:
        return pdf.sort_values(key).reset_index(drop=True)
    return pdf.reset_index(drop=True)


def _sorted(pdf):
    return pdf.sort_values(list(pdf.columns)).reset_index(drop=True)


def _join_loop(q, want_status, timeout_s=15.0):
    """Wait for the supervised loop to reach a terminal status."""
    deadline = time.monotonic() + timeout_s
    while q.status == "RUNNING" and time.monotonic() < deadline:
        time.sleep(0.01)
    assert q.status == want_status, (q.status, q.exception())


def _no_leak():
    LockWatch().assert_no_thread_leak(TRIGGER_PREFIX)


class _NetFeeder:
    """One (shape, sink) network stream: a live FrameProducer plus fresh
    queries over ONE persistent checkpoint. `hard_crash` closes the
    consumer socket as a dead process would."""

    def __init__(self, P, session, shape, sink, base, tag):
        self.P = P
        self.session = session
        self.shape = shape
        self.producer = P.FrameProducer()
        self.port = self.producer.start()
        self.ck = os.path.join(base, f"ck_{tag}")
        self.sink = (os.path.join(base, f"sink_{tag}")
                     if sink == "file" else None)
        self._n = 0

    def feed(self):
        self.producer.send(_round_df(self.shape, self._n))
        self._n += 1

    def query(self):
        src = self.session.network_stream(
            "127.0.0.1", self.port, _schema_df(self.shape))
        plan_df, mode = _plan(self.P, self.shape, src)
        return plan_df.write_stream(self.ck, output_mode=mode,
                                    sink_path=self.sink)

    @staticmethod
    def hard_crash(q):
        q.stream.close()

    def close(self):
        self.producer.close()


# -- the crash matrix -------------------------------------------------------


def _crash_matrix(P, s, base, shape, sink):
    faults = P.faults
    if shape == "spilled":
        s.conf.set(P.SPILL_BYTES_KEY, 1)
        s.conf.set(P.SPILL_PARTS_KEY, 4)
    fb = _NetFeeder(P, s, shape, sink, base, "base")
    try:
        qb = fb.query()
        for _ in range(3):
            fb.feed()
            qb.process_available()
        want_concat = (pd.concat(qb.results(), ignore_index=True)
                       if shape == "stateless" else None)
        want_final = _norm(shape, qb.latest())
        want_sink = (_norm(shape, P.read_sink(fb.sink))
                     if sink == "file" else None)
        fb.hard_crash(qb)
    finally:
        fb.close()
    cells = {}
    for seam in SEAMS:
        f = _NetFeeder(P, s, shape, sink, base, seam)
        try:
            q = f.query()
            f.feed()
            q.process_available()  # batch 0 commits clean
            f.feed()
            fired = False
            if seam == "trigger_tick":
                # a fatal at the top of the supervised loop's tick parks
                # the query FAILED: the in-loop flavor of a hard crash
                with faults.inject(s.conf, "trigger_tick:fatal:1"):
                    q.start(trigger_ms=5)
                    _join_loop(q, "FAILED")
                fired = "FaultInjected" in (q.exception() or "")
                q.stop()
            else:
                if seam == "stream_net_connect":
                    # kill the warm connection so batch 1 must reconnect
                    f.producer.kill_connection()
                with faults.inject(s.conf, f"{seam}:fatal:1"):
                    try:
                        q.process_available()  # crash mid-batch-1
                    except faults.FaultInjected:
                        fired = True
            expect_fire = not (seam == "state_spill"
                               and shape != "spilled")
            assert fired == expect_fire, (shape, sink, seam)
            survivors = dict(q._sink_results)
            f.hard_crash(q)
            del q  # the hard crash: the query object is gone
            f.feed()
            q2 = f.query()  # fresh query over the same checkpoint
            q2.process_available()
            combined = dict(survivors)
            combined.update(q2._sink_results)
            if shape == "stateless":
                got = pd.concat([combined[k] for k in sorted(combined)],
                                ignore_index=True)
                pd.testing.assert_frame_equal(got, want_concat)
            else:
                got = _norm(shape, combined[max(combined)])
                pd.testing.assert_frame_equal(got, want_final)
            cells[seam] = [got]
            if sink == "file":
                got_sink = _sorted(_norm(shape, P.read_sink(f.sink)))
                pd.testing.assert_frame_equal(got_sink,
                                              _sorted(want_sink))
                cells[seam].append(got_sink)
            f.hard_crash(q2)
        finally:
            f.close()
    _no_leak()
    return [want_final, cells]


@pytest.mark.parametrize("sink", ["memory", "file"])
@pytest.mark.parametrize("shape", SHAPES)
def test_unattended_crash_matrix(tmp_path, shape, sink):
    check(_crash_matrix, tmp_path, shape, sink)


# -- network source: reconnect ladder ---------------------------------------


def _socket_kill(P, s, base):
    prod = P.FrameProducer()
    port = prod.start()
    try:
        src = s.network_stream("127.0.0.1", port, _schema_df("stateless"))
        sink = os.path.join(base, "sink")
        q = (src.to_df().filter(P.col("v") >= 0)
             .write_stream(os.path.join(base, "ck"), output_mode="append",
                           sink_path=sink))
        prod.send(_round_df("stateless", 0))
        q.process_available()
        rc0 = s.metrics.counter("streaming_reconnects").value
        # clean kill: EOF at a frame boundary, frames pending
        prod.kill_connection()
        prod.send(_round_df("stateless", 1))
        q.process_available()
        assert s.metrics.counter("streaming_reconnects").value == rc0 + 1
        # torn kill: half a frame on the wire -> stall -> reconnect
        prod.kill_connection_midframe()
        prod.send(_round_df("stateless", 2))
        q.process_available()
        assert s.metrics.counter("streaming_reconnects").value == rc0 + 2
        got = pd.concat(q.results(), ignore_index=True)
        want = pd.concat([_round_df("stateless", i) for i in range(3)],
                         ignore_index=True)
        pd.testing.assert_frame_equal(got, want)
        assert src.quarantined() == []
        got_sink = P.read_sink(sink).sort_values(["k", "v"]) \
            .reset_index(drop=True)
        pd.testing.assert_frame_equal(
            got_sink, want.sort_values(["k", "v"]).reset_index(drop=True))
        src.close()
        return [got, got_sink]
    finally:
        prod.close()


def test_socket_kill_mid_stream_zero_loss_zero_dup(tmp_path):
    check(_socket_kill, tmp_path)


def _poison(P, s, base):
    prod = P.FrameProducer()
    port = prod.start()
    ck = os.path.join(base, "ck")
    q0 = s.metrics.counter("streaming_frames_quarantined").value
    try:
        def build():
            src = s.network_stream("127.0.0.1", port,
                                   _schema_df("stateless"))
            return src, (src.to_df().filter(P.col("v") >= 0)
                         .write_stream(ck, output_mode="append"))

        src, q = build()
        prod.send(_round_df("stateless", 0))
        prod.send_poison()
        prod.send(_round_df("stateless", 1))
        with pytest.warns(UserWarning, match="poison network frame"):
            q.process_available()
        assert s.metrics.counter(
            "streaming_frames_quarantined").value == q0 + 1
        got = pd.concat(q.results(), ignore_index=True)
        want = pd.concat([_round_df("stateless", 0),
                          _round_df("stateless", 1)], ignore_index=True)
        pd.testing.assert_frame_equal(got, want)
        quar = src.quarantined()
        assert len(quar) == 1 and quar[0]["index"] == 1
        src.close()
        del q
        src2, q2 = build()
        q2.process_available()  # drained: nothing new
        assert len(src2.quarantined()) == 1
        assert s.metrics.counter(
            "streaming_frames_quarantined").value == q0 + 1
        src2.close()
        return [got, [e["index"] for e in src2.quarantined()]]
    finally:
        prod.close()


def test_poison_frame_quarantined_stream_flows(tmp_path):
    check(_poison, tmp_path)


def _dead_port():
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()  # nothing listens here now
    return port


def _ladder_exhaustion(P, s, base):
    port = _dead_port()
    s.conf.set(P.MAX_RECONNECTS_KEY, 1)
    s.conf.set("spark_tpu.streaming.source.network.backoffMs", 1)
    src = s.network_stream("127.0.0.1", port, _schema_df("stateless"))
    q = (src.to_df().filter(P.col("v") >= 0)
         .write_stream(os.path.join(base, "ck"), output_mode="append"))
    with pytest.raises(ConnectionError,
                       match="connection attempt budget exhausted"):
        q.process_available()
    with pytest.raises(ConnectionError) as e:
        q.process_available()
    kind = P.failures.classify(e.value)
    assert kind == P.failures.FailureClass.TRANSIENT
    return kind.name


def test_reconnect_ladder_exhaustion_is_transient_shaped(tmp_path):
    check(_ladder_exhaustion, tmp_path)


# -- supervised trigger loop ------------------------------------------------


def _overrun(P, s, base):
    src = P.MemoryStream(s, _schema_df("stateless"))
    q = (src.to_df().filter(P.col("v") >= 0)
         .write_stream(os.path.join(base, "ck"), output_mode="append"))

    class _Clk:
        t = 0.0

    clk = _Clk()
    waits = []

    def sleep_fn(sec):
        waits.append(sec)
        clk.t += sec
        if len(waits) >= 5:
            raise P.lifecycle.QueryCancelledError("test: stop the loop")

    orig = q.process_available

    def slow():
        clk.t += 0.25  # the batch costs 2.5 trigger intervals
        return orig()

    q.process_available = slow
    q.start(trigger_ms=100.0, clock=lambda: clk.t, sleep=sleep_fn)
    q._loop_thread.join(timeout=10)
    assert not q._loop_thread.is_alive()
    assert q.status == "STOPPED" and q.exception() is None
    st = q.state()
    # each iteration: tick, overrun by 150ms -> skip 2, wait 50ms
    assert st["ticks"] == 5
    assert st["skipped_ticks"] == 10
    assert all(w == pytest.approx(0.05) for w in waits), waits
    _no_leak()
    return [st["ticks"], st["skipped_ticks"], waits]


def test_trigger_overrun_skips_never_queues(tmp_path):
    check(_overrun, tmp_path)


def _backoff(P, s, base):
    port = _dead_port()
    s.conf.set(P.MAX_RECONNECTS_KEY, 0)
    s.conf.set("spark_tpu.streaming.source.network.backoffMs", 1)
    s.conf.set(P.TRIGGER_MAX_RESTARTS_KEY, 3)
    s.conf.set(P.TRIGGER_BACKOFF_KEY, 8)
    src = s.network_stream("127.0.0.1", port, _schema_df("stateless"))
    q = (src.to_df().filter(P.col("v") >= 0)
         .write_stream(os.path.join(base, "ck"), output_mode="append"))
    sleeps = []

    class _Rng:
        @staticmethod
        def random():
            return 1.0  # jitter factor pinned to 1.0

    q.start(trigger_ms=5, clock=lambda: 0.0,
            sleep=lambda sec: sleeps.append(round(sec * 1e3, 6)),
            rng=_Rng())
    _join_loop(q, "FAILED")
    q._loop_thread.join(timeout=10)
    assert sleeps == [8.0, 16.0, 32.0]  # backoffMs * 2^n, jitter = 1
    assert q.state()["restarts"] == 3
    assert "connection attempt budget exhausted" in q.exception()
    assert P.get_live(q._live_id) is None  # parked loops unregister
    q.stop()  # idempotent on a parked loop
    _no_leak()
    return [sleeps, q.state()["restarts"]]


def test_supervisor_backoff_deterministic_then_parks(tmp_path):
    check(_backoff, tmp_path)


def _fatal_parks(P, s, base):
    F, col = P.F, P.col
    src = P.MemoryStream(s, _schema_df("stateful"))
    q = (src.to_df().group_by(col("k").alias("g"))
         .agg(F.sum(col("v")).alias("s"))
         .write_stream(os.path.join(base, "ck")))
    src.add_data(_round_df("stateful", 0))
    q.start(trigger_ms=5)
    _join_loop(q, "FAILED")
    assert "ValueError" in q.exception()
    assert q.state()["restarts"] == 0
    assert P.get_live(q._live_id) is None
    q.stop()
    _no_leak()
    return [q.status, q.exception()]


def test_fatal_batch_parks_failed_zero_orphans(tmp_path):
    check(_fatal_parks, tmp_path)


def _pmod5(P, src, ck):
    F, col = P.F, P.col
    return (src.to_df().group_by(F.pmod(col("k"), 5).alias("g"))
            .agg(F.sum(col("v")).alias("s")).write_stream(ck))


def _wait_committed(q, batch, deadline):
    while q._committed_batch < batch and time.monotonic() < deadline:
        time.sleep(0.01)


def _runs_and_stops(P, s, base):
    src = P.MemoryStream(s, _schema_df("stateful"))
    ck = os.path.join(base, "ck")
    q = _pmod5(P, src, ck)
    src.add_data(_round_df("stateful", 0))
    q.start(trigger_ms=10)
    deadline = time.monotonic() + 15
    _wait_committed(q, 0, deadline)
    src.add_data(_round_df("stateful", 1))
    _wait_committed(q, 1, deadline)
    assert q._committed_batch >= 1
    live_id = q._live_id
    assert any(r["id"] == live_id and r["status"] == "RUNNING"
               for r in P.live_queries())
    if P is PORT:
        # the status store samples the live stream while it runs
        from spark_tpu_torch.observability.status_store import StatusStore
        assert StatusStore._streaming_lag()["streams_live"] >= 1.0
    q.stop()
    assert q.status == "STOPPED"
    q.stop()  # idempotent
    assert all(r["id"] != live_id for r in P.live_queries())
    _no_leak()
    src.add_data(_round_df("stateful", 2))
    q2 = _pmod5(P, src, ck)
    q2.process_available()
    src3 = P.MemoryStream(s, _schema_df("stateful"))
    q3 = _pmod5(P, src3, os.path.join(base, "ck3"))
    for i in range(3):
        src3.add_data(_round_df("stateful", i))
    q3.process_available()
    got = q2.latest().sort_values("g").reset_index(drop=True)
    pd.testing.assert_frame_equal(
        got, q3.latest().sort_values("g").reset_index(drop=True))
    return got


def test_trigger_loop_runs_commits_and_stops_bounded(tmp_path):
    check(_runs_and_stops, tmp_path)


def _deadline(P, s, base):
    s.conf.set(P.lifecycle.DEADLINE_KEY, 150)
    src = P.MemoryStream(s, _schema_df("stateless"))
    q = (src.to_df().filter(P.col("v") >= 0)
         .write_stream(os.path.join(base, "ck"), output_mode="append"))
    q.start(trigger_ms=20)
    _join_loop(q, "FAILED")
    assert "QueryDeadlineError" in q.exception()
    _no_leak()
    return q.exception().split(":")[0]


def test_deadline_caps_unattended_loop(tmp_path):
    check(_deadline, tmp_path)


# -- host-spillable keyed state ---------------------------------------------


def _spill_parity(P, s, base):
    src_r = P.MemoryStream(s, _schema_df("spilled"))
    plan_r, mode = _plan(P, "spilled", src_r)
    q_r = plan_r.write_stream(os.path.join(base, "ck_r"), output_mode=mode)
    for i in range(3):
        src_r.add_data(_round_df("spilled", i))
        q_r.process_available()
    want = _norm("spilled", q_r.latest())
    assert q_r._spill is None  # resident run never engaged
    s.conf.set(P.SPILL_BYTES_KEY, 1)
    s.conf.set(P.SPILL_PARTS_KEY, 4)
    sp0 = s.metrics.counter("streaming_spill_bytes").value
    src_s = P.MemoryStream(s, _schema_df("spilled"))
    ck = os.path.join(base, "ck_s")
    plan_s, _ = _plan(P, "spilled", src_s)
    q_s = plan_s.write_stream(ck, output_mode=mode)
    for i in range(3):
        src_s.add_data(_round_df("spilled", i))
        q_s.process_available()
    assert q_s._spill is not None  # the budget engaged the backend
    assert s.metrics.counter("streaming_spill_bytes").value > sp0
    spill_dir = os.path.join(ck, "state", "spill")
    assert [f for f in os.listdir(spill_dir) if f.endswith(".parquet")]
    got = _norm("spilled", q_s.latest())
    pd.testing.assert_frame_equal(got, want)
    del q_s
    src_r.add_data(_round_df("spilled", 3))
    q_r.process_available()
    src_s.add_data(_round_df("spilled", 3))
    plan_s2, _ = _plan(P, "spilled", src_s)
    q_s2 = plan_s2.write_stream(ck, output_mode=mode)
    q_s2.process_available()
    after = _norm("spilled", q_s2.latest())
    pd.testing.assert_frame_equal(after, _norm("spilled", q_r.latest()))
    return [got, after]


def test_spilled_state_output_parity_with_resident(tmp_path):
    check(_spill_parity, tmp_path)


# -- observability: the trigger record --------------------------------------


def _events_tool():
    spec = importlib.util.spec_from_file_location(
        "events_tool", os.path.join(ROOT, "scripts", "events_tool.py"))
    et = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(et)
    return et


def _trigger_records(P, s, base):
    ev_dir = os.path.join(base, "events")
    s.conf.set("spark_tpu.sql.eventLog.dir", ev_dir)
    src = P.MemoryStream(s, _schema_df("stateful"))
    q = _pmod5(P, src, os.path.join(base, "ck"))
    src.add_data(_round_df("stateful", 0))
    q.start(trigger_ms=10)
    deadline = time.monotonic() + 15
    _wait_committed(q, 0, deadline)
    src.add_data(_round_df("stateful", 1))
    _wait_committed(q, 1, deadline)
    q.stop()
    s.conf.set("spark_tpu.sql.eventLog.dir", "")
    events = P.history.read_event_log(ev_dir)
    assert (events["schema_version"].dropna() == 7).all()
    ss = P.history.streaming_summary(events)
    trig = ss[ss["record"] == "trigger"]
    assert len(trig) >= 2, ss
    assert (trig["batches_run"] >= 1).all()
    assert (trig["restarts"] == 0).all()
    assert (trig["reconnects"] == 0).all()
    assert (trig["source"] == "memory").all()
    assert (trig["skew_ms"] >= 0).all()
    assert trig["tick"].is_monotonic_increasing
    assert len(ss[ss["record"] == "batch"]) >= 2
    et = _events_tool()
    assert et.validate([ev_dir]) == []
    bad = {"schema_version": 5, "query_id": 1, "ts": 1.0,
           "status": "ok", "plan": "x", "trigger": {"tick": 1}}
    bad_path = os.path.join(ev_dir, "app-bad.jsonl")
    with open(bad_path, "w") as f:
        f.write(json.dumps(bad) + "\n")
    problems = et.validate([bad_path])
    assert any("v6 field 'trigger'" in p for p in problems), problems
    bad2 = dict(bad, schema_version=6,
                trigger={"tick": "one", "skew_ms": 0.0,
                         "batches_run": 1, "restarts": 0,
                         "source": "memory", "reconnects": 0})
    with open(bad_path, "w") as f:
        f.write(json.dumps(bad2) + "\n")
    problems = et.validate([bad_path])
    assert any("malformed trigger record" in p for p in problems), \
        problems
    # the tick count depends on the wall clock: compare the batch totals
    return [int(trig["batches_run"].sum()), sorted(set(trig["source"]))]


def test_trigger_event_log_v6_summary_and_validator(tmp_path):
    check(_trigger_records, tmp_path)


def test_cancel_right_after_a_commit_keeps_the_tick_record(tmp_path):
    """A cancel that lands right after a tick committed its batch (a
    listener on `on_streaming_batch` cancels the loop's token, so the
    next trigger checkpoint raises inside that tick) still posts the
    tick's `trigger` record: the records' batches_run add up to the
    batch records, one record per committing tick. The JAX package
    loses that record (its `_trigger_loop` re-raises first)."""
    from spark_tpu_torch.observability import QueryListener
    s = PORT.session()
    ev_dir = str(tmp_path / "events")
    s.conf.set("spark_tpu.sql.eventLog.dir", ev_dir)
    src = PORT.MemoryStream(s, _schema_df("stateful"))
    q = _pmod5(PORT, src, str(tmp_path / "ck"))

    class CancelAfterCommit(QueryListener):
        def on_streaming_batch(self, event):
            if event.record["batch_id"] == 1:
                q._token.cancel()

    s.add_listener(CancelAfterCommit())
    src.add_data(_round_df("stateful", 0))
    q.start(trigger_ms=10)
    deadline = time.monotonic() + 15
    _wait_committed(q, 0, deadline)
    src.add_data(_round_df("stateful", 1))
    _wait_committed(q, 1, deadline)
    q._loop_thread.join(15)
    assert not q._loop_thread.is_alive()
    q.stop()
    s.conf.set("spark_tpu.sql.eventLog.dir", "")
    ss = PORT.history.streaming_summary(PORT.history.read_event_log(ev_dir))
    trig = ss[ss["record"] == "trigger"]
    batches = ss[ss["record"] == "batch"]
    assert len(batches) == 2
    assert int(trig["batches_run"].sum()) == len(batches)
    assert (trig["batches_run"] >= 1).all()
    assert trig["tick"].is_monotonic_increasing


# -- the port's own behaviour -----------------------------------------------


def test_network_stream_takes_an_arrow_schema(tmp_path):
    """The port's sources also take an Arrow schema: decimal precisions
    and dictionary columns, which an empty pandas frame cannot carry, so
    frames of such a table conform instead of quarantining."""
    import decimal
    import pyarrow as pa
    table = pa.table({
        "k": pa.array([1, 2, 1], pa.int64()),
        "d": pa.array([decimal.Decimal("1.25"), decimal.Decimal("2.50"),
                       decimal.Decimal("4.75")], pa.decimal128(15, 2)),
        "s": pa.array(["a", "b", "a"]).dictionary_encode()})
    s = PORT.session()
    prod = PORT.FrameProducer()
    port = prod.start()
    try:
        src = s.network_stream("127.0.0.1", port, table.schema)
        q = (src.to_df().group_by(PORT.F.pmod(PORT.col("k"), 4).alias("g"))
             .agg(PORT.F.sum(PORT.col("d")).alias("sd"))
             .write_stream(str(tmp_path / "ck")))
        prod.send(table)
        q.process_available()
        assert src.quarantined() == []
        got = q.latest().sort_values("g")
        assert got["sd"].tolist() == [decimal.Decimal("6.00"),
                                      decimal.Decimal("2.50")]
        src.close()
    finally:
        prod.close()
