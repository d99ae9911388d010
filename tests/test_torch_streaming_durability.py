"""Durable streaming of the port against the JAX package, case for case
with `tests/test_streaming_durability.py`: the crash-point chaos matrix,
the incremental state store, the metadata logs, the file source and
sink's exactly-once proofs, and the event-log record read back by both
packages' `history`.

The matrix kills the micro-batch loop at every persistence seam
(`stream_source_list` / `stream_offset_write` / `stream_state_commit`
/ `stream_sink_emit`), discards the query object, builds a fresh
StreamingQuery over the same checkpoint and proves the recovered output
equals an uninterrupted run's, for stateless, stateful-complete and
event-time queries on the memory and the file source. Each case runs
through both packages (`tests/torch_stream_parity.py`), makes the JAX
test's assertions on each, and holds the port's outputs to the
reference's.
"""

import importlib.util
import json
import os

import numpy as np
import pandas as pd
import pytest

from torch_stream_parity import PORT, REF, both, check, same

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SEAMS = ("stream_source_list", "stream_offset_write",
         "stream_state_commit", "stream_sink_emit")

SHAPES = ("stateless", "stateful", "event_time")


# -- harness ----------------------------------------------------------------


def _schema_df(shape):
    if shape == "event_time":
        return pd.DataFrame({"ts": [pd.Timestamp("2024-01-01")],
                             "v": [0.0]})
    return pd.DataFrame({"k": pd.Series([], dtype=np.int64),
                         "v": pd.Series([], dtype=np.int64)})


def _round_df(shape, i):
    """Feed round i. Event-time rounds carry increasing timestamps, so
    late-data drop never depends on batch boundaries."""
    if shape == "event_time":
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


class _Feeder:
    """One (shape, source) stream: feeds rounds, builds fresh queries
    over ONE persistent checkpoint + source + sink."""

    def __init__(self, P, session, shape, source, base, tag):
        self.P = P
        self.session = session
        self.shape = shape
        self.src_dir = os.path.join(base, f"src_{tag}")
        self.ck = os.path.join(base, f"ck_{tag}")
        self.sink = os.path.join(base, f"sink_{tag}")
        os.makedirs(self.src_dir, exist_ok=True)
        self._mem = (P.MemoryStream(session, _schema_df(shape))
                     if source == "memory" else None)
        self._n = 0

    def feed(self):
        df = _round_df(self.shape, self._n)
        self._n += 1
        if self._mem is not None:
            self._mem.add_data(df)
        else:
            df.to_parquet(os.path.join(self.src_dir,
                                       f"r{self._n:03d}.parquet"))

    def query(self):
        src = self._mem if self._mem is not None else \
            self.P.FileStreamSource(self.session, self.src_dir,
                                    schema_df=_schema_df(self.shape))
        plan_df, mode = _plan(self.P, self.shape, src)
        return plan_df.write_stream(self.ck, output_mode=mode,
                                    sink_path=self.sink)


def _norm(shape, pdf):
    if pdf is None or not len(pdf):
        return pdf
    key = {"stateful": "g", "event_time": "w"}.get(shape)
    if key is not None and key in pdf.columns:
        return pdf.sort_values(key).reset_index(drop=True)
    return pdf.reset_index(drop=True)


def _sorted(pdf):
    return pdf.sort_values(list(pdf.columns)).reset_index(drop=True)


# -- the crash matrix -------------------------------------------------------


def _crash_matrix(P, s, base, shape, source):
    faults = P.faults
    fb = _Feeder(P, s, shape, source, base, "base")
    qb = fb.query()
    for _ in range(3):
        fb.feed()
        qb.process_available()
    want_concat = pd.concat(qb.results(), ignore_index=True)
    want_final = _norm(shape, qb.latest())
    want_sink = _norm(shape, P.read_sink(fb.sink))
    cells = {}
    for seam in SEAMS:
        f = _Feeder(P, s, shape, source, base, seam)
        q = f.query()
        f.feed()
        q.process_available()  # batch 0 commits clean
        f.feed()
        fired = False
        with faults.inject(s.conf, f"{seam}:fatal:1") as fp:
            try:
                q.process_available()  # crash mid-batch-1
            except faults.FaultInjected:
                fired = True
        expect_fire = not (seam == "stream_state_commit"
                           and shape == "stateless")
        assert fired == expect_fire, (shape, source, seam, fp.fired_log)
        survivors = dict(q._sink_results)
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
        got_sink = _norm(shape, P.read_sink(f.sink))
        pd.testing.assert_frame_equal(_sorted(got_sink), _sorted(want_sink))
        cells[seam] = [got, _sorted(got_sink)]
    return [want_concat, want_final, cells]


@pytest.mark.parametrize("source", ["memory", "file"])
@pytest.mark.parametrize("shape", SHAPES)
def test_crash_matrix(tmp_path, shape, source):
    check(_crash_matrix, tmp_path, shape, source)


def _same_object_retry(P, s, base):
    ck, sink = os.path.join(base, "ck"), os.path.join(base, "sink")
    src = P.MemoryStream(s, _schema_df("stateless"))
    q = (src.to_df().filter(P.col("v") >= 0)
         .write_stream(ck, output_mode="append", sink_path=sink))
    src.add_data(_round_df("stateless", 0))
    q.process_available()
    src.add_data(_round_df("stateless", 1))

    def boom(batch_id, payload):
        raise RuntimeError("simulated commit-log write crash")

    q.commit_log.add = boom  # instance shadow
    with pytest.raises(RuntimeError, match="commit-log write crash"):
        q.process_available()
    del q.commit_log.add  # heal
    q.process_available()  # same-object retry replays batch 1
    assert sorted(q._sink_results) == [0, 1]
    want = pd.concat([_round_df("stateless", 0),
                      _round_df("stateless", 1)], ignore_index=True)
    got = pd.concat(q.results(), ignore_index=True)
    pd.testing.assert_frame_equal(got, want)
    got_sink = P.read_sink(sink).sort_values(["k", "v"]) \
        .reset_index(drop=True)
    pd.testing.assert_frame_equal(
        got_sink, want.sort_values(["k", "v"]).reset_index(drop=True))
    return [got, got_sink]


def test_same_object_retry_after_commit_crash(tmp_path):
    """A failure between sink emit and commit-log write, retried on the
    same query object, replaces the batch's sink entry."""
    check(_same_object_retry, tmp_path)


def _wide_round(i):
    """200 rows: enough for the kernel path of the dense update (128 rows
    and up), whose plain version runs on CPU tensors."""
    return pd.DataFrame({"k": np.arange(200, dtype=np.int64) + i,
                         "v": np.arange(200, dtype=np.int64) * (i + 1)})


def _same_object_stateful_retry(P, s, base):
    F, col = P.F, P.col
    src = P.MemoryStream(s, _schema_df("stateful"))
    q = (src.to_df().group_by(F.pmod(col("k"), 5).alias("g"))
         .agg(F.sum(col("v")).alias("s"), F.count().alias("c"))
         .write_stream(os.path.join(base, "ck")))
    src.add_data(_wide_round(0))
    q.process_available()
    src.add_data(_wide_round(1))
    with P.faults.inject(s.conf, "stream_sink_emit:fatal:1"):
        with pytest.raises(P.faults.FaultInjected):
            q.process_available()  # tables updated and saved, no commit
    q.process_available()  # the same object replays batch 1
    twin_src = P.MemoryStream(s, _schema_df("stateful"))
    twin = (twin_src.to_df().group_by(F.pmod(col("k"), 5).alias("g"))
            .agg(F.sum(col("v")).alias("s"), F.count().alias("c"))
            .write_stream(os.path.join(base, "ck2")))
    twin_src.add_data(_wide_round(0))
    twin_src.add_data(_wide_round(1))
    twin.process_available()
    got = q.latest().sort_values("g").reset_index(drop=True)
    pd.testing.assert_frame_equal(
        got, twin.latest().sort_values("g").reset_index(drop=True))
    return got


def test_same_object_stateful_retry_keeps_committed_tables(tmp_path):
    """A stateful batch that failed after its update and state save,
    retried on the same query object, starts again from the committed
    tables: the stream's update returns new tables and never writes into
    the committed ones, so nothing is folded twice."""
    check(_same_object_stateful_retry, tmp_path)


def _pmod5(P, src, ck):
    F, col = P.F, P.col
    return (src.to_df().group_by(F.pmod(col("k"), 5).alias("g"))
            .agg(F.sum(col("v")).alias("s")).write_stream(ck))


def _stateful_restart(P, s, base):
    ck = os.path.join(base, "ck")
    src = P.MemoryStream(s, _schema_df("stateful"))
    q = _pmod5(P, src, ck)
    src.add_data(_round_df("stateful", 0))
    q.process_available()
    src.add_data(_round_df("stateful", 1))
    with P.faults.inject(s.conf, "stream_sink_emit:fatal:1"):
        with pytest.raises(P.faults.FaultInjected):
            q.process_available()  # state v1 written, commit missing
    del q
    q2 = _pmod5(P, src, ck)
    q2.process_available()
    src2 = P.MemoryStream(s, _schema_df("stateful"))
    q3 = _pmod5(P, src2, os.path.join(base, "ck2"))
    src2.add_data(_round_df("stateful", 0))
    src2.add_data(_round_df("stateful", 1))
    q3.process_available()
    got = q2.latest().sort_values("g").reset_index(drop=True)
    pd.testing.assert_frame_equal(
        got, q3.latest().sort_values("g").reset_index(drop=True))
    return got


def test_stateful_crash_between_offset_and_commit_restart(tmp_path):
    check(_stateful_restart, tmp_path)


# -- incremental state store (unit) -----------------------------------------


def _rand_tables(rng, n=64):
    return {"cnt": rng.randint(0, 5, n).astype(np.int64),
            "acc_0_0": rng.randint(-100, 100, n).astype(np.int64),
            "acc_1_0": rng.rand(n)}


def _without_times(info):
    return {k: v for k, v in info.items() if not k.endswith("_ms")}


def _store_delta_snapshot(P, s, base):
    conf = P.Conf().set(
        "spark_tpu.streaming.stateStore.snapshotEveryDeltas", 10)
    store = P.StateStore(os.path.join(base, "st"), conf)
    rng = np.random.RandomState(7)
    state = _rand_tables(rng)
    prev = None
    per_version = {}
    infos = []
    for v in range(13):
        if v:
            idx = rng.choice(64, 5, replace=False)
            state = {k: a.copy() for k, a in state.items()}
            state["acc_0_0"][idx] += 1
            state["cnt"][idx] += 1
        info = store.commit_tables(v, state, prev)
        infos.append(_without_times(info))
        per_version[v] = {k: a.copy() for k, a in state.items()}
        prev = state
        want_kind = "snapshot" if v in (0, 10) else "delta"
        assert info["kind"] == want_kind, (v, info)
        if want_kind == "delta":
            assert info["changed"] <= 5 + 5
    for v in (0, 3, 9, 10, 12):
        got = store.load_tables(v)
        for k, want in per_version[v].items():
            np.testing.assert_array_equal(got[k], want, err_msg=f"v{v}/{k}")
    assert store.last_restore_replayed <= 10
    store.load_tables(12)
    assert store.last_restore_replayed == 2  # snapshot 10 + 2 deltas
    return infos


def test_state_store_delta_snapshot_restore(tmp_path):
    check(_store_delta_snapshot, tmp_path)


def _store_nan(P, s, base):
    store = P.StateStore(os.path.join(base, "st"), P.Conf())
    a = {"cnt": np.array([1, 0, 2], np.int64),
         "acc_0_0": np.array([1.0, np.nan, 3.0])}
    store.commit_tables(0, a, None)
    b = {"cnt": np.array([2, 0, 2], np.int64),
         "acc_0_0": np.array([5.0, np.nan, 3.0])}
    info = store.commit_tables(1, b, a)
    assert info["kind"] == "delta" and info["changed"] == 1, info
    got = store.load_tables(1)
    np.testing.assert_array_equal(got["cnt"], b["cnt"])
    assert np.isnan(got["acc_0_0"][1]) and got["acc_0_0"][0] == 5.0
    return [_without_times(info), got["cnt"].tolist()]


def test_state_store_nan_slots_not_flagged_changed(tmp_path):
    check(_store_nan, tmp_path)


def _store_prune(P, s, base):
    conf = P.Conf().set(
        "spark_tpu.streaming.stateStore.snapshotEveryDeltas", 4)
    store = P.StateStore(os.path.join(base, "st"), conf)
    rng = np.random.RandomState(3)
    state = _rand_tables(rng, 16)
    prev = None
    for v in range(23):
        if v:
            state = {k: a.copy() for k, a in state.items()}
            state["cnt"][rng.randint(0, 16)] += 1
        store.commit_tables(v, state, prev)
        prev = state
        store.prune(v, retain=2)
        got = store.load_tables(v)  # restore after every compaction
        for k in state:
            np.testing.assert_array_equal(got[k], state[k])
        assert store.last_restore_replayed < 4
    assert min(store.snapshot_versions()) >= 16
    assert min(store.delta_versions()) > min(store.snapshot_versions())
    return [store.snapshot_versions(), store.delta_versions()]


def test_state_store_prune_never_breaks_restore(tmp_path):
    check(_store_prune, tmp_path)


def _store_tombstones(P, s, base):
    conf = P.Conf().set(
        "spark_tpu.streaming.stateStore.snapshotEveryDeltas", 10)
    store = P.StateStore(os.path.join(base, "st"), conf)
    s0 = pd.DataFrame({"w": [0, 10, 20], "acc": [1.0, 2.0, 3.0]})
    store.commit_frame(0, s0, None, ["w"])
    s1 = pd.DataFrame({"w": [10, 20, 30], "acc": [5.0, 3.0, 7.0]})
    info = store.commit_frame(1, s1, s0, ["w"])
    assert info["kind"] == "delta" and info["changed"] == 2, info
    got = store.load_frame(1).sort_values("w").reset_index(drop=True)
    pd.testing.assert_frame_equal(
        got, s1.sort_values("w").reset_index(drop=True))
    info2 = store.commit_frame(2, s1, s1, ["w"])
    assert info2["kind"] == "delta" and info2["changed"] == 0
    got2 = store.load_frame(2).sort_values("w").reset_index(drop=True)
    pd.testing.assert_frame_equal(
        got2, s1.sort_values("w").reset_index(drop=True))
    return [info["changed"], got, got2]


def test_state_store_frame_delta_tombstones(tmp_path):
    check(_store_tombstones, tmp_path)


def _delta_ratio(P, s, base):
    F, col = P.F, P.col
    ck = os.path.join(base, "ck")
    records = []

    class _Cap:
        def on_streaming_batch(self, event):
            records.append(event.record)

    cap = _Cap()
    s.add_listener(cap)

    def build(src):
        return (src.to_df()
                .group_by(F.pmod(col("k"), 1024).alias("g"))
                .agg(F.sum(col("v")).alias("s"))
                .write_stream(ck))

    try:
        src = P.MemoryStream(s, _schema_df("stateful"))
        q = build(src)
        # batch 0 touches every group; batches 1..24 touch 64 (~6%)
        src.add_data(pd.DataFrame(
            {"k": np.arange(1024, dtype=np.int64),
             "v": np.ones(1024, dtype=np.int64)}))
        q.process_available()
        for i in range(1, 25):
            src.add_data(pd.DataFrame(
                {"k": np.arange(64, dtype=np.int64),
                 "v": np.full(64, i, dtype=np.int64)}))
            q.process_available()
    finally:
        s.remove_listener(cap)
    assert len(records) == 25
    assert records[0]["kind"] == "snapshot"
    snap_bytes = records[0]["state_bytes"]
    deltas = [r for r in records[1:] if r["kind"] == "delta"]
    snaps = [r for r in records if r["kind"] == "snapshot"]
    assert [r["batch_id"] for r in snaps] == [0, 10, 20]
    assert deltas, records
    steady = max(r["state_bytes"] for r in deltas)
    assert steady <= 0.25 * snap_bytes, (steady, snap_bytes)
    q2 = build(src)
    assert q2._store.last_restore_replayed == 24 - 20
    src.add_data(pd.DataFrame({"k": np.array([0], dtype=np.int64),
                               "v": np.array([1000], dtype=np.int64)}))
    q2.process_available()
    out = q2.latest().set_index("g")["s"]
    assert out.loc[0] == 1 + sum(range(1, 25)) + 1000
    assert out.loc[100] == 1  # untouched group carried intact
    shape = [(r["batch_id"], r["kind"], r["changed_groups"], r["rows_in"],
              r["rows_out"]) for r in records]
    return [shape, q2.latest()]


def test_incremental_delta_ratio_and_bounded_restore(tmp_path):
    check(_delta_ratio, tmp_path)


# -- metadata-log durability ------------------------------------------------


def _log_torn(P, s, base):
    m = s.metrics
    c0 = m.counter("streaming_log_corrupt").value
    log = P.MetadataLog(os.path.join(base, "log"), metrics=m)
    log.add(0, {"start": 0, "end": 1})
    log.add(1, {"start": 1, "end": 2})
    with open(os.path.join(log.path, "2"), "w") as f:
        f.write('{"start": 2, "e')
    with pytest.warns(UserWarning, match="corrupt metadata log"):
        first = log.latest()
    assert first == (1, {"start": 1, "end": 2})
    open(os.path.join(log.path, "3"), "w").close()
    with pytest.warns(UserWarning, match="corrupt metadata log"):
        second = log.latest()
    assert second[0] == 1
    assert m.counter("streaming_log_corrupt").value >= c0 + 3
    assert not [f for f in os.listdir(log.path) if f.endswith(".tmp")]
    return [list(first), list(second),
            m.counter("streaming_log_corrupt").value - c0]


def test_metadata_log_latest_skips_torn_and_empty(tmp_path):
    check(_log_torn, tmp_path)


def _log_all_corrupt(P, s, base):
    log = P.MetadataLog(os.path.join(base, "log"), metrics=s.metrics)
    open(os.path.join(log.path, "0"), "w").close()
    with pytest.warns(UserWarning):
        got = log.latest()
    assert got == (None, None)
    return list(got)


def test_metadata_log_all_corrupt_returns_none(tmp_path):
    check(_log_all_corrupt, tmp_path)


def _torn_commit(P, s, base):
    ck = os.path.join(base, "ck")
    src = P.MemoryStream(s, _schema_df("stateful"))
    q = _pmod5(P, src, ck)
    for i in range(2):
        src.add_data(_round_df("stateful", i))
        q.process_available()
    want = q.latest().sort_values("g").reset_index(drop=True)
    with open(os.path.join(ck, "commits", "1"), "w") as f:
        f.write('{"ok": tru')
    del q
    with pytest.warns(UserWarning, match="corrupt metadata log"):
        q2 = _pmod5(P, src, ck)
    assert q2._committed_batch == 0  # fell back one version
    q2.process_available()  # replays batch 1 from its logged range
    got = q2.latest().sort_values("g").reset_index(drop=True)
    pd.testing.assert_frame_equal(got, want)
    return got


def test_recovery_survives_torn_commit_entry(tmp_path):
    check(_torn_commit, tmp_path)


def _torn_offset(P, s, base):
    ck = os.path.join(base, "ck")
    src = P.MemoryStream(s, _schema_df("stateful"))
    q = _pmod5(P, src, ck)
    for i in range(2):
        src.add_data(_round_df("stateful", i))
        q.process_available()
    del q
    with open(os.path.join(ck, "offsets", "1"), "w") as f:
        f.write('{"start": 1, "e')
    src.add_data(_round_df("stateful", 2))
    with pytest.warns(UserWarning, match="corrupt metadata log"):
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


def test_recovery_survives_torn_offset_entry_with_intact_commit(tmp_path):
    check(_torn_offset, tmp_path)


def _stateless_file_query(P, s, src_dir, ck):
    src = P.FileStreamSource(s, src_dir, schema_df=_schema_df("stateless"))
    return src, (src.to_df().filter(P.col("v") >= 0)
                 .write_stream(ck, output_mode="append"))


def _heal_seen_log(P, s, base):
    src_dir = os.path.join(base, "src")
    ck = os.path.join(base, "ck")
    os.makedirs(src_dir)
    for i in range(3):
        _round_df("stateless", i).to_parquet(
            os.path.join(src_dir, f"r{i}.parquet"))
    _, q = _stateless_file_query(P, s, src_dir, ck)
    q.process_available()  # batch 0 covers files [0, 3)
    assert len(q.results()) == 1 and len(q.results()[0]) == 18
    del q
    with open(os.path.join(ck, "sources", "0", "2"), "w") as f:
        f.write('{"name": "r2.par')
    os.remove(os.path.join(ck, "commits", "0"))  # batch 0 uncommitted
    with pytest.warns(UserWarning, match="corrupt metadata log"):
        _, q2 = _stateless_file_query(P, s, src_dir, ck)
    q2.process_available()  # replays [0, 3) — healed, nothing lost
    got = pd.concat(q2.results(), ignore_index=True)
    want = pd.concat([_round_df("stateless", i) for i in range(3)],
                     ignore_index=True)
    got = got.sort_values(["k", "v"]).reset_index(drop=True)
    pd.testing.assert_frame_equal(
        got, want.sort_values(["k", "v"]).reset_index(drop=True))
    names = [e["name"] for e in q2.stream._seen]
    assert names == ["r0.parquet", "r1.parquet", "r2.parquet"]
    return [got, names]


def test_file_source_heals_torn_seen_log_tail(tmp_path):
    check(_heal_seen_log, tmp_path)


def _vanished_file(P, s, base):
    src_dir = os.path.join(base, "src")
    ck = os.path.join(base, "ck")
    os.makedirs(src_dir)
    for i in range(2):
        _round_df("stateless", i).to_parquet(
            os.path.join(src_dir, f"r{i}.parquet"))
    _, q = _stateless_file_query(P, s, src_dir, ck)
    q.process_available()
    del q
    with open(os.path.join(ck, "sources", "0", "1"), "w") as f:
        f.write("")
    os.remove(os.path.join(ck, "commits", "0"))
    os.remove(os.path.join(src_dir, "r1.parquet"))
    with pytest.warns(UserWarning, match="corrupt metadata log"):
        _, q2 = _stateless_file_query(P, s, src_dir, ck)
    with pytest.raises(RuntimeError, match="planned batch vanished") as e:
        q2.process_available()
    return str(e.value).replace(base, "<base>")


def test_file_source_vanished_planned_file_fails_loudly(tmp_path):
    check(_vanished_file, tmp_path)


# -- file source: quarantine ------------------------------------------------


def _write_corrupt(path):
    with open(path, "wb") as f:
        f.write(b"these bytes are not a parquet file")


def _quarantine(P, s, base):
    src_dir = os.path.join(base, "src")
    os.makedirs(src_dir)
    _round_df("stateless", 0).to_parquet(os.path.join(src_dir, "a.parquet"))
    _write_corrupt(os.path.join(src_dir, "b.parquet"))
    _round_df("stateless", 1).to_parquet(os.path.join(src_dir, "c.parquet"))
    q0 = s.metrics.counter("streaming_files_quarantined").value
    ck = os.path.join(base, "ck")
    src, q = _stateless_file_query(P, s, src_dir, ck)
    with pytest.warns(UserWarning, match="quarantined"):
        q.process_available()
    got = pd.concat(q.results(), ignore_index=True)
    want = pd.concat([_round_df("stateless", 0),
                      _round_df("stateless", 1)], ignore_index=True)
    got = got.sort_values(["k", "v"]).reset_index(drop=True)
    pd.testing.assert_frame_equal(
        got, want.sort_values(["k", "v"]).reset_index(drop=True))
    assert s.metrics.counter("streaming_files_quarantined").value == q0 + 1
    quar = src.quarantined()
    assert len(quar) == 1 and quar[0]["name"] == "b.parquet"
    src2, q2 = _stateless_file_query(P, s, src_dir, ck)
    q2.process_available()  # drained: nothing new
    assert len(src2.quarantined()) == 1
    assert s.metrics.counter("streaming_files_quarantined").value == q0 + 1
    return [got, [e["name"] for e in src2.quarantined()]]


def test_file_source_quarantines_corrupt_file(tmp_path):
    check(_quarantine, tmp_path)


def _strict(P, s, base):
    src_dir = os.path.join(base, "src")
    os.makedirs(src_dir)
    _write_corrupt(os.path.join(src_dir, "bad.parquet"))
    s.conf.set("spark_tpu.streaming.source.file.strict", True)
    _, q = _stateless_file_query(P, s, src_dir, os.path.join(base, "ck"))
    with pytest.raises(RuntimeError, match="strict") as e:
        q.process_available()
    return type(e.value).__name__


def test_file_source_strict_mode_fails_batch(tmp_path):
    check(_strict, tmp_path)


def _schema_mismatch(P, s, base):
    src_dir = os.path.join(base, "src")
    os.makedirs(src_dir)
    pd.DataFrame({"other": [1.5]}).to_parquet(
        os.path.join(src_dir, "wrong.parquet"))
    _round_df("stateless", 0).to_parquet(
        os.path.join(src_dir, "right.parquet"))
    _, q = _stateless_file_query(P, s, src_dir, os.path.join(base, "ck"))
    with pytest.warns(UserWarning, match="quarantined"):
        q.process_available()
    got = pd.concat(q.results(), ignore_index=True)
    assert len(got) == len(_round_df("stateless", 0))
    return got


def test_file_source_schema_mismatch_quarantines(tmp_path):
    check(_schema_mismatch, tmp_path)


def _ignores_metadata(P, s, base):
    src_dir = os.path.join(base, "src")
    os.makedirs(os.path.join(src_dir, "_metadata"))
    _round_df("stateless", 0).to_parquet(
        os.path.join(src_dir, "data.parquet"))
    _round_df("stateless", 1).to_parquet(
        os.path.join(src_dir, "inflight.parquet.tmp"))
    with open(os.path.join(src_dir, "_SUCCESS"), "w"):
        pass
    src = P.FileStreamSource(s, src_dir, schema_df=_schema_df("stateless"))
    assert src.latest_offset() == 1
    assert src._seen[0]["name"] == "data.parquet"
    return [e["name"] for e in src._seen]


def test_file_source_ignores_metadata_and_tmp_names(tmp_path):
    check(_ignores_metadata, tmp_path)


# -- file sink: manifest atomicity ------------------------------------------


def _unmanifested(P, s, base):
    sink = os.path.join(base, "sink")
    src = P.MemoryStream(s, _schema_df("stateless"))
    q = (src.to_df().filter(P.col("v") >= 0)
         .write_stream(os.path.join(base, "ck"), output_mode="append",
                       sink_path=sink))
    for i in range(2):
        src.add_data(_round_df("stateless", i))
        q.process_available()
    want = P.read_sink(sink)
    pd.DataFrame({"k": [999], "v": [999]}).to_parquet(
        os.path.join(sink, "part-09999.parquet"))
    pd.testing.assert_frame_equal(P.read_sink(sink), want)
    assert 999 not in P.read_sink(sink)["k"].values
    with open(os.path.join(sink, "_metadata", "7"), "w") as f:
        f.write('{"parts": ["part-0')
    with pytest.warns(UserWarning, match="corrupt metadata log"):
        pd.testing.assert_frame_equal(P.read_sink(sink), want)
    return want


def test_file_sink_reader_ignores_unmanifested_parts(tmp_path):
    check(_unmanifested, tmp_path)


def _complete_latest(P, s, base):
    sink = os.path.join(base, "sink")
    src = P.MemoryStream(s, _schema_df("stateful"))
    F, col = P.F, P.col
    q = (src.to_df().group_by(F.pmod(col("k"), 5).alias("g"))
         .agg(F.sum(col("v")).alias("s"))
         .write_stream(os.path.join(base, "ck"), sink_path=sink))
    for i in range(3):
        src.add_data(_round_df("stateful", i))
        q.process_available()
    got = P.read_sink(sink).sort_values("g").reset_index(drop=True)
    pd.testing.assert_frame_equal(
        got, q.latest().sort_values("g").reset_index(drop=True))
    return got


def test_file_sink_complete_mode_reads_latest_batch(tmp_path):
    check(_complete_latest, tmp_path)


def _complete_prunes(P, s, base):
    F, col = P.F, P.col
    sink = os.path.join(base, "sink")
    src = P.MemoryStream(s, _schema_df("stateful"))
    q = (src.to_df().group_by(F.pmod(col("k"), 5).alias("g"))
         .agg(F.sum(col("v")).alias("s"))
         .write_stream(os.path.join(base, "ck"), sink_path=sink))
    for i in range(6):
        src.add_data(_round_df("stateful", i))
        q.process_available()
    parts = sorted(f for f in os.listdir(sink) if f.endswith(".parquet"))
    # retainBatches=2: only batches >= committed-2 survive
    assert parts == ["part-00003.parquet", "part-00004.parquet",
                     "part-00005.parquet"], parts
    got = P.read_sink(sink).sort_values("g").reset_index(drop=True)
    pd.testing.assert_frame_equal(
        got, q.latest().sort_values("g").reset_index(drop=True))
    sink2 = os.path.join(base, "sink2")
    src2 = P.MemoryStream(s, _schema_df("stateless"))
    q2 = (src2.to_df().filter(col("v") >= 0)
          .write_stream(os.path.join(base, "ck2"), output_mode="append",
                        sink_path=sink2))
    for i in range(6):
        src2.add_data(_round_df("stateless", i))
        q2.process_available()
    parts2 = sorted(f for f in os.listdir(sink2) if f.endswith(".parquet"))
    assert len(parts2) == 6, parts2
    return [parts, got, parts2]


def test_file_sink_complete_mode_prunes_superseded_parts(tmp_path):
    check(_complete_prunes, tmp_path)


def _sink_replay(P, s, base):
    sink = os.path.join(base, "sink")
    fs = P.FileStreamSink(s, sink, "append")
    fs.emit(0, pd.DataFrame({"k": [1], "v": [10]}))
    fs.emit(1, pd.DataFrame({"k": [2], "v": [20]}))
    fs.emit(1, pd.DataFrame({"k": [2], "v": [20]}))
    got = P.read_sink(sink).sort_values("k").reset_index(drop=True)
    pd.testing.assert_frame_equal(
        got, pd.DataFrame({"k": [1, 2], "v": [10, 20]}))
    return got


def test_file_sink_replay_overwrites_own_parts(tmp_path):
    check(_sink_replay, tmp_path)


# -- observability: streaming record + summary + validator ------------------


def _events_tool():
    spec = importlib.util.spec_from_file_location(
        "events_tool", os.path.join(ROOT, "scripts", "events_tool.py"))
    et = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(et)
    return et


_SUMMARY_COLS = ["batch_id", "kind", "state_bytes", "sink_parts",
                 "quarantined", "source", "rows_in", "rows_out"]


def _event_log(P, s, base):
    F, col = P.F, P.col
    ev_dir = os.path.join(base, "events")
    s.conf.set("spark_tpu.sql.eventLog.dir", ev_dir)
    src = P.MemoryStream(s, _schema_df("stateful"))
    q = (src.to_df().group_by(F.pmod(col("k"), 5).alias("g"))
         .agg(F.sum(col("v")).alias("s"))
         .write_stream(os.path.join(base, "ck"),
                       sink_path=os.path.join(base, "sink")))
    src.add_data(_round_df("stateful", 0))
    q.process_available()
    src.add_data(pd.DataFrame({"k": np.array([0], dtype=np.int64),
                               "v": np.array([7], dtype=np.int64)}))
    q.process_available()
    s.conf.set("spark_tpu.sql.eventLog.dir", "")
    summaries = []
    # the log replays through both packages' history alike
    for history in (PORT.history, REF.history):
        ss = history.streaming_summary(history.read_event_log(ev_dir))
        assert len(ss) == 2, ss
        assert ss["kind"].tolist() == ["snapshot", "delta"]
        assert (ss["state_bytes"] > 0).all()
        assert ss["batch_id"].tolist() == [0, 1]
        assert (ss["sink_parts"] == 1).all()
        assert (ss["quarantined"] == 0).all()
        assert (ss["source"] == "memory").all()
        summaries.append(ss[_SUMMARY_COLS].reset_index(drop=True))
    same(summaries[0], summaries[1], f"{P.name} log")
    et = _events_tool()
    assert et.validate([ev_dir]) == []
    bad = {"schema_version": 3, "query_id": 1, "ts": 1.0,
           "status": "ok", "plan": "x", "streaming": {"batch_id": 0}}
    bad_path = os.path.join(ev_dir, "app-bad.jsonl")
    with open(bad_path, "w") as f:
        f.write(json.dumps(bad) + "\n")
    problems = et.validate([bad_path])
    assert any("v4 field 'streaming'" in p for p in problems), problems
    return summaries[0].drop(columns=["state_bytes"])


def test_streaming_event_log_record_and_summary(tmp_path):
    check(_event_log, tmp_path)


def _counters(P, s, base):
    F, col = P.F, P.col
    m = s.metrics
    b0 = m.counter("streaming_batches").value
    r0 = m.counter("streaming_rows").value
    d0 = m.counter("streaming_state_delta_bytes").value
    s0 = m.counter("streaming_state_snapshot_bytes").value
    src = P.MemoryStream(s, _schema_df("stateful"))
    ck = os.path.join(base, "ck")
    q = _pmod5(P, src, ck)
    src.add_data(_round_df("stateful", 0))
    q.process_available()
    for i in range(2):
        src.add_data(pd.DataFrame(
            {"k": np.array([i], dtype=np.int64),
             "v": np.array([6], dtype=np.int64)}))
        q.process_available()
    assert m.counter("streaming_batches").value == b0 + 3
    assert m.counter("streaming_rows").value == r0 + 8
    assert m.counter("streaming_state_snapshot_bytes").value > s0
    assert m.counter("streaming_state_delta_bytes").value > d0
    t0 = m.counter("streaming_restore_ms").value
    _pmod5(P, src, ck)
    assert m.counter("streaming_restore_ms").value > t0
    return [m.counter("streaming_batches").value - b0,
            m.counter("streaming_rows").value - r0]


def test_streaming_metrics_counters(tmp_path):
    check(_counters, tmp_path)


# -- the flight recorder ----------------------------------------------------


def _flight_recorder(P, s, base):
    src = P.MemoryStream(s, _schema_df("stateful"))
    q = _pmod5(P, src, os.path.join(base, "ck"))
    for i in range(3):
        src.add_data(_round_df("stateful", i))
        q.process_available()
    ring = list(P.FlightRecorder.of(s)._rings.get("streaming", []))
    return [(r["kind"], r.get("batch_id"), r.get("shape")) for r in ring]


def test_flight_recorder_records_streaming_batches(tmp_path):
    """The port records one streaming entry per committed batch, its
    shape under `shape`; the reference passes `kind` twice, so its
    listener raises on every batch and the bus drops the record."""
    with pytest.warns(UserWarning, match="multiple values for argument"):
        got, want = both(_flight_recorder, tmp_path)
    assert [r[:2] for r in got] == [("batch", i) for i in range(3)]
    assert {r[2] for r in got} <= {"snapshot", "delta"}
    assert want == []
