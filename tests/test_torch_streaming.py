"""Structured streaming of the port (`spark_tpu_torch/streaming.py`)
against the JAX package's, case for case with `tests/test_streaming.py`:
the scripted micro-batch tests of the reference's StreamTest DSL
(AddData -> process -> CheckAnswer, stop / restart recovery,
crash-replay idempotence, event time and watermarks). Each case runs
through both packages (`tests/torch_stream_parity.py`), makes the JAX
test's assertions on each, and holds the port's outputs to the
reference's.
"""

import os
import time

import numpy as np
import pandas as pd
import pytest

from torch_stream_parity import check


def _schema_df():
    return pd.DataFrame({"k": pd.Series([], dtype=np.int64),
                         "v": pd.Series([], dtype=np.int64)})


def _stateful(P, s, base):
    F, col = P.F, P.col
    src = P.MemoryStream(s, _schema_df())
    q = (src.to_df()
         .group_by(F.pmod(col("k"), 10).alias("g"))
         .agg(F.sum(col("v")).alias("s"), F.count().alias("c"))
         .write_stream(os.path.join(base, "ck")))
    src.add_data(pd.DataFrame({"k": [1, 2, 11], "v": [10, 20, 30]}))
    q.process_available()
    first = q.latest()
    out = first.set_index("g")
    assert out.loc[1, "s"] == 40 and out.loc[1, "c"] == 2
    assert out.loc[2, "s"] == 20
    src.add_data(pd.DataFrame({"k": [1, 2], "v": [5, 7]}))
    q.process_available()
    out = q.latest().set_index("g")
    assert out.loc[1, "s"] == 45 and out.loc[1, "c"] == 3
    assert out.loc[2, "s"] == 27 and out.loc[2, "c"] == 2
    return [first, q.latest()]


def test_stateful_aggregate_across_batches(tmp_path):
    check(_stateful, tmp_path)


def _stateless(P, s, base):
    src = P.MemoryStream(s, _schema_df())
    q = (src.to_df().filter(P.col("v") > 10)
         .write_stream(os.path.join(base, "ck2"), output_mode="append"))
    src.add_data(pd.DataFrame({"k": [1, 2], "v": [5, 50]}))
    q.process_available()
    assert q.latest()["v"].tolist() == [50]
    src.add_data(pd.DataFrame({"k": [3], "v": [99]}))
    q.process_available()
    assert q.latest()["v"].tolist() == [99]
    assert len(q.results()) == 2
    return q.results()


def test_stateless_append(tmp_path):
    check(_stateless, tmp_path)


def _pmod5_query(P, src, ck):
    F, col = P.F, P.col
    return (src.to_df()
            .group_by(F.pmod(col("k"), 5).alias("g"))
            .agg(F.sum(col("v")).alias("s"))
            .write_stream(ck))


def _restart(P, s, base):
    ck = os.path.join(base, "ck3")
    src = P.MemoryStream(s, _schema_df())
    q = _pmod5_query(P, src, ck)
    src.add_data(pd.DataFrame({"k": [0, 1], "v": [100, 200]}))
    q.process_available()
    q.stop()
    # new query instance over the same checkpoint: state + offsets resume
    q2 = _pmod5_query(P, src, ck)
    src.add_data(pd.DataFrame({"k": [0], "v": [7]}))
    q2.process_available()
    out = q2.latest().set_index("g")
    assert out.loc[0, "s"] == 107
    assert out.loc[1, "s"] == 200
    return q2.latest()


def test_restart_resumes_committed_state(tmp_path):
    check(_restart, tmp_path)


def _crash_between_logs(P, s, base):
    ck = os.path.join(base, "ck4")
    src = P.MemoryStream(s, _schema_df())
    q = _pmod5_query(P, src, ck)
    src.add_data(pd.DataFrame({"k": [0], "v": [10]}))
    q.process_available()
    # a crash AFTER the offset-log write, BEFORE the commit: batch 1
    # planned over rows [1, 2) by hand and never run
    src.add_data(pd.DataFrame({"k": [0], "v": [32]}))
    q.offset_log.add(1, {"start": 1, "end": 2})
    # more data arrives while "down"
    src.add_data(pd.DataFrame({"k": [0], "v": [1000]}))
    q2 = _pmod5_query(P, src, ck)
    q2.process_available()
    out = q2.latest().set_index("g")
    # batch 1 replayed [1,2) only; batch 2 then covered [2,3): total exact
    assert out.loc[0, "s"] == 1042
    commits = sorted(os.listdir(os.path.join(ck, "commits")))
    assert commits == ["0", "1", "2"]
    return [q2.latest(), commits]


def test_crash_between_logs_replays_same_range(tmp_path):
    check(_crash_between_logs, tmp_path)


def _having(P, s, base):
    F, col = P.F, P.col
    src = P.MemoryStream(s, _schema_df())
    q = (src.to_df()
         .group_by(F.pmod(col("k"), 5).alias("g"))
         .agg(F.sum(col("v")).alias("s"))
         .filter(col("s") > 100)
         .write_stream(os.path.join(base, "ckh")))
    src.add_data(pd.DataFrame({"k": [0, 1], "v": [10, 500]}))
    q.process_available()
    out = q.latest()
    assert out["g"].tolist() == [1]
    assert out["s"].tolist() == [500]
    return out


def test_having_above_streaming_aggregate(tmp_path):
    check(_having, tmp_path)


def _append_rejected(P, s, base):
    F, col = P.F, P.col
    src = P.MemoryStream(s, _schema_df())
    with pytest.raises(ValueError, match="append") as e:
        (src.to_df().group_by(F.pmod(col("k"), 5).alias("g"))
         .agg(F.count().alias("c"))
         .write_stream(os.path.join(base, "cka"), output_mode="append"))
    return str(e.value)


def test_append_mode_with_aggregate_rejected(tmp_path):
    check(_append_rejected, tmp_path)


def _join_rejected(P, s, base):
    F, col = P.F, P.col
    static = s.create_dataframe(
        pd.DataFrame({"k": [1, 2], "w": [10, 20]}), "stream_static")
    src = P.MemoryStream(s, _schema_df())
    q = (src.to_df().join(static, on="k")
         .group_by(F.pmod(col("k"), 5).alias("g"))
         .agg(F.count().alias("c"))
         .write_stream(os.path.join(base, "ckj")))
    src.add_data(pd.DataFrame({"k": [1], "v": [1]}))
    with pytest.raises(P.AnalysisError, match="join|unary") as e:
        q.process_available()
    return type(e.value).__name__


def test_stream_static_join_rejected(tmp_path):
    check(_join_rejected, tmp_path)


def _string_key_rejected(P, s, base):
    src = P.MemoryStream(s, pd.DataFrame(
        {"s": pd.Series([], dtype=str), "v": pd.Series([], dtype=np.int64)}))
    q = (src.to_df().group_by(P.col("s")).agg(P.F.count().alias("c"))
         .write_stream(os.path.join(base, "cks")))
    src.add_data(pd.DataFrame({"s": ["a"], "v": [1]}))
    with pytest.raises(ValueError, match="string group keys") as e:
        q.process_available()
    return str(e.value)


def test_string_group_key_rejected(tmp_path):
    check(_string_key_rejected, tmp_path)


def _pruning(P, s, base):
    F, col = P.F, P.col
    ck = os.path.join(base, "ckp")
    s.conf.set("spark_tpu.streaming.stateStore.snapshotEveryDeltas", 2)
    src = P.MemoryStream(s, _schema_df())
    q = (src.to_df().group_by(F.pmod(col("k"), 3).alias("g"))
         .agg(F.count().alias("c")).write_stream(ck))
    for i in range(8):
        src.add_data(pd.DataFrame({"k": [i], "v": [i]}))
        q.process_available()
    # compaction: nothing older than the newest snapshot at/below the
    # retained floor survives, and the retained chain still restores
    store = q._store
    committed = q._committed_batch
    snaps, deltas = store.snapshot_versions(), store.delta_versions()
    keep = max(v for v in snaps if v <= committed - 2)
    assert min(snaps) == keep, (snaps, keep)
    assert all(d > keep for d in deltas), (deltas, keep)
    total = int(store.load_tables(committed)["cnt"].sum())
    assert total == 8
    out = q.latest()
    assert out["c"].sum() == 8
    return [snaps, deltas, total, out]


def test_checkpoint_pruning(tmp_path):
    check(_pruning, tmp_path)


# -- event time / watermarks (WatermarkTracker.scala:1) ---------------------

def _ts(s):
    return pd.Timestamp(s)


def _event_df(P, s):
    F, col = P.F, P.col
    schema = pd.DataFrame({"ts": [pd.Timestamp("2024-01-01")],
                           "v": [0.0]})
    stream = P.MemoryStream(s, schema)
    df = (stream.to_df()
          .with_watermark("ts", "10 seconds")
          .group_by(F.window(col("ts"), "10 seconds").alias("w"))
          .agg(F.sum(col("v")).alias("s"), F.count().alias("c")))
    return stream, df


def _out_of_order(P, s, base):
    stream, df = _event_df(P, s)
    q = df.write_stream(os.path.join(base, "ck"), output_mode="complete")
    stream.add_data(pd.DataFrame({
        "ts": [_ts("2024-01-01 00:00:01"), _ts("2024-01-01 00:00:12")],
        "v": [1.0, 2.0]}))
    q.process_available()
    # an out-of-order (but within-watermark) row lands in window 0
    stream.add_data(pd.DataFrame({
        "ts": [_ts("2024-01-01 00:00:05")], "v": [4.0]}))
    q.process_available()
    out = q.latest().sort_values("w").reset_index(drop=True)
    assert out["s"].tolist() == [5.0, 2.0]
    assert out["c"].tolist() == [2, 1]
    return out


def test_event_time_complete_out_of_order(tmp_path):
    check(_out_of_order, tmp_path)


def _late_rows(P, s, base):
    stream, df = _event_df(P, s)
    q = df.write_stream(os.path.join(base, "ck"), output_mode="complete")
    stream.add_data(pd.DataFrame({
        "ts": [_ts("2024-01-01 00:01:00")], "v": [1.0]}))
    q.process_available()   # watermark -> 00:00:50
    stream.add_data(pd.DataFrame({
        "ts": [_ts("2024-01-01 00:00:20"),   # older than wm: dropped
               _ts("2024-01-01 00:00:55")],  # within wm: counted
        "v": [100.0, 2.0]}))
    q.process_available()
    out = q.latest().sort_values("w").reset_index(drop=True)
    assert out["s"].tolist() == [2.0, 1.0]
    return [out, q._wm]


def test_event_time_late_rows_dropped(tmp_path):
    check(_late_rows, tmp_path)


def _append_closed(P, s, base):
    stream, df = _event_df(P, s)
    q = df.write_stream(os.path.join(base, "ck"), output_mode="append")
    stream.add_data(pd.DataFrame({
        "ts": [_ts("2024-01-01 00:00:01"), _ts("2024-01-01 00:00:03")],
        "v": [1.0, 2.0]}))
    q.process_available()   # wm = 3s-10s: nothing closed, nothing out
    assert q.latest() is None or len(q.latest()) == 0 or \
        len(q.results()) == 0
    stream.add_data(pd.DataFrame({
        "ts": [_ts("2024-01-01 00:00:30")], "v": [8.0]}))
    q.process_available()   # wm = 20s: window [0,10) closes and emits
    emitted = pd.concat(q.results(), ignore_index=True)
    assert len(emitted) == 1
    assert emitted["s"].tolist() == [3.0]
    assert emitted["w"][0] == _ts("2024-01-01 00:00:00")
    # the closed window is evicted from state
    assert (q._evstate["w"] != 0).all()
    stream.add_data(pd.DataFrame({
        "ts": [_ts("2024-01-01 00:01:00")], "v": [16.0]}))
    q.process_available()   # wm = 50s: window [30,40) closes
    emitted = pd.concat(q.results(), ignore_index=True)
    assert emitted["s"].tolist() == [3.0, 8.0]  # first window NOT re-emitted
    return [emitted, q._evstate.reset_index(drop=True)]


def test_event_time_append_emits_closed_windows_once(tmp_path):
    check(_append_closed, tmp_path)


def _event_recovery(P, s, base):
    ck = os.path.join(base, "ck")
    stream, df = _event_df(P, s)
    q = df.write_stream(ck, output_mode="complete")
    stream.add_data(pd.DataFrame({
        "ts": [_ts("2024-01-01 00:00:01")], "v": [1.0]}))
    q.process_available()
    wm1 = q._wm
    # fresh query over the same checkpoint + the same source content
    q2 = df.write_stream(ck, output_mode="complete")
    assert q2._wm == wm1
    stream.add_data(pd.DataFrame({
        "ts": [_ts("2024-01-01 00:00:04")], "v": [2.0]}))
    q2.process_available()
    out = q2.latest()
    assert out["s"].tolist() == [3.0]
    return [wm1, out]


def test_event_time_recovery_restores_watermark_and_state(tmp_path):
    check(_event_recovery, tmp_path)


@pytest.mark.cuda
def test_stateful_stream_on_card_launches_kernels(tmp_path):
    """On the card, a stateful stream driven by the trigger loop's thread
    keeps its tables on the session's device and folds each trigger
    through the dense group-by kernels: `dense_sums_smem` for a 201-slot
    key, `dense_sums_global` for a 2^20-slot key. The result equals
    pandas."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from spark_tpu_torch import SparkTpuSession
    from spark_tpu_torch import functions as F
    from spark_tpu_torch.execution import dense_groupby as D
    from spark_tpu_torch.streaming import MemoryStream
    s = SparkTpuSession.builder().device("cuda").get_or_create()
    rng = np.random.RandomState(11)
    rows = pd.DataFrame({"k": rng.randint(0, 1 << 22, 5000),
                         "v": rng.randint(-50, 50, 5000)})
    for mod, kernel in ((200, "dense_sums_smem"),
                        ((1 << 20) - 1, "dense_sums_global")):
        src = MemoryStream(s, _schema_df())
        q = (src.to_df().group_by(F.pmod(F.col("k"), mod).alias("g"))
             .agg(F.sum(F.col("v")).alias("s"), F.count().alias("c"))
             .write_stream(str(tmp_path / f"ck{mod}")))
        src.add_data(rows.iloc[:2500])
        src.add_data(rows.iloc[2500:])
        before = D.LAUNCHES[kernel]
        q.start(trigger_ms=10)
        try:
            deadline = time.monotonic() + 60
            while q._committed_batch < 0 and time.monotonic() < deadline:
                time.sleep(0.01)
        finally:
            q.stop()
        assert q._committed_batch >= 0, q.exception()
        assert D.LAUNCHES[kernel] > before
        cnt, accs = q._tables
        assert all(t.device == s.device
                   for t in [cnt] + [a for row in accs for a in row])
        got = q.latest().sort_values("g").reset_index(drop=True)
        want = (rows.assign(g=rows["k"] % mod).groupby("g")
                .agg(s=("v", "sum"), c=("v", "size")).reset_index())
        assert got["g"].tolist() == want["g"].tolist()
        assert got["s"].tolist() == want["s"].tolist()
        assert got["c"].tolist() == want["c"].tolist()


def _event_aggregates(P, s, base):
    F, col = P.F, P.col
    schema = pd.DataFrame({"ts": [pd.Timestamp("2024-01-01")],
                           "v": [0.0], "u": [0.0]})
    stream = P.MemoryStream(s, schema)
    v, u = col("v"), col("u")
    q = (stream.to_df().with_watermark("ts", "10 seconds")
         .group_by(F.window(col("ts"), "10 seconds").alias("w"))
         .agg(F.sum(v).alias("sum"), F.avg(v).alias("avg"),
              F.min(v).alias("min"), F.max(v).alias("max"),
              F.count().alias("n"), F.stddev(v).alias("sd"),
              F.stddev_pop(v).alias("sdp"), F.variance(v).alias("var"),
              F.var_pop(v).alias("varp"), F.skewness(v).alias("skew"),
              F.kurtosis(v).alias("kurt"), F.corr(v, u).alias("corr"),
              F.covar_samp(v, u).alias("cvs"),
              F.covar_pop(v, u).alias("cvp"),
              F.count_if(v > 2.0).alias("cif"),
              F.bool_and(v > 0.0).alias("band"),
              F.bool_or(v > 5.0).alias("bor"))
         .write_stream(os.path.join(base, "ck"), output_mode="complete"))
    rng = np.random.RandomState(5)
    for i in range(2):
        secs = rng.randint(0, 30, 40) + 5 * i
        stream.add_data(pd.DataFrame({
            "ts": pd.Timestamp("2024-01-01") + pd.to_timedelta(secs, "s"),
            "v": rng.rand(40) * 10, "u": rng.rand(40) * 3}))
        q.process_available()
    return q.latest().sort_values("w").reset_index(drop=True)


def test_event_time_host_finalize_of_every_aggregate(tmp_path):
    """The event-time path merges partial accumulators on the host and
    finalizes them there (`AggregateFunction.finalize`): every aggregate
    the path allows gives the reference's values."""
    got = check(_event_aggregates, tmp_path)
    assert len(got) == 4 and got["n"].sum() < 80  # late rows dropped


# -- the port's own behaviour -----------------------------------------------

def test_stateless_trigger_frees_its_device_cache_entry(tmp_path):
    """Each stateless trigger scans a fresh `__microbatch__` source, whose
    cache stamp no later key can reach: the trigger frees its device
    cache entry, so the cache does not grow from trigger to trigger."""
    from spark_tpu_torch.io.device_cache import CACHE
    from torch_stream_parity import PORT
    s = PORT.session()
    src = PORT.MemoryStream(s, _schema_df())
    q = (src.to_df().filter(PORT.col("v") > 10)
         .write_stream(str(tmp_path / "ck"), output_mode="append"))
    before = CACHE.nbytes
    for i in range(3):
        src.add_data(pd.DataFrame({"k": np.arange(100) + i,
                                   "v": np.arange(100) * (i + 1)}))
        q.process_available()
        assert CACHE.nbytes == before
    assert sum(len(r) for r in q.results()) == 89 + 94 + 96


def _decimal_window(P, s, base):
    import decimal
    import pyarrow as pa
    import pyarrow.parquet as pq
    src_dir = os.path.join(base, "src")
    os.makedirs(src_dir)
    pq.write_table(pa.table({
        "ts": pa.array([_ts("2024-01-01 00:00:01"), _ts("2024-01-01 00:00:03"),
                        _ts("2024-01-01 00:00:12")], pa.timestamp("us")),
        "d": pa.array([decimal.Decimal("1.25"), decimal.Decimal("2.50"),
                       decimal.Decimal("4.75")], pa.decimal128(12, 2))}),
        os.path.join(src_dir, "a.parquet"))
    stream = P.FileStreamSource(s, src_dir)
    q = (stream.to_df().with_watermark("ts", "10 seconds")
         .group_by(P.F.window(P.col("ts"), "10 seconds").alias("w"))
         .agg(P.F.sum(P.col("d")).alias("s"))
         .write_stream(os.path.join(base, "ck"), output_mode="complete"))
    q.process_available()
    return q.latest().sort_values("w")["s"].tolist()


def test_event_time_decimal_sum_stays_decimal(tmp_path):
    """An event-time decimal sum comes back as decimals in the port, as
    the stateful path gives them; the JAX package's host finalize leaves
    the unscaled integers there (a reference behaviour the port avoids)."""
    import decimal
    from torch_stream_parity import both
    got, want = both(_decimal_window, tmp_path)
    assert got == [decimal.Decimal("3.75"), decimal.Decimal("4.75")]
    assert want == [375, 475]
