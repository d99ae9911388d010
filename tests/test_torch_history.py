"""Event-log replay (`spark_tpu_torch/history.py`, the port's copy of
`spark_tpu/history.py`) against the JAX package's: TPC-H SQL Q1, Q5 and
Q6 and a fault-injected Q6 at SF 0.002 logged by both packages, each
log valid under `scripts/events_tool.py` and replayed through both
packages' `history`, with the same plans, statuses, fault summaries,
per-operator row counts, span timelines, runtime-filter pruning and a
`compare_runs` that finds every query in both; each replay view on
synthetic logs, equal frame for frame; and the 22 TPC-H SQL queries
giving the same Arrow bytes with every observability key on as with
every one off.
"""

import json
import os
import subprocess
import sys
import warnings

import pandas as pd
import pytest

from spark_tpu import history as ref_history
from spark_tpu.testing import faults as ref_faults
from spark_tpu_torch import SparkTpuSession, history
from spark_tpu_torch.io.sources import ParquetSource
from spark_tpu_torch.testing import faults
from spark_tpu_torch.tpch.sql_queries import SQL_QUERIES

from torch_sql_parity import TABLES, sessions, write_data

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVENT_KEY = "spark_tpu.sql.eventLog.dir"
#: the JAX package's spans without a port counterpart (its stage
#: compile, its analyzer's walks) and the port's own (the egress, the
#: SQL parse, the host work between the phases; and, by their prefix,
#: its `op:<PhysicalClass>` operator spans)
UNSHARED_SPANS = {"compile", "analyze", "analyze_jaxpr", "egress", "parse",
                  "admit", "begin",
                  "start_event", "caps_lookup", "predict", "python_udfs",
                  "execution", "stage_completed", "grow_caps",
                  "profile_export", "readback", "caps_store", "external",
                  "end_event"}
#: the logged programs: (label, query, fault spec)
PROGRAMS = (("q1", "q1", ""), ("q5", "q5", ""), ("q6", "q6", ""),
            ("q6_fault", "q6", "stage_run:unavailable:1"))


def events_tool(*args):
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "events_tool.py"),
         *args], capture_output=True, text=True, timeout=60)


@pytest.fixture(scope="module")
def tpch_path(tmp_path_factory):
    return write_data(tmp_path_factory, 0.002)


@pytest.fixture(scope="module")
def logs(tpch_path, tmp_path_factory):
    """(port log dir, reference log dir, port results, reference
    results) of PROGRAMS, run in order in one session per package."""
    base = tmp_path_factory.mktemp("obs_logs")
    port, ref = sessions(tpch_path, "hist",
                         (("spark_tpu.execution.backoffMs", 1),))
    dirs, results = [], []
    for s, fmod, tag in ((port, faults, "port"), (ref, ref_faults, "ref")):
        d = str(base / tag)
        s.conf.set(EVENT_KEY, d)
        got = {}
        for label, q, spec in PROGRAMS:
            with fmod.inject(s.conf, spec), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                got[label] = s.sql(SQL_QUERIES[q])._qe().collect()
        s.conf.set(EVENT_KEY, "")
        dirs.append(d)
        results.append(got)
    return dirs[0], dirs[1], results[0], results[1]


def test_logs_validate_and_results_agree(logs):
    pdir, rdir, pres, rres = logs
    for d in (pdir, rdir):
        out = events_tool("validate", d)
        assert out.returncode == 0, out.stdout + out.stderr
        tail = events_tool("tail", d, "-n", "4")
        assert tail.returncode == 0 and "q" in tail.stdout
    for label, _, _ in PROGRAMS:
        assert pres[label].equals(rres[label]), label


@pytest.mark.parametrize("reader", ["port", "ref"])
def test_each_log_replays_through_each_history(logs, reader):
    """Either package's read_event_log reads either package's log to the
    same frame the log's own package reads."""
    pdir, rdir, _, _ = logs
    h = history if reader == "port" else ref_history
    for d in (pdir, rdir):
        mine = h.read_event_log(d)
        assert len(mine) == len(PROGRAMS)
        assert list(mine["status"]) == ["ok"] * len(PROGRAMS)
        own = (history if d == pdir else ref_history).read_event_log(d)
        pd.testing.assert_frame_equal(
            mine.drop(columns=["spans"]), own.drop(columns=["spans"]))


def test_replayed_records_equal_between_packages(logs):
    """Between the packages' logs: the plans, statuses, the rows_
    metrics, the fault counters and each query's span timeline (less
    the unshared spans) are equal."""
    pdir, rdir, _, _ = logs
    pe, re_ = history.read_event_log(pdir), history.read_event_log(rdir)
    assert list(pe["plan"]) == list(re_["plan"])
    assert list(pe["status"]) == list(re_["status"])
    assert list(pe["query_id"]) == list(re_["query_id"])
    rows = sorted(c for c in re_.columns if c.startswith("rows_"))
    assert rows and rows == sorted(c for c in pe.columns
                                   if c.startswith("rows_"))
    pd.testing.assert_frame_equal(pe[rows], re_[rows])
    for frame in (pe, re_):
        assert frame["fault_transient_retry"].fillna(0).tolist() == \
            [0, 0, 0, 1]
    pst, rst = history.stage_summary(pe), ref_history.stage_summary(re_)
    assert list(pst.columns) == list(rst.columns)

    def timeline(frame):
        shared = ~frame["span"].isin(UNSHARED_SPANS) \
            & ~frame["span"].str.startswith("op:")
        return frame[shared].groupby("query_id")["span"].apply(
            list).to_dict()

    assert timeline(pst) == timeline(rst)
    assert {"analysis", "optimize", "plan", "ingest", "dispatch",
            "retry:transient_retry"} <= set(pst["span"])


def test_fault_and_runtime_filter_summaries_equal(logs):
    pdir, rdir, _, _ = logs
    pe, re_ = history.read_event_log(pdir), ref_history.read_event_log(rdir)
    pf, rf = history.fault_summary(pe), ref_history.fault_summary(re_)
    assert list(pf.columns) == list(rf.columns)
    counts = [c for c in rf.columns
              if c not in ("ts", "app", "retry_backoff_ms", "events")]
    pd.testing.assert_frame_equal(pf[counts].reset_index(drop=True),
                                  rf[counts].reset_index(drop=True))
    assert [[{k: v for k, v in e.items() if k != "backoff_ms"}
             for e in ev] for ev in pf["events"]] == \
        [[{k: v for k, v in e.items() if k != "backoff_ms"}
          for e in ev] for ev in rf["events"]]
    assert pf["transient_retry"].tolist() == [1]
    prt = history.runtime_filter_summary(pe)
    rrt = ref_history.runtime_filter_summary(re_)
    assert list(prt.columns) == list(rrt.columns) and len(prt)
    same = ["tag", "tested", "pruned", "ratio"]
    pd.testing.assert_frame_equal(prt[same], rrt[same])


def test_compare_runs_finds_every_query(logs):
    """compare_runs of the two logs keys every plan of both (none
    differs), and the row counts' deltas are 0."""
    pdir, rdir, _, _ = logs
    pe, re_ = history.read_event_log(pdir), history.read_event_log(rdir)
    for h in (history, ref_history):
        cmp = h.compare_runs(pe, re_)
        assert set(cmp["plan"]) == set(pe["plan"]) == set(re_["plan"])
        rows = cmp[cmp["column"].str.startswith("rows_")]
        assert len(rows) and (rows["delta"] == 0).all()


def test_status_summary_of_both_logs(logs):
    pdir, rdir, _, _ = logs
    summ = [h.status_summary(h.read_event_log(d))
            for h, d in ((history, pdir), (ref_history, rdir))]
    for s in summ:
        assert len(s) == 1
        row = s.iloc[0]
        assert row["queries"] == len(PROGRAMS) and row["n_ok"] == 4
        assert 0 < row["p50_ms"] <= row["p95_ms"] <= row["p99_ms"]
    assert {c for c in summ[0].columns if c.startswith("total_")} >= \
        {"total_analysis_s", "total_ingest_s", "total_execution_s"}


# -- the replay views on synthetic logs --------------------------------------

def _write(tmp_path, name, lines):
    d = tmp_path / name
    d.mkdir()
    with open(d / "app-1-synthetic.jsonl", "w") as f:
        for ln in lines:
            f.write(json.dumps(ln) + "\n")
    return str(d)


def _synthetic(tmp_path, name, execution_s):
    stages = [{"key_hash": "abc", "flops": 5000, "peak_hbm_bytes": 4096,
               "argument_bytes": 2048, "temp_bytes": 1024,
               "output_bytes": 1024}]
    shards = [{"shard": s, "host": 0, "chunk": c, "phase": "compute",
               "rows": 10, "bytes": 80, "wait_ms": 40.0 if s == 1 else 1.0,
               "source": "stream_mesh"}
              for c in range(5) for s in range(4)]
    lines = [{"schema_version": 7, "query_id": i + 1, "ts": 100.0 + i,
              "status": "ok", "plan": "(AggExec (ScanExec t))",
              "phase_times_s": {"execution": execution_s, "ingest": 0.1},
              "metrics": {"rows_op1": 1000 * (i + 1), "join_rows_j1": 200,
                          "udf_rows": 50},
              "stages": stages, "shards": shards,
              "predictions": [{"kind": "join_rows", "tag": "j1",
                               "predicted": 400, "basis": "fk"},
                              {"kind": "udf_rows", "tag": "u",
                               "predicted": 10, "basis": "x"}],
              "rule_trace": [{"batch": "Operator Optimizations",
                              "rule": "PushDownPredicates",
                              "invocations": 3, "effective": 1,
                              "ms": 0.5}],
              "fault_summary": {"transient_retry": 1,
                                "retry_backoff_ms": 2.5,
                                "events": [{"action": "transient_retry"}]}}
             for i in range(2)]
    lines.append({"schema_version": 7, "query_id": 3, "ts": 103.0,
                  "status": "ok", "plan": "stream",
                  "streaming": {"batch_id": 0, "start": 0, "end": 10,
                                "rows_in": 10, "rows_out": 2,
                                "kind": "delta", "state_bytes": 64,
                                "quarantined": 0, "sink_parts": 1,
                                "source": "file"}})
    return _write(tmp_path, name, lines)


VIEWS = ("fault_summary", "stage_summary", "compile_summary",
         "hbm_summary", "streaming_summary", "shard_summary",
         "straggler_report", "prediction_report", "rule_report",
         "runtime_filter_summary", "status_summary")


@pytest.mark.parametrize("view", VIEWS)
def test_replay_view_parity_on_synthetic_log(tmp_path, view):
    """Every replay view gives the JAX package's frame on one log."""
    d = _synthetic(tmp_path, "a", 0.5)
    got = getattr(history, view)(history.read_event_log(d))
    want = getattr(ref_history, view)(ref_history.read_event_log(d))
    pd.testing.assert_frame_equal(got, want)
    if view not in ("runtime_filter_summary", "stage_summary"):
        assert len(got), view


def test_straggler_report_flags_the_slow_shard(tmp_path):
    events = history.read_event_log(_synthetic(tmp_path, "a", 0.5))
    rep = history.straggler_report(events)
    assert set(rep.loc[rep["flagged"], "shard"]) == {1}
    hbm = history.hbm_summary(events)
    assert hbm.iloc[0]["peak_hbm_bytes"] == 4096
    assert hbm.iloc[0]["capacity_bytes"] is None


def test_compare_runs_on_synthetic_logs(tmp_path):
    base = history.read_event_log(_synthetic(tmp_path, "a", 2.0))
    other = history.read_event_log(_synthetic(tmp_path, "b", 1.0))
    cmp = history.compare_runs(base, other)
    pd.testing.assert_frame_equal(cmp, ref_history.compare_runs(base, other))
    row = cmp[(cmp["column"] == "phase_execution_s")
              & (cmp["plan"] != "stream")].iloc[0]
    assert row["base"] == 2.0 and row["other"] == 1.0
    assert row["delta"] == -1.0 and row["ratio"] == 0.5


def test_grade_predictions_parity():
    preds = [{"kind": "join_rows", "tag": "j1", "predicted": 400},
             {"kind": "exch_rows", "tag": "e1", "predicted": 10},
             {"kind": "agg_groups", "tag": "a1", "predicted": 5},
             {"kind": "nope", "tag": "x", "predicted": 1}]
    metrics = {"join_rows_j1": 100, "exch_rows_e1": 20, "agg_groups_a1": 0}
    got = history.grade_predictions(preds, metrics)
    assert got == ref_history.grade_predictions(preds, metrics)
    assert [g["grade"] for g in got] == ["hit", "under", "hit"]


# -- results with every observability key on ---------------------------------

ALL_ON = (("spark_tpu.sql.eventLog.dir", "ev"),
          ("spark_tpu.sql.eventLog.maxBytes", 65536),
          ("spark_tpu.sql.trace.dir", "tr"),
          ("spark_tpu.sql.metrics.sink", "jsonl,prometheus"),
          ("spark_tpu.sql.metrics.dir", "m"),
          ("spark_tpu.sql.observability.xlaCost", "on"),
          ("spark_tpu.sql.observability.shardSpans", "on"),
          ("spark_tpu.sql.flightRecorder.dir", "fr"),
          ("spark_tpu.sql.profile.dir", "prof"))
ALL_OFF = (("spark_tpu.sql.metrics.enabled", False),
           ("spark_tpu.sql.observability.xlaCost", "off"),
           ("spark_tpu.sql.observability.shardSpans", "off"),
           ("spark_tpu.sql.status.enabled", False),
           ("spark_tpu.sql.flightRecorder.enabled", False))


@pytest.fixture(scope="module")
def on_off_sessions(tpch_path, tmp_path_factory):
    base = tmp_path_factory.mktemp("obs_on")
    out = []
    for confs in (ALL_ON, ALL_OFF):
        s = SparkTpuSession.builder().device("cpu").get_or_create()
        for key, value in confs:
            if key.endswith("dir"):
                value = str(base / value)
            s.conf.set(key, value)
        for t in TABLES:
            s.register_table(t, ParquetSource(
                os.path.join(tpch_path, f"{t}.parquet"), f"{t}_onoff"))
        out.append(s)
    return out[0], out[1], str(base)


@pytest.mark.parametrize("q", [f"q{i}" for i in range(1, 23)])
def test_tpch_bytes_equal_with_every_output_on(on_off_sessions, q):
    """Tracing, logging, metrics, cost capture and the flight recorder
    only observe: each TPC-H query gives the same Arrow bytes with every
    observability key on as with every one off, and its line lands in
    the log."""
    on, off, base = on_off_sessions
    got = on.sql(SQL_QUERIES[q])._qe().collect()
    want = off.sql(SQL_QUERIES[q])._qe().collect()
    assert got.equals(want), q
    events = history.read_event_log(os.path.join(base, "ev"))
    assert (events["status"] == "ok").all() and len(events)
    assert os.path.exists(os.path.join(base, "m", "metrics.prom"))
    assert os.listdir(os.path.join(base, "tr"))
    assert os.listdir(os.path.join(base, "prof"))
