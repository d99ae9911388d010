"""The observability spine of the port (`spark_tpu_torch/observability/`)
against the JAX package's (`spark_tpu/observability/`): the listener
bus's callback order (under faults too), failure isolation, spans and
Chrome traces, the event log's schema, rotation and hardening, the
gate that keeps events off the hot path, the per-operator metrics
switch and the registered metric names, each observability conf key,
the device-memory record, the torch.profiler trace, the UDF batch spans
and the mesh's per-shard transfer records.

Each case runs the same inputs through both packages, the JAX package
on the CPU backend `tests/conftest.py` forces and the port on the CPU.
Eager torch compiles no stage, so the JAX package's `compiled` callback
and `compile` span have no counterpart and are left out of its side of
each comparison; so are its analyzer's `analyze`/`analyze_jaxpr` spans
(slice 12b), which these cases turn off on the reference session.
"""

import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pandas as pd
import pytest
import torch

from spark_tpu import config as ref_config
from spark_tpu import functions as RF
from spark_tpu.observability import QueryListener as RefListener
from spark_tpu.observability.sinks import json_default as ref_json_default
from spark_tpu.plan.physical import ExecContext as RefExecContext
from spark_tpu.session import SparkTpuSession as RefSession
from spark_tpu.testing import faults as ref_faults
from spark_tpu.tpch import queries as RQ
from spark_tpu_torch import SparkTpuSession, history
from spark_tpu_torch import config as port_config
from spark_tpu_torch import functions as PF
from spark_tpu_torch.execution.executor import QueryExecution
from spark_tpu_torch.observability import QueryListener
from spark_tpu_torch.observability.sinks import json_default
from spark_tpu_torch.plan.physical import ExecContext
from spark_tpu_torch.testing import faults
from spark_tpu_torch.tpch import queries as PQ

from torch_sql_parity import write_data

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVENT_KEY = "spark_tpu.sql.eventLog.dir"
TRACE_KEY = "spark_tpu.sql.trace.dir"
SINK_KEY = "spark_tpu.sql.metrics.sink"
MDIR_KEY = "spark_tpu.sql.metrics.dir"
MAXB_KEY = "spark_tpu.sql.eventLog.maxBytes"
COST_KEY = "spark_tpu.sql.observability.xlaCost"
SHARD_SPANS_KEY = "spark_tpu.sql.observability.shardSpans"
PROFILE_KEY = "spark_tpu.sql.profile.dir"
MESH_KEY = "spark_tpu.sql.mesh.size"
#: both packages' analyzers off, so their spans and `on_analysis`
#: events stay out of these comparisons (`test_torch_analysis.py` holds
#: the analyzer's event, span and log field across the packages)
NO_ANALYZER = (("spark_tpu.sql.analysis.enabled", False),)
#: the reference's spans without a port counterpart: its stage compile
#: and its analyzer's walks (the jaxpr walk has no port counterpart)
REF_ONLY_SPANS = {"compile", "analyze", "analyze_jaxpr"}
#: the port's spans without a reference counterpart: the egress to
#: Arrow, the SQL parse, the host work between the phases, and one
#: `op:<PhysicalClass>` span an operator computes
PORT_ONLY_SPANS = {"egress", "parse", "admit", "begin", "start_event",
                   "caps_lookup", "predict", "python_udfs", "execution",
                   "stage_completed", "grow_caps", "profile_export",
                   "readback", "caps_store", "external", "end_event"}


def port_only(name: str) -> bool:
    return name in PORT_ONLY_SPANS or name.startswith("op:")

#: the 21 keys of the slice: key -> a value other than the default
OBSERVABILITY_KEYS = {
    "spark_tpu.sql.metrics.enabled": False,
    "spark_tpu.sql.profile.dir": "prof",
    "spark_tpu.sql.eventLog.dir": "ev",
    "spark_tpu.sql.eventLog.maxBytes": 4096,
    "spark_tpu.sql.trace.dir": "tr",
    "spark_tpu.sql.metrics.sink": "jsonl,prometheus",
    "spark_tpu.sql.metrics.dir": "m",
    "spark_tpu.sql.observability.xlaCost": "on",
    "spark_tpu.sql.observability.maxSpans": 10,
    "spark_tpu.sql.observability.shardSpans": "on",
    "spark_tpu.sql.observability.maxShardRecords": 16,
    "spark_tpu.sql.straggler.factor": 4.0,
    "spark_tpu.sql.straggler.minChunks": 2,
    "spark_tpu.sql.straggler.minLatencyMs": 1.0,
    "spark_tpu.sql.status.enabled": False,
    "spark_tpu.sql.status.heartbeatMs": 50,
    "spark_tpu.sql.status.ringSize": 8,
    "spark_tpu.sql.flightRecorder.enabled": False,
    "spark_tpu.sql.flightRecorder.dir": "fr",
    "spark_tpu.sql.flightRecorder.ringSize": 8,
    "spark_tpu.sql.flightRecorder.eventLogTail": 5,
}


class Recorder:
    """Collects (callback, event) pairs; one class per package's base."""

    def __init__(self):
        self.calls = []

    def on_query_start(self, e):
        self.calls.append(("start", e))

    def on_stage_compiled(self, e):
        self.calls.append(("compiled", e))

    def on_stage_completed(self, e):
        self.calls.append(("completed", e))

    def on_fault(self, e):
        self.calls.append(("fault", e))

    def on_query_end(self, e):
        self.calls.append(("end", e))

    def names(self):
        return [c[0] for c in self.calls if c[0] != "compiled"]


class PortRecorder(Recorder, QueryListener):
    pass


class RefRecorder(Recorder, RefListener):
    pass


def sessions(confs=()):
    """(port, reference): fresh sessions, the port's on the CPU, both
    analyzers off."""
    port = SparkTpuSession.builder().device("cpu").get_or_create()
    ref = RefSession(register_active=False)
    for key, value in NO_ANALYZER:
        port.conf.set(key, value)
        ref.conf.set(key, value)
    for key, value in confs:
        port.conf.set(key, value)
        ref.conf.set(key, value)
    return port, ref


def agg(session, F, n):
    """range(n) grouped by id % 5, summed."""
    return (session.range(n).group_by((F.col("id") % 5).alias("k"))
            .agg(F.sum(F.col("id")).alias("s")))


def events_tool(*args):
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "events_tool.py"),
         *args], capture_output=True, text=True, timeout=60)


# -- the listener bus --------------------------------------------------------

@pytest.mark.parametrize("spec", ["", "stage_run:unavailable:1",
                                  "stage_run:fatal:1"])
def test_listener_order_parity(spec, tmp_path):
    """The same query under the same fault gives the same callback
    sequence in both packages (the reference's `compiled` left out):
    start first, end last with the same status, the fault's action,
    one query id, and a failed query's error text."""
    port, ref = sessions((("spark_tpu.execution.backoffMs", 1),
                          ("spark_tpu.sql.flightRecorder.dir",
                           str(tmp_path / "fr"))))
    recs = (PortRecorder(), RefRecorder())
    outs = []
    for s, F, rec, fmod in ((port, PF, recs[0], faults),
                            (ref, RF, recs[1], ref_faults)):
        s.add_listener(rec)
        try:
            with fmod.inject(s.conf, spec), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                try:
                    outs.append(agg(s, F, 772).to_pandas())
                except Exception as e:  # noqa: BLE001 — compared below
                    outs.append(e)
        finally:
            s.remove_listener(rec)
    names = [r.names() for r in recs]
    assert names[0] == names[1], names
    assert names[0][0] == "start" and names[0][-1] == "end"
    ends = [r.calls[-1][1] for r in recs]
    assert ends[0].status == ends[1].status
    for r, end in zip(recs, ends):
        assert end.query_id == r.calls[0][1].query_id
    faults_seen = [[e.action for n, e in r.calls if n == "fault"]
                   for r in recs]
    assert faults_seen[0] == faults_seen[1]
    if spec.endswith("fatal:1"):
        assert ends[0].status == "error"
        assert isinstance(outs[0], faults.FaultInjected)
        assert ends[0].event["error"] == ends[1].event["error"]
        assert "INTERNAL" in ends[0].event["error"]
    else:
        assert ends[0].status == "ok"
        pd.testing.assert_frame_equal(outs[0], outs[1])
        assert ends[0].event["metrics"]
        if spec:
            assert faults_seen[0] == ["transient_retry"]
            assert names[0].index("fault") < names[0].index("end")


def test_listener_failure_isolated():
    """A raising listener is dropped with a UserWarning in both
    packages, counted, and the result is unchanged."""
    port, ref = sessions()
    got = []
    for s, base, F in ((port, QueryListener, PF), (ref, RefListener, RF)):
        class Bad(base):
            def on_query_end(self, e):
                raise RuntimeError("listener bug")

        bad = Bad()
        s.add_listener(bad)
        try:
            with pytest.warns(UserWarning, match="listener bug"):
                got.append(agg(s, F, 50).to_pandas())
        finally:
            s.remove_listener(bad)
        assert s.listeners.dropped >= 1
    pd.testing.assert_frame_equal(got[0], got[1])


def test_no_event_built_without_output_or_listener(monkeypatch, tmp_path):
    """With no output configured and no user listener, `_build_event`
    is never called; one user listener or one output turns it on."""
    calls = []
    original = QueryExecution._build_event

    def counting(self, *a, **k):
        calls.append(self.query_id)
        return original(self, *a, **k)

    monkeypatch.setattr(QueryExecution, "_build_event", counting)
    port, _ = sessions()
    agg(port, PF, 101).to_pandas()
    port.sql("SELECT 1 AS x").collect()
    with faults.inject(port.conf, "stage_run:fatal:1"):
        with pytest.raises(faults.FaultInjected):
            agg(port, PF, 102).to_pandas()
    assert calls == []
    rec = PortRecorder()
    port.add_listener(rec)
    try:
        agg(port, PF, 103).to_pandas()
    finally:
        port.remove_listener(rec)
    assert len(calls) == 1
    port.conf.set(SINK_KEY, "jsonl")
    port.conf.set(MDIR_KEY, str(tmp_path / "m"))
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            agg(port, PF, 104).to_pandas()
    finally:
        port.conf.set(SINK_KEY, "")
    assert len(calls) == 2


# -- spans / Chrome trace ----------------------------------------------------

#: epoch-microsecond timestamps near 1.7e15 carry about 0.25 us of
#: float rounding, so interval ends are compared within this slack
_TS_SLACK_US = 1.0


def _nested_or_disjoint(spans) -> bool:
    """Every pair of (start, end) intervals is disjoint, or one holds the
    other."""
    for i, (a0, a1) in enumerate(spans):
        for b0, b1 in spans[i + 1:]:
            disjoint = a1 <= b0 + _TS_SLACK_US or b1 <= a0 + _TS_SLACK_US
            a_holds_b = a0 <= b0 + _TS_SLACK_US and b1 <= a1 + _TS_SLACK_US
            b_holds_a = b0 <= a0 + _TS_SLACK_US and a1 <= b1 + _TS_SLACK_US
            if not (disjoint or a_holds_b or b_holds_a):
                return False
    return True


def _union_us(spans) -> float:
    """Length of the union of (start, end) intervals sorted by start."""
    total, cur0, cur1 = 0.0, None, None
    for s0, s1 in spans:
        if cur1 is None or s0 > cur1:
            if cur1 is not None:
                total += cur1 - cur0
            cur0, cur1 = s0, s1
        else:
            cur1 = max(cur1, s1)
    if cur1 is not None:
        total += cur1 - cur0
    return total


def test_chrome_trace_parity(tmp_path):
    """Each package writes a valid Chrome trace whose span names are the
    reference's (less its compile and analyzer spans; the port adds its
    own, `PORT_ONLY_SPANS` and the operators'). The port's complete events nest (plan contains optimize,
    which contains analysis): any two are disjoint or one contains the
    other, and their union covers at most the wall time."""
    port, ref = sessions()
    names = []
    for s, F, tag in ((port, PF, "p"), (ref, RF, "r")):
        d = str(tmp_path / tag)
        s.conf.set(TRACE_KEY, d)
        import time
        t0 = time.perf_counter()
        agg(s, F, 774).to_pandas()
        wall_us = (time.perf_counter() - t0) * 1e6
        files = [f for f in os.listdir(d) if f.endswith(".trace.json")]
        assert files == [f"query-{s.app_id}-00001.trace.json"], files
        with open(os.path.join(d, files[0])) as f:
            trace = json.load(f)
        events = trace["traceEvents"]
        for e in events:
            assert e["ph"] in ("X", "i")
            assert isinstance(e["ts"], (int, float)) and e["tid"] == 1
            if e["ph"] == "X":
                assert e["dur"] >= 0
        if tag == "p":
            spans = sorted((e["ts"], e["ts"] + e["dur"])
                           for e in events if e["ph"] == "X")
            assert _nested_or_disjoint(spans), spans
            assert _union_us(spans) <= wall_us
        names.append({e["name"] for e in events})
    assert {"analysis", "optimize", "plan", "ingest",
            "dispatch"} <= names[0]
    assert names[1] - REF_ONLY_SPANS <= names[0]
    assert not [n for n in names[0] - names[1] if not port_only(n)]


def test_spans_in_event_log(tmp_path):
    """The event log's spans replay through both packages' history as
    the same timeline rows (names in order), every duration >= 0."""
    from spark_tpu import history as ref_history
    port, ref = sessions()
    rows = []
    for s, F, tag in ((port, PF, "p"), (ref, RF, "r")):
        s.conf.set(EVENT_KEY, str(tmp_path / tag))
        agg(s, F, 775).to_pandas()
        for h in (history, ref_history):
            spans = h.stage_summary(h.read_event_log(str(tmp_path / tag)))
            assert list(spans.columns) == ["ts", "app", "query_id", "span",
                                           "t0_ms", "dur_ms", "attrs"]
            assert (spans["dur_ms"] >= 0).all()
        rows.append([n for n in spans["span"]
                     if n not in REF_ONLY_SPANS and not port_only(n)])
    assert rows[0] == rows[1]


def test_maxspans_bounds_and_counts():
    port, ref = sessions((("spark_tpu.sql.observability.maxSpans", 3),))
    for s, F in ((port, PF), (ref, RF)):
        qe = agg(s, F, 60)._qe()
        qe.collect()
        assert len(qe.spans.spans) == 3 and qe.spans.dropped > 0


# -- the event log -----------------------------------------------------------

def test_event_log_schema_and_unique_filename(tmp_path):
    port, ref = sessions()
    lines = []
    for s, F, tag in ((port, PF, "p"), (ref, RF, "r")):
        d = str(tmp_path / tag)
        s.conf.set(EVENT_KEY, d)
        agg(s, F, 783).to_pandas()
        files = os.listdir(d)
        assert files == [f"app-{s.app_id}.jsonl"]
        assert files[0] != f"app-{os.getpid()}.jsonl"
        with open(os.path.join(d, files[0])) as f:
            lines.append(json.loads(f.read().splitlines()[-1]))
        assert events_tool("validate", d).returncode == 0
    for line in lines:
        assert line["schema_version"] == 7 and line["status"] == "ok"
        assert line["query_id"] == 1
    assert lines[0]["plan"] == lines[1]["plan"]
    assert lines[0]["metrics"] == lines[1]["metrics"]
    assert set(lines[0]) <= set(lines[1]) | {"stages"}


def test_event_log_rotation_and_replay_order(tmp_path):
    """Every write past maxBytes=1 rolls the live file; both packages
    replay the rolled files in write order, the app filter included."""
    from spark_tpu import history as ref_history
    port, ref = sessions(((MAXB_KEY, 1), (COST_KEY, "off")))
    for s, F, tag in ((port, PF, "p"), (ref, RF, "r")):
        d = str(tmp_path / tag)
        s.conf.set(EVENT_KEY, d)
        for i in range(4):
            s.range(100 + i).agg(F.sum(F.col("id")).alias("s")).to_pandas()
        names = sorted(os.listdir(d))
        assert len([n for n in names if n.count(".") == 2]) == 3, names
        for h in (history, ref_history):
            events = h.read_event_log(d)
            assert len(events) == 4
            assert events["ts"].is_monotonic_increasing
            assert list(events["query_id"]) == [1, 2, 3, 4]
            assert len(h.read_event_log(d, app=s.app_id)) == 4


def test_event_log_write_failure_warns_not_raises(tmp_path):
    bad = tmp_path / "afile"
    bad.write_text("x")
    port, ref = sessions(((EVENT_KEY, str(bad)),))
    got = []
    for s, F in ((port, PF), (ref, RF)):
        with pytest.warns(UserWarning, match="event log write failed"):
            got.append(s.range(5).to_pandas())
    pd.testing.assert_frame_equal(got[0], got[1])


def test_json_default_encoder():
    """numpy and torch values serialize as the JAX package's hook
    serializes numpy and JAX values."""
    assert json_default(np.int64(7)) == ref_json_default(np.int64(7)) == 7
    assert json_default(np.float32(0.5)) == 0.5
    assert json_default(np.array([1, 2])) == [1, 2]
    assert json_default(torch.tensor(3)) == 3
    assert json_default(torch.tensor(2.5, dtype=torch.float64)) == 2.5
    assert json_default(torch.tensor([1, 2], dtype=torch.int64)) == [1, 2]
    assert json_default(torch.int64) == "torch.int64"
    assert json_default({"b", "a"}) == ["a", "b"]
    s = json.dumps({"v": torch.tensor(5), "w": np.float64(1.5),
                    "d": torch.float32}, default=json_default)
    assert json.loads(s) == {"v": 5, "w": 1.5, "d": "torch.float32"}


# -- per-operator metrics ----------------------------------------------------

def test_per_op_metrics_disable():
    """`spark_tpu.sql.metrics.enabled=false` drops the rows_ metrics in
    both packages; the capacity metrics stay."""
    port, ref = sessions((("spark_tpu.sql.metrics.enabled", False),))
    got = []
    for s, F in ((port, PF), (ref, RF)):
        qe = s.range(50).filter(F.col("id") > 40)._qe()
        qe.execute_batch()
        assert not any(k.startswith("rows_") for k in qe.last_metrics)
        qe2 = agg(s, F, 50)._qe()
        qe2.execute_batch()
        got.append(dict(qe2.last_metrics))
    assert got[0] == got[1] and "agg_groups" in got[0]


@pytest.mark.parametrize("name,ok", [
    ("made_up_metric", False), ("rows_op1", True), ("exch_rows_e1", True),
    ("agg_groups", True), ("joinrows_j1", False)])
def test_unregistered_metric_name_rejected(name, ok):
    """ExecContext.add_metric raises on a name outside METRIC_PREFIXES,
    with the JAX package's message, in both packages."""
    for ctx in (ExecContext(port_config.Conf(), "cpu"),
                RefExecContext(ref_config.Conf())):
        if ok:
            ctx.add_metric(name, 1)
            assert ctx.metrics[name] == 1
        else:
            with pytest.raises(ValueError, match="unregistered metric"):
                ctx.add_metric(name, 1)


def test_port_metric_names_are_registered(tmp_path):
    """The names the port emits that the JAX package does not (the hash
    join's steps) are registered in the port's list; the JAX package's
    prefixes are all in it."""
    from spark_tpu.observability.metrics import METRIC_PREFIXES as REF
    from spark_tpu_torch.observability.metrics import (METRIC_PREFIXES,
                                                       is_registered_metric)
    assert set(REF) <= set(METRIC_PREFIXES)
    assert set(METRIC_PREFIXES) - set(REF) == {"join_build_steps_",
                                               "join_probe_steps_"}
    left = pd.DataFrame({"k": np.arange(64, dtype=np.int64),
                         "v": np.arange(64, dtype=np.int64)})
    right = pd.DataFrame({"k": np.arange(0, 64, 2, dtype=np.int64),
                          "w": np.arange(32, dtype=np.int64)})
    port, _ = sessions((("spark_tpu.sql.join.kernelMode", "hash"),))
    port.register_table("obs_hl", left)
    port.register_table("obs_hr", right)
    qe = port.table("obs_hl").join(port.table("obs_hr"), on="k")._qe()
    qe.collect()
    steps = [k for k in qe.last_metrics if "_steps_" in k]
    assert steps and all(is_registered_metric(k) for k in steps)


# -- the conf keys -----------------------------------------------------------

@pytest.mark.parametrize("key", sorted(OBSERVABILITY_KEYS))
def test_observability_key_is_ported(key, tmp_path):
    """Each of the slice's 21 keys is registered with the JAX package's
    default, off the unported list, and takes a value in both packages
    alike (the tests above and in `test_torch_status_store.py` hold
    each one's effect)."""
    assert key in port_config.registry()
    assert key not in port_config.UNPORTED_KEYS
    assert port_config.registry()[key].default == \
        ref_config.registry()[key].default
    value = OBSERVABILITY_KEYS[key]
    if isinstance(value, str) and value.isalpha() and key.endswith("dir"):
        value = str(tmp_path / value)
    pc, rc = port_config.Conf(), ref_config.Conf()
    pc.set(key, value)
    rc.set(key, value)
    assert pc.get(key) == rc.get(key) and pc.is_explicitly_set(key)


def test_unported_list_after_slice_12a():
    # 55 after slice 12a; slice 10b took its seven keys off, slice 11
    # its eleven, slice 12b four (analysis.jaxpr stays: the port leaves
    # the jaxpr analyzer out), slice 12c's first part fourteen, its
    # second part the fleet's ten (the compile cache's stay, left out),
    # slice 14 the cluster's three
    assert len(port_config.UNPORTED_KEYS) == 6
    assert not any("12a" in part
                   for part, _ in port_config.UNPORTED_KEYS.values())
    for key, bad in ((SINK_KEY, "statsd"), (COST_KEY, "sometimes"),
                     (SHARD_SPANS_KEY, "always"),
                     ("spark_tpu.sql.status.heartbeatMs", 5),
                     ("spark_tpu.sql.flightRecorder.ringSize", 4)):
        for conf in (port_config.Conf(), ref_config.Conf()):
            with pytest.raises(ValueError):
                conf.set(key, bad)


# -- device-memory cost, profile trace ---------------------------------------

def test_stage_cost_on_cpu_says_why(tmp_path):
    """xlaCost=on on a CPU session records a stage per plan with the
    reason it measured nothing; off records none; auto follows the
    outputs."""
    port, _ = sessions(((COST_KEY, "on"),))
    qe = agg(port, PF, 776)._qe()
    qe.collect()
    (info,) = qe.stage_costs.values()
    assert "CUDA-only" in info["memory_error"]
    assert len(info["key_hash"]) == 10
    assert "peak_hbm_bytes" not in info
    text = qe.explain(runtime=True)
    assert "Stage cost (device memory)" in text
    port.conf.set(COST_KEY, "auto")
    qe = agg(port, PF, 777)._qe()
    qe.collect()
    assert not qe.stage_costs
    port.conf.set(EVENT_KEY, str(tmp_path / "ev"))
    qe = agg(port, PF, 778)._qe()
    qe.collect()
    assert qe.stage_costs
    port.conf.set(COST_KEY, "off")
    qe = agg(port, PF, 779)._qe()
    qe.collect()
    assert not qe.stage_costs
    events = history.read_event_log(str(tmp_path / "ev"))
    comp = history.compile_summary(events)
    assert list(comp["stage"].dropna()) and comp["peak_hbm_bytes"].isna().all()
    assert history.hbm_summary(events).empty  # nothing measured on a CPU


def test_profile_dir_writes_a_torch_trace(tmp_path):
    d = str(tmp_path / "prof")
    port, _ = sessions(((PROFILE_KEY, d),))
    got = agg(port, PF, 780).to_pandas()
    port.conf.set(PROFILE_KEY, "")
    assert got.equals(agg(port, PF, 780).to_pandas())
    (name,) = os.listdir(d)
    assert name.startswith(f"torch-{port.app_id}-") and \
        name.endswith(".trace.json")
    with open(os.path.join(d, name)) as f:
        trace = json.load(f)
    assert trace["traceEvents"]


# -- operator spans and the profiler's ranges --------------------------------

SQL_JOIN = ("select u.g, sum(t.v) as s from obs_t t join obs_u u "
            "on t.k = u.k where t.v > 3 group by u.g order by u.g")
#: a plain query's phase times before operator spans and the parse span
PHASES = {"analysis", "optimization", "planning", "ingest", "execution",
          "egress"}


def sql_session():
    """A port session on the CPU with two small tables."""
    import pyarrow as pa
    s = SparkTpuSession.builder().device("cpu").get_or_create()
    rng = np.random.default_rng(5)
    s.register_table("obs_t", pa.table({
        "k": rng.integers(0, 50, 2000), "v": rng.integers(0, 100, 2000)}))
    s.register_table("obs_u", pa.table({
        "k": np.arange(50), "g": np.arange(50) % 4}))
    return s


def computed_nodes(root):
    """The class names of the nodes `run_plan` computes: each node once,
    the loaded scans left out."""
    from spark_tpu_torch.plan import physical as PP
    seen, out = set(), []

    def walk(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for c in node.children:
            walk(c)
        if not isinstance(node, PP.ScanExec):
            out.append(type(node).__name__)

    walk(root)
    return out


def test_sql_query_records_parse_phases_and_operator_spans():
    """A SQL query's spans start with `parse` and hold every phase; each
    dispatch holds one `op:<PhysicalClass>` span a computed node."""
    qe = sql_session().sql(SQL_JOIN)._qe()
    qe.collect()
    spans = qe.spans.spans
    names = [sp.name for sp in spans]
    assert names[0] == "parse"
    assert {"parse", "analysis", "optimize", "plan", "ingest", "dispatch",
            "egress"} <= set(names)
    assert qe.phase_times["parse"] == spans[0].t1 - spans[0].t0 > 0
    dispatches = [sp for sp in spans if sp.name == "dispatch"]
    ops = [sp for sp in spans if sp.name.startswith("op:")]
    assert len(dispatches) == qe.attempts >= 1
    for d in dispatches:
        inside = [sp.name[3:] for sp in ops
                  if d.t0 <= sp.t0 and sp.t1 <= d.t1]
        assert sorted(inside) == sorted(computed_nodes(qe.spliced_plan))
    assert len(ops) == len(dispatches) * len(computed_nodes(qe.spliced_plan))
    assert {"op:JoinExec", "op:HashAggregateExec"} <= {sp.name for sp in ops}


def test_a_shared_node_is_one_operator_span():
    from spark_tpu_torch.execution.executor import load_scans, run_plan
    from spark_tpu_torch.observability import SpanRecorder
    from spark_tpu_torch.plan import physical as PP
    s = sql_session()
    qe = s.sql("select k, v + 1 as w from obs_t where v > 50")._qe()
    qe.collect()
    child = qe.spliced_plan
    root = PP.UnionExec(child, child, child.schema())
    rec = SpanRecorder(0)
    out = run_plan(root, ExecContext(s.conf, s.device, spans=rec),
                   loaded=load_scans(root, s.conf, s.device))
    names = [sp.name for sp in rec.spans]
    assert sorted(names) == sorted("op:" + n for n in computed_nodes(root))
    assert names.count("op:UnionExec") == 1 and "op:ScanExec" not in names
    assert len(names) < 2 * len(computed_nodes(child))
    assert out.to_arrow().num_rows == 2 * qe.collect().num_rows


def _shape(items):
    """(name, depth) of nested (start, end, name) intervals in start
    order."""
    out, ends = [], []
    for a, b, name in sorted(items, key=lambda x: (x[0], -x[1])):
        while ends and ends[-1] <= a:
            ends.pop()
        out.append((name, len(ends)))
        ends.append(b)
    return out


def test_every_span_is_a_profiler_range_with_its_nesting():
    """Under a torch.profiler every span of a query is a `spark_tpu/`
    range of the same name, in the same order and nesting."""
    from torch.profiler import ProfilerActivity, profile
    s = sql_session()
    s.sql(SQL_JOIN).collect()  # the capacities converge
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        qe = s.sql(SQL_JOIN)._qe()
        qe.collect()
    prefix = "spark_tpu/"
    ranges = [(e.start_ns(), e.start_ns() + e.duration_ns(),
               e.name()[len(prefix):])
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith(prefix)]
    spans = [(sp.t0, sp.t1, sp.name) for sp in qe.spans.spans
             if sp.t1 > sp.t0]
    assert any(n.startswith("op:") for _, _, n in spans)
    # the walk for streamable aggregates is a range either way, and a
    # span only when one streamed (none does here)
    assert [n for _, _, n in ranges].count("streaming") == 1
    assert "streaming" not in [n for _, _, n in spans]
    ranges = [r for r in ranges if r[2] != "streaming"]
    assert _shape(ranges) == _shape(spans)


def test_no_range_is_entered_without_a_profiler(monkeypatch):
    from torch.profiler import ProfilerActivity, profile
    from spark_tpu_torch.observability import spans as spans_mod
    entered = []
    real = spans_mod._range

    def entry(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(spans_mod, "_range", entry)
    s = sql_session()
    qe = s.sql(SQL_JOIN)._qe()
    qe.collect()
    assert any(sp.name.startswith("op:") for sp in qe.spans.spans)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        qe = s.sql(SQL_JOIN)._qe()
        qe.collect()
    assert sorted(entered) == sorted(
        ["spark_tpu/" + sp.name for sp in qe.spans.spans]
        + ["spark_tpu/streaming"])


def test_streaming_span_only_when_an_aggregate_streamed():
    """The `streaming` span and phase mark a streamed aggregate, and a
    query that streams nothing has neither (the strict analyzer's checks
    read the span's absence)."""
    s = sql_session()

    def agg():
        return (s.range(1 << 12)
                .select(PF.pmod(PF.col("id"), 50).alias("k"))
                .group_by(PF.col("k")).agg(PF.sum(PF.col("k")).alias("s")))

    qe = agg()._qe()
    qe.collect()
    assert "streaming" not in [sp.name for sp in qe.spans.spans]
    assert "streaming" not in qe.phase_times
    s.conf.set("spark_tpu.sql.execution.streamingChunkRows", 1 << 10)
    qe = agg()._qe()
    got = qe.collect()
    assert "InputExec(streamed_agg" in qe.spliced_plan.tree_string()
    names = [sp.name for sp in qe.spans.spans]
    assert names.count("streaming") == 1
    assert names.index("streaming") < names.index("ingest")
    stream = qe.spans.spans[names.index("streaming")]
    assert qe.phase_times["streaming"] == stream.t1 - stream.t0 > 0
    assert got.num_rows == 50


def test_end_event_phase_keys_are_the_phases_and_parse():
    """The end event's phase times keep their keys; a SQL query adds
    `parse`."""
    s = sql_session()
    got = []

    class Keys(QueryListener):
        def on_query_end(self, e):
            got.append(set(e.event["phase_times_s"]))

    s.add_listener(Keys())
    s.range(50).agg(PF.sum(PF.col("id")).alias("s")).collect()
    s.sql("select k, sum(v) as s from obs_t group by k").collect()
    assert got == [PHASES, PHASES | {"parse"}]


def test_recorders_share_one_clock_origin():
    """Spans of different queries map onto the epoch clock through one
    anchor, so their Chrome-trace times line up."""
    import time
    from spark_tpu_torch.observability import SpanRecorder, to_chrome_trace
    a, b = SpanRecorder(1), SpanRecorder(2)
    t = time.perf_counter()
    a.record("x", t, t + 0.001)
    b.record("x", t, t + 0.001)
    assert a.wall(t) == b.wall(t)
    assert to_chrome_trace(a)["traceEvents"][0]["ts"] == \
        to_chrome_trace(b)["traceEvents"][0]["ts"]


# -- the UDF stage's spans ---------------------------------------------------

def test_udf_batch_spans_in_worker_lane(tmp_path):
    """Each Arrow batch through the worker lane is one `udf_batch` span,
    as in the JAX package (its records carry the chunk and rows)."""
    from spark_tpu import functions as RFn
    from spark_tpu_torch import functions as PFn
    confs = (("spark_tpu.sql.udf.mode", "worker"),
             ("spark_tpu.sql.udf.arrow.maxRecordsPerBatch", 40),
             ("spark_tpu.sql.udf.pool.maxWorkers", 1))
    port, ref = sessions(confs)
    spans = []
    for s, Fn in ((port, PFn), (ref, RFn)):
        inc = Fn.udf(lambda v: v + 1, "long")
        qe = s.range(100).select(inc(Fn.col("id")).alias("x"))._qe()
        qe.collect()
        spans.append([(sp.name, sp.attrs) for sp in qe.spans.spans
                      if sp.name == "udf_batch"])
        s._udf_pool.shutdown()
    assert spans[0] == spans[1]
    assert [a["rows"] for _, a in spans[0]] == [40, 40, 20]


# -- the mesh's transfer records ---------------------------------------------

@pytest.fixture(scope="module")
def tpch_path(tmp_path_factory):
    return write_data(tmp_path_factory, 0.002)


def test_mesh_transfer_records_match_reference(tpch_path, tmp_path):
    """DF Q1 at mesh size 4 with shardSpans on: each exchange's
    per-shard routed rows (and bytes) equal the JAX package's records,
    which it unpacks from one-hot vectors; none reach last_metrics; the
    event log carries them and both histories replay them."""
    from spark_tpu import history as ref_history
    port, ref = sessions(((MESH_KEY, 4), (SHARD_SPANS_KEY, "on")))
    recs, tables = [], []
    for s, Q, tag in ((port, PQ, "p"), (ref, RQ, "r")):
        Q.register_tables(s, tpch_path)
        s.conf.set(EVENT_KEY, str(tmp_path / tag))
        qe = Q.QUERIES["q1"](s)._qe()
        tables.append(qe.collect())
        transfer = [r for r in qe.spans.shard_records
                    if r["phase"] == "transfer"]
        assert transfer and not any(k.startswith("shard_")
                                    for k in qe.last_metrics)
        by_source = {}
        for r in transfer:
            by_source.setdefault(r["source"], []).append(
                (r["shard"], r["rows"], r["bytes"]))
        recs.append(by_source)
        for h in (history, ref_history):
            ss = h.shard_summary(h.read_event_log(str(tmp_path / tag)))
            assert len(ss) == len(transfer)
            assert set(ss["phase"]) == {"transfer"}
        assert events_tool("validate", str(tmp_path / tag)).returncode == 0
    assert recs[0].keys() == recs[1].keys()
    for source in recs[0]:
        assert [(i, n) for i, n, _ in recs[0][source]] == \
            [(i, n) for i, n, _ in recs[1][source]], source
    assert tables[0].equals(tables[1])


def test_mesh_transfer_records_off_by_default(tpch_path):
    port, _ = sessions(((MESH_KEY, 4),))
    PQ.register_tables(port, tpch_path)
    qe = PQ.QUERIES["q6"](port)._qe()
    qe.collect()
    assert qe.spans.shard_records == []
