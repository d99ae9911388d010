"""Metrics, the status store, the flight recorder and straggler detection
of the port (`spark_tpu_torch/observability/`) against the JAX
package's: the log-bucketed Histogram on the same observations, the
Prometheus text each package writes parsed by the other's parser, the
JSONL and Prometheus sinks at query end, the status store's fold-in,
rings, provider isolation, heartbeat and disabled state, the latency
histograms, flight-recorder bundles (an injected fatal, on demand, the
rings' bounds, results equal with the recorder on and off), and the
straggler rule `evaluate_waits` on seeded waits, the monitor and the
per-shard telemetry on synthetic chunks (the mesh stream feeds them in
`tests/test_torch_elastic.py` and `test_torch_mesh_stream.py`).

The SLO target (`spark_tpu.service.slo.latencyMs`) is the service's
key: its burn counting and the status store under a live service are
held in `tests/test_torch_service_concurrency.py`.
"""

import glob
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from spark_tpu import config as ref_config
from spark_tpu import functions as RF
from spark_tpu.observability import metrics as RM
from spark_tpu.observability import straggler as RS
from spark_tpu.observability.flight_recorder import \
    FlightRecorder as RefFlightRecorder
from spark_tpu.observability.status_store import StatusStore as RefStore
from spark_tpu.session import SparkTpuSession as RefSession
from spark_tpu.testing import faults as ref_faults
from spark_tpu_torch import SparkTpuSession
from spark_tpu_torch import config as port_config
from spark_tpu_torch import functions as PF
from spark_tpu_torch.observability import StragglerMonitor
from spark_tpu_torch.observability import metrics as M
from spark_tpu_torch.observability import straggler as S
from spark_tpu_torch.observability.flight_recorder import FlightRecorder
from spark_tpu_torch.observability.listener import ShardChunkEvent
from spark_tpu_torch.observability.spans import (ShardStreamTelemetry,
                                                 SpanRecorder,
                                                 use_shard_telemetry)
from spark_tpu_torch.observability.status_store import StatusStore
from spark_tpu_torch.parallel.mesh import Mesh
from spark_tpu_torch.testing import faults

EVENT_KEY = "spark_tpu.sql.eventLog.dir"
SINK_KEY = "spark_tpu.sql.metrics.sink"
MDIR_KEY = "spark_tpu.sql.metrics.dir"
STATUS_RING_KEY = "spark_tpu.sql.status.ringSize"
HEARTBEAT_KEY = "spark_tpu.sql.status.heartbeatMs"
STATUS_ON_KEY = "spark_tpu.sql.status.enabled"
FR_ON_KEY = "spark_tpu.sql.flightRecorder.enabled"
FR_DIR_KEY = "spark_tpu.sql.flightRecorder.dir"
FR_RING_KEY = "spark_tpu.sql.flightRecorder.ringSize"


def port_session(confs=()):
    s = SparkTpuSession.builder().device("cpu").get_or_create()
    for k, v in confs:
        s.conf.set(k, v)
    return s


def ref_session(confs=()):
    s = RefSession(register_active=False)
    s.conf.set("spark_tpu.sql.analysis.enabled", False)
    for k, v in confs:
        s.conf.set(k, v)
    return s


def agg(session, F, n):
    return (session.range(n).group_by((F.col("id") % 7).alias("k"))
            .agg(F.sum(F.col("id")).alias("s")))


# -- the Histogram metric type -----------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_parity(seed):
    """The same observations (log-normal latencies, a few past the last
    bound) give equal counts, sums, buckets and quantiles."""
    rng = np.random.default_rng(seed)
    values = np.concatenate([rng.lognormal(2.0, 2.0, 500),
                             [0.0, 0.1, M.Histogram.DEFAULT_BOUNDS[-1] * 3]])
    hp, hr = M.Histogram(), RM.Histogram()
    for v in values:
        hp.observe(float(v))
        hr.observe(float(v))
    assert hp.snapshot() == hr.snapshot()
    assert hp.percentiles() == hr.percentiles()
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert hp.quantile(q) == hr.quantile(q)
    snap = hp.snapshot()
    assert snap["count"] == len(values) == sum(snap["counts"])
    assert snap["sum"] == pytest.approx(float(values.sum()))


def test_histogram_empty_overflow_and_concurrency():
    h = M.Histogram()
    assert h.quantile(0.99) == 0.0 and h.snapshot()["min"] == 0.0
    big = M.Histogram.DEFAULT_BOUNDS[-1] * 4
    h.observe(big)
    assert h.snapshot()["counts"][-1] == 1 and h.quantile(0.99) == big
    h = M.Histogram()

    def hammer():
        for i in range(500):
            h.observe(float(i % 32) + 0.5)

    ts = [threading.Thread(target=hammer) for _ in range(4)]
    [t.start() for t in ts]
    [t.join(30) for t in ts]
    assert h.snapshot()["count"] == 2000 == sum(h.snapshot()["counts"])


# -- Prometheus exposition ---------------------------------------------------

def _fill(reg):
    reg.counter("status_heartbeats").inc(3)
    reg.counter("queries_total").inc(5)
    reg.gauge("status_queries_inflight").set(2)
    t = reg.timer("udf_exec_ms")
    t.observe(0.25)
    t.observe(0.75)
    for v in (0.5, 3.0, 3.0, 900.0, 5e6):
        reg.histogram("status_latency_ms").observe(v)
    return reg


def test_prometheus_text_parses_across_packages():
    """Each package's exposition parses with the other's parser to the
    same series and values, histogram buckets and timer summaries
    included."""
    pt = M.prometheus_text(_fill(M.MetricsRegistry()).snapshot())
    rt = RM.prometheus_text(_fill(RM.MetricsRegistry()).snapshot())
    assert pt == rt
    got = M.parse_prometheus_text(rt)
    assert got == RM.parse_prometheus_text(pt) == M.parse_prometheus_text(pt)
    assert got["spark_tpu_status_latency_ms_count"] == 5
    assert got['spark_tpu_status_latency_ms_bucket{le="+Inf"}'] == 5
    assert got['spark_tpu_status_latency_ms_bucket{le="4"}'] == 3
    assert got["spark_tpu_udf_exec_ms_seconds_count"] == 2
    assert got["spark_tpu_udf_exec_ms_seconds_sum"] == pytest.approx(1.0)
    ordered = [got[f'spark_tpu_status_latency_ms_bucket{{le="{b:g}"}}']
               for b in M.Histogram.DEFAULT_BOUNDS]
    assert ordered == sorted(ordered)
    with pytest.raises(ValueError, match="unparseable"):
        M.parse_prometheus_text("bad line with spaces here\n")


def test_prometheus_sink_at_query_end(tmp_path):
    """metrics.sink=prometheus rewrites metrics.prom at every query end:
    the query count, the execution timer, the device-cache gauges and
    the latency histogram, parseable by both packages' parsers."""
    mdir = str(tmp_path / "m")
    s = port_session(((SINK_KEY, "prometheus"), (MDIR_KEY, mdir)))
    agg(s, PF, 780).to_pandas()
    agg(s, PF, 781).to_pandas()
    path = os.path.join(mdir, "metrics.prom")
    prom = M.parse_prometheus(path)
    assert prom == RM.parse_prometheus(path)
    assert prom["spark_tpu_queries_total"] == 2
    assert prom["spark_tpu_query_execution_count"] == 2
    assert prom["spark_tpu_status_latency_ms_count"] == 2
    assert any(k.startswith("spark_tpu_device_cache_") for k in prom)


def test_jsonl_sink_appends_snapshots(tmp_path):
    mdir = str(tmp_path / "m")
    s = port_session(((SINK_KEY, "jsonl"), (MDIR_KEY, mdir)))
    agg(s, PF, 782).to_pandas()
    agg(s, PF, 783).to_pandas()
    with open(os.path.join(mdir, "metrics.jsonl")) as f:
        lines = [json.loads(ln) for ln in f]
    assert len(lines) == 2
    assert [ln["counters"]["queries_total"] for ln in lines] == [1, 2]
    assert all("ts" in ln and "histograms" in ln for ln in lines)


def test_registry_holds_the_udf_counters():
    s = port_session()
    snap = s.metrics.snapshot()
    assert {k: snap["counters"][k] for k in M.UDF_COUNTERS} == \
        {k: 0 for k in M.UDF_COUNTERS}


# -- the status store --------------------------------------------------------

def _stores(providers=None, ring=4, enabled=True):
    out = []
    for C, Reg, Store in ((port_config.Conf, M.MetricsRegistry, StatusStore),
                          (ref_config.Conf, RM.MetricsRegistry, RefStore)):
        conf = C()
        conf.set(STATUS_RING_KEY, ring)
        if not enabled:
            conf.set(STATUS_ON_KEY, False)
        out.append((Store(conf, Reg(), providers), conf))
    return out


def test_status_store_listener_fold_in():
    s = port_session()
    store = StatusStore(s.conf, s.metrics)
    feed = store.bind(s, "t0")
    try:
        agg(s, PF, 771771).to_pandas()
    finally:
        s.remove_listener(feed)
    snap = store.snapshot()
    assert snap["enabled"] is True and snap["queries_total"] == 1
    assert snap["statuses"] == {"ok": 1}
    assert snap["queries_inflight"]["t0"] == 0
    assert snap["sessions"]["t0"]["ok"] == 1
    assert {"analysis", "optimization", "planning", "ingest", "execution",
            "egress"} <= set(snap["phase_seconds"])
    assert s.metrics.gauge("status_queries_inflight").value == 0
    # the feed is a user listener, so the query end reached the sinks
    assert snap["latency"]["e2e_ms"]["count"] == 1


def test_status_store_ring_capacity_bound():
    """Eleven samples into rings of 4 keep the last four in both
    packages; non-numeric leaves drop; the filters agree."""
    views = []
    for store, _ in _stores():
        ticks = {"n": 0}

        def prov(ticks=ticks):
            ticks["n"] += 1
            return {"depth": ticks["n"], "skipped": "text"}

        store.add_provider("q", prov)
        for _ in range(11):
            store.sample()
        ts = store.timeseries()
        assert ts["heartbeats"] == 11 and ts["ring_capacity"] == 4
        assert [v for _, v in ts["series"]["q_depth"]] == \
            [8.0, 9.0, 10.0, 11.0]
        assert "q_skipped" not in ts["series"]
        ts2 = store.timeseries(names=["q_depth"], limit=2)
        # both packages' streaming modules sample streams_live
        views.append((sorted(ts["series"]),
                      [v for _, v in ts2["series"]["q_depth"]]))
    assert views[0] == views[1]


def test_status_store_provider_failure_isolated():
    def bad():
        raise RuntimeError("provider down")

    for store, _ in _stores({"bad": bad, "ok": lambda: {"x": 1}}):
        vals = store.sample()
        assert vals["ok_x"] == 1.0 and "bad_x" not in vals
        snap = store.snapshot()
        assert "error" in snap["providers"]["bad"]
        assert snap["providers"]["ok"] == {"x": 1}


def test_status_store_heartbeat_joins_on_stop():
    (store, conf), _ = _stores({"p": lambda: {"v": 1}})
    conf.set(HEARTBEAT_KEY, 20)
    store.start()
    try:
        assert any(t.name == "spark-tpu-status-heartbeat"
                   for t in threading.enumerate())
        for _ in range(200):
            if store.snapshot()["heartbeats"] >= 2:
                break
            time.sleep(0.02)
        assert store.snapshot()["heartbeats"] >= 2
    finally:
        store.stop()
    assert not any(t.name == "spark-tpu-status-heartbeat"
                   for t in threading.enumerate())
    store.stop()  # idempotent


def test_status_store_disabled_is_inert():
    for store, _ in _stores(enabled=False):
        store.start()
        assert store._thread is None
        assert store.snapshot()["enabled"] is False
        assert store.sample()  # a direct tick still samples


def test_latency_histograms_at_query_end(tmp_path):
    """With an output on, every query end feeds the e2e, per-phase and
    per-class latency histograms; status.enabled=false silences them;
    burn counting stays off without the service's SLO key."""
    s = port_session(((EVENT_KEY, str(tmp_path / "ev")),))
    m = s.metrics
    agg(s, PF, 772772).to_pandas()
    assert m.histogram("status_latency_ms").snapshot()["count"] == 1
    names = m.histogram_names()
    assert "status_phase_ms_execution" in names
    assert "status_class_ms_hashaggregateexec" in names
    assert m.counter("slo_queries_total").value == 0
    s.conf.set(STATUS_ON_KEY, False)
    agg(s, PF, 772773).to_pandas()
    assert m.histogram("status_latency_ms").snapshot()["count"] == 1


# -- the flight recorder -----------------------------------------------------

def _bundle(s, F, fmod, tmp_path, tag):
    s.conf.set(EVENT_KEY, str(tmp_path / tag / "ev"))
    s.conf.set(FR_DIR_KEY, str(tmp_path / tag / "fr"))
    agg(s, F, 775001).to_pandas()  # a healthy query first
    with fmod.inject(s.conf, "stage_run:fatal:1"):
        with pytest.raises(fmod.FaultInjected):
            agg(s, F, 775775).to_pandas()
    (b,) = glob.glob(str(tmp_path / tag / "fr" / "bundle-*"))
    with open(os.path.join(b, "MANIFEST.json")) as f:
        return b, json.load(f)


def test_flightrec_bundle_on_injected_fatal_parity(tmp_path):
    """An injected fatal leaves one bundle in each package with the same
    manifest keys, reason, files, extra keys and ring subsystems."""
    port, ref = port_session(), ref_session()
    pb, pm = _bundle(port, PF, faults, tmp_path, "p")
    rb, rm = _bundle(ref, RF, ref_faults, tmp_path, "r")
    assert pm.keys() == rm.keys()
    assert pm["bundle_version"] == rm["bundle_version"] == 1
    assert pm["reason"] == rm["reason"] == "fatal"
    assert pm["files"] == rm["files"]
    assert pm["extra"].keys() == rm["extra"].keys()
    assert "FaultInjected" in pm["error"] and pm["extra"]["plan"]
    for fname in pm["files"]:
        assert os.path.exists(os.path.join(pb, fname)), fname
    subsystems = []
    for b in (pb, rb):
        with open(os.path.join(b, "rings.jsonl")) as f:
            subsystems.append({json.loads(ln)["subsystem"] for ln in f})
    assert subsystems[0] == subsystems[1] == {"query", "stage"}
    with open(os.path.join(pb, "spans.json")) as f:
        assert any(json.load(f)["spans"].values())
    with open(os.path.join(pb, "conf.json")) as f:
        conf_snap = json.load(f)
    assert FR_DIR_KEY in conf_snap["explicitly_set"]
    assert conf_snap["effective"][FR_ON_KEY] is True
    with open(os.path.join(pb, "threads.txt")) as f:
        assert "MainThread" in f.read()
    with open(os.path.join(pb, "eventlog_tail.jsonl")) as f:
        tail = [json.loads(ln) for ln in f]
    assert [e["status"] for e in tail] == ["ok", "error"]
    with open(os.path.join(pb, "lockwatch.json")) as f:
        assert json.load(f) == {"installed": False}
    assert port.metrics.counter("flightrec_bundles").value == 1


def test_flightrec_results_identical_on_vs_off(tmp_path):
    s = port_session(((FR_DIR_KEY, str(tmp_path / "fr")),
                      (EVENT_KEY, str(tmp_path / "ev"))))
    on = agg(s, PF, 776776)._qe().collect()
    s.conf.set(FR_ON_KEY, False)
    off = agg(s, PF, 776776)._qe().collect()
    assert on.equals(off)
    assert glob.glob(str(tmp_path / "fr" / "bundle-*")) == []


def test_flightrec_disabled_and_on_demand(tmp_path):
    for s, Rec in ((port_session(), FlightRecorder),
                   (ref_session(), RefFlightRecorder)):
        rec = Rec.of(s)
        assert rec is not None
        s.conf.set(FR_ON_KEY, False)
        assert rec.dump("test") is None
        s.conf.set(FR_ON_KEY, True)
        s.conf.set(FR_DIR_KEY, str(tmp_path / type(s).__module__))
        path = rec.dump("on_demand", extra={"who": "test"})
        with open(os.path.join(path, "MANIFEST.json")) as f:
            manifest = json.load(f)
        assert manifest["reason"] == "on_demand"
        assert manifest["extra"] == {"who": "test"}
        assert manifest["error"] is None
        assert s.metrics.counter("flightrec_bundles").value == 1


def test_flightrec_ring_bounded(tmp_path):
    s = port_session(((FR_RING_KEY, 8), (EVENT_KEY, str(tmp_path / "ev"))))
    rec = FlightRecorder(s)
    s.add_listener(rec)
    try:
        for i in range(6):  # 6 starts + 6 ends = 12 records > 8
            agg(s, PF, 777100 + i).to_pandas()
    finally:
        s.remove_listener(rec)
    with rec._lock:
        assert len(rec._rings["query"]) == 8
        assert [r["kind"] for r in rec._rings["query"]][-2:] == \
            ["start", "end"]
        assert all(len(d) <= 8 for d in rec._rings.values())


@pytest.mark.parametrize("spec,confs,status", [
    ("stage_run:cancel:1", (), "cancelled"),
    ("stage_run:slow:1:200", (("spark_tpu.execution.queryDeadlineMs", 50),),
     "deadline_exceeded")])
def test_no_bundle_on_cancel_or_deadline(tmp_path, spec, confs, status):
    """A cancelled or deadlined query posts its end with that status and
    dumps no bundle: stopping a query is lifecycle, not a crash."""
    from spark_tpu_torch.observability import QueryListener

    ends = []

    class Ends(QueryListener):
        def on_query_end(self, e):
            ends.append((e.status, e.event["fault_summary"]["cancel"]))

    s = port_session(((FR_DIR_KEY, str(tmp_path / "fr")),) + confs)
    s.add_listener(Ends())
    with faults.inject(s.conf, spec):
        with pytest.raises(Exception, match="(?i)cancel|deadline"):
            agg(s, PF, 778).to_pandas()
    assert ends == [(status, 1)]
    assert glob.glob(str(tmp_path / "fr" / "bundle-*")) == []


# -- straggler detection -----------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_evaluate_waits_parity(seed):
    """Per-shard waits drawn from a seed (some shards slow, some short of
    samples) give the same medians, baseline and flags in both
    packages."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 9))
    waits = {}
    for shard in range(n):
        k = int(rng.integers(0, 12))
        scale = 80.0 if rng.random() < 0.3 else 5.0
        waits[shard] = [float(x) for x in rng.exponential(scale, k)]
    for factor, min_chunks, floor in ((3.0, 4, 10.0), (1.5, 1, 0.0),
                                      (0.0, 2, 1.0)):
        got = S.evaluate_waits(waits, factor, min_chunks, floor)
        want = RS.evaluate_waits(waits, factor, min_chunks, floor)
        assert got == want
    assert S.WINDOW == RS.WINDOW


def _chunk(qid, c, slow=None, n=4, slow_ms=50.0):
    return ShardChunkEvent(query_id=qid, ts=0.0, chunk=c, records=[
        {"shard": s, "host": 0, "phase": "compute",
         "wait_ms": slow_ms if s == slow else 0.1} for s in range(n)])


def test_straggler_monitor_flags_slow_shard():
    """Synthetic chunks with shard 2 slow: flagged once (event and
    counter, posted outside the lock), the healthy shards never."""
    from spark_tpu_torch.observability import QueryListener

    s = port_session((("spark_tpu.sql.straggler.minChunks", 3),
                      ("spark_tpu.sql.straggler.factor", 4.0)))
    seen = []

    class Sub(QueryListener):
        def on_straggler(self, e):
            seen.append(e)
            mon.flagged(e.query_id)  # callbacks may call back in

    mon = StragglerMonitor.of(s)
    s.add_listener(Sub())
    for c in range(6):
        mon.on_shard_records(_chunk(42, c, slow=2))
    assert mon.flagged(42) == {2} and mon.report() == {42: {2}}
    assert len(seen) == 1 and seen[0].shard == 2 and seen[0].chunks == 3
    assert seen[0].median_ms > seen[0].baseline_ms
    assert s.metrics.counter("straggler_flagged").value == 1


def test_straggler_monitor_state_self_bounded():
    s = port_session()
    mon = StragglerMonitor.of(s)
    for qid in range(1000, 1000 + S._LIVE_BOUND + 5):
        mon.on_shard_records(_chunk(qid, 0, n=2))
    assert len(mon._waits) <= S._LIVE_BOUND
    assert 1000 not in mon._waits
    assert 1000 + S._LIVE_BOUND + 4 in mon._waits


def test_straggler_min_chunks_above_window_still_detects():
    s = port_session()
    mon = StragglerMonitor.of(s)
    min_chunks = S.WINDOW + 8
    s.conf.set("spark_tpu.sql.straggler.minChunks", min_chunks)
    for c in range(min_chunks + 2):
        mon.on_shard_records(_chunk(7777, c, slow=2))
    assert mon.flagged(7777) == {2}


def test_shard_telemetry_synthetic_chunks():
    """ShardStreamTelemetry over synthetic per-shard counts on a 4-shard
    CPU mesh: a retried chunk is not recorded twice, the ingest record
    has no shard, and a `shard_chunk:slow` fault on one shard's window
    every chunk makes the monitor flag that shard."""
    s = port_session((("spark_tpu.sql.straggler.minChunks", 3),))
    mesh = Mesh(["cpu"] * 4)
    rec = SpanRecorder(1)
    telem = ShardStreamTelemetry(rec, mesh, query_id=1, bus=s.listeners)
    counts = [torch.tensor(5), torch.tensor(6), torch.tensor(7),
              torch.tensor(0)]
    with use_shard_telemetry(telem):
        telem.chunk_ingested(0, 18, 144, time.perf_counter(),
                             time.perf_counter())
        telem.chunk_dispatched(0, counts, 8, time.perf_counter())
        telem.chunk_dispatched(0, counts, 8, time.perf_counter())  # retry
        telem.chunk_dispatched(1, counts, 8, time.perf_counter())
    comp = [r for r in rec.shard_records if r["phase"] == "compute"]
    assert len(comp) == 8
    assert len({(r["chunk"], r["shard"]) for r in comp}) == 8
    assert [r["rows"] for r in comp[:4]] == [5, 6, 7, 0]
    assert all(r["bytes"] == r["rows"] * 8 for r in comp)
    (ingest,) = [r for r in rec.shard_records if r["phase"] == "ingest"]
    assert ingest["shard"] is None
    rules = ",".join(f"shard_chunk:slow:{c * 4 + 2}:30" for c in range(5))
    with faults.scoped_site("shard_chunk"):
        with faults.inject(s.conf, rules) as fp:
            telem = ShardStreamTelemetry(SpanRecorder(2), mesh,
                                         query_id=2, bus=s.listeners)
            with use_shard_telemetry(telem):
                for c in range(5):
                    telem.chunk_dispatched(c, counts, 8,
                                           time.perf_counter())
    assert len(fp.fired_log) == 5
    assert StragglerMonitor.of(s).flagged(2) == {1}
