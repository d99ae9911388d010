"""The SQL service under concurrency, through both packages
(`tests/torch_service_parity.py`): the service cases of
`tests/test_concurrency.py` (the arbiter install race, the lockwatch
stress across pooled sessions), `tests/test_status_store.py`'s (the
status store under a concurrent service, a bad time-series limit, the
SLO burn counters), `tests/test_streaming_unattended.py`'s (the
service lists and stops live trigger loops) and `tests/test_udf_worker.py`'s
(`UDF_ERROR` with the worker's traceback, a DELETE in the middle of a
UDF, concurrent UDF queries under lockwatch).

The port's pooled sessions run on the CPU device. Each case makes the
JAX test's assertions on each package and holds what the two observed
equal (results, statuses, error codes, HTTP codes). Under the port's
lockwatch every observed nesting must also be an edge of the port's
static lock graph, and the stress must observe the service's session
lease nesting above the engine's locks.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pandas as pd
import pytest

from torch_service_parity import PORT, REF, both, check_golden, same_table

from spark_tpu_torch.analysis.concurrency import lockorder as port_lockorder
from spark_tpu_torch.tpch import sql_queries as SQLQ
from spark_tpu_torch.tpch.datagen import write_parquet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_KEY = "spark_tpu.service.port"
HEARTBEAT_KEY = "spark_tpu.sql.status.heartbeatMs"
FR_DIR_KEY = "spark_tpu.sql.flightRecorder.dir"
EVENT_KEY = "spark_tpu.sql.eventLog.dir"
SLO_KEY = "spark_tpu.service.slo.latencyMs"
MODE_KEY = "spark_tpu.sql.udf.mode"
BATCH_KEY = "spark_tpu.sql.udf.arrow.maxRecordsPerBatch"


@pytest.fixture(scope="module")
def tpch_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tpch_torch_svc_conc") / "sf")
    write_parquet(path, 0.002)
    return path


def _uninstall_arbiters():
    for P in (PORT, REF):
        P.arbiter.install_arbiter(None)


def _static_graph():
    static, _ = port_lockorder.build_graph(REPO)
    return set(static)


# ---------------------------------------------------------------------------
# the arbiter install race
# ---------------------------------------------------------------------------


def test_service_arbiter_install_race_installs_exactly_once():
    def case(P):
        conf = P.Conf()
        conf.set("spark_tpu.service.hbmBudget", 1 << 30)
        svc = P.service(conf)
        try:
            barrier = threading.Barrier(8)

            def racer():
                barrier.wait()
                svc._ensure_arbiter()

            ts = [threading.Thread(target=racer) for _ in range(8)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(10)
            assert P.arbiter.get_arbiter() is svc.arbiter
            assert svc._installed_arbiter
        finally:
            svc.stop()
        return P.arbiter.get_arbiter() is None  # stop() uninstalled it

    assert both(case) == (True, True)


# ---------------------------------------------------------------------------
# the lockwatch stress across pooled sessions
# ---------------------------------------------------------------------------


def test_service_stress_under_lockwatch(tpch_path, tmp_path):
    """Three sessions x two Q1 runs on the live service -- chunked scans
    with prefetch workers, arbiter leases, admission queueing, event-log
    writes, /metrics and /queries scraped meanwhile -- under lockwatch:
    every result at golden parity, the observed acquisition order
    consistent with the registry ranks, the service's session lease
    observed nesting above other locks, and no prefetch daemon
    outliving its query."""
    def case(P):
        sessions = ["s1", "s2", "s3"]
        conf = P.Conf()
        for key, value in (
                (PORT_KEY, 0), ("spark_tpu.service.maxConcurrent", 2),
                ("spark_tpu.service.queueDepth", 8),
                ("spark_tpu.service.queueTimeoutMs", 120000),
                ("spark_tpu.service.hbmBudget", 1 << 30),
                ("spark_tpu.sql.execution.streamingChunkRows", 4096),
                ("spark_tpu.sql.io.deviceCacheBytes", 0),
                ("spark_tpu.sql.ingest.prefetch", True),
                (EVENT_KEY, str(tmp_path / P.name / "events"))):
            conf.set(key, value)
        svc = P.service(conf, lambda s: P.register_tables(s, tpch_path))
        svc.start()
        watch = P.lockwatch.LockWatch()
        try:
            for name in sessions:  # warm the pool, then watch it
                svc.submit(SQLQ.Q1, session=name)
            watch.install_service(svc)
            results, errors = [], []
            stop_scrape = threading.Event()

            def run_queries(name):
                try:
                    for _ in range(2):
                        record, table = svc.submit(SQLQ.Q1, session=name)
                        results.append(table)
                except Exception as e:  # noqa: BLE001 — surfaced below
                    errors.append((name, repr(e)))

            def scrape():
                while not stop_scrape.is_set():
                    text = urllib.request.urlopen(
                        f"http://127.0.0.1:{svc.port}/metrics",
                        timeout=30).read().decode()
                    P.parse_prometheus(text)
                    urllib.request.urlopen(
                        f"http://127.0.0.1:{svc.port}/queries",
                        timeout=30).read()
                    time.sleep(0.02)

            scraper = threading.Thread(target=scrape, daemon=True)
            scraper.start()
            threads = [threading.Thread(target=run_queries, args=(n,))
                       for n in sessions]
            for t in threads:
                t.start()
            for t in threads:
                t.join(300)
            stop_scrape.set()
            scraper.join(30)
            assert not any(t.is_alive() for t in threads), "query wedged"
            assert errors == [], errors
            assert len(results) == 6
            for table in results:
                check_golden("q1", table, tpch_path)
            edges = watch.edges()
            assert edges, "no lock nesting observed"
            assert any(a == "service.session" for a, _ in edges), edges
            watch.assert_order_consistent()
            snap = svc.metrics.snapshot()["counters"]
            assert any(k.startswith("ingest_") for k in snap), snap
            watch.assert_no_thread_leak()
            assert watch.report()["locks"]
            return results[0], set(edges)
        finally:
            watch.uninstall()
            svc.stop()
            P.arbiter.install_arbiter(None)

    (ptable, pedges), (rtable, _) = both(case)
    same_table(ptable, rtable)
    # every nesting the port showed is one its static graph predicts
    assert pedges <= _static_graph(), pedges - _static_graph()


# ---------------------------------------------------------------------------
# the status store under a live service
# ---------------------------------------------------------------------------


def test_status_under_concurrent_service(tpch_path, tmp_path):
    def case(P):
        sessions = ["s1", "s2", "s3"]
        conf = P.Conf()
        conf.set(PORT_KEY, 0)
        conf.set("spark_tpu.service.hbmBudget", 1 << 30)
        conf.set(HEARTBEAT_KEY, 25)
        conf.set(FR_DIR_KEY, str(tmp_path / P.name / "fr"))
        svc = P.service(conf, lambda s: P.register_tables(s, tpch_path))
        svc.start()
        watch = P.lockwatch.LockWatch()
        scrapes = []
        try:
            for name in sessions:
                svc.submit(SQLQ.Q1, session=name)
            watch.install_service(svc)
            results, errors = [], []
            stop_scrape = threading.Event()

            def run_queries(name):
                try:
                    for _ in range(2):
                        results.append(svc.submit(SQLQ.Q1,
                                                  session=name)[1])
                except Exception as e:  # noqa: BLE001 — surfaced below
                    errors.append((name, repr(e)))

            def scrape():
                while not stop_scrape.is_set():
                    st = json.load(urllib.request.urlopen(
                        f"http://127.0.0.1:{svc.port}/status", timeout=30))
                    ts = json.load(urllib.request.urlopen(
                        f"http://127.0.0.1:{svc.port}/status/timeseries"
                        f"?limit=5", timeout=30))
                    scrapes.append((st, ts))
                    threading.Event().wait(0.02)

            scraper = threading.Thread(target=scrape, daemon=True)
            scraper.start()
            threads = [threading.Thread(target=run_queries, args=(n,))
                       for n in sessions]
            [t.start() for t in threads]
            [t.join(300) for t in threads]
            stop_scrape.set()
            scraper.join(30)
            assert not any(t.is_alive() for t in threads), "query wedged"
            assert errors == [], errors
            assert len(results) == 6
            st = svc.status_store.snapshot()
            assert st["queries_total"] >= 9  # 3 warm + 6 concurrent
            assert st["statuses"].get("ok", 0) >= 9
            assert st["queries_inflight_total"] == 0
            assert set(sessions) <= set(st["sessions"])
            lat = st["latency"]["e2e_ms"]
            assert lat["count"] >= 9 and lat["p50"] <= lat["p95"]
            providers = sorted(st["providers"])
            for prov in ("admission", "quota", "arbiter", "pool", "udf"):
                assert prov in st["providers"], st["providers"]
            assert scrapes, "scraper never ran"
            for st_s, ts_s in scrapes:
                assert st_s["enabled"] is True
                for pts in ts_s["series"].values():
                    assert len(pts) <= 5
            ts_all = svc.status_store.timeseries()
            assert ts_all["heartbeats"] >= 1
            for pts in ts_all["series"].values():
                assert len(pts) <= ts_all["ring_capacity"]
            db = json.load(urllib.request.urlopen(
                f"http://127.0.0.1:{svc.port}/debug/bundle", timeout=60))
            assert len(db["bundles"]) >= len(sessions)
            for entry in db["bundles"]:
                manifest = json.load(open(os.path.join(
                    entry["path"], "MANIFEST.json")))
                assert manifest["reason"] == "on_demand"
            watch.assert_order_consistent()
            edges = set(watch.edges())
        finally:
            watch.uninstall()
            svc.stop()
            P.arbiter.install_arbiter(None)
        P.lockwatch.LockWatch().assert_no_thread_leak(
            prefix="spark-tpu-status-heartbeat", timeout_s=5.0)
        return (results[0], st["queries_total"], st["statuses"],
                sorted(st["sessions"]), providers,
                sorted(e["session"] for e in db["bundles"]), edges)

    port, ref = both(case)
    same_table(port[0], ref[0])
    assert port[1:6] == ref[1:6]
    assert port[6] <= _static_graph(), port[6] - _static_graph()


def test_status_timeseries_bad_limit_is_400(tpch_path):
    def case(P):
        conf = P.Conf()
        conf.set(PORT_KEY, 0)
        svc = P.service(conf, lambda s: P.register_tables(s, tpch_path))
        svc.start()
        try:
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{svc.port}/status/timeseries"
                    f"?limit=bogus", timeout=30)
            return ei.value.code, json.load(ei.value)["error"]
        finally:
            svc.stop()
            P.arbiter.install_arbiter(None)

    assert both(case) == ((400, "BAD_REQUEST"), (400, "BAD_REQUEST"))


def test_slo_burn_counters_follow_the_service_key(tmp_path):
    """The SLO target burns at query end when set (a 1 ms target and a
    fresh aggregate) and stays idle by default, in both packages: the
    port reads the key since the service registered it."""
    def case(P):
        s = P.session(register_active=False)
        F = P.F
        m = s.metrics
        s.conf.set(EVENT_KEY, str(tmp_path / P.name / "ev"))

        def agg(n):
            return (s.range(n).group_by((F.col("id") % 7).alias("k"))
                    .agg(F.sum(F.col("id")).alias("s")))

        agg(773773).to_pandas()  # no target: burn counters idle
        idle = m.counter("slo_queries_total").value
        s.conf.set(SLO_KEY, 1)
        agg(772772).to_pandas()
        s.conf.set(SLO_KEY, 0)
        return (idle, m.counter("slo_queries_total").value,
                m.counter("slo_burned_total").value,
                m.counter("slo_burn_ms_total").value >= 1,
                m.histogram("status_latency_ms").snapshot()["count"])

    port, ref = both(case)
    assert port == ref
    assert port[:4] == (0, 1, 1, True)


# ---------------------------------------------------------------------------
# live streams under the service
# ---------------------------------------------------------------------------


def test_service_lists_and_stops_live_streams(tmp_path):
    """GET /queries folds live trigger loops in under `streams`; DELETE
    /queries/stream-<n> stops the loop bounded (no orphan thread) and a
    second DELETE is a structured 404."""
    def case(P):
        svc = P.service(P.Conf())
        s = P.session(register_active=False)
        schema = pd.DataFrame({"k": pd.Series([], dtype=np.int64),
                               "v": pd.Series([], dtype=np.int64)})
        src = P.streaming.MemoryStream(s, schema)
        q = (src.to_df().filter(P.F.col("v") >= 0)
             .write_stream(str(tmp_path / P.name / "ck"),
                           output_mode="append"))
        q.start(trigger_ms=20)
        try:
            live_id = q._live_id
            rows = [r for r in svc.query_listing()["streams"]
                    if r["id"] == live_id]
            assert rows and rows[0]["status"] == "RUNNING"
            status, body = svc.cancel_query(live_id)
            assert status == 200
            assert P.streaming.get_live(live_id) is None
            assert all(r["id"] != live_id
                       for r in svc.query_listing()["streams"])
            status2, body2 = svc.cancel_query(live_id)
            P.lockwatch.LockWatch().assert_no_thread_leak(
                "spark-tpu-stream-trigger")
        finally:
            q.stop()
            svc.stop()
        return (rows[0]["status"], rows[0]["source"], rows[0]["trigger_ms"],
                status, body["status"], body["query_status"], status2,
                body2["error"])

    port, ref = both(case)
    assert port == ref == ("RUNNING", "memory", 20.0, 200, "stopped",
                           "STOPPED", 404, "NOT_FOUND")


# ---------------------------------------------------------------------------
# Python UDFs through the service
# ---------------------------------------------------------------------------


def _udf_service(P, **conf_overrides):
    """A started service whose sessions hold a small table and three
    UDFs. The UDFs are closures (cloudpickle ships them by value)."""
    def init(s):
        s.register_table("svc_t", pd.DataFrame({
            "x": np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]),
            "i": np.array([1, 2, 3, 4, 5, 6], dtype=np.int64)}))
        s.udf.register("twice", lambda v: v * 2.0, "double")

        def svc_boom(v):
            raise RuntimeError("svc udf exploded")

        s.udf.register("svc_boom", svc_boom, "double")

        def svc_slow(v):
            import time as _time
            _time.sleep(0.5)
            return v

        s.udf.register("svc_slow", svc_slow, "double")

    conf = P.Conf()
    conf.set(PORT_KEY, 0)
    for k, v in conf_overrides.items():
        conf.set(k, v)
    return P.service(conf, init).start()


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/sql", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _http(port, method, path):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 method=method)
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _poll_terminal(svc, rid, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        rec = svc.query_snapshot(rid)
        if rec and rec.get("status") not in ("submitted", "running"):
            return rec
        time.sleep(0.02)
    raise AssertionError(f"query {rid} never finished: "
                         f"{svc.query_snapshot(rid)}")


def test_service_udf_error_structured_400():
    def case(P):
        svc = _udf_service(P)
        try:
            status, body = _post(svc.port, {
                "sql": "select svc_boom(x) as y from svc_t",
                "conf": {MODE_KEY: "worker"}})
            assert status == 400 and body["error"] == "UDF_ERROR"
            assert "svc udf exploded" in body["message"]
            assert "svc_boom" in body.get("traceback", "")
            astatus, abody = _post(svc.port, {
                "sql": "select svc_boom(x) as y from svc_t",
                "mode": "async", "conf": {MODE_KEY: "worker"}})
            assert astatus == 202
            rec = _poll_terminal(svc, abody["query_id"])
            assert rec["status"] == "error"
            assert rec["error"]["error"] == "UDF_ERROR"
            assert "svc udf exploded" in rec["error"]["message"]
            assert "svc_boom" in rec["error"].get("traceback", "")
        finally:
            svc.stop()
            P.arbiter.install_arbiter(None)
        return status, body["error"], astatus, rec["status"], \
            rec["error"]["error"]

    port, ref = both(case)
    assert port == ref


def test_service_delete_mid_udf_no_surviving_children():
    def case(P):
        svc = _udf_service(P)
        port = svc.port
        try:
            status, body = _post(port, {
                "sql": "select svc_slow(x) as y from svc_t",
                "mode": "async", "conf": {MODE_KEY: "worker",
                                          BATCH_KEY: 1}})
            assert status == 202
            rid = body["query_id"]
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                if svc.query_snapshot(rid).get("status") == "running":
                    break
                time.sleep(0.01)
            time.sleep(0.3)  # into the per-batch worker loop
            code, resp = _http(port, "DELETE", f"/queries/{rid}")
            assert code == 200 and resp["status"] == "cancel_requested"
            rec = _poll_terminal(svc, rid, timeout_s=20)
            assert rec["status"] == "cancelled", rec
            assert rec["error"]["error"] == "QUERY_CANCELLED"
            sessions = [e.session for e in svc.pool._entries.values()]
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                if all(p.poll() is not None for s in sessions
                       for p in s._udf_pool.child_procs()):
                    break
                time.sleep(0.05)
            leaked = [p.pid for s in sessions
                      for p in s._udf_pool.child_procs() if p.poll() is None]
            assert not leaked, f"workers survived the cancel: {leaked}"
            assert svc.arbiter.stats()["leased_bytes"] == 0
            status2, body2 = _post(port, {
                "sql": "select svc_slow(x) as y from svc_t",
                "conf": {MODE_KEY: "worker", BATCH_KEY: 1}})
            assert status2 == 200
        finally:
            svc.stop()
            P.arbiter.install_arbiter(None)
        return (code, rec["status"], rec["error"]["error"], status2,
                [r["y"] for r in body2["rows"]])

    port, ref = both(case)
    assert port == ref
    assert port[-1] == [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]


def test_service_concurrent_udf_queries_lockwatch():
    def case(P):
        svc = _udf_service(P, **{"spark_tpu.service.maxConcurrent": 4})
        port = svc.port
        watch = P.lockwatch.LockWatch()
        watch.install_service(svc)
        try:
            results = [None] * 6

            def run(ix):
                results[ix] = _post(port, {
                    "sql": "select twice(x) as y, i from svc_t",
                    "session": f"s{ix % 2}",
                    "conf": {MODE_KEY: "worker", BATCH_KEY: 2}})

            # the two sessions appear on first use: warm them, then
            # install again so their pool cvs are wrapped too
            run(0), run(1)
            watch.install_service(svc)
            threads = [threading.Thread(target=run, args=(i,))
                       for i in range(2, 6)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            for st, body in results:
                assert st == 200, body
                assert [r["y"] for r in body["rows"]] == \
                    [2.0, 4.0, 6.0, 8.0, 10.0, 12.0]
            watch.assert_order_consistent()
            watch.assert_no_thread_leak()
        finally:
            watch.uninstall()
            svc.stop()
            P.arbiter.install_arbiter(None)
        assert any("udf.pool" in k for k in watch.lock_stats), \
            watch.report()
        return [body["rows"] for _, body in results], set(watch.edges())

    port, ref = both(case)
    assert port[0] == ref[0]
    assert port[1] <= _static_graph(), port[1] - _static_graph()
