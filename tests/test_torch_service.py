"""The SQL service of the port (`spark_tpu_torch/service/`) against the
JAX package's (`spark_tpu/service/`): every case of
`tests/test_service.py`, each run through both packages
(`tests/torch_service_parity.py`). The port's service runs its pooled
sessions on the CPU device, the JAX package's on its CPU backend, both
over TPC-H SF 0.01.

Each case makes the JAX test's assertions on each package and holds
what the two observed equal: Arrow results (ints, decimals and strings
exactly, floats within rtol 1e-12), records' statuses, error codes and
row counts, HTTP status codes, and the names of the `service_*`,
`arbiter_*`, `result_cache_*` and `session_quota_*` counters.

The JAX test of the compiled-stage cache shared across sessions becomes
a port case: the port compiles no stages, so it holds equal results
across sessions, device-cache hits across sessions and no rebuild of
the kernel library instead.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from torch_service_parity import (PORT, REF, both, check_golden, same_rows,
                                  same_table, service_counters)

from spark_tpu_torch.tpch import sql_queries as SQLQ
from spark_tpu_torch.tpch.datagen import write_parquet

SF = 0.01
CHUNK_KEY = "spark_tpu.sql.execution.streamingChunkRows"
HBM_KEY = "spark_tpu.service.hbmBudget"
PORT_KEY = "spark_tpu.service.port"
MAXC_KEY = "spark_tpu.service.maxConcurrent"
DEPTH_KEY = "spark_tpu.service.queueDepth"
QT_KEY = "spark_tpu.service.queueTimeoutMs"
CACHE_BYTES_KEY = "spark_tpu.sql.io.deviceCacheBytes"
COUNT_SQL = "select count(*) as n from lineitem"


@pytest.fixture(scope="module")
def tpch_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tpch_torch_service") / "sf")
    write_parquet(path, SF)
    return path


@pytest.fixture()
def service(tpch_path):
    """make(P, **conf): a fresh service of package P (ephemeral port,
    TPC-H tables on every pooled session), stopped at teardown with both
    packages' arbiters uninstalled."""
    made = []

    def make(P, **conf_overrides):
        conf = P.Conf()
        conf.set(PORT_KEY, 0)
        for k, v in conf_overrides.items():
            conf.set(k, v)
        svc = P.service(conf, lambda s: P.register_tables(s, tpch_path))
        made.append(svc)
        return svc

    yield make
    for svc in made:
        svc.stop()
    for P in (PORT, REF):
        P.arbiter.install_arbiter(None)


def _post_sql(port, payload, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/sql",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.load(resp)


def _get_json(port, path, timeout=30):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=timeout) as resp:
        return resp.status, json.load(resp)


# ---------------------------------------------------------------------------
# Admission controller (unit)
# ---------------------------------------------------------------------------


def test_admission_rejects_at_queue_depth():
    def case(P):
        ctl = P.admission.AdmissionController(
            max_concurrent=1, queue_depth=1, queue_timeout_ms=0)
        ctl.acquire("a")  # takes the only slot
        release_b = threading.Event()
        queued = threading.Event()
        got_slot = []

        def queued_query():
            queued.set()
            with ctl.slot("b"):
                got_slot.append("b")
                release_b.wait(5)

        t = threading.Thread(target=queued_query, daemon=True)
        t.start()
        queued.wait(5)
        for _ in range(100):  # until b is parked in the queue
            if ctl.stats()["queued"] == 1:
                break
            time.sleep(0.01)
        assert ctl.stats()["queued"] == 1
        with pytest.raises(P.admission.AdmissionRejected) as exc:
            ctl.acquire("c")
        err = exc.value.to_dict()
        assert err["error"] == "ADMISSION_REJECTED"
        ctl.release()  # a frees -> b runs
        release_b.set()
        t.join(5)
        return err, got_slot, ctl.stats()

    port, ref = both(case)
    assert port == ref
    assert port[1] == ["b"]
    assert port[2] == {"running": 0, "queued": 0, "max_concurrent": 1,
                       "queue_depth": 1}


def test_admission_queue_timeout():
    def case(P):
        ctl = P.admission.AdmissionController(
            max_concurrent=1, queue_depth=4, queue_timeout_ms=30)
        ctl.acquire("a")
        with pytest.raises(P.admission.AdmissionTimeout) as exc:
            ctl.acquire("b")
        err = exc.value.to_dict()
        ctl.release()
        ctl.acquire("c")  # the slot is free again
        ctl.release()
        return err["error"], exc.value.http_status, ctl.stats()

    port, ref = both(case)
    assert port == ref and port[0] == "ADMISSION_TIMEOUT" and port[1] == 503


# ---------------------------------------------------------------------------
# Arbiter (unit)
# ---------------------------------------------------------------------------


def test_arbiter_lease_grant_deny_release():
    def case(P):
        arb = P.arbiter.DeviceResourceArbiter(1000)
        a, b = P.arbiter._Owner("a"), P.arbiter._Owner("b")
        seen = [arb.try_acquire(a, "scan1", 600),
                arb.try_acquire(a, "scan1", 600),  # idempotent per key
                arb.leased_bytes,
                arb.try_acquire(b, "scan2", 600)]  # pool exhausted
        arb.release(a)
        seen.append(arb.try_acquire(b, "scan2", 600))  # denial memoized
        arb.release(b)  # clears the memo
        seen.append(arb.try_acquire(b, "scan2", 600))
        arb.release(b)
        seen.append(arb.leased_bytes)
        return seen

    port, ref = both(case)
    assert port == ref == [True, True, 600, False, False, True, 0]


def test_arbiter_evicts_storage_under_lease_pressure():
    """Lease pressure evicts the device table cache (the storage pool)
    before denying execution memory."""
    import numpy as np

    def case(P):
        CACHE = P.device_cache.CACHE
        CACHE.clear()
        s = P.session(register_active=False)
        s.conf.set(CACHE_BYTES_KEY, 1 << 30)
        df = s.create_dataframe({"x": np.arange(4096, dtype=np.int64)},
                                name="arb_evict_t")
        df.collect()
        cached = CACHE.nbytes
        assert cached > 0
        arb = P.arbiter.DeviceResourceArbiter(cached + 100)
        owner = P.arbiter._Owner("q")
        # the pool is nearly full of storage: the lease only fits after
        # eviction
        granted = arb.try_acquire(owner, "s", cached + 50)
        shrank = CACHE.nbytes < cached
        arb.release(owner)
        return granted, shrank, arb.leased_bytes

    port, ref = both(case)
    assert port == ref == (True, True, 0)


def test_result_cache_lru_bound():
    import pyarrow as pa

    def case(P):
        rc = P.arbiter.ResultCache(max_bytes=1)  # every insert evicts
        t = pa.table({"a": list(range(1000))})
        rc["fp1"] = t
        seen = ["fp1" in rc, len(rc)]  # over the bound: rejected
        rc2 = P.arbiter.ResultCache(max_bytes=t.nbytes * 2 + 100)
        rc2["fp1"] = t
        rc2["fp2"] = t
        seen += ["fp1" in rc2, "fp2" in rc2]
        rc2["fp3"] = t  # past the bound: the LRU entry (fp1) goes
        seen += ["fp1" in rc2, rc2.get("fp3") is t, rc2.pop("fp3") is t,
                 "fp3" in rc2]
        return seen

    port, ref = both(case)
    assert port == ref == [False, 0, True, True, False, True, True, False]


# ---------------------------------------------------------------------------
# Concurrency: two sessions, conflicting overlays, golden parity
# ---------------------------------------------------------------------------


def test_concurrent_sessions_conflicting_conf_parity(service, tpch_path):
    """Two pooled sessions with conflicting overlays run Q1 and Q3
    concurrently, three times each, over one arbiter pool and one
    metrics registry: both hold golden parity and keep their own
    conf."""
    def case(P):
        svc = service(P, **{HBM_KEY: 8 << 30})
        svc.start()  # installs the shared arbiter pool
        a_conf = {CHUNK_KEY: 2048, "spark_tpu.sql.caseSensitive": "false"}
        b_conf = {"spark_tpu.sql.aggregate.estimatedGroups": 1 << 10,
                  "spark_tpu.sql.caseSensitive": "true"}
        errors, results = [], {}

        def run(name, sql, sess, conf, rounds=3):
            try:
                for _ in range(rounds):
                    record, table = svc.submit(sql, session=sess, conf=conf)
                    assert record["status"] == "ok"
                results[name] = table
            except Exception as e:  # noqa: BLE001 — surfaced via errors
                errors.append((name, e))

        t1 = threading.Thread(target=run,
                              args=("q1", SQLQ.Q1, "sess_a", a_conf))
        t3 = threading.Thread(target=run,
                              args=("q3", SQLQ.Q3, "sess_b", b_conf))
        t1.start(); t3.start()
        t1.join(300); t3.join(300)
        assert not errors, errors
        check_golden("q1", results["q1"], tpch_path)
        check_golden("q3", results["q3"], tpch_path)
        sessions = svc.pool.sessions()
        a, b = sessions["sess_a"], sessions["sess_b"]
        assert int(a.conf.get(CHUNK_KEY)) == 2048
        assert int(b.conf.get(
            "spark_tpu.sql.aggregate.estimatedGroups")) == 1 << 10
        assert bool(b.conf.get("spark_tpu.sql.caseSensitive")) is True
        assert bool(a.conf.get("spark_tpu.sql.caseSensitive")) is False
        # one result cache and one registry shared; every lease drained
        assert a._data_cache is b._data_cache is svc.arbiter.result_cache
        assert a.metrics is b.metrics is svc.metrics
        assert P.arbiter.get_arbiter() is svc.arbiter
        assert svc.arbiter.leased_bytes == 0
        return results, service_counters(svc)

    (pres, pcount), (rres, rcount) = both(case)
    same_table(pres["q1"], rres["q1"])
    same_table(pres["q3"], rres["q3"])
    assert pcount == rcount


def test_shared_compile_cache_hit_across_sessions(service, tpch_path):
    """The JAX package's second session hits the sessions-shared
    compiled-stage cache. The port has no stage cache (it runs eagerly):
    its second session gives the same result, hits the process's device
    table cache the first session filled, and builds no kernel library
    again."""
    from spark_tpu_torch.execution import dense_groupby

    def port_case(P):
        P.device_cache.CACHE.clear()
        svc = service(P)
        assert not hasattr(svc.arbiter, "stage_cache")
        builds = []
        real_build = dense_groupby.build
        dense_groupby.build = lambda *a, **k: (builds.append(1),
                                               real_build(*a, **k))[1]
        lib = dense_groupby._lib
        try:
            _, t_a = svc.submit(SQLQ.Q1, session="alpha")
            hits = P.device_cache.CACHE.hits
            _, t_b = svc.submit(SQLQ.Q1, session="beta")
            assert P.device_cache.CACHE.hits > hits
        finally:
            dense_groupby.build = real_build
        assert builds == [] and dense_groupby._lib is lib
        sessions = svc.pool.sessions()
        assert not hasattr(sessions["alpha"], "_stage_cache")
        return t_a, t_b

    def ref_case(P):
        svc = service(P)
        _, t_a = svc.submit(SQLQ.Q1, session="alpha")
        hits_before = svc.metrics.counter("compile_cache_hits").value
        _, t_b = svc.submit(SQLQ.Q1, session="beta")
        assert svc.metrics.counter("compile_cache_hits").value > hits_before
        return t_a, t_b

    pa_, pb = port_case(PORT)
    ra, rb = ref_case(REF)
    assert pa_.equals(pb)
    check_golden("q1", pb, tpch_path)
    same_table(pb, rb)
    same_table(pa_, ra)


def test_arbiter_lease_exhaustion_degrades_not_crashes(service, tpch_path):
    """A starved pool routes Q1 down the streaming path: parity holds,
    `arbiter_lease_denied` counts, nothing fails and the pool drains to
    zero leases."""
    def case(P):
        P.device_cache.CACHE.clear()  # cold: a cached scan takes no lease
        svc = service(P, **{HBM_KEY: 4096})  # nothing fits resident
        svc.start()
        assert P.arbiter.get_arbiter() is svc.arbiter
        record, table = svc.submit(SQLQ.Q1, session="starved")
        assert record["status"] == "ok"
        check_golden("q1", table, tpch_path)
        assert svc.metrics.counter("arbiter_lease_denied").value > 0
        assert svc.arbiter.leased_bytes == 0
        return table, record["row_count"], service_counters(svc)

    port, ref = both(case)
    same_table(port[0], ref[0])
    assert port[1:] == ref[1:]


def test_arbiter_large_pool_grants_and_releases(service, tpch_path):
    def case(P):
        P.device_cache.CACHE.clear()
        svc = service(P, **{HBM_KEY: 8 << 30})
        svc.start()
        record, table = svc.submit(SQLQ.Q1, session="roomy")
        assert record["status"] == "ok"
        check_golden("q1", table, tpch_path)
        assert svc.metrics.counter("arbiter_lease_granted").value > 0
        assert svc.arbiter.leased_bytes == 0
        return table, service_counters(svc)

    port, ref = both(case)
    same_table(port[0], ref[0])
    assert port[1] == ref[1]


def test_arbiter_credits_warm_cached_scan(service, tpch_path):
    """A scan already in the device table cache is admitted as storage:
    a second lease would count it twice and evict the table the query
    reuses."""
    def case(P):
        CACHE = P.device_cache.CACHE
        CACHE.clear()
        svc = service(P, **{HBM_KEY: 64 << 20})
        svc.start()
        svc.submit(SQLQ.Q1, session="warm")  # cold: leases, fills cache
        assert CACHE.nbytes > 0
        denied0 = svc.metrics.counter("arbiter_lease_denied").value
        hits0 = CACHE.hits
        record, table = svc.submit(SQLQ.Q1, session="warm")
        assert record["status"] == "ok"
        assert CACHE.hits > hits0
        assert svc.metrics.counter("arbiter_lease_denied").value == denied0
        check_golden("q1", table, tpch_path)
        return table, service_counters(svc)

    port, ref = both(case)
    same_table(port[0], ref[0])
    assert port[1] == ref[1]


# ---------------------------------------------------------------------------
# HTTP endpoints
# ---------------------------------------------------------------------------


def test_http_sql_roundtrip_parity_and_status(service, tpch_path):
    import pandas as pd

    def case(P):
        svc = service(P).start()
        port = svc.port
        status, resp = _post_sql(port, {"sql": SQLQ.Q1})
        assert status == 200 and resp["status"] == "ok"
        check_golden("q1", pd.DataFrame(resp["rows"],
                                        columns=resp["columns"]), tpch_path)
        rstatus, rec = _get_json(port, f"/queries/{resp['query_id']}")
        assert rstatus == 200 and rec["status"] == "ok"
        assert rec["engine_query_id"] >= 1
        assert rec["phase_times_s"]  # on_query_end fed the record
        assert any(e["action"] == "admitted" for e in rec["events"])
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=30) as m:
            parsed = P.parse_prometheus(m.read().decode())
        assert parsed["spark_tpu_service_queries_submitted"] >= 1
        assert parsed["spark_tpu_queries_total"] >= 1
        hstatus, h = _get_json(port, "/healthz")
        assert hstatus == 200 and h["status"] == "ok" and h["sessions"] >= 1
        return (status, resp["columns"], resp["rows"], resp["row_count"],
                rstatus, rec["status"], [e["action"] for e in rec["events"]],
                hstatus, service_counters(svc))

    port, ref = both(case)
    same_rows(port[2], ref[2])
    assert port[:2] + port[3:] == ref[:2] + ref[3:]


def test_http_arrow_format(service, tpch_path):
    import pyarrow as pa

    def case(P):
        svc = service(P).start()
        req = urllib.request.Request(
            f"http://127.0.0.1:{svc.port}/sql",
            data=json.dumps({"sql": SQLQ.Q1, "format": "arrow"}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200
            ctype = resp.headers["Content-Type"]
            qid = resp.headers["X-Query-Id"]
            table = pa.ipc.open_stream(resp.read()).read_all()
        assert qid.startswith("q-")
        check_golden("q1", table, tpch_path)
        return table, ctype, qid

    port, ref = both(case)
    same_table(port[0], ref[0])
    assert port[1:] == ref[1:] == ("application/vnd.apache.arrow.stream",
                                   "q-1")


def test_http_bad_request_and_sql_error(service):
    def case(P):
        svc = service(P).start()
        port = svc.port
        seen = []
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/sql", data=b"not json",
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=30)
        seen.append((exc.value.code, json.load(exc.value)["error"]))
        for sql in ("select nope from missing_table", "SELEKT 1"):
            with pytest.raises(urllib.error.HTTPError) as exc:
                _post_sql(port, {"sql": sql})
            seen.append((exc.value.code, json.load(exc.value)["error"]))
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get_json(port, "/queries/q-99999")
        seen.append((exc.value.code, json.load(exc.value)["error"]))
        return seen

    port, ref = both(case)
    assert port == ref == [(400, "BAD_REQUEST"), (400, "INVALID_SQL"),
                           (400, "INVALID_SQL"), (404, "NOT_FOUND")]


def test_http_admission_rejection_structured(service):
    """maxConcurrent 1, queueDepth 0: with the only slot held, an HTTP
    submission gets a structured 429, a rejected ServiceEvent and the
    counter; the service works again once the slot frees."""
    def case(P):
        svc = service(P, **{MAXC_KEY: 1, DEPTH_KEY: 0, QT_KEY: 100}).start()
        port = svc.port
        events = []

        class Sub(P.Listener):
            def on_service(self, event):
                events.append((event.action, event.query_id))

        svc.bus.register(Sub())
        svc.admission.acquire("holder")
        try:
            with pytest.raises(urllib.error.HTTPError) as exc:
                _post_sql(port, {"sql": COUNT_SQL})
            code = exc.value.code
            body = json.load(exc.value)
            assert body["error"] == "ADMISSION_REJECTED"
            assert body["queue_depth"] == 0
            assert body["query_id"].startswith("q-")
        finally:
            svc.admission.release()
        assert ("rejected", body["query_id"]) in events
        parsed = P.parse_prometheus(svc.metrics_text())
        assert parsed["spark_tpu_service_rejected"] >= 1
        _, rec = _get_json(port, f"/queries/{body['query_id']}")
        assert rec["status"] == "rejected"
        assert rec["error"]["error"] == "ADMISSION_REJECTED"
        status, resp = _post_sql(port, {"sql": COUNT_SQL})
        assert status == 200 and resp["status"] == "ok"
        return (code, body, rec["status"], [a for a, _ in events],
                resp["rows"], service_counters(svc))

    port, ref = both(case)
    assert port == ref


def test_http_query_listing_timeline_and_plan(service, tpch_path):
    """GET /queries lists a finished Q1; /queries/<id>/timeline serves
    its phase spans, stage records and shard rows, /plan the runtime
    tree. A stage record of the port measures device memory through
    `torch.cuda` and on the CPU says why it holds no peak; the JAX
    package's CPU backend gives XLA's peak."""
    def case(P):
        svc = service(P, **{"spark_tpu.sql.observability.xlaCost": "on"})
        svc.start()
        port = svc.port
        _, resp = _post_sql(port, {"sql": SQLQ.Q1})
        qid = resp["query_id"]
        _post_sql(port, {"sql": COUNT_SQL})
        _, listing = _get_json(port, "/queries")
        assert listing["total"] >= 2
        assert listing["queries"][0]["submitted_ts"] >= \
            listing["queries"][-1]["submitted_ts"]  # newest first
        assert any(q["id"] == qid and q["status"] == "ok"
                   for q in listing["queries"])
        _, page = _get_json(port, "/queries?limit=1")
        assert len(page["queries"]) == 1 and page["next_offset"] == 1
        _, page2 = _get_json(port, "/queries?limit=1&offset=1")
        assert page2["queries"][0]["id"] != page["queries"][0]["id"]
        _, only_ok = _get_json(port, "/queries?status=ok&session=default")
        assert only_ok["total"] >= 2
        _, tl = _get_json(port, f"/queries/{qid}/timeline")
        assert tl["engine_query_id"] >= 1
        assert any(s["name"] == "dispatch" for s in tl["spans"]), tl["spans"]
        assert tl["stages"]
        if P is PORT:
            assert all(s.get("memory_error") for s in tl["stages"]), tl
        else:
            assert any(s.get("peak_hbm_bytes") for s in tl["stages"]), tl
        assert isinstance(tl["shards"], list)
        assert tl["phase_times_s"].get("execution") is not None
        _, pl = _get_json(port, f"/queries/{qid}/plan")
        assert "HashAggregateExec" in pl["physical"], pl
        assert "rows out" in pl["physical"]
        assert pl["sql"].lstrip().lower().startswith("select")
        codes = []
        for suffix in ("timeline", "plan"):
            with pytest.raises(urllib.error.HTTPError) as exc:
                _get_json(port, f"/queries/q-99999/{suffix}")
            codes.append(exc.value.code)
        return ([(q["id"], q["status"], q["row_count"])
                 for q in listing["queries"]], page2["queries"][0]["id"],
                only_ok["total"], tl["shards"], pl["sql"], pl["reorder"],
                codes)

    port, ref = both(case)
    assert port == ref


def test_history_store_bounded():
    def case(P):
        store = P.history_store.QueryHistoryStore(max_entries=2)
        for i in range(4):
            store.put(f"q-{i}", {"engine_query_id": i})
        return len(store), store.get("q-0"), store.get("q-3")

    port, ref = both(case)
    assert port == ref == (2, None, {"engine_query_id": 3})


def test_concurrent_queries_scrape_and_rotation(service, tmp_path):
    """Pooled sessions run queries in parallel while /metrics is scraped
    and the event log rotates (a 512-byte bound): every scrape parses and
    the rotated log replays with no corrupt line."""
    import os

    def case(P):
        ev_dir = str(tmp_path / P.name / "ev")
        svc = service(P, **{
            "spark_tpu.sql.eventLog.dir": ev_dir,
            "spark_tpu.sql.eventLog.maxBytes": 512,
            "spark_tpu.sql.metrics.sink": "prometheus",
            "spark_tpu.sql.metrics.dir": str(tmp_path / P.name / "m"),
        }).start()
        port = svc.port
        n_sessions, n_rounds = 3, 3
        errors, rows = [], []
        done = threading.Event()

        def run(sess):
            try:
                for _ in range(n_rounds):
                    record, table = svc.submit(COUNT_SQL, session=sess)
                    assert record["status"] == "ok"
                    rows.append(table.to_pylist())
            except Exception as e:  # noqa: BLE001 — surfaced via errors
                errors.append((sess, e))

        def scrape():
            try:
                while not done.is_set():
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{port}/metrics",
                            timeout=30) as m:
                        assert isinstance(
                            P.parse_prometheus(m.read().decode()), dict)
                    time.sleep(0.01)
            except Exception as e:  # noqa: BLE001
                errors.append(("scrape", e))

        threads = [threading.Thread(target=run, args=(f"s{i}",))
                   for i in range(n_sessions)]
        scraper = threading.Thread(target=scrape)
        scraper.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        done.set()
        scraper.join(60)
        assert not errors, errors
        assert len(os.listdir(ev_dir)) > n_sessions  # the log rolled
        events = P.history.read_event_log(ev_dir)
        assert len(events) == n_sessions * n_rounds
        assert (events["status"] == "ok").all()
        assert (events["schema_version"] == 7).all()
        return rows, len(events)

    import importlib.util
    import os as _os
    root = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "events_tool", _os.path.join(root, "scripts", "events_tool.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    port, ref = both(case)
    assert port == ref
    for P in (PORT, REF):
        assert tool.validate([str(tmp_path / P.name / "ev")]) == []


def test_http_async_submission(service):
    def case(P):
        svc = service(P).start()
        status, resp = _post_sql(svc.port, {"sql": SQLQ.Q1,
                                            "mode": "async"})
        assert status == 202
        qid = resp["query_id"]
        for _ in range(600):
            _, rec = _get_json(svc.port, f"/queries/{qid}")
            if rec["status"] in ("ok", "error"):
                break
            time.sleep(0.1)
        assert rec["status"] == "ok" and rec["row_count"] >= 1
        # the 202 body reads the record as the worker thread left it
        assert resp["status"] in ("submitted", "running", "ok")
        return status, rec["status"], rec["row_count"]

    port, ref = both(case)
    assert port == ref


def test_session_pool_bound(service):
    def case(P):
        svc = service(P, **{"spark_tpu.service.maxSessions": 1})
        record, _ = svc.submit("select l_orderkey from lineitem limit 1",
                               session="only")
        with pytest.raises(P.pool.PoolExhausted) as exc:
            svc.submit("select l_orderkey from lineitem limit 1",
                       session="another")
        return (record["status"], exc.value.to_dict()["error"],
                service_counters(svc))

    port, ref = both(case)
    assert port == ref


def test_active_session_contextvar_isolated(service):
    """Pooled sessions never replace the active session of the thread
    that submits (the one the builder returns)."""
    def case(P):
        before = P.Session._active
        svc = service(P)
        record, _ = svc.submit(COUNT_SQL)
        assert P.Session._active is before
        return record["status"]

    port, ref = both(case)
    assert port == ref == "ok"


def test_session_busy_sheds_with_structured_timeout(service):
    """A request for a session already running a query sheds with a
    structured 503 after queueTimeoutMs and burns no execution slot:
    other sessions keep running."""
    def case(P):
        svc = service(P, **{QT_KEY: 150})
        entry = svc.pool.get_or_create("busy")
        entry.lock.acquire()  # stand-in for a long-running query
        try:
            with pytest.raises(P.admission.AdmissionTimeout) as exc:
                svc.submit(COUNT_SQL, session="busy")
            body = exc.value.to_dict()
            assert body["session"] == "busy"
            record, table = svc.submit(COUNT_SQL, session="idle")
            assert record["status"] == "ok"
        finally:
            entry.lock.release()
        return body["error"], exc.value.http_status, table.to_pylist()

    port, ref = both(case)
    assert port == ref


def test_async_submissions_bounded(service):
    """An async burst past maxConcurrent + queueDepth is rejected at the
    front door (429-shaped) instead of spawning unbounded threads."""
    def case(P):
        svc = service(P, **{MAXC_KEY: 1, DEPTH_KEY: 0, QT_KEY: 100})
        svc.admission.acquire("holder")  # pin the only slot
        entry = svc.pool.get_or_create("default")
        entry.lock.acquire()  # park the first worker at its lease
        try:
            first = svc.submit_async(COUNT_SQL)  # occupies the bound
            with pytest.raises(P.admission.AdmissionRejected) as exc:
                svc.submit_async(COUNT_SQL)
            body = exc.value.to_dict()
            assert body["error"] == "ADMISSION_REJECTED"
            assert body["bound"] == 1
        finally:
            svc.admission.release()  # slot first, lease second
            entry.lock.release()
        for _ in range(200):
            if first["status"] in ("ok", "error", "queue_timeout"):
                break
            time.sleep(0.05)
        assert first["status"] in ("ok", "queue_timeout")
        return body["error"], body["bound"], body["in_flight"]

    port, ref = both(case)
    assert port == ref


def test_pinned_cache_entries_survive_lease_pressure():
    """evict_bytes skips entries pinned by running queries: their memory
    would not be freed (the query's reference keeps it live)."""
    def case(P):
        cache = P.device_cache.DeviceTableCache()
        cache.put(("pinned",), P.batch(1000), budget=1 << 20)
        cache.put(("loose",), P.batch(500), budget=1 << 20)
        seen = [cache.pin(("pinned",)), cache.evict_bytes(10_000),
                cache.contains(("pinned",))]
        cache.unpin(("pinned",))
        seen += [cache.evict_bytes(10_000), cache.pin(("missing",))]
        return seen

    port, ref = both(case)
    assert port == ref == [True, 500, True, 1000, False]


def test_put_eviction_skips_pinned_entries():
    """put's budget eviction honours pins as evict_bytes does."""
    def case(P):
        cache = P.device_cache.DeviceTableCache()
        cache.put(("pinned",), P.batch(1000), budget=2000)
        seen = [cache.pin(("pinned",))]
        cache.put(("loose",), P.batch(800), budget=2000)
        cache.put(("new",), P.batch(900), budget=2000)
        seen += [cache.contains(k) for k in
                 (("pinned",), ("loose",), ("new",))]
        seen.append(cache.pin(("new",)))
        cache.put(("last",), P.batch(1000), budget=2000)
        seen += [cache.contains(("last",)), cache.contains(("new",))]
        cache.unpin(("pinned",))
        cache.unpin(("new",))
        cache.evict_bytes(1 << 30)
        return seen

    port, ref = both(case)
    assert port == ref == [True, True, False, True, True, True, True]


def test_lease_kept_when_cache_put_rejected():
    """convert_lease_to_pin keeps the lease when the entry never landed
    in the device cache: dropping it would credit phantom headroom."""
    def case(P):
        CACHE = P.device_cache.CACHE
        arb = P.arbiter.DeviceResourceArbiter(10_000)
        owner = P.arbiter._Owner("q")
        key = ("svc-test-lease-kept",)
        seen = [arb.try_acquire(owner, key, 4000)]
        arb.convert_lease_to_pin(owner, key)  # not cached: kept
        seen.append(arb.leased_bytes)
        CACHE.put(key, P.batch(100), budget=1 << 20)
        try:
            arb.convert_lease_to_pin(owner, key)
            seen.append(arb.leased_bytes)
        finally:
            arb.release(owner)  # unpins
            CACHE.evict_bytes(200)
        return seen

    port, ref = both(case)
    assert port == ref == [True, 4000, 0]


def test_prefer_resident_takes_no_lease_for_streaming_scan():
    """_prefer_resident runs its cheap disqualifiers before consulting
    the arbiter: a scan that streams anyway (an uncacheable source)
    holds no estimate-sized lease to query end."""
    def case(P):
        class _Src:
            def cache_token(self):
                return None  # uncacheable: the scan streams

            def estimated_rows(self):
                return 1_000_000

        class _Field:
            dtype = P.T.IntegerType()
            nullable = False

        class _Schema:
            fields = [_Field()]

        class _Leaf:
            source = _Src()
            required_columns = None
            pushed_filters = ()

            def schema(self):
                return _Schema()

        arb = P.arbiter.DeviceResourceArbiter(1 << 30)
        P.arbiter.install_arbiter(arb)
        try:
            conf = P.Conf()
            conf.set(CACHE_BYTES_KEY, 1 << 30)
            token = P.arbiter.enter_query("stream-test")
            try:
                verdict = P.prefer_resident(_Leaf(), conf)
                leased = arb.leased_bytes
            finally:
                P.arbiter.exit_query(token)
        finally:
            P.arbiter.install_arbiter(None)
        return verdict, leased

    port, ref = both(case)
    assert port == ref == (False, 0)


def test_standalone_session_result_cache_unbounded():
    """A standalone session keeps an unbounded result cache unless
    resultCacheBytes is set explicitly."""
    def case(P):
        plain = P.session(register_active=False)
        conf = P.Conf()
        conf.set(P.arbiter.RESULT_CACHE_BYTES_KEY, 1234)
        bounded = P.session(register_active=False, conf=conf)
        return plain._data_cache.max_bytes, bounded._data_cache.max_bytes

    port, ref = both(case)
    assert port == ref == (0, 1234)
