"""The port's crash-only serving fleet (`spark_tpu_torch/service/fleet.py`)
against the JAX package's (`spark_tpu/service/fleet.py`): the routing,
metrics and kill-9 cells of `tests/test_fleet.py` and its two unit
cases, on a 2-worker fleet of real worker processes on the CPU device
over TPC-H SF 0.002 (`tests/torch_fleet_parity.py`), plus parity cases:
the ring places every session on the JAX package's worker list, the
read classifier, the exposition merge and the router's structured
error bodies give the JAX package's outputs, and every routed result
equals the JAX package's in-process `session.sql` on the same Parquet
(Arrow: ints, decimals and strings exactly, floats within rtol 1e-12).

The kill-9 cells pass here, though the JAX package's fail in every run:
the port has no compiled-stage cache for a respawned worker to read a
mismatched executable from. The chaos cells (streaming trigger,
flap breaker, drain) and the SqlService lifecycle cases are in
`tests/test_torch_fleet_chaos.py`.
"""

import json
import os
import signal
import threading

import pandas as pd
import pytest

import torch_fleet_parity as FP
from torch_service_parity import same_table

import spark_tpu.service.fleet as ref_fleet
from spark_tpu.config import Conf as RefConf
from spark_tpu.observability.metrics import \
    parse_prometheus_text as ref_parse

import spark_tpu_torch.service.fleet as port_fleet
from spark_tpu_torch.config import Conf
from spark_tpu_torch.observability.metrics import parse_prometheus_text
from spark_tpu_torch.tpch import golden as G
from spark_tpu_torch.tpch import sql_queries as SQLQ
from spark_tpu_torch.tpch.datagen import write_parquet


@pytest.fixture(scope="module")
def tpch_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tpch_torch_fleet") / "sf_small")
    write_parquet(path, FP.SF)
    return path


@pytest.fixture(scope="module")
def init_dir(tmp_path_factory, tpch_path):
    d = tmp_path_factory.mktemp("fleet_torch_init")
    report = FP.write_init_modules(d, tpch_path)
    with FP.on_pythonpath(d):
        yield report


@pytest.fixture(scope="module")
def ref_q1(tpch_path):
    """The JAX package's Q1 on the same Parquet, in process."""
    return FP.ref_sql(tpch_path, SQLQ.Q1)


@pytest.fixture(scope="module")
def fleet(tmp_path_factory, init_dir):
    """One 2-worker fleet shared by the routing/failover cells; each
    kill cell restores full strength before finishing, and teardown
    asserts zero orphans + zero leaked fleet threads."""
    conf = FP.fleet_conf(tmp_path_factory, 2, "fleet_torch_tpch_init:init")
    sup = FP.start_fleet(conf)
    assert sup.wait_ready(180), sup.fleet_health()
    yield sup
    FP.stop_clean(sup)


def _check_q1_golden(resp, tpch_path):
    got = pd.DataFrame(resp["rows"], columns=resp["columns"])
    want = G.GOLDEN["q1"](tpch_path).reset_index(drop=True)
    G.compare(G.normalize_decimals(got)[list(want.columns)]
              .reset_index(drop=True), want)


# -- routing + parity -------------------------------------------------------


def test_router_parity_and_introspection(fleet, tpch_path, ref_q1):
    st, hdrs, resp = FP.post_sql(fleet.port, SQLQ.Q1, session="alpha")
    assert st == 200 and resp["status"] == "ok", resp
    # session affinity: the router picked the session's ring-home
    assert int(hdrs["X-Fleet-Worker"]) == fleet._route("alpha")[0]
    _check_q1_golden(resp, tpch_path)
    # the same query in Arrow equals the JAX package's, in process
    st, ahdrs, table = FP.post_arrow(fleet.port, SQLQ.Q1, session="alpha")
    assert st == 200 and ahdrs["X-Fleet-Worker"] == hdrs["X-Fleet-Worker"]
    same_table(table, ref_q1)
    # same session routes to the same worker; the generation-prefixed
    # id routes GET /queries/<id> back to the owner without a table
    qid = resp["query_id"]
    assert qid.startswith(f"q-w{hdrs['X-Fleet-Worker']}g")
    st, hdrs2, rec = FP.req(fleet.port, "GET", f"/queries/{qid}")
    assert st == 200 and rec["status"] == "ok"
    assert hdrs2["X-Fleet-Worker"] == hdrs["X-Fleet-Worker"]
    # merged listing sees it; fleet health + metrics agree
    st, _, listing = FP.req(fleet.port, "GET", "/queries")
    assert st == 200 and any(q["id"] == qid for q in listing["queries"])
    st, _, health = FP.req(fleet.port, "GET", "/healthz")
    assert st == 200 and health["workers_ready"] == 2
    prom = parse_prometheus_text(FP.metrics_text(fleet.port))
    assert prom.get("spark_tpu_fleet_requests_proxied", 0) >= 1
    # a stale generation 503s structurally instead of 404-ing
    st, _, err = FP.req(fleet.port, "GET", "/queries/q-w0g999-1")
    assert st == 503 and err["error"] == "WORKER_LOST"


def test_metrics_fanout_merges_worker_series(fleet):
    """GET /metrics on the router merges the supervisor's fleet_*
    counters with every live worker's metrics, each worker's series
    tagged worker="<idx>" — one scrape covers the whole fleet and stays
    valid exposition (parseable, one # TYPE line per family)."""
    st, hdrs, resp = FP.post_sql(fleet.port, "SHOW TABLES",
                                 session="metrics-fanout")
    assert st == 200, resp
    widx = hdrs["X-Fleet-Worker"]
    text = FP.metrics_text(fleet.port)
    prom = parse_prometheus_text(text)  # merged doc parses cleanly
    assert ref_parse(text) == prom  # and reads the same to the JAX parser
    # supervisor's own series stay unlabeled...
    assert prom.get("spark_tpu_fleet_requests_proxied", 0) >= 1
    # ...and the worker that served the query shows up labeled
    assert prom.get(
        f'spark_tpu_service_admitted{{worker="{widx}"}}', 0) >= 1
    # TYPE lines dedup across sources: one per family name
    families = [ln.split()[2] for ln in text.splitlines()
                if ln.startswith("# TYPE ")]
    assert len(families) == len(set(families)), families


def test_sync_kill9_failover_parity_and_rehome(fleet, tpch_path, ref_q1):
    """Sync cell: kill -9 the session's home worker mid-query. The
    idempotent read retries ONCE on the re-homed worker with golden
    parity (and the JAX package's bytes), and the session's DURABLE
    catalog state (a CTAS table in the shared warehouse dir) survives
    the crash — the re-homed worker reads the same bytes the dead worker
    wrote."""
    home = fleet._route("alpha")[0]
    pid = fleet._workers[home].snapshot()["pid"]
    st, _, resp = FP.post_sql(
        fleet.port,
        "CREATE TABLE fleet_scratch AS "
        "SELECT l_orderkey FROM lineitem LIMIT 1", session="alpha")
    assert st == 200, resp
    st, _, before = FP.post_sql(
        fleet.port, "SELECT l_orderkey FROM fleet_scratch",
        session="alpha")
    assert st == 200, before

    results = []

    def run():
        results.append(FP.post_sql(
            fleet.port, SQLQ.Q1, session="alpha",
            conf={FP.INJECT_KEY: "stage_run:slow:1:2500"}))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    # kill once the query is observably in flight on the worker
    FP.wait(lambda: any(
        q.get("status") == "running" and q.get("session") == "alpha"
        for q in FP.req(fleet.port, "GET", "/queries")[2].get(
            "queries", [])), 30, "query in flight")
    os.kill(pid, signal.SIGKILL)
    t.join(120)
    assert not t.is_alive() and results, "query thread wedged"
    st, hdrs, resp = results[0]
    assert st == 200 and resp["status"] == "ok", resp
    assert hdrs.get("X-Fleet-Failover") == "1"
    assert int(hdrs["X-Fleet-Worker"]) != home
    _check_q1_golden(resp, tpch_path)
    # the failed-over worker gives the JAX package's bytes too
    st, _, table = FP.post_arrow(fleet.port, SQLQ.Q1, session="alpha")
    assert st == 200
    same_table(table, ref_q1)
    # durable state re-homed with the session: the new worker serves
    # the table the dead worker created, byte-for-byte
    st, _, after = FP.post_sql(
        fleet.port, "SELECT l_orderkey FROM fleet_scratch",
        session="alpha")
    assert st == 200 and after["rows"] == before["rows"], after
    # fleet back at full strength; the killed pid was reaped
    assert fleet.wait_ready(180), fleet.fleet_health()
    FP.assert_pid_dead(pid)
    assert fleet._workers[home].snapshot()["generation"] >= 2
    # the respawned home serves the session again, with the same bytes
    st, hdrs, table = FP.post_arrow(fleet.port, SQLQ.Q1, session="alpha")
    assert st == 200 and int(hdrs["X-Fleet-Worker"]) == home
    same_table(table, ref_q1)
    st, _, _ = FP.post_sql(fleet.port, "DROP TABLE fleet_scratch",
                           session="alpha")
    assert st == 200


def test_async_kill9_worker_lost_structured(fleet):
    """Async cell: the submitted query's record dies with its worker.
    GET/DELETE on its id answer 503 WORKER_LOST (broken worker first,
    stale generation after the respawn) — never a 404, never a hang."""
    session = "beta"
    st, hdrs, resp = FP.post_sql(
        fleet.port, SQLQ.Q1, session=session, mode="async",
        conf={FP.INJECT_KEY: "stage_run:slow:1:3000"})
    assert st == 202, resp
    qid = resp["query_id"]
    owner = int(hdrs["X-Fleet-Worker"])
    pid = fleet._workers[owner].snapshot()["pid"]
    FP.wait(lambda: FP.running_on_fleet(fleet.port, qid), 30,
            "async query running")
    os.kill(pid, signal.SIGKILL)
    st, _, err = FP.req(fleet.port, "GET", f"/queries/{qid}")
    assert st == 503 and err["error"] == "WORKER_LOST", err
    assert err["query_id"] == qid and err["worker"] == owner
    st, _, err = FP.req(fleet.port, "DELETE", f"/queries/{qid}")
    assert st == 503 and err["error"] == "WORKER_LOST", err
    # after the respawn the generation moved on: still WORKER_LOST
    assert fleet.wait_ready(180), fleet.fleet_health()
    st, _, err = FP.req(fleet.port, "GET", f"/queries/{qid}")
    assert st == 503 and err["error"] == "WORKER_LOST", err
    FP.assert_pid_dead(pid)


def test_workers_import_neither_jax_nor_the_jax_package(fleet, init_dir):
    """Every worker process the fleet started (respawns included) ran
    the port's worker module and loaded no JAX module and no module of
    the JAX package."""
    # one query homed on each worker, so that each ran the init
    homes = {}
    for i in range(200):
        homes.setdefault(fleet._route(f"s{i}")[0], f"s{i}")
    for session in homes.values():
        st, _, _ = FP.post_sql(fleet.port, "SHOW TABLES", session=session)
        assert st == 200
    for w in fleet._workers:
        args = w.snapshot()["proc"].args
        assert args[1:] == ["-m", "spark_tpu_torch.service.fleet",
                            "--worker"], args
    reports = [f for f in os.listdir(init_dir)
               if f.startswith("modules-")]
    assert len(reports) >= 2, reports
    for f in reports:
        with open(os.path.join(init_dir, f)) as fh:
            assert json.load(fh) == [], f


# -- parity units: ring, classifier, exposition, error bodies ----------------


@pytest.mark.parametrize("workers", [1, 2, 3, 5])
def test_route_matches_reference_ring(workers):
    """The md5 ring with 64 virtual nodes a worker places every session
    name on the JAX package's preference-ordered worker list."""
    port_conf, ref_conf = FP.router_confs(workers)
    p = port_fleet.FleetSupervisor(port_conf)
    r = ref_fleet.FleetSupervisor(ref_conf)
    names = ["alpha", "beta", "gamma", "delta", "default", "",
             "metrics-fanout"] + [f"s{i}" for i in range(200)]
    homes = set()
    for name in names:
        assert p._route(name) == r._route(name), name
        assert sorted(p._route(name)) == list(range(workers))
        homes.add(p._route(name)[0])
    assert homes == set(range(workers))
    assert p._ring == r._ring


def test_merge_prometheus_labels_and_dedups():
    sup = "# TYPE spark_tpu_fleet_x counter\nspark_tpu_fleet_x 2\n"
    w0 = ("# TYPE spark_tpu_service_admitted counter\n"
          "spark_tpu_service_admitted 3\n"
          "# TYPE spark_tpu_h histogram\n"
          'spark_tpu_h_bucket{le="1"} 1\n')
    w1 = ("# TYPE spark_tpu_service_admitted counter\n"
          "spark_tpu_service_admitted 5\n")
    texts = [(None, sup), ("0", w0), ("1", w1)]
    text = port_fleet._merge_prometheus(texts)
    assert text == ref_fleet._merge_prometheus(texts)
    prom = parse_prometheus_text(text)
    assert prom["spark_tpu_fleet_x"] == 2
    # same family from two workers: one TYPE line, two labeled series
    assert prom['spark_tpu_service_admitted{worker="0"}'] == 3
    assert prom['spark_tpu_service_admitted{worker="1"}'] == 5
    # worker label lands FIRST inside an existing label set
    assert prom['spark_tpu_h_bucket{worker="0",le="1"}'] == 1
    families = [ln.split()[2] for ln in text.splitlines()
                if ln.startswith("# TYPE ")]
    assert len(families) == len(set(families)), families


@pytest.mark.parametrize("line", [
    "spark_tpu_service_admitted 3",
    'spark_tpu_h_bucket{le="1"} 1',
    'spark_tpu_h_bucket{le="+Inf",op="scan"} 7',
    "spark_tpu_x_sum 0.25 1700000000000",
])
def test_label_sample_matches_reference(line):
    for w in ("0", "12"):
        got = port_fleet._label_sample(line, w)
        assert got == ref_fleet._label_sample(line, w)
        assert f'worker="{w}"' in got


def test_is_read_classifier():
    cases = {
        "SELECT 1 FROM t": True,
        "  -- comment\n  select x from t": True,
        "WITH c AS (SELECT 1 FROM t) SELECT * FROM c": True,
        "SHOW TABLES": True,
        "DESCRIBE t": True,
        "VALUES (1)": True,
        "explain select 1": True,
        "CREATE TABLE t AS SELECT 1 FROM s": False,
        "INSERT INTO t VALUES (1)": False,
        "DROP TABLE t": False,
        "": False,
        "-- only a comment": False,
        None: False,
        "(SELECT 1)": False,
    }
    for sql, want in cases.items():
        assert port_fleet._is_read(sql) is want, sql
        assert ref_fleet._is_read(sql) is want, sql


def test_router_error_bodies_match_reference():
    """Each package's router served alone (no worker behind it) answers
    the same status codes and the same structured bodies: no ready
    worker, an id of no worker, a malformed id, a stale generation, an
    unknown path, a bad body, readiness, and the drain shed."""
    port_conf, ref_conf = FP.router_confs(2)
    calls = [
        ("POST", "/sql", {"sql": "SELECT 1", "session": "a"}),
        ("GET", "/queries/q-w1g3-7", None),
        ("DELETE", "/queries/q-w0g1-2", None),
        ("GET", "/queries/q-w9g1-1", None),
        ("GET", "/queries/bogus-1", None),
        ("GET", "/nowhere", None),
        ("POST", "/nowhere", {}),
        ("POST", "/sql", [1, 2]),
        ("GET", "/healthz/ready", None),
        ("GET", "/healthz/live", None),
        ("GET", "/queries", None),
    ]
    seen = {}
    for pkg, conf in ((port_fleet, port_conf), (ref_fleet, ref_conf)):
        with FP.router_only(pkg, conf) as (sup, port):
            out = [FP.req(port, m, p, b) for m, p, b in calls]
            health = FP.req(port, "GET", "/healthz")
            assert sup.drain(timeout_ms=0) is True
            out.append(FP.post_sql(port, "SELECT 1"))
        seen[pkg.__name__] = (
            [(st, body) for st, _, body in out],
            (health[0], {k: v for k, v in health[2].items()
                         if k != "uptime_s"}))
    port_seen, ref_seen = seen.values()
    assert port_seen == ref_seen
    codes = [st for st, _ in port_seen[0]]
    assert codes == [503, 503, 503, 404, 404, 404, 404, 400, 503, 200,
                     200, 503]
    assert port_seen[0][0][1]["error"] == "FLEET_UNAVAILABLE"
    assert port_seen[0][1][1]["error"] == "WORKER_LOST"
    assert port_seen[0][-1][1]["error"] == "FLEET_DRAINING"
    assert port_fleet.FleetDraining("x").to_dict() == \
        ref_fleet.FleetDraining("x").to_dict()


def test_fleet_keys_read_as_the_reference_does(tmp_path):
    """The ten fleet keys the supervisor reads take the JAX package's
    defaults and values; the worker's conf ships the same explicit
    settings and seat (loopback, ephemeral port, id prefix), and a CPU
    fleet adds no device-memory budget."""
    overrides = {FP.WORKERS_KEY: 3, FP.RESTART_MAX_KEY: 4,
                 FP.RESTART_WINDOW_KEY: 5000, FP.RESTART_BACKOFF_KEY: 10,
                 "spark_tpu.service.fleet.failoverReads": False,
                 FP.HEALTH_INTERVAL_KEY: 50,
                 "spark_tpu.service.fleet.spawnTimeoutMs": 1234,
                 "spark_tpu.service.fleet.proxyTimeoutMs": 4321,
                 FP.FLEET_DIR_KEY: str(tmp_path),
                 FP.INIT_KEY: "m:f"}
    pc, rc = Conf(), RefConf()
    for k, v in overrides.items():
        pc.set(k, v)
        rc.set(k, v)
    p = port_fleet.FleetSupervisor(pc, device="cpu")
    r = ref_fleet.FleetSupervisor(rc)
    for attr in ("_window_s", "_max_per_window", "_backoff_ms",
                 "_drain_timeout_ms", "_failover_reads", "_interval_s",
                 "_spawn_timeout_s", "_proxy_timeout_s", "_fleet_dir"):
        assert getattr(p, attr) == getattr(r, attr), attr
    assert len(p._workers) == len(r._workers) == 3
    assert p._worker_hbm_budget() is None
    assert p._worker_conf(1, 2) == r._worker_conf(1, 2)
    assert p._worker_conf(1, 2)["spark_tpu.service.idPrefix"] == "w1g2-"


def test_fleet_worker_fault_site_rides_the_ladder(tmp_path):
    """The `fleet_worker` seam fires before each spawn attempt: a
    raising rule there is a worker dying at boot, which rides the
    restart ladder into the flap breaker's quarantine. No worker
    process starts in either package; both count, bundle and report the
    same."""
    import spark_tpu.testing.faults as ref_faults
    import spark_tpu_torch.testing.faults as port_faults
    spec = "fleet_worker:fatal:1,fleet_worker:unavailable:2"
    seen = []
    for pkg, faults, C in ((port_fleet, port_faults, Conf),
                           (ref_fleet, ref_faults, RefConf)):
        conf = C()
        for k, v in ((FP.WORKERS_KEY, 1), (FP.RESTART_MAX_KEY, 2),
                     (FP.RESTART_BACKOFF_KEY, 10),
                     (FP.HEALTH_INTERVAL_KEY, 20),
                     (FP.FLEET_DIR_KEY, str(tmp_path / pkg.__name__)),
                     (FP.PORT_KEY, 0)):
            conf.set(k, v)
        with faults.inject(conf, spec) as plan:
            sup = pkg.FleetSupervisor(conf).start()
            try:
                FP.wait(lambda: sup._workers[0].snapshot()["state"]
                        == "quarantined", 30, "quarantine")
                assert sup.worker_pids() == []
                counters = sup.metrics.snapshot()["counters"]
                fired = list(plan.fired_log)
            finally:
                sup.stop()
        bundles = sorted(os.listdir(tmp_path / pkg.__name__ / "bundles"))
        with open(tmp_path / pkg.__name__ / "bundles" / bundles[0]
                  / "stderr.txt") as f:
            said = f.read()
        seen.append((fired, {k: v for k, v in counters.items()
                             if k.startswith("fleet_")},
                     [b.split("-", 2)[2] for b in bundles],
                     said.split(":", 1)[0]))
    assert seen[0] == seen[1]
    fired, counters, reasons, said = seen[0]
    assert [f[2] for f in fired] == ["fatal", "unavailable"]
    assert counters["fleet_worker_lost"] == 2
    assert counters["fleet_quarantined"] == 1
    assert counters.get("fleet_spawns", 0) == 0
    assert reasons == ["0-spawn_failed", "1-spawn_failed"]
    assert said == "spawn failed"
