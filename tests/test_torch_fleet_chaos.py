"""The port's fleet under chaos, and the worker lifecycle of its
`SqlService`, against the JAX package's: the streaming-trigger kill-9,
flap-breaker and drain cells of `tests/test_fleet.py` on real worker
processes on the CPU device (`tests/torch_fleet_parity.py`), and its
`SqlService` lifecycle cases (`/healthz` liveness and readiness,
idempotent and concurrent `stop`, SIGTERM drain with and without an
in-flight query, the structured drain), each run through both
packages' in-process service (`tests/torch_service_parity.py`) with
statuses, error bodies and results held equal.

The port's service has no warm start (it compiles no stages), so it is
ready as soon as it starts. The live-but-not-ready state stays in the
fleet's state machine, for a worker whose start is slow: the port's
case holds a worker there by gating the supervisor's readiness probe.
"""

import json
import os
import signal
import threading
import time

import pytest

import torch_fleet_parity as FP
from torch_service_parity import PORT, REF

import spark_tpu_torch.service.fleet as port_fleet
from spark_tpu_torch.observability.metrics import parse_prometheus_text
from spark_tpu_torch.tpch import sql_queries as SQLQ
from spark_tpu_torch.tpch.datagen import write_parquet


@pytest.fixture(scope="module")
def tpch_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tpch_torch_chaos") / "sf_small")
    write_parquet(path, FP.SF)
    return path


@pytest.fixture(scope="module")
def init_dir(tmp_path_factory, tpch_path):
    d = tmp_path_factory.mktemp("fleet_torch_chaos_init")
    report = FP.write_init_modules(d, tpch_path)
    with FP.on_pythonpath(d):
        yield report


# -- streaming-trigger cell -------------------------------------------------


def test_streaming_trigger_kill9_rehome(tmp_path_factory, init_dir):
    """Streaming cell: a worker with a live supervised trigger loop is
    kill -9'd. The loop is in-memory worker state — it vanishes from
    the merged listing, the fleet sheds structurally while down, and
    the respawned worker's session init starts a FRESH loop."""
    conf = FP.fleet_conf(tmp_path_factory, 1,
                         "fleet_torch_stream_init:init")
    sup = FP.start_fleet(conf)
    try:
        assert sup.wait_ready(180), sup.fleet_health()
        st, _, resp = FP.post_sql(sup.port, "SHOW TABLES",
                                  session="gamma")
        assert st == 200, resp
        FP.wait(lambda: FP.req(sup.port, "GET", "/queries")[2].get(
            "streams"), 30, "live trigger loop in merged listing")
        pid = sup._workers[0].snapshot()["pid"]
        os.kill(pid, signal.SIGKILL)
        # single worker down: structured shed, streams gone
        st, _, err = FP.post_sql(sup.port, "SHOW TABLES", session="gamma")
        assert st == 503, err
        assert err["error"] in ("WORKER_LOST", "FLEET_UNAVAILABLE")
        FP.assert_pid_dead(pid)
        # crash-only recovery: respawn, re-init, fresh loop
        assert sup.wait_ready(180), sup.fleet_health()
        st, _, resp = FP.post_sql(sup.port, "SHOW TABLES",
                                  session="gamma")
        assert st == 200, resp
        FP.wait(lambda: FP.req(sup.port, "GET", "/queries")[2].get(
            "streams"), 30, "respawned trigger loop")
        assert sup._workers[0].snapshot()["generation"] >= 2
    finally:
        FP.stop_clean(sup)


# -- flap breaker -----------------------------------------------------------


def _quarantined(sup, conf, stderr_needle):
    """The breaker's end state: quarantined, 503s, bundles per death."""
    FP.wait(lambda: sup._workers[0].snapshot()["state"] == "quarantined",
            120, "flap-breaker quarantine")
    st, _, err = FP.post_sql(sup.port, "SHOW TABLES")
    assert st == 503 and err["error"] == "FLEET_UNAVAILABLE", err
    st, _, health = FP.req(sup.port, "GET", "/healthz")
    assert st == 503 and health["status"] == "degraded"
    prom = parse_prometheus_text(FP.metrics_text(sup.port))
    assert prom.get("spark_tpu_fleet_worker_lost", 0) >= 2
    assert prom.get("spark_tpu_fleet_quarantined", 0) >= 1
    assert prom.get("spark_tpu_fleet_requests_proxied", 0) == 0
    bundles_dir = os.path.join(str(conf.get(FP.FLEET_DIR_KEY)), "bundles")
    bundles = sorted(os.listdir(bundles_dir))
    assert len(bundles) >= 2, bundles
    with open(os.path.join(bundles_dir, bundles[0],
                           "MANIFEST.json")) as f:
        manifest = json.load(f)
    assert manifest["worker"] == 0 and manifest["reason"]
    with open(os.path.join(bundles_dir, bundles[0], "stderr.txt")) as f:
        assert stderr_needle in f.read()


def test_flap_breaker_quarantine_and_shed(tmp_path_factory, init_dir):
    """A deterministic boot failure (unimportable init module) crashes
    the worker every spawn: after restartMaxPerWindow crashes inside
    the window the breaker QUARANTINES the slot instead of respawn-
    storming, traffic sheds with structured 503s, and every death left
    a flight bundle."""
    conf = FP.fleet_conf(tmp_path_factory, 1,
                         "fleet_no_such_module_xyz:init",
                         **{FP.RESTART_MAX_KEY: 2,
                            FP.RESTART_BACKOFF_KEY: 50})
    sup = FP.start_fleet(conf)
    try:
        _quarantined(sup, conf, "fleet_no_such_module_xyz")
    finally:
        FP.stop_clean(sup)


def test_fleet_without_device_or_cuda_never_serves(tmp_path_factory,
                                                   init_dir, monkeypatch):
    """A fleet given no device runs its workers on the current CUDA
    card; with no CUDA each worker's SqlService raises at boot, the
    crash ladder and the breaker quarantine the slot, and the fleet
    never serves on the CPU. (CUDA_VISIBLE_DEVICES is emptied for the
    workers, so the case holds on a machine with a card too.)"""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    conf = FP.fleet_conf(tmp_path_factory, 1, "fleet_torch_tpch_init:init",
                         **{FP.RESTART_MAX_KEY: 2,
                            FP.RESTART_BACKOFF_KEY: 50})
    sup = FP.start_fleet(conf, device=None)
    try:
        assert sup.device == ""
        _quarantined(sup, conf, "CUDA is not available")
        assert sup._workers[0].info()["state"] == "quarantined"
    finally:
        FP.stop_clean(sup)


# -- drain ------------------------------------------------------------------


def test_drain_finishes_inflight_sheds_new(tmp_path_factory, init_dir,
                                           tpch_path):
    """Drain cell: shutdown() mid-query stops admitting (structured
    FLEET_DRAINING), lets the in-flight query finish with its result
    intact (the JAX package's bytes), SIGTERMs the worker through its
    own drain path (exit 0), and leaves zero orphans and zero fleet
    threads."""
    conf = FP.fleet_conf(tmp_path_factory, 1, "fleet_torch_tpch_init:init")
    sup = FP.start_fleet(conf)
    stopped = False
    try:
        assert sup.wait_ready(180), sup.fleet_health()
        pid = sup._workers[0].snapshot()["pid"]
        proc = sup._workers[0].snapshot()["proc"]
        results, shut = [], []

        def run():
            results.append(FP.post_sql(
                sup.port, SQLQ.Q6, session="delta", fmt="json",
                conf={FP.INJECT_KEY: "stage_run:slow:1:2000"}))

        t = threading.Thread(target=run, daemon=True)
        t.start()
        FP.wait(lambda: any(
            q.get("status") == "running"
            for q in FP.req(sup.port, "GET", "/queries")[2].get(
                "queries", [])), 60, "query in flight")
        ts = threading.Thread(target=lambda: shut.append(sup.shutdown()),
                              daemon=True)
        ts.start()
        # draining: the front door sheds IMMEDIATELY and structurally
        FP.wait(lambda: FP.post_sql(sup.port, "SHOW TABLES",
                                    timeout=10)[2].get("error")
                == "FLEET_DRAINING", 10, "drain shed")
        t.join(120)
        ts.join(120)
        assert not ts.is_alive() and shut == [True], shut
        st, _, resp = results[0]
        # zero dropped in-flight: the query that was running when the
        # drain began completed normally
        assert st == 200 and resp["status"] == "ok", resp
        ref = FP.ref_sql(tpch_path, SQLQ.Q6).to_pylist()
        assert [r["revenue"] for r in resp["rows"]] == pytest.approx(
            [float(r["revenue"]) for r in ref], rel=1e-12)
        FP.assert_pid_dead(pid)
        assert proc.returncode == 0  # the worker's own drain path
        assert sup.wait_for_shutdown(1)
        stopped = True
        from spark_tpu_torch.testing.lockwatch import LockWatch
        LockWatch().assert_no_thread_leak(sup.thread_prefix, timeout_s=15)
    finally:
        if not stopped:
            sup.stop()


# -- readiness ----------------------------------------------------------------


def _gate_readiness(monkeypatch):
    """Hold every fleet worker live-but-not-ready: the supervisor's
    readiness probe answers 503 until the gate opens (the port's
    counterpart of the JAX test's gated warm start, which the port's
    service does not have)."""
    gate = threading.Event()
    probe = port_fleet.FleetSupervisor._probe

    def gated(self, port, path):
        if path == "/healthz/ready" and not gate.is_set():
            return 503
        return probe(self, port, path)

    monkeypatch.setattr(port_fleet.FleetSupervisor, "_probe", gated)
    return gate


def test_healthz_liveness_readiness_split(tmp_path_factory, init_dir,
                                          monkeypatch, tmp_path):
    """The fleet: a live-but-not-ready worker takes no traffic, and the
    router's /healthz/live, /healthz/ready, /healthz and POST /sql say
    so with the JAX package's bodies (its service held in its warm
    start, gated the same way); once ready, both serve. The port's
    service itself is ready at start: its /healthz family answers as
    the JAX service's does once that one's warm start is done."""
    import spark_tpu.execution.compile_cache as ref_cc
    ref_gate = threading.Event()
    monkeypatch.setattr(ref_cc, "warm_start",
                        lambda stage_cache, conf, metrics:
                        ref_gate.wait(10) and 0)
    gate = _gate_readiness(monkeypatch)
    conf = FP.fleet_conf(tmp_path_factory, 1, "fleet_torch_tpch_init:init")
    sup = FP.start_fleet(conf)
    ref_conf = REF.Conf().set(FP.PORT_KEY, 0) \
        .set("spark_tpu.sql.compileCache.enabled", True) \
        .set("spark_tpu.sql.compileCache.dir", str(tmp_path / "cc"))
    ref_svc = REF.service(ref_conf).start()
    port_svc = PORT.service(PORT.Conf().set(FP.PORT_KEY, 0)).start()
    try:
        FP.wait(lambda: sup._workers[0].snapshot()["state"] == "live", 60,
                "worker live (handshake)")
        st, _, live = FP.req(sup.port, "GET", "/healthz/live")
        assert st == 200 and live == {"live": True, "ready": False}
        st, _, ready = FP.req(sup.port, "GET", "/healthz/ready")
        assert st == 503 and ready["error"] == "NOT_READY", ready
        ref_st, _, ref_ready = FP.req(ref_svc.port, "GET", "/healthz/ready")
        assert (ref_st, ref_ready["error"], ref_ready["ready"]) == \
            (503, "NOT_READY", False)
        st, _, health = FP.req(sup.port, "GET", "/healthz")
        assert st == 503 and health["ready"] is False
        st, _, err = FP.post_sql(sup.port, "SHOW TABLES")
        assert st == 503 and err["error"] == "FLEET_UNAVAILABLE", err
        gate.set()
        ref_gate.set()
        assert sup.wait_ready(60), sup.fleet_health()
        FP.wait(lambda: ref_svc.ready, 15, "JAX service ready")
        st, _, resp = FP.post_sql(sup.port, "SHOW TABLES")
        assert st == 200, resp
        answers = []
        for svc in (port_svc, ref_svc):
            answers.append([FP.req(svc.port, "GET", p)[::2]
                            for p in ("/healthz/live", "/healthz/ready")])
        assert answers[0] == answers[1] == [
            (200, {"live": True, "ready": True}), (200, {"ready": True})]
        assert FP.req(port_svc.port, "GET", "/healthz")[2]["ready"] is True
    finally:
        gate.set()
        ref_gate.set()
        port_svc.stop()
        ref_svc.stop()
        FP.stop_clean(sup)


# -- worker lifecycle satellites (in-process SqlService, both packages) ------


def test_stop_idempotent_and_concurrent():
    """Double-stop / stop-racing-shutdown never deadlocks: every caller
    returns inside the bounded joins."""
    for P in (PORT, REF):
        svc = P.service(P.Conf().set(FP.PORT_KEY, 0)).start()
        threads = [threading.Thread(target=svc.stop, daemon=True)
                   for _ in range(2)]
        threads.append(threading.Thread(target=svc.shutdown, daemon=True))
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads), P.name
        svc.stop()  # and once more, after the fact
        assert svc.wait_for_shutdown(1)


def test_stop_racing_start_no_deadlock(monkeypatch):
    """The JAX test stops a service during its warm start. The port's
    service has no warm start, so the race is stop() against start()
    itself. stop() landing while start() is under way waits for the
    whole start and tears it down: no RuntimeError from a heartbeat
    thread not yet started, no socket left serving after stop()
    returned, and a start() after the stop is a no-op. (The JAX
    package's start does not serialize with stop, so this case holds
    the port alone; both packages' plain start-then-stop ends the same,
    the socket closed and the shutdown event set.)"""
    for P in (PORT, REF):
        svc = P.service(P.Conf().set(FP.PORT_KEY, 0)).start()
        svc.stop()
        assert svc.port is None and svc.wait_for_shutdown(1), P.name
    svc = PORT.service(PORT.Conf().set(FP.PORT_KEY, 0))
    in_start, errors = threading.Event(), []
    heartbeat = svc.status_store.start

    def slow_heartbeat_start():
        in_start.set()
        time.sleep(0.3)  # stop() arrives in here
        heartbeat()

    monkeypatch.setattr(svc.status_store, "start", slow_heartbeat_start)

    def run(fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    t0 = time.monotonic()
    starter = threading.Thread(target=run, args=(svc.start,), daemon=True)
    starter.start()
    assert in_start.wait(10)
    stopper = threading.Thread(target=run, args=(svc.stop,), daemon=True)
    stopper.start()
    starter.join(45)
    stopper.join(45)
    assert not starter.is_alive() and not stopper.is_alive()
    assert errors == []
    assert time.monotonic() - t0 < 40
    assert svc.wait_for_shutdown(1)
    assert svc.port is None and svc._serve_thread is None
    assert svc.status_store._thread is None
    assert svc.start() is svc and svc.port is None  # stays stopped
    for _ in range(5):  # and unpatched, whichever thread wins
        svc = PORT.service(PORT.Conf().set(FP.PORT_KEY, 0))
        threads = [threading.Thread(target=run, args=(fn,), daemon=True)
                   for fn in (svc.start, svc.stop)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(45)
        svc.stop()
        assert errors == [] and svc.port is None
        assert svc.wait_for_shutdown(1)


def _sigterm(svc):
    """Install the drain handlers, SIGTERM this process, restore."""
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                              signal.SIGINT)}
    try:
        svc.install_signal_handlers()
        os.kill(os.getpid(), signal.SIGTERM)
        assert svc.wait_for_shutdown(60), "handler never fired"
    finally:
        for s, h in saved.items():
            signal.signal(s, h)


def test_sigterm_runs_drain_path():
    """SIGTERM lands in the installed handler, drains and stops the
    service from a normal thread, and unblocks wait_for_shutdown — what
    a fleet worker does when its supervisor terminates it."""
    errors = []
    for P in (PORT, REF):
        svc = P.service(P.Conf().set(FP.PORT_KEY, 0)).start()
        try:
            _sigterm(svc)
            FP.wait(lambda: svc._stopped, 30, "signal-driven stop")
            with pytest.raises(P.admission.ServiceDraining) as exc:
                svc.submit("SHOW TABLES")
            errors.append((exc.value.http_status, exc.value.to_dict()))
        finally:
            svc.stop()
    assert errors[0] == errors[1]


def test_sigterm_drains_inflight_async_query(tpch_path):
    """Regression: the SIGTERM handler must NOT set the shutdown event
    itself — a worker main parked on wait_for_shutdown() would wake,
    call stop() and exit while an in-flight ASYNC query (which the
    router's in-flight count never sees) was still running. The event
    may only fire once drain+stop completed, with the async query
    finished inside drainTimeoutMs."""
    rows = []
    for P in (PORT, REF):
        conf = P.Conf().set(FP.PORT_KEY, 0).set(FP.DRAIN_TIMEOUT_KEY, 30000)
        svc = P.service(conf, lambda s: P.register_tables(s, tpch_path))
        svc.start()
        try:
            st, _, resp = FP.post_sql(
                svc.port, "select count(*) as n from lineitem",
                mode="async", conf={FP.INJECT_KEY: "stage_run:slow:1:2500"})
            assert st == 202, resp
            rid = resp["query_id"]
            FP.wait(lambda: svc.query_snapshot(rid).get("status")
                    == "running", 60, "async query in flight")
            t0 = time.monotonic()
            _sigterm(svc)
            assert (time.monotonic() - t0) * 1e3 <= 30000
            assert svc._stopped, "event fired before stop() completed"
            rec = svc.query_snapshot(rid)
            assert rec["status"] == "ok", rec
            with svc._async_lock:
                assert svc._async_inflight == 0
            rows.append(rec["row_count"])
        finally:
            svc.stop()
    assert rows[0] == rows[1] == 1


def test_drain_sheds_structured_and_is_idempotent():
    bodies = []
    for P in (PORT, REF):
        svc = P.service(P.Conf().set(FP.PORT_KEY, 0)).start()
        try:
            assert svc.drain(timeout_ms=2000) is True
            assert svc.drain(timeout_ms=2000) is True  # idempotent
            with pytest.raises(P.admission.ServiceDraining) as exc:
                svc.submit("SHOW TABLES")
            err = exc.value.to_dict()
            assert err["error"] == "SERVICE_DRAINING"
            assert exc.value.http_status == 503
            st, _, body = FP.post_sql(svc.port, "SHOW TABLES")
            bodies.append((err, st, body))
        finally:
            svc.stop()
    assert bodies[0] == bodies[1]
    assert bodies[0][1] == 503
