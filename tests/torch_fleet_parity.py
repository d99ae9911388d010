"""Shared harness of the fleet tests (`tests/test_torch_fleet.py`,
`tests/test_torch_fleet_chaos.py`).

The port's fleet runs REAL worker subprocesses (`python -m
spark_tpu_torch.service.fleet --worker`) started by
`FleetSupervisor(conf, device="cpu")`; the supervisor runs in-process so
a test can reach its ring and worker table. Session init ships as a
module in a temporary directory on the workers' PYTHONPATH (a child
cannot inherit a lambda). The TPC-H init module also writes, once per
worker process, the names of any JAX or JAX-package module the worker
has loaded (`modules-<pid>.json` in the report directory): there must be
none.

No JAX fleet is started: the JAX package's kill-9 cases fail on its
compiled-stage cache (a respawned worker deserializes an executable that
does not match its devices). Results are held instead against the JAX
package's in-process `session.sql` on the same Parquet (`ref_sql`), and
the router's structured error bodies against the JAX package's router
served alone, with no worker process behind it (`router_only`).
"""

import contextlib
import json
import os
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

from spark_tpu.config import Conf as RefConf
from spark_tpu.session import SparkTpuSession as RefSession
from spark_tpu.tpch import queries as RQ

import spark_tpu_torch.service.fleet as port_fleet
from spark_tpu_torch.config import Conf
from spark_tpu_torch.testing.lockwatch import LockWatch

SF = 0.002
WORKERS_KEY = "spark_tpu.service.fleet.workers"
RESTART_MAX_KEY = "spark_tpu.service.fleet.restartMaxPerWindow"
RESTART_WINDOW_KEY = "spark_tpu.service.fleet.restartWindowMs"
RESTART_BACKOFF_KEY = "spark_tpu.service.fleet.restartBackoffMs"
DRAIN_TIMEOUT_KEY = "spark_tpu.service.fleet.drainTimeoutMs"
HEALTH_INTERVAL_KEY = "spark_tpu.service.fleet.healthIntervalMs"
FLEET_DIR_KEY = "spark_tpu.service.fleet.dir"
INIT_KEY = "spark_tpu.service.fleet.init"
PORT_KEY = "spark_tpu.service.port"
WAREHOUSE_KEY = "spark_tpu.sql.warehouse.dir"
INJECT_KEY = "spark_tpu.faults.inject"

TPCH_INIT_SRC = """\
import json
import os
import sys
import spark_tpu_torch.tpch.queries as Q
PATH = {path!r}
REPORT = {report!r}
def init(session):
    Q.register_tables(session, PATH)
    bad = sorted(m for m in sys.modules
                 if m in ("jax", "spark_tpu")
                 or m.startswith(("jax.", "spark_tpu.")))
    with open(os.path.join(REPORT, f"modules-{{os.getpid()}}.json"),
              "w") as f:
        json.dump(bad, f)
"""

STREAM_INIT_SRC = """\
import tempfile
import numpy as np
import pandas as pd
from spark_tpu_torch.streaming import MemoryStream
def init(session):
    src = MemoryStream(session, pd.DataFrame(
        {"k": pd.Series([], dtype=np.int64),
         "v": pd.Series([], dtype=np.int64)}))
    ck = tempfile.mkdtemp(prefix="fleet-stream-ck-")
    q = src.to_df().write_stream(ck, output_mode="append")
    q.start(trigger_ms=200)
"""


# -- HTTP helpers -----------------------------------------------------------


def req(port, method, path, body=None, timeout=120):
    """(status, headers, decoded JSON body) of one request."""
    r = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body).encode() if body is not None else None,
        headers={"Content-Type": "application/json"}, method=method)
    try:
        resp = urllib.request.urlopen(r, timeout=timeout)
        return resp.status, dict(resp.headers), json.loads(
            resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read() or b"{}")


def post_sql(port, sql, session="default", conf=None, mode=None,
             timeout=120, fmt=None):
    body = {"sql": sql, "session": session}
    if conf:
        body["conf"] = conf
    if mode:
        body["mode"] = mode
    if fmt:
        body["format"] = fmt
    return req(port, "POST", "/sql", body, timeout=timeout)


def post_arrow(port, sql, session="default", timeout=120):
    """(status, headers, Arrow table) of a `format=arrow` query."""
    import pyarrow as pa
    r = urllib.request.Request(
        f"http://127.0.0.1:{port}/sql",
        data=json.dumps({"sql": sql, "session": session,
                         "format": "arrow"}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    resp = urllib.request.urlopen(r, timeout=timeout)
    return resp.status, dict(resp.headers), \
        pa.ipc.open_stream(resp.read()).read_all()


def metrics_text(port) -> str:
    return urllib.request.urlopen(
        f"http://127.0.0.1:{port}/metrics", timeout=30).read().decode()


def assert_pid_dead(pid, timeout_s=15.0):
    """The crash-only invariant: killed/stopped workers are REAPED — no
    zombie, no orphan."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return
        time.sleep(0.05)
    raise AssertionError(f"worker pid {pid} still alive (orphan)")


def wait(cond, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def running_on_fleet(port, qid):
    st, _, listing = req(port, "GET", "/queries")
    return st == 200 and any(
        q.get("id") == qid and q.get("status") == "running"
        for q in listing.get("queries", []))


# -- fleets -----------------------------------------------------------------


def write_init_modules(d, tpch_path):
    """The init modules, written into directory `d` (a pathlib.Path),
    and the report directory the TPC-H init writes to."""
    report = d / "reports"
    report.mkdir(exist_ok=True)
    (d / "fleet_torch_tpch_init.py").write_text(
        TPCH_INIT_SRC.format(path=tpch_path, report=str(report)))
    (d / "fleet_torch_stream_init.py").write_text(STREAM_INIT_SRC)
    return str(report)


@contextlib.contextmanager
def on_pythonpath(d):
    prev = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = str(d) + (os.pathsep + prev if prev else "")
    try:
        yield str(d)
    finally:
        if prev is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = prev


def fleet_conf(tmp_path_factory, workers, init_spec, **overrides):
    """The JAX test's fleet conf but its compile-cache keys (the port
    leaves the compiled-stage cache out; they raise UnportedConfError)."""
    conf = (Conf()
            .set(PORT_KEY, 0)
            .set(WORKERS_KEY, workers)
            .set(HEALTH_INTERVAL_KEY, 100)
            .set(RESTART_BACKOFF_KEY, 100)
            .set(RESTART_MAX_KEY, 5)
            .set(RESTART_WINDOW_KEY, 60000)
            .set(DRAIN_TIMEOUT_KEY, 30000)
            .set(FLEET_DIR_KEY, str(tmp_path_factory.mktemp("fleet")))
            .set(WAREHOUSE_KEY, str(tmp_path_factory.mktemp("fleet_wh"))))
    if init_spec:
        conf.set(INIT_KEY, init_spec)
    for k, v in overrides.items():
        conf.set(k, v)
    return conf


def start_fleet(conf, device="cpu"):
    return port_fleet.FleetSupervisor(conf, device=device).start()


def stop_clean(sup) -> None:
    """stop(), then the fixture's invariants: every worker pid reaped,
    no `fleet<n>-` thread of this supervisor left."""
    pids = sup.worker_pids()
    prefix = sup.thread_prefix
    sup.stop()
    for pid in pids:
        assert_pid_dead(pid)
    LockWatch().assert_no_thread_leak(prefix, timeout_s=15)


# -- the JAX package's side -------------------------------------------------


def ref_sql(path, sql):
    """The JAX package's in-process result of `sql` over the TPC-H
    Parquet at `path` (Arrow)."""
    s = RefSession(register_active=False)
    s.conf.set("spark_tpu.sql.analysis.enabled", False)
    RQ.register_tables(s, path)
    return s.sql(sql).collect()


@contextlib.contextmanager
def router_only(pkg_fleet, conf):
    """One package's fleet router served alone: a supervisor whose
    workers were never spawned (every slot `stopped`), so every answer
    is the router's own. Yields (supervisor, port)."""
    sup = pkg_fleet.FleetSupervisor(conf)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                pkg_fleet._make_router(sup))
    httpd.daemon_threads = True
    t = threading.Thread(target=httpd.serve_forever, daemon=True,
                         name="fleet-router-only")
    t.start()
    try:
        yield sup, httpd.server_address[1]
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(10)


def router_confs(workers):
    """The same explicit settings as a conf of each package."""
    out = []
    for C in (Conf, RefConf):
        c = C()
        c.set(WORKERS_KEY, workers)
        out.append(c)
    return out
