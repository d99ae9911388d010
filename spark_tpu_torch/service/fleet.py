"""Crash-only serving fleet: supervisor + router over SqlService workers
(the port of `spark_tpu/service/fleet.py`).

One host, N `SqlService` worker SUBPROCESSES, one public port. The
supervisor owns the socket; workers bind ephemeral loopback ports, and
each holds its own CUDA context, caching allocator, device table cache
and arbiter on the fleet's device. The design is crash-only (Candea &
Fox): workers hold NO durable state (query records are in-memory;
results are re-derivable because the engine is deterministic and every
worker reads the same sources), so the recovery path from kill -9 IS
the start path, and the supervisor exercises it routinely instead of
treating it as an exception. A worker is ready as soon as its service
starts: the port compiles no stages, so it has no warm start to replay.

The compiled-stage cache (`spark_tpu/execution/compile_cache.py`) is
left out by choice: the port runs eagerly and compiles no stages; its
one compiled artifact, the kernel library, is kept on disk by mtime and
replaced atomically (`execution/dense_groupby.build` writes it through
a per-pid temporary file and `os.replace`, so workers racing on a stale
library each pay an nvcc run but never load a torn file). The JAX
package's fleet shares serialized executables through that cache, and
its kill-9 cases fail on it: a respawned worker deserializes an
executable that does not match its devices. The port's `compileCache.*`
keys and `execution.bucketGrowth` stay on `config.UNPORTED_KEYS` under
that reason.

The device: `FleetSupervisor(conf, device=None)` ships its device to
every worker beside the conf (env SPARK_TPU_FLEET_DEVICE). A worker
given no device runs on the current CUDA card; without CUDA its
`SqlService` raises, the spawn dies, and the crash ladder and the flap
breaker take it from there -- the fleet never serves on the CPU unless
it is given device="cpu". On a CUDA device, a fleet whose conf leaves
`service.hbmBudget` unset gives each worker the card's free memory at
start (`torch.cuda.mem_get_info`) divided by the worker count as its
budget, since each worker's arbiter would otherwise lease against the
whole card.

Routing -- session affinity by consistent hash:
    Each worker owns `_VNODES` points on an md5 hash ring; a session
    name hashes to a preference-ordered worker list (walk the ring).
    Queries from one session land on one worker (its session-scoped
    catalog state -- CREATE TABLE AS SELECT tables, conf overrides --
    lives there), and when that worker dies the session re-homes to
    the NEXT ring position deterministically, without reshuffling any
    other session's placement. The ring is the JAX package's, point
    for point.

Failover -- reads retry once, everything else surfaces loss:
    A worker that dies mid-request is detected by the broken proxy
    connection. Idempotent reads (SELECT/WITH/VALUES/EXPLAIN/SHOW/
    DESCRIBE, conf fleet.failoverReads) transparently retry ONCE on
    the re-homed worker -- byte parity holds because the engine is
    deterministic and every worker reads the same sources. Writes and
    unclassifiable statements get a structured 503 WORKER_LOST with
    the fleet request id: re-running them is the CLIENT's decision.
    Query ids embed worker index + generation (`q-w0g2-5` via
    spark_tpu.service.idPrefix), so GET/DELETE /queries/<id> routes
    without a lookup table and a stale generation answers 503
    WORKER_LOST -- in-memory records died with the worker, and the
    router says so instead of 404-ing.

Supervision -- RetryPolicy ladder with a flap breaker:
    The health thread (fleet-health) polls child processes, probes
    /healthz/ready (live-but-not-ready workers -- a slow CUDA start --
    take no traffic), and respawns crashes under the shared
    `RetryPolicy` exponential-backoff ladder (fleet.restartBackoffMs).
    K crashes inside fleet.restartWindowMs (fleet.restartMaxPerWindow)
    trips the breaker: the worker is QUARANTINED (no respawn storm
    against a deterministic boot failure) and its traffic sheds with
    the same structured 503 machinery admission control uses. Every
    death dumps a flight bundle (MANIFEST.json + stderr tail) under
    fleet.dir.

Drain -- SIGTERM is a first-class exit:
    `shutdown()` (wired to SIGTERM/SIGINT by the CLI) stops admitting
    (503 FLEET_DRAINING), waits bounded (fleet.drainTimeoutMs) for
    in-flight proxied queries, then SIGTERMs workers -- each runs its
    own SqlService drain path -- and reaps them. kill -9 the
    supervisor and the workers die with it (they are direct children
    watched by pipes).

Worker protocol (stdlib-only, no IPC framework):
    supervisor spawns  python -m spark_tpu_torch.service.fleet --worker
    (a fresh interpreter, never a fork: the supervisor may hold a CUDA
    context) with SPARK_TPU_FLEET_CONF (JSON conf overrides: port=0,
    loopback host, idPrefix=w<idx>g<gen>-), SPARK_TPU_FLEET_IDX and
    SPARK_TPU_FLEET_DEVICE; the worker starts, prints ONE stdout JSON
    handshake line {"spark_tpu_fleet_worker": idx, "port": p, "pid":
    pid}, installs SIGTERM/SIGINT drain handlers, and parks on
    wait_for_shutdown().

Run a fleet:

    python -m spark_tpu_torch.service.fleet --workers 2 --port 8080 \
        --init myapp.serving:init_session [--device cuda:0]
"""

from __future__ import annotations

import bisect
import collections
import hashlib
import http.client
import itertools
import json
import os
import random
import re
import subprocess
import sys
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from ..config import Conf
from ..observability.metrics import MetricsRegistry, prometheus_text
from ..observability.status_store import StatusStore
from .admission import AdmissionError

WORKERS_KEY = "spark_tpu.service.fleet.workers"
RESTART_MAX_KEY = "spark_tpu.service.fleet.restartMaxPerWindow"
RESTART_WINDOW_KEY = "spark_tpu.service.fleet.restartWindowMs"
RESTART_BACKOFF_KEY = "spark_tpu.service.fleet.restartBackoffMs"
DRAIN_TIMEOUT_KEY = "spark_tpu.service.fleet.drainTimeoutMs"
FAILOVER_READS_KEY = "spark_tpu.service.fleet.failoverReads"
HEALTH_INTERVAL_KEY = "spark_tpu.service.fleet.healthIntervalMs"
SPAWN_TIMEOUT_KEY = "spark_tpu.service.fleet.spawnTimeoutMs"
PROXY_TIMEOUT_KEY = "spark_tpu.service.fleet.proxyTimeoutMs"
FLEET_DIR_KEY = "spark_tpu.service.fleet.dir"
INIT_KEY = "spark_tpu.service.fleet.init"
HOST_KEY = "spark_tpu.service.host"
PORT_KEY = "spark_tpu.service.port"
ID_PREFIX_KEY = "spark_tpu.service.idPrefix"
HBM_BUDGET_KEY = "spark_tpu.service.hbmBudget"

ENV_CONF = "SPARK_TPU_FLEET_CONF"
ENV_IDX = "SPARK_TPU_FLEET_IDX"
ENV_DEVICE = "SPARK_TPU_FLEET_DEVICE"

#: virtual nodes per worker on the hash ring — enough that removing
#: one worker re-homes its sessions roughly evenly across survivors
_VNODES = 64

#: monotonically numbers supervisors in one process so their thread
#: names never collide (see FleetSupervisor.thread_prefix)
_SUP_IDS = itertools.count(1)

#: consecutive liveness-ping failures before a ready worker is
#: declared wedged and recycled through the crash ladder
_PING_FAILURE_LIMIT = 3

#: worker query ids are `q-w<idx>g<generation>-<seq>`; the router
#: parses ownership out of the id instead of keeping a lookup table
_QID_RE = re.compile(r"^q-w(\d+)g(\d+)-")

_READ_KEYWORDS = ("SELECT", "WITH", "VALUES", "EXPLAIN", "SHOW",
                  "DESCRIBE")


def _is_read(sql: str) -> bool:
    """True when the statement is an idempotent read — safe to retry
    once on a re-homed worker after the original died mid-query.
    Unknown/unparseable statements classify as NOT reads (failover
    must never replay a write)."""
    s = sql or ""
    while True:
        s = s.lstrip()
        if s.startswith("--"):
            nl = s.find("\n")
            if nl < 0:
                return False
            s = s[nl + 1:]
        else:
            break
    m = re.match(r"[A-Za-z]+", s)
    return bool(m) and m.group(0).upper() in _READ_KEYWORDS


class FleetDraining(AdmissionError):
    """The fleet is draining (SIGTERM / explicit drain()): the router
    sheds new submissions while in-flight proxied queries finish."""

    code = "FLEET_DRAINING"
    http_status = 503


class FleetUnavailable(AdmissionError):
    """No ready worker to route to — every worker is crashed, still
    starting, or quarantined by the flap breaker. Structured 503 like
    the admission shed path: transient, a client retries. (The body's
    message is the JAX package's, word for word.)"""

    code = "FLEET_UNAVAILABLE"
    http_status = 503


class _WorkerLost(Exception):
    """Internal: the proxy connection to a worker broke mid-request
    (the worker died, or its socket did — crash-only treats both as
    death)."""


class _Worker:
    """Supervisor-side record of one worker slot. All mutable fields
    are guarded by the per-instance `_lock` (concurrency registry:
    service.fleet_worker, rank 13) and mutated ONLY through methods
    here; the supervisor reads via `snapshot()`/`info()`.

    States: stopped -> starting -> live -> ready
                         \\-> crashed -> backoff -> starting ...
                                     \\-> quarantined
    """

    def __init__(self, idx: int):
        self.idx = idx
        self._lock = threading.Lock()
        self.state = "stopped"
        self.proc: Optional[subprocess.Popen] = None
        self.port: Optional[int] = None
        self.pid: Optional[int] = None
        #: bumped per spawn; baked into the worker's query-id prefix
        #: (q-w<idx>g<gen>-...) so stale ids route to 503 WORKER_LOST
        self.generation = 0
        #: RetryPolicy ladder for the current crash burst (None until
        #: the first crash; reset when the budget is consumed)
        self.policy = None
        self.next_spawn_ts = 0.0
        self.spawn_deadline_ts = 0.0
        self.ping_failures = 0
        # append-only ring buffers: deque ops are GIL-atomic and these
        # are never rebound after __init__
        self.crash_times: collections.deque = collections.deque(
            maxlen=32)
        self.stderr_tail: collections.deque = collections.deque(
            maxlen=200)

    # -- spawn-side transitions (health thread only) ---------------------

    def begin_spawn(self, deadline_ts: float) -> int:
        with self._lock:
            self.generation += 1
            self.state = "starting"
            self.spawn_deadline_ts = deadline_ts
            self.ping_failures = 0
            self.port = None
            self.pid = None
            return self.generation

    def attach_proc(self, proc: subprocess.Popen) -> None:
        with self._lock:
            self.proc = proc
            self.pid = proc.pid

    def note_handshake(self, gen: int, port: int, pid: int) -> None:
        """Stdout-reader thread: the worker printed its handshake.
        Generation-checked — a stale reader from a previous spawn
        must not resurrect a respawned slot."""
        with self._lock:
            if gen != self.generation or self.state != "starting":
                return
            self.port = port
            self.pid = pid
            self.state = "live"

    def mark_ready(self) -> None:
        with self._lock:
            if self.state == "live":
                self.state = "ready"
                self.ping_failures = 0

    # -- failure-side transitions ----------------------------------------

    def mark_lost(self) -> bool:
        """Router-observed death (broken proxy connection): flip to
        crashed so routing skips the slot immediately; the health
        thread reaps and schedules the respawn."""
        with self._lock:
            if self.state in ("ready", "live"):
                self.state = "crashed"
                return True
            return False

    def note_ping_failure(self) -> int:
        with self._lock:
            self.ping_failures += 1
            return self.ping_failures

    def reset_ping_failures(self) -> None:
        with self._lock:
            if self.ping_failures:
                self.ping_failures = 0

    def take_proc(self) -> Optional[Dict]:
        """Claim the dead/dying process for reaping (health thread).
        Returns None when the slot was already handled — the guard
        that makes a router-marked death and the health tick's own
        poll detection converge on ONE crash accounting."""
        with self._lock:
            if self.state not in ("starting", "live", "ready",
                                  "crashed"):
                return None
            out = {"proc": self.proc, "port": self.port,
                   "pid": self.pid, "generation": self.generation}
            self.proc = None
            self.port = None
            self.state = "crashed"
            return out

    def record_crash(self, now: float, window_s: float,
                     max_per_window: int,
                     backoff_ms: float) -> Optional[float]:
        """Account one crash: flap breaker first (>= max_per_window
        crashes inside window_s -> quarantined, returns None), else
        schedule the respawn under the RetryPolicy exponential-backoff
        ladder and return the delay in ms."""
        from ..execution.failures import RetryPolicy
        with self._lock:
            self.crash_times.append(now)
            recent = sum(1 for t in self.crash_times
                         if now - t <= window_s)
            if recent >= max_per_window:
                self.state = "quarantined"
                self.policy = None
                return None
            if self.policy is None or self.policy.remaining <= 0:
                # no-op sleep: attempt_retry() returns the jittered
                # delay without blocking the health thread; seeded rng
                # keeps chaos tests deterministic
                self.policy = RetryPolicy(
                    max_per_window, backoff_ms,
                    sleep=lambda s: None,
                    rng=random.Random(self.idx * 7919
                                      + self.generation))
            policy = self.policy
        # attempt_retry runs a lifecycle checkpoint (chaos seam) —
        # outside _lock so the fault/lifecycle machinery never nests
        # under the worker lock
        delay_ms = policy.attempt_retry()
        if delay_ms is None:
            delay_ms = float(backoff_ms)
        with self._lock:
            self.state = "backoff"
            self.next_spawn_ts = now + delay_ms / 1e3
        return delay_ms

    def mark_stopped(self) -> Optional[subprocess.Popen]:
        with self._lock:
            proc = self.proc
            self.proc = None
            self.port = None
            self.state = "stopped"
            return proc

    # -- reads ------------------------------------------------------------

    def snapshot(self) -> Dict:
        with self._lock:
            return {"state": self.state, "proc": self.proc,
                    "port": self.port, "pid": self.pid,
                    "generation": self.generation,
                    "next_spawn_ts": self.next_spawn_ts,
                    "spawn_deadline_ts": self.spawn_deadline_ts,
                    "ping_failures": self.ping_failures}

    def info(self) -> Dict:
        """JSON-safe view for /fleet, /healthz and the status store."""
        with self._lock:
            return {"worker": self.idx, "state": self.state,
                    "port": self.port, "pid": self.pid,
                    "generation": self.generation,
                    "restarts": max(0, self.generation - 1),
                    "crashes": len(self.crash_times)}


class FleetSupervisor:
    """Owns the public port, the worker slots, and the health loop.
    `start()` spawns the workers and serves; `shutdown()` is the
    SIGTERM drain path; `stop()` is the fast teardown (tests'
    finally blocks)."""

    def __init__(self, conf: Optional[Conf] = None, device=None):
        self.conf = conf or Conf()
        #: the workers' device as text ("" = the current CUDA card,
        #: resolved in each worker; without CUDA the worker fails)
        self.device = "" if device is None else str(device)
        #: each worker's service.hbmBudget on a CUDA device, set by
        #: start() (None: the conf's own value, shipped as is)
        self._hbm_share: Optional[int] = None
        self.metrics = MetricsRegistry()
        #: per-instance thread-name prefix: lockwatch leak checks (and
        #: humans reading thread dumps) must be able to tell THIS
        #: fleet's threads from another supervisor's in the same
        #: process (tests run several)
        self.thread_prefix = f"fleet{next(_SUP_IDS)}-"
        n = int(self.conf.get(WORKERS_KEY))
        self._workers = [_Worker(i) for i in range(n)]
        #: guards _inflight/_draining/_stopped/_seq (concurrency
        #: registry: service.fleet_inflight, rank 12 — below the
        #: per-worker lock, so cv -> worker._lock nests ascending)
        self._cv = threading.Condition()
        self._inflight = 0
        self._draining = False
        self._stopped = False
        self._seq = 0
        ring: List[Tuple[int, int]] = []
        for idx in range(n):
            for v in range(_VNODES):
                point = int(hashlib.md5(
                    f"w{idx}#{v}".encode()).hexdigest()[:8], 16)
                ring.append((point, idx))
        self._ring = sorted(ring)
        self._ring_points = [p for p, _ in self._ring]
        self._window_s = float(self.conf.get(RESTART_WINDOW_KEY)) / 1e3
        self._max_per_window = int(self.conf.get(RESTART_MAX_KEY))
        self._backoff_ms = float(self.conf.get(RESTART_BACKOFF_KEY))
        self._drain_timeout_ms = float(
            self.conf.get(DRAIN_TIMEOUT_KEY))
        self._failover_reads = bool(self.conf.get(FAILOVER_READS_KEY))
        self._interval_s = float(
            self.conf.get(HEALTH_INTERVAL_KEY)) / 1e3
        self._spawn_timeout_s = float(
            self.conf.get(SPAWN_TIMEOUT_KEY)) / 1e3
        self._proxy_timeout_s = float(
            self.conf.get(PROXY_TIMEOUT_KEY)) / 1e3
        d = str(self.conf.get(FLEET_DIR_KEY) or "")
        self._fleet_dir = d or os.path.join(
            tempfile.gettempdir(), f"spark-tpu-fleet-{os.getpid()}")
        self._bundle_seq = itertools.count()
        self._started_ts = time.time()
        self._health_stop = threading.Event()
        self._shutdown_event = threading.Event()
        self.status_store = StatusStore(self.conf, self.metrics, {
            "fleet": self.stats,
        })
        # lifecycle attrs (guarded-by waiver): written only by the
        # owning control thread in start()/teardown
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._serve_thread: Optional[threading.Thread] = None
        self._health_thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "FleetSupervisor":
        os.makedirs(self._fleet_dir, exist_ok=True)
        self._hbm_share = self._worker_hbm_budget()
        self.status_store.start()
        self._httpd = ThreadingHTTPServer(
            (str(self.conf.get(HOST_KEY)),
             int(self.conf.get(PORT_KEY))),
            _make_router(self))
        self._httpd.daemon_threads = True
        self._serve_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=self.thread_prefix + "http")
        self._serve_thread.start()
        for w in self._workers:
            self._spawn(w)
        self._health_thread = threading.Thread(
            target=self._health_loop, daemon=True,
            name=self.thread_prefix + "health")
        self._health_thread.start()
        return self

    @property
    def port(self) -> Optional[int]:
        return None if self._httpd is None \
            else self._httpd.server_address[1]

    def ready_count(self) -> int:
        return sum(1 for w in self._workers
                   if w.snapshot()["state"] == "ready")

    def wait_ready(self, timeout_s: float = 120.0,
                   n: Optional[int] = None) -> bool:
        """Block until `n` (default: all) workers are ready — the
        test/CLI helper mirroring a k8s readiness gate."""
        want = len(self._workers) if n is None else int(n)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.ready_count() >= want:
                return True
            time.sleep(0.05)
        return self.ready_count() >= want

    def drain(self, timeout_ms: Optional[float] = None) -> bool:
        """Stop admitting (router sheds with 503 FLEET_DRAINING) and
        bounded-wait for in-flight proxied queries — each of which is
        already bounded by its own queryDeadlineMs budget. True when
        the router drained dry inside the budget."""
        with self._cv:
            self._draining = True
        if timeout_ms is None:
            timeout_ms = self._drain_timeout_ms
        deadline = time.monotonic() + float(timeout_ms) / 1e3
        with self._cv:
            while self._inflight > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                # short slices: notify_all in end_request wakes us;
                # the slice only bounds a lost-wakeup worst case
                self._cv.wait(min(0.1, left))
            ok = self._inflight == 0
        if ok:
            self.metrics.counter("fleet_drains").inc()
        return ok

    def shutdown(self) -> bool:
        """The SIGTERM path: drain the router, SIGTERM the workers
        (each runs its own SqlService drain), reap, tear down. True
        when everything exited cleanly inside the budgets."""
        ok = self.drain()
        with self._cv:
            already = self._stopped
            self._stopped = True
        if already:
            return ok
        clean = self._stop_workers(graceful=True)
        self._teardown_http()
        return ok and clean

    def stop(self) -> None:
        """Fast idempotent teardown (tests' finally blocks): no drain
        courtesy — SIGTERM, bounded wait, SIGKILL leftovers, reap."""
        with self._cv:
            already = self._stopped
            self._stopped = True
            self._draining = True
        if already:
            return
        self._stop_workers(graceful=False)
        self._teardown_http()

    def wait_for_shutdown(self,
                          timeout: Optional[float] = None) -> bool:
        return self._shutdown_event.wait(timeout)

    def _stop_workers(self, graceful: bool) -> bool:
        # health loop first: it must not respawn what we kill
        self._health_stop.set()
        t = self._health_thread
        if t is not None:
            t.join(timeout=10)
        procs: List[subprocess.Popen] = []
        for w in self._workers:
            p = w.mark_stopped()
            if p is None:
                continue
            if p.poll() is None:
                procs.append(p)
            else:
                p.wait()  # reap an already-dead child
        clean = True
        for p in procs:
            try:
                p.terminate()  # SIGTERM -> worker's drain path
            except OSError:
                pass
        budget = self._drain_timeout_ms / 1e3 + 5.0 if graceful else 5.0
        deadline = time.monotonic() + budget
        for p in procs:
            left = max(0.1, deadline - time.monotonic())
            try:
                p.wait(timeout=left)
            except subprocess.TimeoutExpired:
                clean = False
                try:
                    p.kill()
                except OSError:
                    pass
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    pass
            else:
                clean = clean and p.returncode == 0
        return clean

    def _teardown_http(self) -> None:
        self.status_store.stop()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=10)
            self._serve_thread = None
        self._shutdown_event.set()

    # -- spawning ----------------------------------------------------------

    def _worker_hbm_budget(self) -> Optional[int]:
        """Each worker's share of the card: its free memory now, divided
        by the worker count, when the fleet runs on a CUDA device and
        the conf sets no service.hbmBudget of its own. None otherwise
        (a CPU fleet, an explicit budget, or no CUDA -- whose workers
        then fail at boot)."""
        if self.conf.is_explicitly_set(HBM_BUDGET_KEY):
            return None
        import torch
        if self.device:
            dev = torch.device(self.device)
            if dev.type != "cuda":
                return None
        elif torch.cuda.is_available():
            dev = torch.device("cuda", torch.cuda.current_device())
        else:
            return None
        free, _ = torch.cuda.mem_get_info(dev)
        return int(free) // len(self._workers)

    def _worker_conf(self, idx: int, gen: int) -> Dict:
        """Conf overrides shipped to the worker: every JSON-safe
        explicit setting from the supervisor chain (deadlines,
        admission bounds, the warehouse dir...), plus the forced worker
        seat: loopback ephemeral bind, the routing id prefix and, on a
        CUDA device, the worker's share of the card."""
        out: Dict = {}
        layers = []
        c: Optional[Conf] = self.conf
        while c is not None:
            layers.append(getattr(c, "_settings", {}))
            c = getattr(c, "_parent", None)
        for layer in reversed(layers):
            out.update(layer)
        safe = {}
        for k, v in out.items():
            try:
                json.dumps(v)
            except (TypeError, ValueError):
                continue
            safe[k] = v
        safe[HOST_KEY] = "127.0.0.1"
        safe[PORT_KEY] = 0
        safe[ID_PREFIX_KEY] = f"w{idx}g{gen}-"
        if self._hbm_share is not None:
            safe[HBM_BUDGET_KEY] = self._hbm_share
        return safe

    def _spawn(self, w: _Worker) -> None:
        now = time.monotonic()
        gen = w.begin_spawn(now + self._spawn_timeout_s)
        from ..testing import faults
        try:
            # chaos seam: a rule here makes the spawn itself fail,
            # exercising the ladder and the flap breaker
            faults.fire("fleet_worker")
            env = dict(os.environ)
            env[ENV_CONF] = json.dumps(self._worker_conf(w.idx, gen))
            env[ENV_IDX] = str(w.idx)
            env[ENV_DEVICE] = self.device
            root = os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__))))
            env["PYTHONPATH"] = root + os.pathsep \
                + env.get("PYTHONPATH", "")
            proc = subprocess.Popen(
                [sys.executable, "-m", "spark_tpu_torch.service.fleet",
                 "--worker"],
                env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True,
                encoding="utf-8", errors="replace")
        except Exception as e:  # noqa: BLE001 — rides the crash ladder
            w.stderr_tail.append(f"spawn failed: {type(e).__name__}: "
                                 f"{e}")
            self._account_crash(w, None, "spawn_failed",
                                {"proc": None, "port": None,
                                 "pid": None, "generation": gen})
            return
        w.attach_proc(proc)
        self.metrics.counter("fleet_spawns").inc()
        if gen > 1:
            self.metrics.counter("fleet_restarts").inc()
        threading.Thread(
            target=self._read_stdout, args=(w, proc, gen),
            daemon=True,
            name=f"{self.thread_prefix}out-w{w.idx}").start()
        threading.Thread(
            target=self._read_stderr, args=(w, proc),
            daemon=True,
            name=f"{self.thread_prefix}err-w{w.idx}").start()

    def _read_stdout(self, w: _Worker, proc: subprocess.Popen,
                     gen: int) -> None:
        """Pipe watcher: parse the one-line JSON handshake, then keep
        draining so the child never blocks on a full pipe. EOF means
        the child exited; the health loop reaps."""
        try:
            for line in proc.stdout:
                line = line.strip()
                if not line.startswith("{"):
                    continue
                try:
                    msg = json.loads(line)
                except ValueError:
                    continue
                if msg.get("spark_tpu_fleet_worker") is not None:
                    w.note_handshake(gen, int(msg["port"]),
                                     int(msg["pid"]))
        except (OSError, ValueError):
            pass

    def _read_stderr(self, w: _Worker,
                     proc: subprocess.Popen) -> None:
        try:
            for line in proc.stderr:
                w.stderr_tail.append(line.rstrip("\n"))
        except (OSError, ValueError):
            pass

    # -- health loop -------------------------------------------------------

    def _health_loop(self) -> None:
        while not self._health_stop.wait(self._interval_s):
            with self._cv:
                frozen = self._draining or self._stopped
            now = time.monotonic()
            ready = 0
            for w in self._workers:
                try:
                    self._tick_worker(w, now, frozen)
                except Exception:  # noqa: BLE001 — loop must survive
                    pass
                if w.snapshot()["state"] == "ready":
                    ready += 1
            self.metrics.gauge("fleet_workers_ready").set(ready)

    def _tick_worker(self, w: _Worker, now: float,
                     frozen: bool) -> None:
        st = w.snapshot()
        state, proc = st["state"], st["proc"]
        if state in ("quarantined", "stopped"):
            return
        if state == "crashed":
            # router saw the broken connection first
            self._on_worker_death(w, None, "proxy_error")
            return
        if proc is not None and proc.poll() is not None:
            self._on_worker_death(w, proc.returncode, "exit")
            return
        if state == "starting":
            if now >= st["spawn_deadline_ts"]:
                self._on_worker_death(w, None, "spawn_timeout")
            return
        if state == "live":
            # readiness probe: the worker's service has started
            if self._probe(st["port"], "/healthz/ready") == 200:
                w.mark_ready()
            return
        if state == "ready":
            if self._probe(st["port"], "/healthz/live") == 200:
                w.reset_ping_failures()
            elif w.note_ping_failure() >= _PING_FAILURE_LIMIT:
                self._on_worker_death(w, None, "ping_timeout")
            return
        if state == "backoff" and not frozen \
                and now >= st["next_spawn_ts"]:
            self._spawn(w)

    def _probe(self, port: Optional[int],
               path: str) -> Optional[int]:
        if not port:
            return None
        conn = http.client.HTTPConnection("127.0.0.1", port,
                                          timeout=2.0)
        try:
            conn.request("GET", path)
            r = conn.getresponse()
            r.read()
            return r.status
        except (OSError, http.client.HTTPException):
            return None
        finally:
            conn.close()

    def _on_worker_death(self, w: _Worker, rc: Optional[int],
                         reason: str) -> None:
        info = w.take_proc()
        if info is None:
            return  # another path already accounted this death
        proc = info["proc"]
        if proc is not None:
            if rc is None:
                try:
                    proc.kill()
                except OSError:
                    pass
            try:
                proc.wait(timeout=10)
                rc = proc.returncode
            except subprocess.TimeoutExpired:
                pass
        self._account_crash(w, rc, reason, info)

    def _account_crash(self, w: _Worker, rc: Optional[int],
                       reason: str, info: Dict) -> None:
        self.metrics.counter("fleet_worker_lost").inc()
        self._dump_bundle(w, info, rc, reason)
        delay_ms = w.record_crash(time.monotonic(), self._window_s,
                                  self._max_per_window,
                                  self._backoff_ms)
        if delay_ms is None:
            # flap breaker: crash storm inside the window — quarantine
            # instead of a respawn loop against a deterministic failure
            self.metrics.counter("fleet_quarantined").inc()

    def _dump_bundle(self, w: _Worker, info: Dict, rc: Optional[int],
                     reason: str) -> None:
        """Flight bundle per death: what the worker said on stderr
        and where it was in its lifecycle — the post-mortem record a
        crash-only design owes the operator."""
        try:
            d = os.path.join(
                self._fleet_dir, "bundles",
                f"w{w.idx}-g{info['generation']}-"
                f"{next(self._bundle_seq)}-{reason}")
            os.makedirs(d, exist_ok=True)
            manifest = {"ts": time.time(), "worker": w.idx,
                        "generation": info["generation"],
                        "reason": reason, "returncode": rc,
                        "pid": info["pid"], "port": info["port"],
                        "info": w.info()}
            with open(os.path.join(d, "MANIFEST.json"), "w") as f:
                json.dump(manifest, f, indent=2, default=str)
            with open(os.path.join(d, "stderr.txt"), "w") as f:
                f.write("\n".join(w.stderr_tail))
            self.metrics.counter("fleet_bundles").inc()
        except OSError:
            pass

    # -- routing -----------------------------------------------------------

    def _route(self, session: str) -> List[int]:
        h = int(hashlib.md5(
            str(session).encode()).hexdigest()[:8], 16)
        i = bisect.bisect_left(self._ring_points, h)
        seen, order = set(), []
        for k in range(len(self._ring)):
            _, idx = self._ring[(i + k) % len(self._ring)]
            if idx not in seen:
                seen.add(idx)
                order.append(idx)
        return order

    def _pick(self, session: str) -> Tuple[Optional[_Worker],
                                           Optional[int]]:
        """First READY worker on the session's ring walk — affinity
        with deterministic re-homing when the home worker is down."""
        for idx in self._route(session):
            w = self._workers[idx]
            st = w.snapshot()
            if st["state"] == "ready" and st["port"]:
                return w, st["port"]
        return None, None

    def note_worker_lost(self, w: _Worker) -> None:
        w.mark_lost()

    # -- request accounting ------------------------------------------------

    def begin_request(self) -> str:
        with self._cv:
            if self._draining or self._stopped:
                raise FleetDraining(
                    "fleet is draining; not admitting new queries")
            self._seq += 1
            self._inflight += 1
            return f"fleet-{self._seq}"

    def end_request(self) -> None:
        with self._cv:
            self._inflight -= 1
            self._cv.notify_all()

    def proxy(self, port: int, method: str, path: str,
              body: Optional[bytes] = None,
              headers: Optional[Dict] = None) -> Tuple[int, list,
                                                       bytes]:
        conn = http.client.HTTPConnection(
            "127.0.0.1", port, timeout=self._proxy_timeout_s)
        try:
            conn.request(method, path, body=body,
                         headers=headers or {})
            r = conn.getresponse()
            data = r.read()
            return r.status, r.getheaders(), data
        except (OSError, http.client.HTTPException) as e:
            raise _WorkerLost(f"{type(e).__name__}: {e}") from e
        finally:
            conn.close()

    # -- introspection -----------------------------------------------------

    def fleet_health(self) -> Dict:
        infos = [w.info() for w in self._workers]
        ready = sum(1 for i in infos if i["state"] == "ready")
        with self._cv:
            draining, inflight = self._draining, self._inflight
        return {"status": "ok" if ready else "degraded",
                "role": "fleet", "ready": ready > 0,
                "draining": draining,
                "workers_ready": ready, "workers": infos,
                "inflight": inflight,
                "uptime_s": round(time.time() - self._started_ts, 1)}

    def stats(self) -> Dict:
        """Status-store provider (GET /status, series fleet.*)."""
        infos = [w.info() for w in self._workers]
        with self._cv:
            inflight, draining = self._inflight, self._draining
        return {"workers": len(infos),
                "ready": sum(i["state"] == "ready" for i in infos),
                "quarantined": sum(i["state"] == "quarantined"
                                   for i in infos),
                "restarts": sum(i["restarts"] for i in infos),
                "inflight": inflight, "draining": int(draining)}

    def metrics_text(self) -> str:
        """GET /metrics body: the supervisor's own fleet_* registry
        merged with every live worker's /metrics, each worker's
        samples tagged with a worker="<idx>" label so identically
        named series from N workers stay distinguishable. A worker
        dying mid-scrape is noted and skipped — a scrape must degrade,
        never fail."""
        texts: List[Tuple[Optional[str], str]] = [
            (None, prometheus_text(self.metrics.snapshot()))]
        for w in self._workers:
            st = w.snapshot()
            if st["state"] not in ("ready", "live") or not st["port"]:
                continue
            try:
                status, _, data = self.proxy(
                    st["port"], "GET", "/metrics")
            except _WorkerLost:
                self.note_worker_lost(w)
                continue
            if status == 200:
                texts.append((str(w.idx),
                              data.decode("utf-8", "replace")))
        return _merge_prometheus(texts)

    def worker_pids(self) -> List[int]:
        return [w.snapshot()["pid"] for w in self._workers
                if w.snapshot()["pid"] is not None]


# ---------------------------------------------------------------------------
# Prometheus exposition merge (supervisor + workers on one scrape)
# ---------------------------------------------------------------------------


def _label_sample(line: str, worker: str) -> str:
    """Tag one exposition sample line with worker="<idx>" (inserted
    first in an existing label set, e.g. histogram `_bucket{le=...}`
    lines)."""
    name, _, rest = line.partition(" ")
    if "{" in name:
        head, _, tail = name.partition("{")
        name = f'{head}{{worker="{worker}",{tail}'
    else:
        name = f'{name}{{worker="{worker}"}}'
    return f"{name} {rest}"


def _merge_prometheus(texts: List[Tuple[Optional[str], str]]) -> str:
    """Merge several text expositions into one valid 0.0.4 document:
    each (worker_label, text) source's samples get a worker label
    (None = emit unlabeled, the supervisor's own series), families
    sharing a name coalesce under a single # TYPE line, and every
    family's samples stay contiguous — both format requirements when
    N workers export the same metric names."""
    families: Dict[str, Dict] = {}
    order: List[str] = []
    for worker, text in texts:
        fam = None
        for line in text.splitlines():
            if line.startswith("# TYPE "):
                _, _, name, typ = line.split(None, 3)
                fam = families.get(name)
                if fam is None:
                    fam = families[name] = {"type": typ,
                                            "samples": []}
                    order.append(name)
            elif not line or line.startswith("#"):
                continue
            elif fam is not None:
                fam["samples"].append(
                    line if worker is None
                    else _label_sample(line, worker))
    out: List[str] = []
    for name in order:
        fam = families[name]
        out.append(f"# TYPE {name} {fam['type']}")
        out.extend(fam["samples"])
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# Router HTTP front end
# ---------------------------------------------------------------------------


def _make_router(sup: FleetSupervisor):
    class Router(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet: metrics cover it
            pass

        def _send_json(self, status: int, payload: Dict) -> None:
            body = json.dumps(payload, default=str).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _relay(self, status: int, hdrs: list, data: bytes,
                   extra: Dict) -> None:
            """Forward a worker response, keeping only end-to-end
            headers (length is recomputed; hop-by-hop dropped)."""
            self.send_response(status)
            keep = {"content-type", "x-query-id"}
            for k, v in hdrs:
                if k.lower() in keep:
                    self.send_header(k, v)
            for k, v in extra.items():
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        # -- query-id routing ---------------------------------------------

        def _route_query_path(self, method: str) -> None:
            path = self.path.split("?", 1)[0]
            rest = path[len("/queries/"):]
            qid = rest.split("/", 1)[0]
            m = _QID_RE.match(qid)
            if not m:
                self._send_json(404, {
                    "error": "NOT_FOUND",
                    "message": f"unknown query id {qid!r} (fleet ids "
                               f"embed their worker: q-w<i>g<n>-...)",
                    "query_id": qid})
                return
            idx, gen = int(m.group(1)), int(m.group(2))
            if idx >= len(sup._workers):
                self._send_json(404, {
                    "error": "NOT_FOUND",
                    "message": f"no worker {idx} in this fleet",
                    "query_id": qid})
                return
            w = sup._workers[idx]
            st = w.snapshot()
            if (gen != st["generation"]
                    or st["state"] not in ("ready", "live")
                    or not st["port"]):
                # crash-only: in-memory records died with the worker —
                # say so structurally instead of 404-ing
                self._send_json(503, {
                    "error": "WORKER_LOST",
                    "message": f"query {qid} belonged to worker {idx} "
                               f"generation {gen}, which is gone "
                               f"(records are in-memory and die with "
                               f"their worker)",
                    "query_id": qid, "worker": idx})
                return
            try:
                status, hdrs, data = sup.proxy(
                    st["port"], method, self.path)
            except _WorkerLost:
                sup.note_worker_lost(w)
                self._send_json(503, {
                    "error": "WORKER_LOST",
                    "message": f"worker {idx} died answering for "
                               f"{qid}",
                    "query_id": qid, "worker": idx})
                return
            self._relay(status, hdrs, data,
                        {"X-Fleet-Worker": str(idx)})

        # -- verbs ---------------------------------------------------------

        def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
            from urllib.parse import parse_qs
            path, _, query = self.path.partition("?")
            if path == "/healthz":
                h = sup.fleet_health()
                self._send_json(200 if h["ready"] else 503, h)
            elif path == "/healthz/live":
                self._send_json(200, {"live": True,
                                      "ready": sup.ready_count() > 0})
            elif path == "/healthz/ready":
                if sup.ready_count() > 0:
                    self._send_json(200, {"ready": True})
                else:
                    self._send_json(503, {
                        "error": "NOT_READY",
                        "message": "no ready worker",
                        "ready": False})
            elif path == "/fleet":
                self._send_json(200, sup.fleet_health())
            elif path == "/metrics":
                body = sup.metrics_text().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif path == "/status":
                self._send_json(200, sup.status_store.snapshot())
            elif path == "/status/timeseries":
                qs = parse_qs(query)
                names = None
                if qs.get("series"):
                    names = [s for s in qs["series"][0].split(",")
                             if s]
                try:
                    limit = (int(qs["limit"][0])
                             if qs.get("limit") else None)
                except (TypeError, ValueError) as e:
                    self._send_json(400, {"error": "BAD_REQUEST",
                                          "message": str(e)[:200]})
                    return
                self._send_json(200, sup.status_store.timeseries(
                    names=names, limit=limit))
            elif path in ("/queries", "/queries/"):
                # fan-out merge across ready workers
                out: Dict = {"queries": [], "streams": [],
                             "total": 0, "workers": {}}
                for w in sup._workers:
                    st = w.snapshot()
                    if st["state"] != "ready" or not st["port"]:
                        continue
                    try:
                        status, _, data = sup.proxy(
                            st["port"], "GET", self.path)
                    except _WorkerLost:
                        sup.note_worker_lost(w)
                        continue
                    if status != 200:
                        continue
                    try:
                        d = json.loads(data)
                    except ValueError:
                        continue
                    out["queries"].extend(d.get("queries") or [])
                    out["streams"].extend(d.get("streams") or [])
                    out["total"] += int(d.get("total") or 0)
                    out["workers"][str(w.idx)] = int(
                        d.get("total") or 0)
                self._send_json(200, out)
            elif path.startswith("/queries/"):
                self._route_query_path("GET")
            else:
                self._send_json(404, {"error": "NOT_FOUND",
                                      "message": path})

        def do_DELETE(self):  # noqa: N802
            path = self.path.split("?", 1)[0]
            if path.startswith("/queries/"):
                self._route_query_path("DELETE")
            else:
                self._send_json(404, {"error": "NOT_FOUND",
                                      "message": path})

        def do_POST(self):  # noqa: N802
            path = self.path.split("?", 1)[0]
            n = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(n) if n else b"{}"
            if path != "/sql":
                self._send_json(404, {"error": "NOT_FOUND",
                                      "message": path})
                return
            try:
                req = json.loads(raw or b"{}")
                if not isinstance(req, dict):
                    raise ValueError("body must be a JSON object")
            except (ValueError, TypeError) as e:
                self._send_json(400, {"error": "BAD_REQUEST",
                                      "message": str(e)[:200]})
                return
            session = str(req.get("session") or "default")
            sql = req.get("sql") or ""
            try:
                fid = sup.begin_request()
            except AdmissionError as e:
                sup.metrics.counter("fleet_requests_shed").inc()
                self._send_json(e.http_status, e.to_dict())
                return
            try:
                self._post_sql(session, sql, raw, fid)
            finally:
                sup.end_request()

        def _post_sql(self, session: str, sql: str, raw: bytes,
                      fid: str) -> None:
            headers = {"Content-Type":
                       self.headers.get("Content-Type")
                       or "application/json"}
            attempt = 0
            w, port = sup._pick(session)
            while True:
                if w is None:
                    sup.metrics.counter("fleet_requests_shed").inc()
                    self._send_json(503, FleetUnavailable(
                        "no ready worker (crashed, warm-starting or "
                        "quarantined)",
                        workers_ready=sup.ready_count()).to_dict())
                    return
                try:
                    status, hdrs, data = sup.proxy(
                        port, "POST", self.path, raw, headers)
                except _WorkerLost:
                    sup.note_worker_lost(w)
                    lost_idx = w.idx
                    if (attempt == 0 and sup._failover_reads
                            and _is_read(sql)):
                        # idempotent read: retry ONCE on the re-homed
                        # worker (deterministic engine + the same
                        # sources => byte parity)
                        attempt = 1
                        sup.metrics.counter("fleet_failovers").inc()
                        w, port = sup._pick(session)
                        continue
                    self._send_json(503, {
                        "error": "WORKER_LOST",
                        "message": f"worker {lost_idx} died "
                                   f"mid-request; statement is not a "
                                   f"retryable read"
                        if attempt == 0 else
                        f"worker {lost_idx} died during failover "
                        f"retry",
                        "query_id": fid, "worker": lost_idx})
                    return
                sup.metrics.counter("fleet_requests_proxied").inc()
                extra = {"X-Fleet-Worker": str(w.idx),
                         "X-Fleet-Request": fid}
                if attempt:
                    extra["X-Fleet-Failover"] = "1"
                self._relay(status, hdrs, data, extra)
                return

    return Router


# ---------------------------------------------------------------------------
# Entry points: worker child and supervisor CLI
# ---------------------------------------------------------------------------


def _resolve_init(spec: str):
    """'module:function' -> callable, the init_session hook a worker
    applies to every pooled session (register tables, UDFs...)."""
    import importlib
    mod, _, fn = spec.partition(":")
    m = importlib.import_module(mod)
    return getattr(m, fn) if fn else None


def _worker_main() -> int:
    """Child entry (`python -m spark_tpu_torch.service.fleet --worker`):
    build the conf from SPARK_TPU_FLEET_CONF, serve on an ephemeral
    loopback port on the device SPARK_TPU_FLEET_DEVICE names (empty:
    the current CUDA card, or a boot failure without CUDA), print the
    one-line JSON handshake, park until SIGTERM drains us."""
    idx = int(os.environ.get(ENV_IDX, "0"))
    conf = Conf()
    for k, v in json.loads(os.environ.get(ENV_CONF, "{}")).items():
        conf.set(k, v)
    init = None
    spec = str(conf.get(INIT_KEY) or "")
    if spec:
        # resolve BEFORE the heavy engine import: a bad init spec is a
        # deterministic boot failure and should crash cheaply (the
        # supervisor's flap breaker quarantines it after K attempts)
        init = _resolve_init(spec)
    from .server import SqlService
    svc = SqlService(conf, init_session=init,
                     device=os.environ.get(ENV_DEVICE) or None)
    svc.install_signal_handlers()  # SIGTERM/SIGINT -> drain -> stop
    svc.start()
    print(json.dumps({"spark_tpu_fleet_worker": idx,
                      "port": svc.port, "pid": os.getpid()}),
          flush=True)
    # wait_for_shutdown only unblocks after a signal-driven
    # drain+stop has fully completed, so stop() here is a true
    # idempotent no-op (it also covers a direct stop() call)
    svc.wait_for_shutdown()
    svc.stop()
    return 0


def _supervisor_main(argv: Optional[List[str]] = None) -> int:
    """CLI entry (`python -m spark_tpu_torch.service.fleet`): parse
    flags, serve, park until SIGTERM/SIGINT drains the fleet."""
    import argparse
    import signal
    p = argparse.ArgumentParser(
        prog="spark-tpu-fleet",
        description="Crash-only SqlService fleet: supervisor + "
                    "router over N worker subprocesses.")
    p.add_argument("--workers", type=int, default=None,
                   help="worker subprocess count "
                        f"(default: conf {WORKERS_KEY})")
    p.add_argument("--host", default=None,
                   help="router bind host")
    p.add_argument("--port", type=int, default=None,
                   help="router bind port (0 = ephemeral)")
    p.add_argument("--conf", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="conf override, repeatable (values parse as "
                        "JSON when possible)")
    p.add_argument("--init", default=None, metavar="MODULE:FUNC",
                   help="session initializer run in every worker")
    p.add_argument("--device", default=None,
                   help="the workers' torch device (default: the "
                        "current CUDA card; 'cpu' runs them on the CPU)")
    args = p.parse_args(argv)
    conf = Conf()
    for kv in args.conf:
        k, _, v = kv.partition("=")
        try:
            parsed = json.loads(v)
        except ValueError:
            parsed = v
        conf.set(k, parsed)
    if args.workers is not None:
        conf.set(WORKERS_KEY, args.workers)
    if args.host is not None:
        conf.set(HOST_KEY, args.host)
    if args.port is not None:
        conf.set(PORT_KEY, args.port)
    if args.init:
        conf.set(INIT_KEY, args.init)
    sup = FleetSupervisor(conf, device=args.device).start()

    def _handler(signum, frame):
        threading.Thread(target=sup.shutdown, daemon=True,
                         name="fleet-shutdown").start()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _handler)
    print(json.dumps({"spark_tpu_fleet": {
        "port": sup.port, "pid": os.getpid(),
        "workers": len(sup._workers)}}), flush=True)
    sup.wait_for_shutdown()
    return 0


if __name__ == "__main__":
    if "--worker" in sys.argv[1:]:
        sys.exit(_worker_main())
    sys.exit(_supervisor_main(
        [a for a in sys.argv[1:] if a != "--worker"]))
