"""Session pool: named long-lived sessions sharing process resources
(the port of `spark_tpu/service/pool.py`).

The `SparkSQLSessionManager` seat of the thriftserver: one pooled
`SparkTpuSession` per distinct session name, each with its OWN conf
overlay (a child `Conf` over the service base conf — the per-session
SQLConf clone) and its own catalog/UDF registry, built on the service's
device, but SHARING the process resources:

- one plan-fingerprint result cache (`arbiter.result_cache`);
- one metrics registry, so `GET /metrics` aggregates every session;
- the process's device table cache (`io/device_cache.CACHE`), so the
  second session's scan of a table the first loaded is a cache hit.

The JAX package's pooled sessions also share a compiled-stage cache;
the port runs eagerly and has none.

Execution per session is SERIALIZED (a per-session lock): the engine's
per-session state (query sequence, AQE cap store, exec depth) is
single-caller by design, so concurrency comes from running DIFFERENT
sessions' queries in parallel — exactly the thriftserver model of one
session per connection. Leasing a busy session blocks until it frees.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from ..config import Conf

MAX_SESSIONS_KEY = "spark_tpu.service.maxSessions"


class PoolExhausted(RuntimeError):
    """Structured error: a NEW session name past service.maxSessions."""

    def to_dict(self) -> Dict:
        return {"error": "POOL_EXHAUSTED", "message": str(self)}


class _Entry:
    __slots__ = ("name", "session", "lock", "current_record", "ready",
                 "init_error")

    def __init__(self, session, name: str = "default"):
        #: pool name: status-store attribution label for this session
        self.name = name
        self.session = session
        self.lock = threading.Lock()
        #: the service query record currently executing on this
        #: session (the status listener resolves events against it)
        self.current_record = None
        #: set once the (possibly slow) init_session hook has run —
        #: concurrent first requests for the same name wait on it
        #: instead of stalling the whole pool
        self.ready = threading.Event()
        self.init_error = None


class SessionPool:
    def __init__(self, base_conf: Conf, metrics, arbiter,
                 init_session: Optional[Callable] = None,
                 make_listener: Optional[Callable] = None,
                 device=None):
        self._base_conf = base_conf
        #: the device every pooled session is built on (None: the
        #: current CUDA card, resolved per session)
        self._device = device
        self._metrics = metrics
        self._arbiter = arbiter
        self._init_session = init_session
        self._make_listener = make_listener
        self._lock = threading.Lock()
        self._entries: Dict[str, _Entry] = {}
        self.max_sessions = int(base_conf.get(MAX_SESSIONS_KEY))

    def _create(self, name: str) -> _Entry:
        from ..session import SparkTpuSession
        conf = Conf(parent=self._base_conf)
        # register_active=False: a pooled session must not become the
        # creating thread's active session (worker threads pin it per
        # query with session.as_active())
        s = SparkTpuSession(conf, self._device, register_active=False)
        # swap in the shared process resources (see module docstring)
        s.metrics = self._metrics
        s._data_cache = self._arbiter.result_cache
        entry = _Entry(s, name)
        if self._make_listener is not None:
            s.add_listener(self._make_listener(entry))
        return entry

    def get_or_create(self, name: str = "default") -> _Entry:
        """Fetch the named session, creating it (bounded by
        service.maxSessions) on first use. Conf overrides are the
        CALLER's job, applied while holding `entry.lock` (the server
        does) so a request's overrides and its execution are atomic —
        a concurrent request naming the same session can neither
        clobber them pre-execution nor land them mid-query."""
        with self._lock:
            entry = self._entries.get(name)
            creating = entry is None
            if creating:
                if len(self._entries) >= self.max_sessions:
                    raise PoolExhausted(
                        f"session pool full "
                        f"({len(self._entries)}/{self.max_sessions}); "
                        f"reuse an existing session name")
                entry = self._entries[name] = self._create(name)
                self._metrics.gauge("service_sessions").set(
                    len(self._entries))
        if not creating:
            # the creator may still be inside init_session: wait for
            # it rather than handing out a half-initialized session
            entry.ready.wait()
            if entry.init_error is not None:
                raise RuntimeError(
                    f"session '{name}' failed to initialize: "
                    f"{entry.init_error}") from entry.init_error
            return entry
        # run the user init hook OUTSIDE the pool lock: registering
        # tables reads Parquet schemas (easily seconds) and lookups of
        # every OTHER session must not stall behind it
        try:
            if self._init_session is not None:
                self._init_session(entry.session)
        except BaseException as e:
            entry.init_error = e
            with self._lock:
                self._entries.pop(name, None)
                self._metrics.gauge("service_sessions").set(
                    len(self._entries))
            entry.ready.set()
            raise
        entry.ready.set()
        return entry

    def sessions(self) -> Dict[str, object]:
        with self._lock:
            return {n: e.session for n, e in self._entries.items()}

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
