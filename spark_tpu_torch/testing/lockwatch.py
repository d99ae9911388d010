"""Runtime lock verification: observed order, hold times, contention
(the port of `spark_tpu/testing/lockwatch.py`).

The dynamic half of the concurrency analyzer
(`spark_tpu_torch/analysis/concurrency/`): the static passes prove the
DECLARED lock graph acyclic and rank-ascending; lockwatch wraps the
live lock objects at test time and records what threads ACTUALLY do --

- acquisition-order edges (lock held -> lock acquired, per thread),
  asserted consistent with the same registry ranks the static graph
  was proven against (`assert_order_consistent`);
- hold time per lock (total + max) and contention (acquisitions that
  found the lock taken), for spotting critical sections that grew;
- daemon-thread hygiene: `assert_no_thread_leak` proves no worker
  (e.g. the ingest prefetcher) outlives its query.

Opt-in and test-only: `LockWatch().install_session(s)` swaps the
session's lock attributes and the process-wide ones its queries take
(the device cache, the cancel-token registry, the kernel build and
launch locks, the mesh's copy counters, the live-stream registry) for
recording proxies; `install_service(svc)` does the same for a SQL
service, its locks and each of its pooled sessions; `uninstall()`
restores them. Per-instance leaf locks (each metrics Counter/Timer) are
not wrapped -- they rank above everything and acquire nothing.

    watch = LockWatch()
    watch.install_session(s)         # + watch.install_faults()
    try:
        ... run concurrent queries ...
        watch.assert_order_consistent()
        watch.assert_no_thread_leak()
    finally:
        watch.uninstall()
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

#: the most recently ENTERED LockWatch (cleared by uninstall): the
#: flight recorder's bundle dump reads it via `current_watch()` so
#: crash bundles under test carry the observed lock report. Written
#: only from test setup/teardown -- no lock needed (GIL-atomic ref).
_CURRENT: Optional["LockWatch"] = None


def current_watch() -> Optional["LockWatch"]:
    """The active LockWatch, if a test installed one (None in
    production -- lockwatch is opt-in and test-only)."""
    return _CURRENT


class _WatchedLock:
    """Recording proxy over a Lock/RLock: context-manager + explicit
    acquire/release, delegating to the wrapped lock."""

    def __init__(self, watch: "LockWatch", lock_id: str, inner):
        self._watch = watch
        self._lock_id = lock_id
        self._inner = inner

    # -- lock protocol ------------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1):
        t0 = time.perf_counter()
        contended = not self._inner.acquire(blocking=False)
        if contended:
            if not blocking:
                self._watch._note_contended(self._lock_id)
                return False
            ok = self._inner.acquire(True, timeout)
            if not ok:
                self._watch._note_contended(self._lock_id)
                return False
        self._watch._note_acquired(self._lock_id, contended,
                                   time.perf_counter() - t0,
                                   obj=id(self._inner))
        return True

    def release(self):
        self._watch._note_released(self._lock_id)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()


class _WatchedCondition(_WatchedLock):
    """Condition proxy: `wait` releases the lock for its duration, so
    the held-stack entry is popped around the inner wait and re-pushed
    on wakeup (the re-acquisition records its edges again)."""

    def wait(self, timeout: Optional[float] = None):
        self._watch._note_released(self._lock_id)
        try:
            return self._inner.wait(timeout)
        finally:
            self._watch._note_acquired(self._lock_id, False, 0.0,
                                       obj=id(self._inner))

    def wait_for(self, predicate, timeout: Optional[float] = None):
        self._watch._note_released(self._lock_id)
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            self._watch._note_acquired(self._lock_id, False, 0.0,
                                       obj=id(self._inner))

    def notify(self, n: int = 1):
        self._inner.notify(n)

    def notify_all(self):
        self._inner.notify_all()


class LockWatch:
    """Process-wide recorder over wrapped locks. Internal state is
    guarded by its OWN plain lock (never itself watched)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._tls = threading.local()
        #: (held_id, acquired_id) -> count, across all threads
        self.edge_counts: Dict[Tuple[str, str], int] = {}
        #: lock_id -> {"acquires", "contended", "wait_s", "hold_s",
        #:             "max_hold_s"}
        self.lock_stats: Dict[str, Dict[str, float]] = {}
        self._installed: List[Tuple[object, str, object]] = []

    # -- recording (called from the proxies) --------------------------------

    def _held(self) -> List[List]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _note_acquired(self, lock_id: str, contended: bool,
                       wait_s: float, obj: int = 0) -> None:
        stack = self._held()
        with self._mu:
            st = self.lock_stats.setdefault(
                lock_id, {"acquires": 0, "contended": 0, "wait_s": 0.0,
                          "hold_s": 0.0, "max_hold_s": 0.0})
            st["acquires"] += 1
            st["wait_s"] += wait_s
            if contended:
                st["contended"] += 1
            # edges from every DISTINCT held lock object: a same-id
            # pair of different objects (two sessions' leases, two
            # sessions' buses) is exactly the ABBA deadlock shape a
            # rank check cannot see, so it records as a self-edge and
            # assert_order_consistent flags it; a reentrant re-acquire
            # of the SAME object (RLock, Condition.wait re-push) does
            # not
            for h_id, _, h_obj in stack:
                if h_id != lock_id or (obj and h_obj and h_obj != obj):
                    key = (h_id, lock_id)
                    self.edge_counts[key] = \
                        self.edge_counts.get(key, 0) + 1
        stack.append([lock_id, time.perf_counter(), obj])

    def _note_contended(self, lock_id: str) -> None:
        with self._mu:
            st = self.lock_stats.setdefault(
                lock_id, {"acquires": 0, "contended": 0, "wait_s": 0.0,
                          "hold_s": 0.0, "max_hold_s": 0.0})
            st["contended"] += 1

    def _note_released(self, lock_id: str) -> None:
        stack = self._held()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] == lock_id:
                _, t0, _ = stack.pop(i)
                hold = time.perf_counter() - t0
                with self._mu:
                    st = self.lock_stats.get(lock_id)
                    if st is not None:
                        st["hold_s"] += hold
                        st["max_hold_s"] = max(st["max_hold_s"], hold)
                return

    # -- installation -------------------------------------------------------

    def watch_attr(self, obj, attr: str, lock_id: str) -> None:
        """Swap `obj.<attr>` for a recording proxy (idempotent per
        (obj, attr))."""
        inner = getattr(obj, attr)
        if isinstance(inner, _WatchedLock):
            return
        cls = _WatchedCondition if hasattr(inner, "notify_all") \
            else _WatchedLock
        setattr(obj, attr, cls(self, lock_id, inner))
        self._installed.append((obj, attr, inner))
        global _CURRENT
        _CURRENT = self

    def install_service(self, svc) -> None:
        """Wrap a SqlService's locks (admission, quota, arbiter, the
        shared result cache, pool, registry, async bound, install and
        stop guards, history, the shared metrics registry, the service
        bus and status store), the process device cache and cancel-token
        registry, and every pooled session present at call time: its
        lease and `install_session`'s locks. Warm the pool first, or call
        again after new sessions appear."""
        from ..execution import lifecycle
        from ..io.device_cache import CACHE
        self.watch_attr(svc, "_stop_lock", "service.stop")
        self.watch_attr(svc.admission, "_cv", "service.admission")
        self.watch_attr(svc.session_quota, "_lock", "service.quota")
        self.watch_attr(lifecycle, "_TOKENS_LOCK", "execution.lifecycle")
        self.watch_attr(svc.arbiter, "_cv", "service.arbiter")
        self.watch_attr(svc.arbiter.result_cache, "_lock",
                        "service.result_cache")
        self.watch_attr(svc.pool, "_lock", "service.pool")
        self.watch_attr(svc, "_records_lock", "service.records")
        self.watch_attr(svc, "_async_lock", "service.async")
        self.watch_attr(svc, "_install_lock", "service.install")
        self.watch_attr(svc.history, "_lock", "service.history")
        self.watch_attr(svc.metrics, "_lock", "metrics.registry")
        self.watch_attr(svc.metrics, "_flush_lock", "metrics.flush")
        self.watch_attr(svc.bus, "_lock", "obs.bus")
        self.watch_attr(svc.status_store, "_lock", "obs.status")
        self.watch_attr(CACHE, "_lock", "io.device_cache")
        for entry in list(svc.pool._entries.values()):
            self.watch_attr(entry, "lock", "service.session")
            self.install_session(entry.session)

    def install_session(self, session) -> None:
        """Wrap one session's locks (its bus, metrics registry, UDF
        worker pool, query-id counter and built-in listeners') and the
        process-wide locks its queries take: the device table cache,
        the cancel-token registry, the kernel build and launch locks,
        the mesh's copy counters and the live-stream registry."""
        from .. import streaming
        from ..execution import dense_groupby, lifecycle
        from ..io.device_cache import CACHE
        from ..observability.flight_recorder import FlightRecorder
        from ..observability.sinks import EventLogListener
        from ..observability.straggler import StragglerMonitor
        from ..parallel import mesh
        self.watch_attr(lifecycle, "_TOKENS_LOCK", "execution.lifecycle")
        self.watch_attr(CACHE, "_lock", "io.device_cache")
        self.watch_attr(dense_groupby, "_lib_lock", "dense_groupby.build")
        self.watch_attr(dense_groupby, "_LAUNCH_LOCK",
                        "dense_groupby.launch")
        self.watch_attr(mesh, "_COPY_LOCK", "mesh.copy_stats")
        self.watch_attr(streaming, "_LIVE_LOCK", "streaming.live")
        self.watch_attr(session, "_query_seq_lock", "session.query_seq")
        self.watch_attr(session.listeners, "_lock", "obs.bus")
        self.watch_attr(session.metrics, "_lock", "metrics.registry")
        self.watch_attr(session.metrics, "_flush_lock", "metrics.flush")
        self.watch_attr(session._udf_pool, "_cv", "udf.pool")
        for li in session.listeners.listeners:
            if isinstance(li, EventLogListener):
                self.watch_attr(li, "_write_lock", "obs.event_log")
            elif isinstance(li, StragglerMonitor):
                self.watch_attr(li, "_lock", "obs.straggler")
            elif isinstance(li, FlightRecorder):
                self.watch_attr(li, "_lock", "obs.flightrec")

    def install_faults(self) -> None:
        """Wrap the currently-armed fault plan's counter lock (call
        after `faults.arm`/`faults.inject` created it)."""
        from . import faults
        plan = faults.active()
        if plan is not None:
            self.watch_attr(plan, "_lock", "faults.plan")

    def install_query(self, query) -> None:
        """Wrap a streaming query's cross-thread status lock (call
        before `query.start()`, so the trigger thread takes the proxy)."""
        self.watch_attr(query._trigger, "_lock", "streaming.trigger")

    def uninstall(self) -> None:
        """Restore every wrapped attribute (reverse order)."""
        global _CURRENT
        for obj, attr, inner in reversed(self._installed):
            setattr(obj, attr, inner)
        self._installed.clear()
        if _CURRENT is self:
            _CURRENT = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.uninstall()
        return False

    # -- verdicts -----------------------------------------------------------

    def edges(self) -> Dict[Tuple[str, str], int]:
        with self._mu:
            return dict(self.edge_counts)

    def report(self) -> Dict:
        with self._mu:
            return {
                "edges": {f"{a} -> {b}": n
                          for (a, b), n in sorted(self.edge_counts.items())},
                "locks": {k: dict(v)
                          for k, v in sorted(self.lock_stats.items())},
            }

    def assert_order_consistent(self) -> None:
        """Every observed acquisition edge must ascend in the registry
        ranking (the order the static lock-order pass proved acyclic),
        and no edge may have been observed in both directions."""
        from ..analysis.concurrency.registry import rank_of
        edges = self.edges()
        problems = []
        for (a, b), n in sorted(edges.items()):
            if a == b:
                # recorded only for DISTINCT lock objects sharing one
                # id (see _note_acquired): two sessions' leases nested
                # is an ABBA deadlock shape no rank can order
                problems.append(
                    f"distinct {a!r} locks nested on one thread "
                    f"({n}x): same-rank ABBA deadlock shape")
                continue
            if (b, a) in edges:
                problems.append(
                    f"edge observed in BOTH directions: {a!r} <-> "
                    f"{b!r} (classic deadlock shape)")
            ra, rb = rank_of(a), rank_of(b)
            if ra is None or rb is None:
                problems.append(
                    f"edge touches unregistered lock: {a!r} -> {b!r}")
            elif ra >= rb:
                problems.append(
                    f"observed order inverts the registry ranking: "
                    f"{a!r} (rank {ra}) held while acquiring {b!r} "
                    f"(rank {rb}), {n}x")
        assert not problems, (
            "lockwatch: observed acquisition order inconsistent with "
            "the static lock-order registry:\n  "
            + "\n  ".join(problems)
            + f"\nfull report: {self.report()}")

    def assert_no_thread_leak(
            self, prefix: str = "spark-tpu-torch-ingest-prefetch",
            timeout_s: float = 10.0) -> None:
        """No daemon thread with the given name prefix may outlive the
        queries that spawned it (bounded wait: a worker observed
        mid-exit gets `timeout_s` to finish)."""
        deadline = time.monotonic() + timeout_s
        while True:
            leaked = [t.name for t in threading.enumerate()
                      if t.name.startswith(prefix) and t.is_alive()]
            if not leaked:
                return
            if time.monotonic() >= deadline:
                raise AssertionError(
                    f"lockwatch: {len(leaked)} thread(s) with prefix "
                    f"{prefix!r} still alive {timeout_s}s after the "
                    f"queries ended: {leaked}")
            time.sleep(0.05)
