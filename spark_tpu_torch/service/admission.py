"""Admission control for the SQL service: bounded concurrency + queue
(the port of `spark_tpu/service/admission.py`).

The thriftserver seat of a bounded execution pool: at most
`spark_tpu.service.maxConcurrent` queries execute at once; up to
`spark_tpu.service.queueDepth` more wait; anything past that is
rejected IMMEDIATELY with a structured error (HTTP 429 at the server),
and a queued query that waits longer than
`spark_tpu.service.queueTimeoutMs` fails with a structured timeout —
load sheds at the front door instead of growing an unbounded backlog
(the reference rejects at the pool the same way).

Queue waits are CANCELLABLE (execution/lifecycle.py): with a cancel
token installed — the service installs one per request — the cv wait
runs in short slices capped by the remaining queryDeadlineMs budget,
and a cancelled/deadlined waiter leaves the queue with its slot math
intact, never having executed.

`SessionQuota` adds the per-session half
(`spark_tpu.service.session.maxConcurrent`): one session name's
in-flight submissions are bounded separately, so a single greedy
session cannot consume every queue slot and starve the pool —
exceeding it rejects with SESSION_QUOTA_EXCEEDED (HTTP 429) and
counts `session_quota_rejections`.

Every transition posts a typed `ServiceEvent` on the service bus and
counts into the shared metrics registry, so `GET /metrics` shows
admitted/queued/rejected/timeout totals live.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

SESSION_MAX_CONCURRENT_KEY = "spark_tpu.service.session.maxConcurrent"


class AdmissionError(RuntimeError):
    """Base for structured admission failures: `to_dict()` is the HTTP
    error body (and the shape tests assert on)."""

    code = "ADMISSION_ERROR"
    http_status = 500

    def __init__(self, message: str, **detail):
        super().__init__(message)
        self.detail = detail

    def to_dict(self) -> Dict:
        return {"error": self.code, "message": str(self), **self.detail}


class AdmissionRejected(AdmissionError):
    """Queue full: the submission was never queued."""

    code = "ADMISSION_REJECTED"
    http_status = 429


class AdmissionTimeout(AdmissionError):
    """Queued, but no slot freed within queueTimeoutMs."""

    code = "ADMISSION_TIMEOUT"
    http_status = 503


class ServiceDraining(AdmissionError):
    """The service is draining (SIGTERM / explicit drain()): new
    submissions shed at the front door while in-flight queries finish
    under the bounded drain budget. 503: the condition is transient —
    a router retries elsewhere."""

    code = "SERVICE_DRAINING"
    http_status = 503


class SessionQuotaExceeded(AdmissionError):
    """The session's per-session in-flight quota
    (spark_tpu.service.session.maxConcurrent) is full."""

    code = "SESSION_QUOTA_EXCEEDED"
    http_status = 429


class SessionQuota:
    """Per-session in-flight submission counter. `acquire` is
    check-and-increment under the quota lock; rejection bookkeeping
    (counter + structured raise) runs outside it. 0 = unlimited."""

    def __init__(self, max_per_session: int, metrics=None):
        self.max_per_session = int(max_per_session)
        self.metrics = metrics
        self._lock = threading.Lock()
        self._inflight: Dict[str, int] = {}

    def acquire(self, session: str) -> None:
        """Count one in-flight submission for `session`; raises
        SessionQuotaExceeded (structured, HTTP 429) at the bound."""
        if self.max_per_session <= 0:
            return
        with self._lock:
            n = self._inflight.get(session, 0)
            over = n >= self.max_per_session
            if not over:
                self._inflight[session] = n + 1
        if over:
            if self.metrics is not None:
                self.metrics.counter("session_quota_rejections").inc()
            raise SessionQuotaExceeded(
                f"session '{session}' at its in-flight quota "
                f"({n}/{self.max_per_session})",
                session=session, in_flight=n,
                session_max_concurrent=self.max_per_session)

    def release(self, session: str) -> None:
        if self.max_per_session <= 0:
            return
        with self._lock:
            n = self._inflight.get(session, 0) - 1
            if n <= 0:
                self._inflight.pop(session, None)
            else:
                self._inflight[session] = n

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"max_per_session": self.max_per_session,
                    "sessions_in_flight": dict(self._inflight)}


class AdmissionController:
    """Condition-variable slot gate. `slot(...)` is a context manager:
    entering acquires (or queues for) an execution slot, exiting
    releases it and wakes the queue head."""

    def __init__(self, max_concurrent: int, queue_depth: int,
                 queue_timeout_ms: float, metrics=None, on_event=None):
        self.max_concurrent = int(max_concurrent)
        self.queue_depth = int(queue_depth)
        self.queue_timeout_ms = float(queue_timeout_ms)
        self.metrics = metrics
        #: callable(action, query_id, detail) -> None; the service
        #: routes these onto its listener bus as ServiceEvents
        self.on_event = on_event or (lambda *a, **k: None)
        self._cv = threading.Condition()
        self.running = 0
        self.queued = 0

    def _count(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.counter(name).inc()

    def _gauges(self) -> None:
        if self.metrics is not None:
            self.metrics.gauge("service_running").set(self.running)
            self.metrics.gauge("service_queued").set(self.queued)

    def acquire(self, query_id: str = "") -> None:
        """Take an execution slot, queueing within bounds. Raises
        AdmissionRejected / AdmissionTimeout (structured), or the
        structured lifecycle error when the request's cancel token was
        cancelled / its deadline blew while queued (the waiter leaves
        the queue without ever executing; slot math intact)."""
        from ..execution import lifecycle
        # cooperative boundary before taking (or queueing for) a slot
        lifecycle.checkpoint("admission")
        deadline = None
        if self.queue_timeout_ms > 0:
            deadline = time.monotonic() + self.queue_timeout_ms / 1e3
        with self._cv:
            # fast path only when nobody is queued: a fresh arrival
            # must not steal a freed slot ahead of waiters (barging
            # would starve queued requests into 503s under a steady
            # arrival stream)
            if self.running < self.max_concurrent and self.queued == 0:
                self.running += 1
                self._count("service_admitted")
                self._gauges()
                self.on_event("admitted", query_id)
                return
            if self.queued >= self.queue_depth:
                self._count("service_rejected")
                self.on_event("rejected", query_id,
                              f"queueDepth={self.queue_depth}")
                raise AdmissionRejected(
                    f"admission queue full "
                    f"(running={self.running}, "
                    f"queued={self.queued}/{self.queue_depth})",
                    running=self.running, queued=self.queued,
                    queue_depth=self.queue_depth,
                    max_concurrent=self.max_concurrent)
            self.queued += 1
            self._count("service_queued_total")
            self._gauges()
            self.on_event("queued", query_id)
            try:
                while self.running >= self.max_concurrent:
                    remaining = None if deadline is None \
                        else deadline - time.monotonic()
                    if remaining is not None and remaining <= 0:
                        self._count("service_queue_timeout")
                        self.on_event(
                            "queue_timeout", query_id,
                            f"queueTimeoutMs={self.queue_timeout_ms:g}")
                        raise AdmissionTimeout(
                            f"no execution slot within "
                            f"{self.queue_timeout_ms:g}ms "
                            f"(running={self.running}, "
                            f"queued={self.queued})",
                            running=self.running, queued=self.queued,
                            queue_timeout_ms=self.queue_timeout_ms)
                    # token-capped wait: with a cancel token installed
                    # the wait runs in short slices (bounded by the
                    # remaining deadline budget) and re-checks the
                    # token each wakeup, so DELETE /queries/<id> or a
                    # blown queryDeadlineMs lands within ~one slice
                    # instead of after queueTimeoutMs
                    self._cv.wait(lifecycle.wait_slice(remaining))
                    lifecycle.checkpoint("queue_wait")
            finally:
                self.queued -= 1
                self._gauges()
            self.running += 1
            self._count("service_admitted")
            self._gauges()
            self.on_event("admitted", query_id)

    def release(self) -> None:
        with self._cv:
            self.running -= 1
            self._gauges()
            self._cv.notify()

    class _Slot:
        def __init__(self, ctl: "AdmissionController", query_id: str):
            self._ctl = ctl
            self._query_id = query_id

        def __enter__(self):
            self._ctl.acquire(self._query_id)
            return self

        def __exit__(self, *exc):
            self._ctl.release()
            return False

    def slot(self, query_id: str = "") -> "_Slot":
        return self._Slot(self, query_id)

    def stats(self) -> Dict[str, Optional[int]]:
        with self._cv:
            return {"running": self.running, "queued": self.queued,
                    "max_concurrent": self.max_concurrent,
                    "queue_depth": self.queue_depth}
