"""Long-lived concurrent SQL service (the port of `spark_tpu/service/`;
the hive-thriftserver analog).

The engine below this package is single-query: one session, one
driver thread, per-query budgets. This package is the serving layer
that turns it into a long-lived multi-session server on one device
(`HiveThriftServer2.scala:44` seat):

- ``arbiter``: the cross-query device-memory arbiter — ONE shared lease
  pool over the card's memory (replacing per-query `deviceBudget`
  reads) and the size-bounded plan-fingerprint result cache every
  pooled session shares (`UnifiedMemoryManager.scala:49` +
  `CacheManager.scala` seats);
- ``admission``: bounded-queue admission control
  (`service.{maxConcurrent,queueDepth,queueTimeoutMs}`) with
  structured rejection/timeout errors;
- ``pool``: the session pool — per-session conf overlays on the
  config registry, one shared metrics registry, serialized per-session
  execution;
- ``query_history``: the bounded per-query detail store behind the
  timeline and plan endpoints;
- ``server``: the HTTP JSON endpoint (stdlib http.server):
  `POST /sql`, `GET /queries/<id>`, `GET /metrics` (Prometheus text),
  `GET /healthz`, `/status`, `/debug/bundle`;
- ``fleet``: the crash-only serving fleet -- a supervisor and router
  over N `SqlService` worker processes sharing one card (`python -m
  spark_tpu_torch.service.fleet`).

`arbiter` is imported eagerly (the executor's lease scopes and the
device cache's gates use it); the HTTP machinery loads lazily.
"""

from . import arbiter  # noqa: F401

__all__ = ["arbiter", "SqlService", "SessionPool", "AdmissionController",
           "AdmissionRejected", "AdmissionTimeout", "FleetSupervisor"]


def __getattr__(name):
    if name == "SqlService":
        from .server import SqlService
        return SqlService
    if name == "FleetSupervisor":
        from .fleet import FleetSupervisor
        return FleetSupervisor
    if name == "SessionPool":
        from .pool import SessionPool
        return SessionPool
    if name in ("AdmissionController", "AdmissionRejected",
                "AdmissionTimeout"):
        from . import admission
        return getattr(admission, name)
    raise AttributeError(name)
