"""Structured failure taxonomy and retry policy for query execution (the
port of `spark_tpu/execution/failures.py`; reference: `TaskSetManager`
and `spark.task.maxFailures`, the DAGScheduler's per-kind reactions).

- TRANSIENT: infrastructure flakes ("UNAVAILABLE", "DEADLINE_EXCEEDED",
  a reset connection) — retried with exponential backoff and jitter
  (`spark_tpu.execution.{maxRetries,backoffMs}`).
- TIMEOUT: a stage attempt blew `spark_tpu.execution.stageTimeoutMs` —
  retried like TRANSIENT.
- OOM: device memory exhausted — `torch.cuda.OutOfMemoryError`, a
  message holding "CUDA out of memory", or the "RESOURCE_EXHAUSTED" form
  the fault seams raise. The executor's degradation ladder handles it
  (evict the device table cache, then re-plan through the chunked
  host-spill paths, then a diagnostic).
- OVERFLOW: static-capacity overflow. Never an exception — it flows as
  flags into the re-plan loop; listed so the taxonomy is total.
- CANCELLED: lifecycle control (`execution/lifecycle.py`): the query was
  cancelled or blew its queryDeadlineMs. Never retried, never degraded.
- FATAL: everything else, including a sticky CUDA error (an illegal
  memory access, a device-side assert, `cudaErrorLaunchFailure`): the
  CUDA context is dead after one, so no retry can succeed; and a user
  function's exception in a UDF worker (`udf_worker.UdfError`). A UDF
  worker that dies mid-batch (`UdfWorkerLost`) says UNAVAILABLE, so it
  is TRANSIENT.

Synthetic faults from `spark_tpu_torch.testing.faults` carry their class
on the exception; real errors classify by type and message tokens, so
both flow through one path. `is_mesh_failure` picks the failures of the
mesh's own path (a broken rendezvous, a collective's peer copy, the
`mesh` fault site): the candidates for the executor's single-device
fallback.
"""

from __future__ import annotations

import random
from enum import Enum
from typing import Optional


class FailureClass(Enum):
    TRANSIENT = "transient"
    TIMEOUT = "timeout"
    OOM = "oom"
    OVERFLOW = "overflow"
    CANCELLED = "cancelled"
    FATAL = "fatal"


class StageTimeoutError(RuntimeError):
    """A stage attempt exceeded spark_tpu.execution.stageTimeoutMs."""


class StageOOMError(RuntimeError):
    """Device memory stayed exhausted through the whole degradation
    ladder; the message names the stage and its capacity stats."""


#: message tokens of retryable infrastructure flakes
_TRANSIENT_TOKENS = (
    "remote_compile", "UNAVAILABLE", "DEADLINE_EXCEEDED", "ABORTED",
    "Connection reset", "Socket closed", "connection attempt",
)

_OOM_TOKENS = (
    "RESOURCE_EXHAUSTED", "Out of memory", "out of memory",
    "Allocator ran out", "OOM while allocating",
)

#: sticky CUDA errors: the context is unusable afterwards, so they are
#: FATAL even where their text holds a transient token
_STICKY_CUDA_TOKENS = (
    "illegal memory access", "device-side assert", "cudaErrorLaunchFailure",
    "unspecified launch failure", "cudaErrorIllegalAddress",
    "misaligned address",
)


#: tokens that mark a failure as coming from the collective path (the
#: port's markers: `parallel/mesh.py` raises MeshCollectiveError with
#: "collective" for a broken rendezvous or a failed peer copy).
#: Deliberately narrow: a bare "mesh" token would also take get_mesh's
#: setup diagnostic ("devices visible"), which must surface.
_MESH_TOKENS = ("collective", "rendezvous", "peer copy", "all_to_all",
                "all_gather", "NCCL")


def is_mesh_failure(exc: BaseException) -> bool:
    """True when the failure points at the mesh/collective path, or is a
    synthetic fault at the `mesh`, `mesh_checkpoint` (a shard lost at a
    snapshot point) or `decommission` (a drain that died at its
    boundary) site: the candidates of the mesh ladder (gang restart,
    then the one-device fallback)."""
    from ..testing.faults import FaultInjected
    if isinstance(exc, FaultInjected):
        return exc.site in ("mesh", "mesh_checkpoint", "decommission")
    msg = f"{type(exc).__name__}: {exc}"
    return any(t in msg for t in _MESH_TOKENS)


def classify(exc: BaseException) -> FailureClass:
    """Map an exception to its failure class. Synthetic faults classify
    by their carried class; real errors by type and message tokens."""
    import torch
    from ..testing.faults import FaultInjected
    from ..udf_worker import UdfError
    from .lifecycle import QueryCancelledError, QueryDeadlineError
    if isinstance(exc, (QueryCancelledError, QueryDeadlineError)):
        return FailureClass.CANCELLED
    if isinstance(exc, StageTimeoutError):
        return FailureClass.TIMEOUT
    if isinstance(exc, UdfError):
        return FailureClass.FATAL  # a user bug, whatever its message says
    if isinstance(exc, FaultInjected):
        if exc.fault == "resource_exhausted":
            return FailureClass.OOM
        if exc.fault in ("unavailable", "deadline"):
            return FailureClass.TRANSIENT
        return FailureClass.FATAL
    if isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError)):
        return FailureClass.OOM
    msg = f"{type(exc).__name__}: {exc}"
    if any(t in msg for t in _STICKY_CUDA_TOKENS):
        return FailureClass.FATAL
    if any(t in msg for t in _OOM_TOKENS):
        return FailureClass.OOM
    if any(t in msg for t in _TRANSIENT_TOKENS):
        return FailureClass.TRANSIENT
    return FailureClass.FATAL


class RetryPolicy:
    """One retry budget per query execution, shared by every failure
    class that retries (TRANSIENT and TIMEOUT): exponential backoff with
    jitter.

    delay_n = backoff_ms * 2^n * uniform(0.5, 1.0)

    The default sleep is the interruptible lifecycle wait: a backoff
    wakes at once when the query is cancelled and is capped by the
    remaining queryDeadlineMs budget. Pass an explicit `sleep` to opt
    out (tests that count slept milliseconds do).
    """

    def __init__(self, max_retries: int, backoff_ms: float,
                 sleep=None, rng: Optional[random.Random] = None):
        self.max_retries = max(0, int(max_retries))
        self.remaining = self.max_retries
        self.backoff_ms = max(0.0, float(backoff_ms))
        self.attempts = 0
        self.total_sleep_ms = 0.0
        self._sleep = sleep
        self._rng = rng or random.Random()

    def attempt_retry(self) -> Optional[float]:
        """Consume one retry and sleep the backoff. Returns the slept
        milliseconds, or None when the budget is exhausted (the caller
        surfaces the error). Raises the lifecycle error when the query
        was cancelled or deadlined."""
        if self.remaining <= 0:
            return None
        from .lifecycle import checkpoint, sleep as _lc_sleep
        checkpoint("retry_backoff")
        if self._sleep is None:
            self._sleep = _lc_sleep
        delay_ms = self.backoff_ms * (2 ** self.attempts)
        delay_ms *= 0.5 + self._rng.random() * 0.5
        if delay_ms > 0:
            self._sleep(delay_ms / 1e3)
        self.attempts += 1
        self.remaining -= 1
        self.total_sleep_ms += delay_ms
        return delay_ms
