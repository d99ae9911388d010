"""Query lifecycle control: cooperative cancellation and end-to-end
deadlines (the port of `spark_tpu/execution/lifecycle.py`; reference:
`SparkContext.cancelJobGroup` / `cancelStage`).

A launched CUDA kernel runs to its end, but the engine owns a set of
HOST boundaries: chunk loops, stage-attempt entries, retry backoffs, the
wait for a stage's device work. One cooperative token is planted there:

- ``CancelToken`` — a thread-safe cancel flag plus an optional monotonic
  deadline (``spark_tpu.execution.queryDeadlineMs``), installed per
  query execution in a ContextVar, so the deep loops need no new
  arguments.
- ``checkpoint(where)`` — the boundary call: fires the ``cancel_point``
  fault seam, then raises ``QueryCancelledError`` /
  ``QueryDeadlineError`` when the installed token says stop. Wired at
  every chunk (ChunkRetrier), stage-attempt entry, scan ingest and
  retry-backoff entry.
- ``sleep(seconds)`` — the interruptible sleep of every cancellable path
  (RetryPolicy backoff, the ``slow`` fault): wakes on cancel, caps at
  the remaining deadline budget and raises instead of returning into a
  dead query.
- ``wait_slice(remaining_s)`` — caps one blocking wait (the prefetch
  consumer's wait for a decoded chunk) to a short slice bounded by the
  remaining deadline budget, so the waiter checks the token in between.

Both errors classify as ``FailureClass.CANCELLED``: the recovery ladder
re-raises them at once.

Token registry: ``enter_query_scope`` (called at every execute_batch /
collect entry) registers the token under ``(app_id, query_id)``, so
``session.cancel(query_id)`` reaches a query running on another thread.
A nested execution (a scalar subquery, a cached subtree) shares the
outer token. A cancelled or deadlined query releases what it holds (the
prefetch worker is joined), and the same query run again right after is
byte-identical to an uninterrupted run. The SQL service's leases and
its own query map come with the service.
"""

from __future__ import annotations

import threading
import time
from contextvars import ContextVar
from typing import Dict, Optional, Tuple

from ..testing import faults

DEADLINE_KEY = "spark_tpu.execution.queryDeadlineMs"


class QueryCancelledError(RuntimeError):
    """The query was cancelled (session.cancel) and stopped at the next
    cooperative boundary."""

    code = "QUERY_CANCELLED"


class QueryDeadlineError(RuntimeError):
    """The query exceeded its end-to-end deadline
    (spark_tpu.execution.queryDeadlineMs). Distinct from the per-stage
    TIMEOUT class: a blown deadline stops the recovery ladder instead of
    retrying through it."""

    code = "QUERY_DEADLINE_EXCEEDED"


class CancelToken:
    """Thread-safe cancel flag + optional monotonic deadline. `cancel()`
    may be called from any thread; `check()` runs on the query thread at
    every cooperative boundary."""

    def __init__(self, deadline_ms: Optional[float] = None):
        self._event = threading.Event()
        self.deadline_ms = float(deadline_ms) if deadline_ms else None
        self.deadline = (time.monotonic() + self.deadline_ms / 1e3
                         if self.deadline_ms else None)

    def cancel(self) -> None:
        """Idempotent: the query stops at its next boundary; waiters
        parked in `wait()` wake at once."""
        self._event.set()

    @property
    def cancelled(self) -> bool:
        return self._event.is_set()

    def remaining_s(self) -> Optional[float]:
        """Deadline budget left (negative = blown); None = no deadline."""
        if self.deadline is None:
            return None
        return self.deadline - time.monotonic()

    def expired(self) -> bool:
        rem = self.remaining_s()
        return rem is not None and rem <= 0

    def check(self, where: str = "") -> None:
        """Raise the structured error when this query must stop."""
        at = f" at {where}" if where else ""
        if self._event.is_set():
            raise QueryCancelledError(f"query cancelled{at}")
        if self.expired():
            raise QueryDeadlineError(
                f"query exceeded queryDeadlineMs="
                f"{self.deadline_ms:g}{at}")

    def wait(self, seconds: float) -> None:
        """Interruptible bounded sleep: wakes on cancel, caps at the
        remaining deadline budget, raises on either. A capped wait raises
        QueryDeadlineError: the full sleep would have outrun the
        budget."""
        s = max(0.0, float(seconds))
        rem = self.remaining_s()
        capped = rem is not None and rem < s
        if capped:
            s = max(rem, 0.0)
        if s > 0:
            self._event.wait(s)
        if self._event.is_set():
            raise QueryCancelledError("query cancelled during wait")
        if capped or self.expired():
            raise QueryDeadlineError(
                f"query exceeded queryDeadlineMs={self.deadline_ms:g} "
                f"during wait")


#: the token of the query execution running in the current context
_TOKEN: ContextVar[Optional[CancelToken]] = ContextVar(
    "spark_tpu_torch_cancel_token", default=None)


def install(token: CancelToken):
    """Install `token` for the current context; returns the ContextVar
    reset token for `uninstall`."""
    return _TOKEN.set(token)


def uninstall(ctx_token) -> None:
    _TOKEN.reset(ctx_token)


def current_token() -> Optional[CancelToken]:
    return _TOKEN.get()


def checkpoint(where: str = "") -> None:
    """The cooperative boundary: fire the `cancel_point` fault seam (a
    `cancel_point:cancel:n` rule cancels the installed token at the nth
    boundary), then raise if the installed token says stop."""
    faults.fire("cancel_point")
    tok = _TOKEN.get()
    if tok is not None:
        tok.check(where)


def sleep(seconds: float) -> None:
    """Interruptible sleep for cancellable paths: plain time.sleep
    without a token."""
    tok = _TOKEN.get()
    if tok is None:
        time.sleep(seconds)
    else:
        tok.wait(seconds)


def wait_slice(remaining_s: Optional[float],
               poll_s: float = 0.05) -> Optional[float]:
    """Cap one condition-variable wait: without a token, the caller's own
    remaining timeout (None = forever); with one, a short poll slice
    also bounded by the remaining deadline budget."""
    tok = _TOKEN.get()
    if tok is None:
        return remaining_s
    s = poll_s
    if remaining_s is not None:
        s = min(s, remaining_s)
    rem = tok.remaining_s()
    if rem is not None:
        s = min(s, max(rem, 0.0))
    return max(s, 1e-3)


# ---------------------------------------------------------------------------
# Token registry: session.cancel(query_id) -> the token of a query running
# on another thread
# ---------------------------------------------------------------------------

_TOKENS: Dict[Tuple[str, int], CancelToken] = {}
_TOKENS_LOCK = threading.Lock()


def enter_query_scope(app_id: str, query_id: int, conf):
    """Open the lifecycle scope of a query execution: install a fresh
    token (deadline armed from queryDeadlineMs) unless an outer scope
    already installed one, and register it for session.cancel. Returns
    an opaque scope for `exit_query_scope`."""
    tok = _TOKEN.get()
    created = None
    if tok is None:
        ms = float(conf.get(DEADLINE_KEY))
        tok = CancelToken(deadline_ms=ms if ms > 0 else None)
        created = _TOKEN.set(tok)
    key = (app_id, int(query_id))
    with _TOKENS_LOCK:
        # a nested scope under the same key (collect() wraps
        # execute_batch) leaves the registration to the outer scope
        inserted = key not in _TOKENS
        if inserted:
            _TOKENS[key] = tok
    return (key, created, inserted)


def exit_query_scope(scope) -> None:
    if scope is None:
        return
    key, created, inserted = scope
    if inserted:
        with _TOKENS_LOCK:
            _TOKENS.pop(key, None)
    if created is not None:
        _TOKEN.reset(created)


def cancel(app_id: str, query_id: int) -> bool:
    """Cancel the identified running query (the session.cancel seat).
    False when no such execution is registered."""
    with _TOKENS_LOCK:
        tok = _TOKENS.get((app_id, int(query_id)))
    if tok is None:
        return False
    tok.cancel()
    return True


def cancel_current() -> None:
    """Cancel the token installed in this context — the `cancel` fault's
    effect: the next checkpoint raises."""
    tok = _TOKEN.get()
    if tok is not None:
        tok.cancel()
