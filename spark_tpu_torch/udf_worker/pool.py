"""Reusable CPython subprocess worker pool for the out-of-process UDF
lane (the port of `spark_tpu/udf_worker/pool.py`).

The `PythonWorkerFactory` seat: workers are spawned once (`sys.executable
worker.py` through `subprocess.Popen`, never `multiprocessing`: the
parent holds a CUDA context that a forked child must not inherit;
PING/PONG handshake timed into `udf_worker_spawn_ms`), kept idle between
batches AND between queries (reuse amortizes the interpreter start the
way the reference's daemon-forked workers do), bounded by
`spark_tpu.sql.udf.pool.maxWorkers`, and reaped after
`udf.pool.idleTimeoutMs` without a checkout.

Concurrency: `_cv` is the single pool lock guarding
`_idle`/`_live`/`_all`. NOTHING that can fire a fault seam or a
cancellation checkpoint runs while `_cv` is held: `lifecycle.checkpoint`
and `faults.fire` happen outside the lock, spawns happen outside the
lock (an interpreter start must not serialize unrelated checkouts),
kills happen outside the lock. A checked-out `WorkerHandle` is confined
to its query thread — only the hand-off back into `_idle` is locked.
(The JAX package ranks this lock for its lock checker, which comes with
the port's serving slice.)

Failure surface: a worker that dies mid-batch (SIGKILL, segfault in
user code, OOM-killer) raises `UdfWorkerLost` whose message carries the
UNAVAILABLE token, so the failure taxonomy classifies it TRANSIENT and
ChunkRetrier replays exactly the in-flight batch on a fresh worker. A
worker that exceeds `udf.batchTimeoutMs` raises StageTimeoutError
(TIMEOUT — same replay path). A worker that died BETWEEN queries is
reaped lazily at checkout (`poll()` before reuse), so the next query's
first batch gets a live worker instead of a stale-pipe
BrokenPipeError.
"""

from __future__ import annotations

import os
import select
import subprocess
import sys
import threading
import time
from typing import List, Optional, Tuple

from ..execution import lifecycle
from ..execution.failures import StageTimeoutError
from ..testing import faults
from . import protocol

#: PING->PONG handshake budget for a fresh interpreter (generous: the
#: child imports numpy/pandas/pyarrow before it can answer)
SPAWN_TIMEOUT_S = 30.0

_WORKER_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "worker.py")


class UdfWorkerLost(RuntimeError):
    """The worker process died mid-batch (pipe EOF / broken pipe). The
    UNAVAILABLE token classifies this TRANSIENT (execution/failures.py)
    so ChunkRetrier replays the in-flight batch on a fresh worker."""

    def __init__(self, pid: int, detail: str):
        super().__init__(
            f"UNAVAILABLE: python udf worker pid {pid} died mid-batch "
            f"({detail})")
        self.pid = pid


class WorkerHandle:
    """One live worker subprocess, checked out to a single query thread
    at a time (thread-confined; hand-off under the pool cv). All reads
    go through `os.read` on the raw stdout fd with `select` timeouts —
    never the BufferedReader — so a poll/deadline can interrupt a read
    without leaving bytes stranded in a Python-side buffer."""

    def __init__(self, proc: subprocess.Popen, spawn_ms: float):
        self.proc = proc
        self.pid = proc.pid
        self.spawn_ms = spawn_ms
        self.last_used = time.monotonic()
        self._rbuf = bytearray()

    # -- timed framed I/O ---------------------------------------------------

    def _read_exact(self, n: int, deadline: Optional[float], poll) -> bytes:
        fd = self.proc.stdout.fileno()
        while len(self._rbuf) < n:
            if poll is not None:
                poll()
            slice_s = 0.05
            if deadline is not None:
                rem = deadline - time.monotonic()
                if rem <= 0:
                    raise _BatchTimeout()
                slice_s = min(slice_s, max(rem, 1e-3))
            ready, _, _ = select.select([fd], [], [], slice_s)
            if not ready:
                continue
            chunk = os.read(fd, 1 << 20)
            if not chunk:
                raise UdfWorkerLost(
                    self.pid, f"pipe closed, exit {self.proc.poll()}")
            self._rbuf += chunk
        out = bytes(self._rbuf[:n])
        del self._rbuf[:n]
        return out

    def _read_frame(self, deadline: Optional[float],
                    poll) -> Tuple[bytes, bytes]:
        header = self._read_exact(protocol._HEADER.size, deadline, poll)
        ftype, length = protocol._HEADER.unpack(header)
        if length > protocol.MAX_FRAME_BYTES:
            raise protocol.ProtocolError(
                f"frame length {length} exceeds bound")
        payload = (self._read_exact(length, deadline, poll)
                   if length else b"")
        return ftype, payload

    def _write_frame(self, ftype: bytes, payload: bytes) -> None:
        try:
            protocol.write_frame(self.proc.stdin, ftype, payload)
        except (BrokenPipeError, OSError):
            raise UdfWorkerLost(
                self.pid, f"broken stdin pipe, exit {self.proc.poll()}")

    def handshake(self, timeout_s: float = SPAWN_TIMEOUT_S) -> None:
        self._write_frame(protocol.FRAME_PING, b"")
        deadline = time.monotonic() + timeout_s
        try:
            ftype, _ = self._read_frame(deadline, None)
        except _BatchTimeout:
            raise UdfWorkerLost(
                self.pid, f"no PONG within {timeout_s:g}s of spawn")
        if ftype != protocol.FRAME_PONG:
            raise protocol.ProtocolError(
                f"worker pid {self.pid} answered handshake with "
                f"{ftype!r}, expected PONG")

    def eval(self, payload: bytes, timeout_s: Optional[float] = None,
             poll=None) -> Tuple[bytes, bytes]:
        """One EVAL round-trip. `poll` (if given) runs every ~50ms while
        waiting — the lane passes the cancellation check, so a
        cancel/deadline raises out of here mid-batch instead of waiting
        the worker out. Raises UdfWorkerLost (worker died) or
        StageTimeoutError (batch exceeded udf.batchTimeoutMs)."""
        self._write_frame(protocol.FRAME_EVAL, payload)
        deadline = (time.monotonic() + timeout_s
                    if timeout_s and timeout_s > 0 else None)
        try:
            return self._read_frame(deadline, poll)
        except _BatchTimeout:
            raise StageTimeoutError(
                f"python udf worker pid {self.pid} exceeded "
                f"udf.batchTimeoutMs={timeout_s * 1e3:g} on one batch")

    # -- lifecycle ----------------------------------------------------------

    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self) -> None:
        """Hard-kill and reap (never leaves a zombie: wait() always
        follows the kill)."""
        try:
            if self.proc.poll() is None:
                self.proc.kill()
        except OSError:
            pass
        try:
            self.proc.wait(timeout=10)
        except Exception:
            pass
        for s in (self.proc.stdin, self.proc.stdout):
            try:
                if s is not None:
                    s.close()
            except OSError:
                pass


class _BatchTimeout(Exception):
    """Internal deadline marker; translated to StageTimeoutError (eval)
    or UdfWorkerLost (handshake) at the call boundary."""


class UdfWorkerPool:
    """Bounded pool of reusable UDF workers, shared across the queries
    of one session (worker reuse across queries is the point: spawn
    cost is paid once, not per query)."""

    def __init__(self, max_workers: int, idle_timeout_ms: float = 0.0,
                 metrics=None):
        self.max_workers = max(1, int(max_workers))
        self.idle_timeout_ms = float(idle_timeout_ms)
        self._metrics = metrics
        #: THE pool lock: guards _idle/_live/_all
        self._cv = threading.Condition()
        self._idle: List[WorkerHandle] = []
        #: workers alive or reserved (idle + checked out + mid-spawn)
        self._live = 0
        #: every Popen ever spawned — the leak-check test surface:
        #: after cancel/shutdown, all entries must have poll() != None
        self._all: List[subprocess.Popen] = []

    # -- checkout / checkin -------------------------------------------------

    def checkout(self, timeout_s: Optional[float] = None) -> WorkerHandle:
        """Take an idle worker, or spawn one under the maxWorkers bound,
        or wait for a checkin. The wait is a cooperative boundary:
        `lifecycle.checkpoint` runs outside the lock each iteration, so
        cancel/deadline land within ~one poll slice."""
        t0 = time.monotonic()
        while True:
            lifecycle.checkpoint("udf_pool_wait")
            handle = None
            reserved = False
            to_kill: List[WorkerHandle] = []
            with self._cv:
                self._reap_locked(to_kill)
                if self._idle:
                    handle = self._idle.pop()
                elif self._live < self.max_workers:
                    self._live += 1
                    reserved = True
                else:
                    self._cv.wait(lifecycle.wait_slice(0.25, 0.05) or 0.05)
            for h in to_kill:
                h.kill()
            if handle is not None:
                return handle
            if reserved:
                try:
                    return self._spawn()
                except BaseException:
                    with self._cv:
                        self._live -= 1
                        self._cv.notify_all()
                    raise
            if (timeout_s is not None
                    and time.monotonic() - t0 > timeout_s):
                raise RuntimeError(
                    f"udf worker pool checkout timed out after "
                    f"{timeout_s:g}s (maxWorkers={self.max_workers} all "
                    f"busy)")

    def checkin(self, handle: WorkerHandle) -> None:
        """Return a LIVE worker for reuse (a dead/killed one goes
        through `discard`)."""
        handle.last_used = time.monotonic()
        with self._cv:
            self._idle.append(handle)
            self._cv.notify()

    def discard(self, handle: WorkerHandle) -> None:
        """Drop a checked-out worker (died mid-batch, timed out, or
        cancelled): kill outside the lock, then release its slot."""
        handle.kill()
        with self._cv:
            self._live -= 1
            self._cv.notify()

    def _reap_locked(self, to_kill: List[WorkerHandle]) -> None:
        """Under `_cv`: drop idle workers that died between queries
        (the stale-pipe bugfix — poll() before reuse, so a checkout
        never hands out a corpse) and queue idle-expired ones for an
        outside-the-lock kill."""
        now = time.monotonic()
        keep = []
        for h in self._idle:
            if not h.alive():
                self._live -= 1
                h.proc.poll()  # already dead; poll() reaps the zombie
            elif (self.idle_timeout_ms > 0
                  and (now - h.last_used) * 1e3 > self.idle_timeout_ms):
                self._live -= 1
                to_kill.append(h)
            else:
                keep.append(h)
        self._idle = keep

    # -- spawn --------------------------------------------------------------

    def _spawn(self) -> WorkerHandle:
        """Spawn + handshake one worker, OUTSIDE the pool lock. The
        `udf_worker_spawn` chaos seam fires before the exec so spawn
        failures ride the normal batch-replay path."""
        faults.fire("udf_worker_spawn")
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, _WORKER_PATH],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        handle = WorkerHandle(proc, 0.0)
        try:
            handle.handshake()
        except BaseException:
            handle.kill()
            raise
        handle.spawn_ms = (time.perf_counter() - t0) * 1e3
        if self._metrics is not None:
            self._metrics.counter("udf_worker_spawn_ms").inc(
                int(handle.spawn_ms))
        with self._cv:
            self._all.append(proc)
        return handle

    # -- shutdown / test surface --------------------------------------------

    def shutdown(self) -> None:
        """Kill every idle worker and reap it. Checked-out workers are
        their query thread's to kill (the cancel path kills the
        in-flight handle first, then calls this) — after both, every
        proc in `child_procs()` is dead."""
        with self._cv:
            victims = self._idle
            self._idle = []
            self._live -= len(victims)
            self._cv.notify_all()
        for h in victims:
            h.kill()

    def child_procs(self) -> List[subprocess.Popen]:
        """Every Popen this pool ever spawned (the no-orphan test
        surface: after cancel + shutdown, all must have exited)."""
        with self._cv:
            return list(self._all)

    def idle_count(self) -> int:
        with self._cv:
            return len(self._idle)

    def live_count(self) -> int:
        with self._cv:
            return self._live
