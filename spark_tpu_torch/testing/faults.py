"""Conf-driven deterministic fault injection for chaos testing (the port
of `spark_tpu/testing/faults.py`).

Named injection points sit at the host-side seams of execution and are
armed from one conf string:

    spark_tpu.faults.inject = "stream_chunk:unavailable:2,scan_load:resource_exhausted:1"

Grammar (comma-separated rules):

    rule  := site ":" fault ":" nth [":" arg]
    site  := one of KNOWN_SITES (the wired seams)
    fault := resource_exhausted | unavailable | deadline | fatal | slow
             | cancel
    nth   := 1-based hit count of `site` at which the rule fires
    arg   := fault argument (only `slow`: sleep milliseconds, default 100)

Each rule fires exactly once (later hits of the same site pass), so a
retry that re-executes the site succeeds: the chaos tests prove
recovery, not permanent outage. Several rules on one site with different
`nth` model repeated failures.

Raising faults carry messages shaped like real device errors
("RESOURCE_EXHAUSTED: ...", "UNAVAILABLE: ..."), so the failure taxonomy
(execution/failures.py) classifies synthetic and real errors through the
same path. `slow` sleeps on the interruptible lifecycle wait instead of
raising: the trigger for the stage wall-clock deadline
(spark_tpu.execution.stageTimeoutMs). `cancel` cancels the installed
query token, so the boundary that fired the rule raises
QueryCancelledError.

The seams this package wires:

- `scan_load` fires at every whole-table load (io/sources.py), the
  host -> device ingest edge;
- `stage_run` fires before each run of the plan (execution/executor.py);
- `join_build` fires at each join's build-side sort (execution/join.py),
  once per join per run: eager torch has no trace, so it counts runs
  where the JAX package counts compiles;
- `stream_chunk` fires once per chunk attempt of the streaming loops
  (execution/recovery.py), so replays re-fire;
- `ingest_prefetch` fires once per chunk host-decode attempt on the
  prefetcher's worker thread (io/sources.py);
- `udf_batch` fires once per attempt of a UDF worker-lane batch, inside
  the step (execution/python_eval.py): a `fatal` rule kills the
  in-flight worker, and the batch replays on a fresh one;
- `udf_worker_spawn` fires before each UDF worker spawn
  (udf_worker/pool.py);
- `cancel_point` fires at every cooperative cancellation boundary
  (execution/lifecycle.py `checkpoint`);
- `mesh` fires before each run of the plan on a mesh
  (execution/executor.py), where the JAX package fires it once per mesh
  stage compile; a fault there takes the mesh failure ladder;
- `shuffle` fires once per exchange per mesh run, on shard 0, before any
  row moves (parallel/shuffle.py), as the JAX package fires it once per
  exchange lowering;
- `mesh_checkpoint` fires at each mesh-stream snapshot point, before
  the snapshot is taken (execution/recovery.py), so a fault there
  models a shard lost mid-stream and leaves the previous checkpoint;
- `shard_chunk` fires once per (chunk, shard) inside the per-shard
  telemetry's timed wait (observability/spans.py): hit chunk*n+shard+1
  is one shard of one chunk, and a `slow` rule makes that shard a
  straggler;
- `mesh_restart` fires at each gang-restart attempt
  (parallel/elastic.py): a fault there fails that attempt, consuming
  its budget, so the ladder still lands on the single-device rung;
- `decommission` fires at the drain boundary of a mesh stream, before
  the forced checkpoint (execution/streaming_agg.py); a fault there
  takes the mesh failure ladder.

The four `stream_*` micro-batch seams (streaming.py and
execution/state_store.py) each fire BEFORE their boundary's action, so
a `fatal` rule models a hard crash at that point with nothing of the
action persisted: `stream_source_list` before the loop polls the source
for new offsets, `stream_offset_write` before the planned range lands in
the offset log, `stream_state_commit` at every state-store commit
(delta or snapshot, nothing written yet), and `stream_sink_emit` before
the batch's output reaches the sink. The unattended seams:
`stream_net_connect` before every connect attempt of the socket source
and `stream_net_recv` before every frame read (io/network_source.py),
`trigger_tick` at the top of every tick of the trigger loop
(streaming.py), and `state_spill` before every partition write of the
spilled event-time state (execution/external.py).

`fleet_worker` fires before each worker-subprocess spawn attempt in
the fleet supervisor (service/fleet.py -- the `udf_worker_spawn`
pattern one tier up): a raising rule models a worker that dies at
boot, which rides the supervisor's RetryPolicy restart ladder and, at
`restartMaxPerWindow` crashes within the window, trips the flap
breaker into quarantine.

The JAX package's `stage_compile` and `compile_cache_load` seams have
no counterpart: eager torch has no compile step, and the port leaves
the compiled-stage cache out by choice (service/fleet.py says why).
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import List, Optional, Tuple

INJECT_KEY = "spark_tpu.faults.inject"

#: the wired seams: every site here has a `faults.fire(site)` call in
#: the package. `_parse` validates rule sites against it, so a typo'd
#: site fails at arm time instead of silently never firing.
KNOWN_SITES = ("scan_load", "stage_run", "join_build", "stream_chunk",
               "ingest_prefetch", "cancel_point", "udf_batch",
               "udf_worker_spawn", "mesh", "shuffle", "mesh_checkpoint",
               "shard_chunk", "mesh_restart", "decommission",
               "stream_source_list", "stream_offset_write",
               "stream_state_commit", "stream_sink_emit",
               "stream_net_connect", "stream_net_recv", "trigger_tick",
               "state_spill", "fleet_worker")

#: test-registered extra seams (register_site)
_EXTRA_SITES: set = set()


def register_site(site: str) -> str:
    """Declare an ad-hoc injection seam (tests planting their own
    `faults.fire(site)` points). Returns the site."""
    _EXTRA_SITES.add(site)
    return site


def unregister_site(site: str) -> None:
    _EXTRA_SITES.discard(site)


@contextlib.contextmanager
def scoped_site(site: str):
    """`register_site` bounded to a with-block (the test idiom)."""
    register_site(site)
    try:
        yield site
    finally:
        unregister_site(site)


def known_sites() -> tuple:
    return KNOWN_SITES + tuple(sorted(_EXTRA_SITES))


#: raising fault classes -> message templates shaped like real errors
_MESSAGES = {
    "resource_exhausted":
        "RESOURCE_EXHAUSTED: injected: out of memory while allocating "
        "device buffer at {site} (hit {n})",
    "unavailable":
        "UNAVAILABLE: injected: backend endpoint unreachable at "
        "{site} (hit {n})",
    "deadline":
        "DEADLINE_EXCEEDED: injected: operation deadline exceeded at "
        "{site} (hit {n})",
    "fatal":
        "INTERNAL: injected: unrecoverable failure at {site} (hit {n})",
}

FAULT_CLASSES = tuple(_MESSAGES) + ("slow", "cancel")


class FaultInjected(Exception):
    """Synthetic error raised by an armed injection point. Carries the
    site and fault class so the taxonomy classifies without string
    matching."""

    def __init__(self, site: str, fault: str, message: str):
        super().__init__(message)
        self.site = site
        self.fault = fault


@dataclass
class _Rule:
    site: str
    fault: str
    nth: int
    arg: Optional[float] = None
    fired: bool = False


def _parse(spec: str) -> List[_Rule]:
    rules = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        bits = part.split(":")
        if len(bits) not in (3, 4):
            raise ValueError(
                f"bad fault rule {part!r}: want site:fault:nth[:arg]")
        site, fault = bits[0].strip(), bits[1].strip()
        if site not in known_sites():
            raise ValueError(
                f"unknown fault site {site!r} in rule {part!r}: no "
                f"faults.fire({site!r}) seam is wired, so the rule "
                f"could never fire; known sites: {known_sites()}")
        if fault not in FAULT_CLASSES:
            raise ValueError(
                f"unknown fault class {fault!r} in {part!r}; "
                f"known: {FAULT_CLASSES}")
        nth = int(bits[2])
        if nth < 1:
            raise ValueError(f"hit count must be >= 1 in {part!r}")
        arg = float(bits[3]) if len(bits) == 4 else None
        rules.append(_Rule(site, fault, nth, arg))
    return rules


class FaultPlan:
    """Parsed spec + per-site hit counters + a log of fired rules.

    Hit counting is lock-guarded: `ingest_prefetch` fires from the
    prefetcher's worker thread. Within one thread a site's nth targeting
    is deterministic; across threads only the count is."""

    def __init__(self, spec: str):
        self.spec = spec
        self.rules = _parse(spec)
        self.hits = {}
        self.fired_log: List[Tuple[str, int, str]] = []
        self._lock = threading.Lock()

    def fire(self, site: str) -> None:
        with self._lock:
            n = self.hits.get(site, 0) + 1
            self.hits[site] = n
            due = []
            for r in self.rules:
                if r.fired or r.site != site or r.nth != n:
                    continue
                r.fired = True
                self.fired_log.append((site, n, r.fault))
                due.append(r)
        # effects run outside the lock: a `slow` sleep must not
        # serialize other sites' counting
        for r in due:
            if r.fault == "slow":
                from ..execution import lifecycle
                lifecycle.sleep(
                    (r.arg if r.arg is not None else 100.0) / 1e3)
                continue
            if r.fault == "cancel":
                from ..execution import lifecycle
                lifecycle.cancel_current()
                continue
            raise FaultInjected(
                site, r.fault, _MESSAGES[r.fault].format(site=site, n=n))


#: the single armed plan, shared by every thread that reaches a seam
_PLAN: Optional[FaultPlan] = None


def arm(conf) -> None:
    """Arm/disarm from conf, at every execution entry: an unchanged spec
    keeps its hit counters (multi-execution scenarios count across
    queries); a changed spec starts fresh."""
    global _PLAN
    spec = str(conf.get(INJECT_KEY) or "").strip()
    if not spec:
        _PLAN = None
        return
    if _PLAN is None or _PLAN.spec != spec:
        _PLAN = FaultPlan(spec)


def reset() -> None:
    """Drop the armed plan and its hit counters."""
    global _PLAN
    _PLAN = None


def active() -> Optional[FaultPlan]:
    return _PLAN


def fire(site: str) -> None:
    """The injection point: a no-op unless a plan is armed."""
    if _PLAN is not None:
        _PLAN.fire(site)


@contextlib.contextmanager
def inject(conf, spec: str):
    """Scoped injection for tests: set the conf spec with fresh hit
    counters, restore and disarm on exit. Yields the armed FaultPlan so
    assertions can read `fired_log`."""
    old = conf.get(INJECT_KEY)
    conf.set(INJECT_KEY, spec)
    reset()
    arm(conf)
    try:
        yield active()
    finally:
        conf.set(INJECT_KEY, old if old else "")
        reset()
