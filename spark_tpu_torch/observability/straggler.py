"""Straggler detection over the per-shard telemetry stream (the port of
`spark_tpu/observability/straggler.py`; the elastic rebalancer,
`parallel/elastic.py`, acts on its `on_straggler` events).

The speculation seat (`TaskSetManager.checkSpeculatableTasks`, SURVEY
section 2.5), sized to gang SPMD: there are no independent task
attempts to re-launch — a slow shard stalls every chunk of the gang —
so the monitor's job is DETECTION: identify which mesh position (and
host) is consistently slow so the elastic rebalancer can move chunk
rows away from it (`parallel/elastic.py`), and so operators
see the flag live (`straggler_flagged` counter, `on_straggler` event)
instead of diagnosing a 3x-slow query from wall-clock alone.

Signal: the per-shard completion wait (`wait_ms`) the mesh chunk
drivers' telemetry measures at each chunk boundary
(ShardStreamTelemetry) — walking the per-shard output pieces in mesh
order, a straggling device inflates its own block-until-ready window
while shards that kept up read back instantly. The monitor keeps a
rolling window of waits per (query, shard) and flags a shard once

    samples >= spark_tpu.sql.straggler.minChunks
    and median(shard) >  factor * median(all shards' medians)
    and median(shard) >= straggler.minLatencyMs   (noise floor)

Each (query, shard) flags at most once. Detection is conf-read at
event time (the sinks idiom), costs a few comparisons per chunk, and
— like every listener — can never fail a query (the bus isolates it).
"""

from __future__ import annotations

import statistics
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Set, Tuple

from .listener import QueryListener, ShardChunkEvent, StragglerEvent

FACTOR_KEY = "spark_tpu.sql.straggler.factor"
MIN_CHUNKS_KEY = "spark_tpu.sql.straggler.minChunks"
MIN_LATENCY_KEY = "spark_tpu.sql.straggler.minLatencyMs"

#: rolling window of per-chunk waits kept per (query, shard) — medians
#: over a bounded recent window track a shard that turns slow mid-query
WINDOW = 32

#: completed-query flag sets retained for report() (bounded)
_REPORT_BOUND = 64

#: queries tracked live at once. on_query_end is the precise cleanup,
#: but it only fires when the executor observes events — with
#: shardSpans=on and NO other observability output, on_shard_records
#: still streams, so the live maps must self-bound (oldest query
#: evicted) or a long-lived session leaks one entry per mesh query.
_LIVE_BOUND = 16


def evaluate_waits(waits_by_shard: Dict[int, List[float]],
                   factor: float, min_chunks: int, floor_ms: float
                   ) -> Tuple[Dict[int, float], Optional[float],
                              Set[int]]:
    """THE detection rule, as one pure function — (medians, baseline,
    flagged shards) over already-window-trimmed per-shard waits.
    Shared by the live monitor's _evaluate and the offline
    history.straggler_report so the two verdicts cannot drift:

    - a shard is `ready` once it has min_chunks samples; only ready
      shards feed the baseline or can be flagged;
    - baseline = median of ready shards' medians (None when fewer
      than two shards are ready — no baseline, no flags);
    - flag when median > factor * baseline and median >= floor_ms.
    """
    medians = {s: statistics.median(w)
               for s, w in waits_by_shard.items() if w}
    ready = {s: m for s, m in medians.items()
             if len(waits_by_shard[s]) >= min_chunks}
    baseline = statistics.median(sorted(ready.values())) \
        if len(ready) >= 2 else None
    flagged: Set[int] = set()
    if baseline is not None and factor > 0:
        for s, m in ready.items():
            if m >= floor_ms and m > factor * baseline:
                flagged.add(s)
    return medians, baseline, flagged


class StragglerMonitor(QueryListener):
    """Built-in bus subscriber: rolling per-shard chunk-wait medians
    with factor-threshold flagging. `session.add_listener` installs it
    by default; find it with `StragglerMonitor.of(session)`."""

    _builtin = True

    def __init__(self, session):
        self._session = session
        self._lock = threading.Lock()
        #: query_id -> shard -> deque of recent wait_ms
        self._waits: Dict[int, Dict[int, deque]] = {}
        #: query_id -> shard -> host (from the records)
        self._hosts: Dict[int, Dict[int, int]] = {}
        #: query_id -> flagged shard set (live + retained post-query)
        self._flagged: "OrderedDict[int, Set[int]]" = OrderedDict()

    @staticmethod
    def of(session) -> Optional["StragglerMonitor"]:
        for li in session.listeners.listeners:
            if isinstance(li, StragglerMonitor):
                return li
        return None

    def flagged(self, query_id: int) -> Set[int]:
        with self._lock:
            return set(self._flagged.get(query_id, ()))

    def report(self) -> Dict[int, Set[int]]:
        """{query_id: flagged shards} for recently seen queries."""
        with self._lock:
            return {q: set(s) for q, s in self._flagged.items() if s}

    # -- bus callbacks ------------------------------------------------------

    def on_shard_records(self, event: ShardChunkEvent) -> None:
        conf = self._session.conf
        factor = float(conf.get(FACTOR_KEY))
        if factor <= 0:
            return
        min_chunks = int(conf.get(MIN_CHUNKS_KEY))
        floor_ms = float(conf.get(MIN_LATENCY_KEY))
        with self._lock:
            waits = self._waits.setdefault(event.query_id, {})
            hosts = self._hosts.setdefault(event.query_id, {})
            # self-bound the live maps: insertion order == query order,
            # so dropping the first key evicts the oldest query (see
            # _LIVE_BOUND — on_query_end may never fire). Never evict
            # the query being recorded: a long-running stream that
            # became the oldest entry would have its window silently
            # reset every chunk and could never accumulate minChunks.
            while len(self._waits) > _LIVE_BOUND:
                old = next(k for k in self._waits
                           if k != event.query_id)
                self._waits.pop(old, None)
                self._hosts.pop(old, None)
            while len(self._flagged) > _REPORT_BOUND:
                self._flagged.popitem(last=False)
            # window >= minChunks: a minChunks above the default
            # rolling window must widen it, not silently make the
            # `ready` gate unsatisfiable (detection would turn off
            # with no indication)
            window = max(WINDOW, min_chunks)
            for rec in event.records:
                shard = rec.get("shard")
                if shard is None or rec.get("phase") != "compute":
                    continue
                waits.setdefault(int(shard), deque(maxlen=window)) \
                    .append(float(rec.get("wait_ms") or 0.0))
                hosts[int(shard)] = int(rec.get("host") or 0)
            newly = self._evaluate(event.query_id, factor, min_chunks,
                                   floor_ms)
        # post OUTSIDE the lock: a listener consuming on_straggler may
        # call back into flagged()/report()
        for shard, median, baseline, n in newly:
            self._session.metrics.counter("straggler_flagged").inc()
            self._session.listeners.post("on_straggler", StragglerEvent(
                query_id=event.query_id, ts=time.time(), shard=shard,
                host=self._hosts.get(event.query_id, {}).get(shard, 0),
                median_ms=round(median, 3),
                baseline_ms=round(baseline, 3), chunks=n, factor=factor))

    def on_query_end(self, event) -> None:
        with self._lock:
            self._waits.pop(event.query_id, None)
            self._hosts.pop(event.query_id, None)
            # retain the flag set for report(), bounded
            self._flagged.setdefault(event.query_id, set())
            while len(self._flagged) > _REPORT_BOUND:
                self._flagged.popitem(last=False)

    # -- detection (lock held) ----------------------------------------------

    def _evaluate(self, query_id: int, factor: float, min_chunks: int,
                  floor_ms: float):
        waits = self._waits.get(query_id) or {}
        medians, baseline, flag_now = evaluate_waits(
            {s: list(w) for s, w in waits.items()},
            factor, min_chunks, floor_ms)
        flagged = self._flagged.setdefault(query_id, set())
        newly = []
        for shard in sorted(flag_now - flagged):
            flagged.add(shard)
            newly.append((shard, medians[shard], baseline,
                          len(waits[shard])))
        return newly
