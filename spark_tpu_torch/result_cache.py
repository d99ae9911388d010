"""Plan-fingerprint result cache: a byte-bounded, thread-safe LRU of
materialized Arrow tables (the port of `ResultCache` in
`spark_tpu/service/arbiter.py`; reference: `CacheManager.scala`).

A standalone session keeps one as its data cache: `cache()`-marked
plans fill it after their first action, and WITH-clause views fill it
for one statement. The SQL service's arbiter owns one more, bounded by
`spark_tpu.service.resultCacheBytes`, and every pooled session points
its data cache at it (`service/pool.py`), so the pooled sessions of one
service read and fill one cache.
"""

from __future__ import annotations

import threading
from collections import OrderedDict


class ResultCache:
    """Size-bounded LRU of materialized Arrow tables keyed by plan
    fingerprint, with the subset of the mapping protocol the executor
    and the session use. `max_bytes=0` disables bounding. `evictions`
    and `rejected` count the tables the bound pushed out or kept out;
    with a metrics registry they also count as `result_cache_evictions`
    and `result_cache_rejected`."""

    def __init__(self, max_bytes: int = 0, metrics=None):
        self.max_bytes = int(max_bytes)
        self.metrics = metrics
        self._lock = threading.Lock()
        self.evictions = 0
        self.rejected = 0
        self._entries: "OrderedDict[str, tuple]" = OrderedDict()
        self._bytes = 0

    def get(self, fp, default=None):
        with self._lock:
            entry = self._entries.get(fp)
            if entry is None:
                return default
            self._entries.move_to_end(fp)
            return entry[0]

    def __contains__(self, fp) -> bool:
        with self._lock:
            return fp in self._entries

    def __setitem__(self, fp, table) -> None:
        nbytes = int(getattr(table, "nbytes", 0))
        evicted_n = 0
        with self._lock:
            old = self._entries.pop(fp, None)
            if old is not None:
                self._bytes -= old[1]
            if self.max_bytes > 0 and nbytes > self.max_bytes:
                self.rejected += 1
                rejected = True  # larger than the whole bound: don't thrash
            else:
                rejected = False
                self._entries[fp] = (table, nbytes)
                self._bytes += nbytes
                while self.max_bytes > 0 and self._bytes > self.max_bytes \
                        and len(self._entries) > 1:
                    _, (_, evicted) = self._entries.popitem(last=False)
                    self._bytes -= evicted
                    self.evictions += 1
                    evicted_n += 1
        # counters outside the cache lock (a counter is a leaf lock)
        if rejected:
            self._count("result_cache_rejected", 1)
        elif evicted_n:
            self._count("result_cache_evictions", evicted_n)

    def pop(self, fp, default=None):
        with self._lock:
            entry = self._entries.pop(fp, None)
            if entry is None:
                return default
            self._bytes -= entry[1]
            return entry[0]

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def nbytes(self) -> int:
        with self._lock:
            return self._bytes

    def _count(self, name: str, n: int) -> None:
        if self.metrics is not None:
            self.metrics.counter(name).inc(n)
