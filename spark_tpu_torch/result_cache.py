"""Plan-fingerprint result cache: a byte-bounded LRU of materialized
Arrow tables (the port of the standalone part of `ResultCache` in
`spark_tpu/service/arbiter.py`; reference: `CacheManager.scala`).

A session keeps one as its data cache: `cache()`-marked plans fill it
after their first action, and WITH-clause views fill it for one
statement. The arbiter's cache shared by pooled sessions is not ported.
"""

from __future__ import annotations

from collections import OrderedDict


class ResultCache:
    """Size-bounded LRU of materialized Arrow tables keyed by plan
    fingerprint, with the subset of the mapping protocol the executor
    and the session use (one session's, so no lock). `max_bytes=0` disables bounding.
    `evictions` and `rejected` count the tables the bound pushed out or
    kept out."""

    def __init__(self, max_bytes: int = 0):
        self.max_bytes = int(max_bytes)
        self.evictions = 0
        self.rejected = 0
        self._entries: "OrderedDict[str, tuple]" = OrderedDict()
        self._bytes = 0

    def get(self, fp, default=None):
        entry = self._entries.get(fp)
        if entry is None:
            return default
        self._entries.move_to_end(fp)
        return entry[0]

    def __contains__(self, fp) -> bool:
        return fp in self._entries

    def __setitem__(self, fp, table) -> None:
        nbytes = int(getattr(table, "nbytes", 0))
        old = self._entries.pop(fp, None)
        if old is not None:
            self._bytes -= old[1]
        if self.max_bytes > 0 and nbytes > self.max_bytes:
            self.rejected += 1
            return  # larger than the whole bound: don't thrash
        self._entries[fp] = (table, nbytes)
        self._bytes += nbytes
        while self.max_bytes > 0 and self._bytes > self.max_bytes \
                and len(self._entries) > 1:
            _, (_, evicted) = self._entries.popitem(last=False)
            self._bytes -= evicted
            self.evictions += 1

    def pop(self, fp, default=None):
        entry = self._entries.pop(fp, None)
        if entry is None:
            return default
        self._bytes -= entry[1]
        return entry[0]

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def nbytes(self) -> int:
        return self._bytes
