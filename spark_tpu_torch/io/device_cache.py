"""Device-resident table cache: loaded scans stay on the device across
queries (the port of `spark_tpu/io/device_cache.py`; reference:
`CacheManager.scala:1` and the BlockManager's storage tier).

A process-level LRU over loaded device Batches keyed on (source identity
stamp, pruned columns, pushed filters, torch device), with a byte budget
(`spark_tpu.sql.io.deviceCacheBytes`). Device memory plays the storage
pool of `UnifiedMemoryManager.scala:49`, and LRU eviction its storage
eviction policy.

Source identity stamps make staleness structural rather than time-based:
an Arrow-backed source gets a fresh token per source object
(re-registering a table name creates a new source), and a Parquet source
stamps its file list with (size, mtime) pairs, so rewritten files miss.
The device is part of the key because one process can hold a CPU session
and a CUDA session: a hit never hands one device's batch to the other. A
mesh caches each shard's stripe on its own device, under a key that also
holds the shard's index and the mesh size (`load_scan_shards`), so a
one-device run and a mesh run, or a mesh with every shard on one device,
never share an entry.

Cached batches are shared by every query that hits them. Operators build
new tensors and never write into an input batch's tensors, so a cached
batch stays as it was loaded.

The executor's device-memory ladder calls `CACHE.evict_bytes` (its first
rung frees the storage pool before a retry). `admit_scan_resident` is the
one residency verdict the out-of-core gates read
(`execution/streaming_agg.py`, `execution/external.py`): under a
per-query `spark_tpu.sql.memory.deviceBudget`, a scan stays resident only
when its estimate fits it; with the SQL service's cross-query arbiter
installed (`service/arbiter.py`), only when the shared pool leases it,
evicting unpinned entries here first. Without either, it stays resident.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Optional, Tuple

CACHE_BYTES_KEY = "spark_tpu.sql.io.deviceCacheBytes"
DEVICE_BUDGET_KEY = "spark_tpu.sql.memory.deviceBudget"


def _tensor_nbytes(t) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def batch_nbytes(batch) -> int:
    """Device bytes of a batch: data, validity and selection tensors."""
    total = _tensor_nbytes(batch.selection)
    for col in batch.columns.values():
        total += (_tensor_nbytes(col.data) + _tensor_nbytes(col.validity)
                  + _tensor_nbytes(col.offsets)
                  + _tensor_nbytes(col.elem_validity))
    return total


class DeviceTableCache:
    """LRU cache of loaded device Batches with a byte budget.

    Lock-guarded, as the JAX package's is: concurrent queries may hit,
    fill and evict it from several threads."""

    def __init__(self):
        self._lock = threading.RLock()
        self._entries: "OrderedDict[Tuple, Tuple[object, int]]" = \
            OrderedDict()
        #: pin counts per key: entries a running query still uses;
        #: eviction skips them, since evicting a batch another query
        #: still references frees no device memory
        self._pins: Dict[Tuple, int] = {}
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        #: entries dropped by budget pressure or clears (never reset)
        self.evictions = 0

    def get(self, key) -> Optional[object]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return entry[0]

    def contains(self, key) -> bool:
        with self._lock:
            return key in self._entries

    def put(self, key, batch, budget: int) -> None:
        nbytes = batch_nbytes(batch)
        if nbytes > budget:
            return  # larger than the whole budget: don't thrash
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[key] = (batch, nbytes)
            self._bytes += nbytes
            while self._bytes > budget:
                # LRU, skipping the key just inserted and pinned entries
                victim = next((k for k in self._entries
                               if k != key and not self._pins.get(k)),
                              None)
                if victim is None:
                    break
                _, evicted = self._entries.pop(victim)
                self._bytes -= evicted
                self.evictions += 1

    def evict_bytes(self, nbytes: int) -> int:
        """Evict LRU entries until at least `nbytes` are freed (or only
        pinned entries remain); returns the bytes freed."""
        freed = 0
        with self._lock:
            for key in list(self._entries):
                if freed >= nbytes:
                    break
                if self._pins.get(key):
                    continue
                _, entry_bytes = self._entries.pop(key)
                self._bytes -= entry_bytes
                self.evictions += 1
                freed += entry_bytes
        return freed

    def pin(self, key) -> bool:
        """Mark `key` in use by a running query (counted); False when the
        entry is not present."""
        with self._lock:
            if key not in self._entries:
                return False
            self._pins[key] = self._pins.get(key, 0) + 1
            return True

    def unpin(self, key) -> None:
        with self._lock:
            n = self._pins.get(key)
            if n is not None:
                if n <= 1:
                    del self._pins[key]
                else:
                    self._pins[key] = n - 1

    def invalidate_token(self, token) -> None:
        """Drop every entry whose source stamp is `token`."""
        with self._lock:
            for k in [k for k in self._entries if k[0] == token]:
                _, nbytes = self._entries.pop(k)
                self._bytes -= nbytes

    def clear(self) -> None:
        with self._lock:
            self.evictions += len(self._entries)
            self._entries.clear()
            self._pins.clear()  # unpin on a dropped key is a no-op
            self._bytes = 0

    @property
    def nbytes(self) -> int:
        return self._bytes

    def stats(self) -> Dict[str, int]:
        """Counters snapshot: hits, misses, evictions, bytes, entries."""
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions, "bytes": self._bytes,
                    "entries": len(self._entries)}


#: process-level cache (device memory is a process resource)
CACHE = DeviceTableCache()


def scan_cache_key(scan, device) -> Optional[Tuple]:
    """Cache key for a ScanExec loaded onto `device`, or None when the
    source is uncacheable. The source token comes first
    (`invalidate_token` matches on it)."""
    token = scan.source.cache_token()
    if token is None:
        return None
    cols = None if scan.required_columns is None \
        else tuple(scan.required_columns)
    filters = tuple(repr(f) for f in scan.pushed_filters)
    return (token, cols, filters, str(device))


def estimated_scan_bytes(scan) -> Optional[int]:
    """Rough post-prune device footprint of a scan: rows x per-column
    width, with 2x headroom for capacity bucketing. None when the source
    can't estimate rows."""
    from .. import types as T
    est = scan.source.estimated_rows()
    if est is None:
        return None
    width = 0
    for f in scan.schema().fields:
        if isinstance(f.dtype, T.StringType):
            width += 4  # dictionary codes (dictionary bytes stay host-side)
        elif isinstance(f.dtype, T.DecimalType):
            width += 16
        elif isinstance(f.dtype, (T.IntegerType, T.DateType, T.FloatType)):
            width += 4
        elif isinstance(f.dtype, T.BooleanType):
            width += 1
        else:
            width += 8
        if f.nullable:
            width += 1
    return 2 * est * width


def out_of_core_active(conf) -> bool:
    """Whether an out-of-core budget is in force (a per-query
    deviceBudget, or the SQL service's installed arbiter): the cheap
    early gate of the spill and external-collect paths."""
    from ..service import arbiter
    return int(conf.get(DEVICE_BUDGET_KEY)) > 0 \
        or arbiter.get_arbiter() is not None


def admit_scan_resident(conf, scan) -> bool:
    """May this scan's working set stay on the device? The one residency
    verdict every out-of-core gate reads (external collect, the streaming
    partial spill, the resident preference):

    - an explicit per-query deviceBudget (a test's conf or the OOM
      ladder's 1-byte overlay) wins: the estimate must fit it, and an
      unknown estimate streams;
    - otherwise the SQL service's installed arbiter pins a cached scan,
      or leases the estimated footprint from the shared pool (False =
      denied = stream or spill);
    - otherwise the scan stays resident.
    """
    from ..service import arbiter
    budget = int(conf.get(DEVICE_BUDGET_KEY))
    if budget > 0:
        est = estimated_scan_bytes(scan)
        return est is not None and est <= budget
    arb = arbiter.get_arbiter()
    if arb is None:
        return True
    owner = arbiter._OWNER.get()
    device = None if owner is None else owner.device
    key = None if device is None else scan_cache_key(scan, device)
    if key is not None and CACHE.contains(key):
        # already on the device: its bytes count as storage (the pool's
        # headroom subtracts CACHE.nbytes), so a lease would count them
        # twice and evict the very table the query is about to reuse
        arb.pin_storage(owner, key)
        return True
    est = estimated_scan_bytes(scan)
    if est is None:
        return False  # an unsizeable lease streams
    # per-session share: one session's leases are capped at
    # hbmShare * pool, and an over-share scan streams instead
    share = float(conf.get(arbiter.SESSION_HBM_SHARE_KEY))
    return arb.try_acquire(owner, key or ("scan", id(scan)), est,
                           share=share)


def is_cached(scan, device) -> bool:
    key = scan_cache_key(scan, device)
    return key is not None and CACHE.contains(key)


def load_scan(scan, conf, device) -> object:
    """Load a ScanExec's Batch onto `device` through the device cache."""
    budget = int(conf.get(CACHE_BYTES_KEY))
    key = scan_cache_key(scan, device) if budget > 0 else None
    if key is not None:
        batch = CACHE.get(key)
        if batch is not None:
            return batch
    batch = scan.load(device)
    if key is not None:
        CACHE.put(key, batch, budget)
        # a residency lease the running query took for this scan becomes
        # a pin on the cached entry (service/arbiter.py)
        from ..service.arbiter import note_scan_cached
        note_scan_cached(key)
    return batch


def load_scan_shards(scan, conf, mesh) -> list:
    """The n stripes of a ScanExec's batch, stripe i on the mesh's device
    i, each cached under its shard's key. On a miss the scan loads once
    onto the host, pads to a multiple of n and copies each stripe to its
    device (the JAX package hands the padded batch to `shard_map`).

    On a mesh that spans processes each process reads the whole scan (as
    every JAX process hands the same array to `device_put`) and copies
    only its own positions' stripes; the others' entries are None, and
    the cache keys name the process's rank."""
    from ..parallel.shuffle import move_batch, shard_stripes
    n = mesh.size
    local = mesh.local_positions
    budget = int(conf.get(CACHE_BYTES_KEY))
    keys = [None] * n
    if budget > 0:
        rank = f"/r{mesh.ranks[local[0]]}" if mesh.cluster is not None \
            else ""
        for i in local:
            k = scan_cache_key(scan, mesh.devices[i])
            keys[i] = None if k is None else k + (f"shard{i}/{n}{rank}",)
    if all(keys[i] is not None for i in local):
        hits = [CACHE.get(k) if k is not None else None for k in keys]
        if all(hits[i] is not None for i in local):
            return hits
    import torch
    host = scan.load(torch.device("cpu"))
    stripes = shard_stripes(host, n)
    out = [move_batch(stripes[i], mesh.devices[i])
           if mesh.devices[i] is not None else None for i in range(n)]
    for i in local:
        if keys[i] is not None:
            CACHE.put(keys[i], out[i], budget)
    return out
