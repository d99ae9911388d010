"""Cross-query device-memory arbiter and the shared result cache (the
port of `spark_tpu/service/arbiter.py`; reference:
`UnifiedMemoryManager.scala:49`).

One byte pool of device memory that every query of a serving process
leases scan residency from, instead of each query reading its own
`spark_tpu.sql.memory.deviceBudget`. On a card the pool is
`spark_tpu.service.hbmBudget` bytes of the device memory `torch.cuda`
reports (`torch.cuda.get_device_properties(i).total_memory`); the
arbiter counts estimated scan footprints against it, not the caching
allocator's bytes. The pool is unified with the device table cache
(`io/device_cache.py`) as the reference unifies execution and storage
memory: lease pressure first evicts cached tables (storage), then
denies the lease, and a denied lease sends the query down the
out-of-core paths it already has (`execution/external.py`, the
streaming partial spill), never into an out-of-memory failure. The OOM
ladder composes unchanged: its second rung pins an explicit 1-byte
deviceBudget, which takes precedence over the arbiter (a forced
re-route stays forced).

The arbiter also owns the plan-fingerprint result cache every pooled
session shares (`result_cache.ResultCache`, bounded by
`spark_tpu.service.resultCacheBytes`). The JAX package's arbiter owns a
third process resource, the compiled-stage cache; the port runs eagerly
and compiles no stages, so it has none.

Installation is process-level (`install_arbiter` / `get_arbiter`), like
`device_cache.CACHE`: device memory is a process resource. The SQL
service installs one at first use when `hbmBudget` > 0; without one,
every single-session path runs as before.
"""

from __future__ import annotations

import threading
import time
from contextvars import ContextVar
from typing import Dict, Optional

from ..result_cache import ResultCache

HBM_BUDGET_KEY = "spark_tpu.service.hbmBudget"
RESULT_CACHE_BYTES_KEY = "spark_tpu.service.resultCacheBytes"
SESSION_HBM_SHARE_KEY = "spark_tpu.service.session.hbmShare"


class _Owner:
    """Identity of one query execution's leases (one per outermost
    `enter_query`). `group` is the session's identity, the app_id prefix
    of the executor's "app:qN" label: the unit the per-session hbmShare
    quota sums leases over. `device` is the device the execution runs
    on, so a scan's cache key can be formed at the gates."""

    __slots__ = ("label", "group", "device")

    def __init__(self, label: str = "", device=None):
        self.label = label
        self.group = label.rsplit(":q", 1)[0] if ":q" in label else label
        self.device = device


#: the owner of the query execution running in this context; set by the
#: executor, read by the out-of-core gates
_OWNER: ContextVar[Optional[_Owner]] = ContextVar(
    "spark_tpu_torch_arbiter_owner", default=None)


class DeviceResourceArbiter:
    """One shared device byte pool, leased per (query, scan).

    `try_acquire` is idempotent per (owner, key): one scan is gate-checked
    from several sites along an execution (external collect, the
    streaming splice, the resident preference) and they must all see one
    verdict. Denials are memoized per owner for the same reason: a lease
    freed mid-execution must not flip a query that already took the spill
    path back to resident."""

    def __init__(self, total_bytes: int, metrics=None,
                 result_cache_bytes: int = 0):
        self.total = int(total_bytes)
        self.metrics = metrics
        self._cv = threading.Condition()
        self._leases: Dict[_Owner, Dict[object, int]] = {}
        self._denied: Dict[_Owner, set] = {}
        #: device-cache keys each owner runs against as STORAGE, pinned
        #: in the cache so lease pressure cannot evict bytes a running
        #: query still references
        self._pins: Dict[_Owner, set] = {}
        #: the result cache every pooled session shares
        self.result_cache = ResultCache(max_bytes=result_cache_bytes,
                                        metrics=metrics)

    # -- accounting ---------------------------------------------------------

    @property
    def leased_bytes(self) -> int:
        with self._cv:
            return self._leased_locked()

    def _leased_locked(self) -> int:
        return sum(sum(d.values()) for d in self._leases.values())

    @staticmethod
    def _storage_bytes() -> int:
        from ..io.device_cache import CACHE
        return CACHE.nbytes

    def headroom(self) -> int:
        with self._cv:
            return self.total - self._leased_locked() - self._storage_bytes()

    # -- leasing ------------------------------------------------------------

    def try_acquire(self, owner: Optional[_Owner], key, nbytes: int,
                    wait_ms: float = 0.0, share: float = 0.0) -> bool:
        """Lease `nbytes` of residency for (owner, key). Storage (the
        device table cache) is evicted LRU-first under pressure, then the
        request waits up to `wait_ms` for other queries to release, then
        is denied (the caller takes the out-of-core path).

        `share` (`spark_tpu.service.session.hbmShare`) caps one owner
        group's (one session's) leases at share * pool: a lease that
        would pass it is denied at once (`session_quota_rejections`),
        since only the session's own query end could free room.

        A wait is cancellable: under an installed lifecycle token it runs
        in deadline-capped slices and a cancelled or deadlined waiter
        raises the structured error out of the gate."""
        from ..execution import lifecycle
        from ..io.device_cache import CACHE
        if owner is None:
            # no query scope (direct engine use with an arbiter
            # installed): grant against headroom without tracking
            return nbytes <= self.headroom()
        deadline = time.monotonic() + wait_ms / 1e3
        group_cap = int(share * self.total) if share > 0 else 0
        with self._cv:
            held = self._leases.get(owner, {})
            if key in held:
                return True
            if key in self._denied.get(owner, ()):
                return False
            while True:
                if group_cap > 0:
                    group_leased = sum(
                        sum(d.values())
                        for o, d in self._leases.items()
                        if o.group == owner.group)
                    if group_leased + nbytes > group_cap:
                        self._denied.setdefault(owner, set()).add(key)
                        self._count("arbiter_lease_denied")
                        self._count("session_quota_rejections")
                        return False
                free = (self.total - self._leased_locked()
                        - self._storage_bytes())
                if nbytes <= free:
                    self._leases.setdefault(owner, {})[key] = int(nbytes)
                    self._count("arbiter_lease_granted")
                    self._gauges()
                    return True
                # shrink the storage pool before denying execution memory
                freed = CACHE.evict_bytes(nbytes - free)
                if freed > 0:
                    self._count("arbiter_storage_evicted_bytes", freed)
                    continue
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._denied.setdefault(owner, set()).add(key)
                    self._count("arbiter_lease_denied")
                    return False
                self._cv.wait(lifecycle.wait_slice(remaining))
                lifecycle.checkpoint("lease_wait")

    def pin_storage(self, owner: Optional[_Owner], key) -> None:
        """`owner` runs against the CACHED copy of `key`: pin it, so
        another query's lease pressure cannot evict bytes this query
        still references (evicting them frees nothing while the
        accounting would credit them as free)."""
        from ..io.device_cache import CACHE
        if owner is None or key is None:
            return
        with self._cv:
            pins = self._pins.setdefault(owner, set())
            if key in pins:
                return
            if CACHE.pin(key):
                pins.add(key)

    def convert_lease_to_pin(self, owner: Optional[_Owner], key) -> None:
        """The owner's leased scan just landed in the device cache: its
        bytes now count as storage (headroom subtracts CACHE.nbytes), so
        the lease would count them twice. Drop it and pin the entry for
        the rest of the execution."""
        from ..io.device_cache import CACHE
        if owner is None:
            return
        with self._cv:
            held = self._leases.get(owner)
            if not held or key not in held:
                return
            pins = self._pins.setdefault(owner, set())
            if key not in pins and not CACHE.pin(key):
                # the put was rejected: the batch is live on the device
                # but not in CACHE.nbytes, so the lease stays
                return
            pins.add(key)
            del held[key]
            self._gauges()
            self._cv.notify_all()

    def release(self, owner: Optional[_Owner]) -> None:
        """Drop every lease, pin and denial memo the owner holds: at the
        end of its execution, or before the OOM ladder re-plans."""
        from ..io.device_cache import CACHE
        if owner is None:
            return
        with self._cv:
            self._leases.pop(owner, None)
            self._denied.pop(owner, None)
            for key in self._pins.pop(owner, ()):
                CACHE.unpin(key)
            self._gauges()
            self._cv.notify_all()

    # -- observability ------------------------------------------------------

    def _count(self, name: str, n: int = 1) -> None:
        if self.metrics is not None:
            self.metrics.counter(name).inc(n)

    def _gauges(self) -> None:
        if self.metrics is not None:
            self.metrics.gauge("arbiter_leased_bytes").set(
                self._leased_locked())
            self.metrics.gauge("arbiter_total_bytes").set(self.total)

    def stats(self) -> Dict[str, int]:
        with self._cv:
            return {"total_bytes": self.total,
                    "leased_bytes": self._leased_locked(),
                    "owners": len(self._leases),
                    "headroom_bytes": (self.total - self._leased_locked()
                                       - self._storage_bytes())}


# ---------------------------------------------------------------------------
# Process-level installation
# ---------------------------------------------------------------------------

_ARBITER: Optional[DeviceResourceArbiter] = None


def install_arbiter(arbiter: Optional[DeviceResourceArbiter]) -> None:
    global _ARBITER
    _ARBITER = arbiter


def get_arbiter() -> Optional[DeviceResourceArbiter]:
    return _ARBITER


# ---------------------------------------------------------------------------
# Query scopes (the executor's side)
# ---------------------------------------------------------------------------

#: token of a scope opened inside an enclosing one: the outer owner keeps
#: the leases, so the nested exit is a no-op. Otherwise the external
#: collect gate's exit would release the residency lease it just granted
#: before the resident execution it authorized runs.
_NESTED = ("nested-arbiter-scope",)


def enter_query(label: str = "", device=None) -> Optional[tuple]:
    """Open a lease scope for the execution starting in this context.
    Returns a token for `exit_query`, or None when no arbiter is
    installed. Re-entrant: a scope opened under an existing one shares
    its owner, so leases live until the OUTERMOST exit (`collect()` opens
    that scope: residency granted at the external-collect gate stays
    leased while the resident execution runs)."""
    if _ARBITER is None:
        return None
    if _OWNER.get() is not None:
        return _NESTED
    owner = _Owner(label, device)
    return owner, _OWNER.set(owner)


def exit_query(token: Optional[tuple]) -> None:
    """Close a lease scope and release its leases (a nested scope's exit
    does nothing; the outermost releases)."""
    if token is None or token is _NESTED:
        return
    owner, ctx_token = token
    _OWNER.reset(ctx_token)
    arb = _ARBITER
    if arb is not None:
        arb.release(owner)


def release_current() -> None:
    """Release the running query's leases without closing its scope: the
    OOM ladder calls this before a degraded re-plan, so the retry's
    verdicts start from a clean slate."""
    arb = _ARBITER
    owner = _OWNER.get()
    if arb is not None and owner is not None:
        arb.release(owner)


# ---------------------------------------------------------------------------
# The device cache's hook (its gates read get_arbiter() and _OWNER)
# ---------------------------------------------------------------------------


def note_scan_cached(key) -> None:
    """`io/device_cache.load_scan`'s hook: the scan keyed `key` just
    landed in the device cache. A lease the running query took for it
    becomes a storage pin (no double count)."""
    arb = _ARBITER
    if arb is not None:
        arb.convert_lease_to_pin(_OWNER.get(), key)
