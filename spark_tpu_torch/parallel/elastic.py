"""Elastic mesh recovery: gang restart, graceful decommission and
straggler chunk rebalancing (the port of `spark_tpu/parallel/elastic.py`;
reference: the `BlockManagerDecommissioner` and task-speculation seats,
SURVEY sections 5 and 2.5, re-thought for a gang of shards, where there
are no independent task attempts to relaunch).

- **Gang restart** (`ElasticMeshState`): on a mesh or collective failure
  the executor re-executes the query still mesh-planned, up to
  `spark_tpu.execution.meshRestart.maxRestarts` times with the
  exponential-backoff RetryPolicy, before the single-device fallback,
  which becomes the last rung. The mesh stream finds its surviving
  checkpoint (execution/recovery.py) and resumes at its chunk cursor on
  the mesh, so losing a shard mid-stream replays at most
  `checkpoint.everyChunks` chunks. The `mesh_restart` fault seam fires
  at each restart: a fault there fails that attempt (its budget spent)
  and the ladder falls through, in the end to the single-device rung.
- **Graceful decommission** (`MeshDecommissionRequest`,
  `pending_decommission`): `spark_tpu.execution.decommission.shards`
  (or `session.decommission_shards([...])`) requests a drain; the mesh
  stream honours it at its next chunk boundary (the `decommission` seam
  fires, a checkpoint is forced at the cursor, the request is raised).
  The executor excludes the draining positions' device ids at session
  level (`spark_tpu.sql.mesh.excludeDevices`, so the drain outlives the
  query), clears the request, and re-executes on the reduced gang,
  which resumes from the forced checkpoint. A device id is a card's
  CUDA ordinal, or a pinned mesh's virtual id (`parallel/mesh.py`).
- **Straggler rebalancing** (`RebalanceState`, `ElasticRebalancer`): a
  built-in `on_straggler` subscriber closes the detect-act loop. Once
  the StragglerMonitor flags a shard mid-stream, later chunks assign
  live rows away from it (its share drops by
  `spark_tpu.sql.straggler.rebalance.maxSkew`, spread over the healthy
  shards): the gang still steps together, but the slow shard steps over
  fewer rows. Per-shard slot capacity stays uniform. Integer and
  decimal results are bit-exact (partial aggregation does not depend on
  which shard folds a row); float sums may move in the last ulp, as
  any change of mesh size or chunk boundaries moves them.

On a mesh that spans engine processes (`parallel/cluster.py`) the three
run over the global mesh, and what each process decides alone is agreed:
a drain request is the union of every process's at each chunk boundary
(`pending_decommission`), the straggler monitor flags from every
process's per-shard waits (`ShardStreamTelemetry` gathers them), so
`RebalanceState` holds the same flags and weights at the same chunk in
every process, and the gang restart re-meshes over the global pool
(`healthy_device_count`). The `mesh_restart` fault seam is each
process's own: a fault armed there in one process only sends that one to
the single-device rung while its peers restart the gang and wait for it,
so arm it in every process.

All three reach `_record_fault` -> fault_summary -> the event log and
history as the actions `mesh_restart`, `decommission` and
`shard_rebalance`; the session's metrics count `mesh_restart_attempts`
and `rebalance_rows`.
"""

from __future__ import annotations

import contextlib
import warnings
from contextvars import ContextVar
from typing import Dict, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..observability.listener import QueryListener

RESTART_ENABLED_KEY = "spark_tpu.execution.meshRestart.enabled"
RESTART_MAX_KEY = "spark_tpu.execution.meshRestart.maxRestarts"
DECOMMISSION_KEY = "spark_tpu.execution.decommission.shards"
EXCLUDE_KEY = "spark_tpu.sql.mesh.excludeDevices"
REBALANCE_ENABLED_KEY = "spark_tpu.sql.straggler.rebalance.enabled"
REBALANCE_MAX_SKEW_KEY = "spark_tpu.sql.straggler.rebalance.maxSkew"
REBALANCE_DECAY_KEY = "spark_tpu.sql.straggler.rebalance.decayChunks"
BACKOFF_KEY = "spark_tpu.execution.backoffMs"


def _parse_int_set(spec, warn: bool = True) -> Set[int]:
    """Comma-separated ints -> set. `warn=False` for the per-chunk caller
    (pending_decommission): one warning per query comes from
    discard_stale_decommission instead."""
    out: Set[int] = set()
    for part in str(spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        try:
            out.add(int(part))
        except ValueError:
            if warn:
                warnings.warn(f"ignoring non-integer entry {part!r} in "
                              f"shard/device list {spec!r}")
    return out


# ---------------------------------------------------------------------------
# Gang restart
# ---------------------------------------------------------------------------

class ElasticMeshState:
    """One execution's gang-restart budget: bounded restart attempts with
    exponential backoff (the RetryPolicy), each behind the `mesh_restart`
    fault seam. The executor makes one per execution, like every other
    recovery budget."""

    def __init__(self, conf):
        from ..execution.failures import RetryPolicy
        self.enabled = bool(conf.get(RESTART_ENABLED_KEY))
        self.max_restarts = int(conf.get(RESTART_MAX_KEY))
        self.policy = RetryPolicy(self.max_restarts,
                                  float(conf.get(BACKOFF_KEY)))
        #: restart attempts that passed their seam (were applied)
        self.restarts = 0

    def try_restart(self, record) -> Optional[float]:
        """Spend restart attempts until one passes its fault seam or the
        budget runs out. Returns the backoff slept (ms) before the
        attempt that will be applied, or None when the ladder must fall
        through to the single-device rung. A fault at the `mesh_restart`
        seam fails that attempt: recorded with ok=False, budget spent."""
        from ..testing import faults
        if not self.enabled:
            return None
        while True:
            slept = self.policy.attempt_retry()
            if slept is None:
                return None
            try:
                # the restart boundary: a fault here models the re-admitted
                # shard dying again
                faults.fire("mesh_restart")
            except Exception as e:  # noqa: BLE001 — the attempt failed
                record("mesh_restart", e, attempt=self.policy.attempts,
                       ok=False)
                continue
            self.restarts += 1
            return slept


def healthy_device_count(conf, device=None, pinned_pool: int = 0
                         ) -> Optional[int]:
    """Devices in the pool and not excluded — the pool a gang restart may
    re-mesh over: the visible cards, or a pinned session's virtual
    devices (`mesh.device_pool`); on a cluster the global pool, from the
    sizes the last mesh gathered (no collective here: the failure ladder
    calls it). None when the pool cannot be read (the restart then keeps
    the configured size)."""
    from . import cluster
    from .mesh import device_pool, excluded_device_ids, mesh_size
    try:
        excl = excluded_device_ids(conf)
        if cluster.cluster_spec(conf) is not None:
            cl = cluster.current()
            if cl is None or cl.pool_sizes is None:
                return None
            return _cluster_healthy(cl.pool_sizes, excl)
        pool = device_pool(device, max(pinned_pool, mesh_size(conf)))
        return len([i for i in pool if i not in excl])
    except Exception:  # noqa: BLE001 — probing must never raise
        return None


def _cluster_healthy(pool_sizes: Sequence[int], excluded) -> int:
    """The cluster's global pool (every process's pool, in rank order)
    less the excluded global ids that fall inside it."""
    total = sum(pool_sizes)
    return total - len([i for i in excluded if 0 <= i < total])


# ---------------------------------------------------------------------------
# Graceful decommission
# ---------------------------------------------------------------------------

class MeshDecommissionRequest(Exception):
    """Control flow, not a failure: a drain request reached a chunk
    boundary of a running mesh stream. Carries the draining mesh
    positions and their device ids; the executor excludes the ids at
    session level and re-executes on the reduced gang."""

    def __init__(self, shards: Sequence[int], device_ids: Sequence[int]):
        super().__init__(
            f"decommission requested for shard(s) {sorted(shards)} "
            f"(device ids {sorted(device_ids)})")
        self.shards = tuple(shards)
        self.device_ids = tuple(device_ids)


def pending_decommission(conf, mesh) -> Tuple[Tuple[int, ...],
                                              Tuple[int, ...]]:
    """The drain request's (mesh positions, device ids) valid for this
    mesh; empty tuples when nothing is pending. Positions outside
    [0, n) are ignored (a request naming a drained position must not
    fire forever).

    On a mesh that spans processes the request is agreed: one
    `all_gather_object` at every chunk boundary gives the union of every
    process's pending positions, so a drain requested in one process
    drains the same positions at the same chunk in all of them. A drain
    that would leave a process without a position raises AnalysisError
    in every process alike, before anything is excluded or cleared."""
    spec = str(conf.get(DECOMMISSION_KEY) or "").strip()
    # silent parse: this runs at every chunk boundary
    requested = _parse_int_set(spec, warn=False) if spec else set()
    positions = sorted(p for p in requested if 0 <= p < mesh.size)
    if mesh.cluster is not None:
        agreed = mesh.cluster.all_gather_object(positions, "decommission")
        positions = sorted(set().union(*agreed))
        if positions:
            _refuse_emptying_drain(conf, mesh, positions)
    if not positions:
        return (), ()
    return tuple(positions), tuple(mesh.ids[p] for p in positions)


def _refuse_emptying_drain(conf, mesh, positions: Sequence[int]) -> None:
    """Raise AnalysisError when draining `positions` would form a mesh
    (as `apply_decommission` then `get_mesh` form it) that leaves some
    process of the cluster without a position."""
    from ..expr import AnalysisError
    from .mesh import cluster_positions, excluded_device_ids, mesh_size
    cl = mesh.cluster
    excluded = excluded_device_ids(conf) | {mesh.ids[p] for p in positions}
    healthy = _cluster_healthy(cl.pool_sizes, excluded)
    chosen, ranks = cluster_positions(cl.pool_sizes,
                                      min(mesh_size(conf), healthy), excluded)
    left = sorted(set(range(cl.world)) - set(ranks)) \
        if len(chosen) > 1 else list(range(cl.world))
    if left:
        raise AnalysisError(
            f"decommission of mesh position(s) {list(positions)} refused: "
            f"it would leave cluster process(es) {left} without a mesh "
            f"position, and every engine process must drive a shard; "
            f"nothing was excluded")


def discard_stale_decommission(session_conf, mesh) -> None:
    """Drop a drain request with no position valid for the gang about to
    run (`decommission_shards([9])` on an 8-gang): left armed it would
    fire the first time a larger mesh makes the position valid. The
    executor calls it at the start of each mesh query; a request with
    some valid position is kept."""
    spec = str(session_conf.get(DECOMMISSION_KEY) or "").strip()
    if not spec:
        return
    requested = _parse_int_set(spec, warn=False)  # warned below
    if not requested:
        # it could never fire, and armed it would be parsed at every
        # chunk boundary
        warnings.warn(
            f"discarding unparseable decommission request {spec!r}")
        session_conf.set(DECOMMISSION_KEY, "")
    elif not any(0 <= p < mesh.size for p in requested):
        warnings.warn(
            f"discarding stale decommission request {spec!r}: no "
            f"requested position is valid for the {mesh.size}-shard gang")
        session_conf.set(DECOMMISSION_KEY, "")


def apply_decommission(session_conf, device_ids: Sequence[int],
                       device=None, pinned_pool: int = 0) -> None:
    """Make a drain last: merge the device ids into the session's
    exclusions (get_mesh builds every later gang over the surviving
    pool), clear the one-shot request, and lower mesh.size to the
    surviving pool so planning (exchange sizes divide by n) agrees with
    the gang that runs, for this query's re-execution and every later
    one. `device` and `pinned_pool` name the pool as get_mesh does."""
    merged = _parse_int_set(session_conf.get(EXCLUDE_KEY)) \
        | set(int(i) for i in device_ids)
    session_conf.set(EXCLUDE_KEY, ",".join(str(i) for i in sorted(merged)))
    session_conf.set(DECOMMISSION_KEY, "")
    pool = healthy_device_count(session_conf, device, pinned_pool)
    if pool is None:
        return
    n = int(session_conf.get("spark_tpu.sql.mesh.size") or 0)
    if n > 1 and pool < n:
        session_conf.set("spark_tpu.sql.mesh.size", max(pool, 0))


def decommission_shards(session, shards: Sequence[int]) -> None:
    """The drain API: request a graceful decommission of mesh positions.
    A running mesh stream drains at its next chunk boundary; otherwise
    the next mesh query applies it at its first. Merges with a request
    still pending, so back-to-back drains keep the earlier one."""
    pending = _parse_int_set(session.conf.get(DECOMMISSION_KEY))
    merged = pending | {int(s) for s in shards}
    session.conf.set(DECOMMISSION_KEY,
                     ",".join(str(s) for s in sorted(merged)))


# ---------------------------------------------------------------------------
# Straggler chunk rebalancing
# ---------------------------------------------------------------------------

#: the mesh stream installs its live rebalance state here for its chunk
#: loop; the ElasticRebalancer (on_straggler fires synchronously on the
#: stream's thread, inside the telemetry flush) flags shards into it
_REBALANCE: ContextVar[Optional["RebalanceState"]] = \
    ContextVar("spark_tpu_rebalance", default=None)


def current_rebalance() -> Optional["RebalanceState"]:
    return _REBALANCE.get()


@contextlib.contextmanager
def use_rebalance(state: Optional["RebalanceState"]):
    token = _REBALANCE.set(state)
    try:
        yield state
    finally:
        _REBALANCE.reset(token)


class RebalanceState:
    """One stream's row-assignment weights over the mesh's shards.

    Until a shard is flagged the state is inert and padding takes the
    zero-cost `pad_batch_to_multiple` path. After `flag(shard)` each
    chunk's live rows are re-assigned: the flagged shard's share drops
    to (1 - maxSkew) x fair and the deficit spreads evenly over the
    healthy shards. With `straggler.rebalance.decayChunks` > 0 each
    rebalanced chunk fades every flagged shard's penalty by
    1/decayChunks, so a recovered shard earns its fair share back and
    the state goes inert again (0 keeps the penalty until the stream
    ends). Per-shard slot capacity is uniform and sized from the
    full-penalty weights, so it stays one shape across a decay."""

    def __init__(self, n: int, conf, recovery=None):
        self.n = int(n)
        self.enabled = bool(conf.get(REBALANCE_ENABLED_KEY))
        self.max_skew = float(conf.get(REBALANCE_MAX_SKEW_KEY))
        self.recovery = recovery  # RecoveryContext: record() and metrics
        self.decay_chunks = int(conf.get(REBALANCE_DECAY_KEY))
        self.slow: Set[int] = set()
        #: shard -> remaining penalty in (0, 1]: 1.0 at the flag, fading
        #: by 1/decayChunks a rebalanced chunk (tick())
        self.penalty: Dict[int, float] = {}
        self.moved_rows = 0

    @property
    def active(self) -> bool:
        return bool(self.slow)

    def flag(self, shard: int) -> None:
        """Mark one shard slow (idempotent; a re-flag mid-decay restores
        the full penalty). Records one `shard_rebalance` action per
        shard."""
        shard = int(shard)
        if not self.enabled or self.max_skew <= 0:
            return
        if shard in self.slow:
            self.penalty[shard] = 1.0
            return
        if not 0 <= shard < self.n:
            return
        if len(self.slow) >= self.n - 1:
            return  # one healthy shard at least must take the rows
        self.slow.add(shard)
        self.penalty[shard] = 1.0
        if self.recovery is not None:
            self.recovery.record("shard_rebalance", None, shard=shard,
                                 max_skew=self.max_skew)

    # -- assignment math ----------------------------------------------------

    def _weights(self, decayed: bool = True) -> np.ndarray:
        """Per-shard weights: `decayed` scales each flagged shard's skew
        by its remaining penalty (the live assignment); otherwise the
        full-penalty weights slot_capacity sizes shapes from."""
        w = np.ones(self.n)
        z = len(self.slow)
        if z and z < self.n:
            deficit = 0.0
            for i in self.slow:
                p = self.penalty.get(i, 1.0) if decayed else 1.0
                w[i] = 1.0 - self.max_skew * p
                deficit += self.max_skew * p
            boost = deficit / (self.n - z)
            for i in range(self.n):
                if i not in self.slow:
                    w[i] = 1.0 + boost
        return w

    def targets(self, live: int) -> np.ndarray:
        """Per-shard live rows of one chunk, summing to `live` exactly
        (largest-remainder rounding)."""
        raw = live * self._weights() / self.n
        t = np.floor(raw).astype(np.int64)
        for i in np.argsort(-(raw - t), kind="stable")[:live - t.sum()]:
            t[i] += 1
        return t

    def slot_capacity(self, chunk_capacity: int) -> int:
        """Uniform per-shard slot count: the largest target of a fully
        live chunk plus one for rounding, constant while the flagged set
        is."""
        wmax = float(np.max(self._weights(decayed=False)))
        return int(-(-int(chunk_capacity) * wmax // self.n)) + 1

    def rebalance(self, batch, n: int):
        """One chunk's live rows re-assigned to shard segments by the
        current weights: one host copy of the selection mask and one
        `index_select` per column, only while a shard is flagged."""
        from ..columnar import Batch, Column
        mask = batch.selection_mask().cpu().numpy()
        live_idx = np.flatnonzero(mask)
        live = int(live_idx.size)
        t = self.targets(live)
        s_cap = self.slot_capacity(batch.capacity)
        take = np.zeros(s_cap * n, np.int64)
        sel = np.zeros(s_cap * n, bool)
        off = 0
        for i in range(n):
            k = int(t[i])
            seg = i * s_cap
            take[seg:seg + k] = live_idx[off:off + k]
            sel[seg:seg + k] = True
            off += k
        # rows moved off the flagged shards against the even split (the
        # `rebalance_rows` counter)
        fair = live // n
        moved = sum(max(0, fair - int(t[i])) for i in self.slow)
        self.moved_rows += moved
        if self.recovery is not None and self.recovery.metrics is not None \
                and moved:
            self.recovery.metrics.counter("rebalance_rows").inc(moved)
        self.tick()
        dev = batch.device
        take_d = torch.as_tensor(take, device=dev)
        cols = {}
        for name, c in batch.columns.items():
            validity = None if c.validity is None \
                else c.validity.index_select(0, take_d)
            cols[name] = Column(c.data.index_select(0, take_d), c.dtype,
                                validity, c.dictionary, bits=c.bits)
        return Batch(cols, torch.as_tensor(sel, device=dev), dev)

    def tick(self) -> None:
        """One rebalanced chunk passed: fade every flagged shard's penalty
        by 1/decayChunks; a shard at zero unflags, and when the last one
        does the state is inert again (shares uniform)."""
        if self.decay_chunks <= 0:
            return
        step = 1.0 / self.decay_chunks
        for shard in sorted(self.slow):
            p = self.penalty.get(shard, 1.0) - step
            if p > 1e-12:
                self.penalty[shard] = p
            else:
                self.slow.discard(shard)
                self.penalty.pop(shard, None)


def pad_chunk_for_shards(batch, n: int,
                         state: Optional[RebalanceState] = None):
    """The mesh stream's padding step: `pad_batch_to_multiple` until a
    straggler is flagged, the skewed re-assignment after."""
    from .shuffle import pad_batch_to_multiple
    if state is None or not state.active:
        return pad_batch_to_multiple(batch, n)
    return state.rebalance(batch, n)


class ElasticRebalancer(QueryListener):
    """Built-in bus subscriber closing the straggler detect-act loop:
    on_straggler (posted by the StragglerMonitor from the telemetry
    flush, on the stream's thread) flags the shard into the stream's
    live RebalanceState, so the next chunk's rows already move away from
    it. Stateless: the state lives in the context variable, scoped to
    the running stream."""

    _builtin = True

    def on_straggler(self, event) -> None:
        state = current_rebalance()
        if state is not None:
            state.flag(int(event.shard))
