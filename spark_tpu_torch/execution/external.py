"""Out-of-core host egress: ORDER BY / LIMIT / plain materialization over
scans past the device budget (the port of `try_external_collect` in
`spark_tpu/execution/external.py`; reference: the spillable operators
`UnsafeExternalSorter.java:1`, `ExternalAppendOnlyMap.scala:55` and
`SortExec.scala:40`).

Chunks of the probe scan go through the filter/project/join chain on the
device, and the host (RAM, Arrow buffers) plays the spill tier:

- ``LIMIT n``          -> stream chunks until n live rows have spilled;
- ``ORDER BY + LIMIT`` -> a top-n per chunk on the device (sort + limit),
  then one final device sort + limit over the concatenated winners — a
  tournament reduction;
- ``ORDER BY``         -> spill every replayed chunk, then one host
  pyarrow sort over the runs (the k-way merge's seat; the order keys
  must be output columns), honouring ASC/DESC and NULLS FIRST/LAST;
- plain chain          -> spill every replayed chunk and concatenate.

It engages only when the scan's estimate exceeds the per-query
``spark_tpu.sql.memory.deviceBudget``; a query within budget keeps
whole-input residency and device sorts.

`SpillableKeyedState` is the streaming event-time state's spill tier:
hash-partitioned Parquet files on the host, numpy and pandas as in the
JAX package.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from ..columnar import Batch
from ..plan import physical as P
from .recovery import ChunkRetrier
from .streaming_agg import (_CHUNKABLE_JOINS, _ChunkClock, _next_chunk,
                            _open_chunks, prepare_chunk_joins,
                            replay_checked)


def _match_shape(plan: P.PhysicalPlan):
    """[LimitExec] [SortExec] (Project|Filter|chunkable Join)* Scan."""
    limit = None
    sort = None
    node = plan
    if isinstance(node, P.LimitExec):
        limit = node
        node = node.child
    if isinstance(node, P.SortExec):
        sort = node
        node = node.child
    chain: List[P.PhysicalPlan] = []
    while True:
        if isinstance(node, (P.ProjectExec, P.FilterExec)):
            chain.append(node)
            node = node.children[0]
        elif isinstance(node, P.RuntimeFilterExec):
            # only prunes: the chunked replay drops it (the join checks
            # every key again)
            node = node.children[0]
        elif isinstance(node, P.JoinExec) and node.how in _CHUNKABLE_JOINS:
            chain.append(node)
            node = node.children[0]
        else:
            break
    if not isinstance(node, P.ScanExec):
        return None
    return limit, sort, chain, node


def _host_sort_keys(sort: P.SortExec, schema) -> Optional[Tuple]:
    """SortOrders -> (pyarrow (name, order) keys, null_placement), or None
    when a key is a computed expression (the host merge needs the key as
    a spilled output column) or null placements are mixed (pyarrow's
    SortOptions has one null_placement for all keys)."""
    from ..expr import Alias, ColumnRef
    keys = []
    placements = []
    names = set(schema.names)
    for o in sort.orders:
        e = o.child
        while isinstance(e, Alias):
            e = e.child
        if not isinstance(e, ColumnRef) or e._name not in names:
            return None
        keys.append((e._name,
                     "ascending" if o.ascending else "descending"))
        placements.append("at_start" if o.nulls_first else "at_end")
    if not keys or len(set(placements)) > 1:
        return None
    return keys, placements[0]


def try_external_collect(session, plan: P.PhysicalPlan, conf,
                         recovery=None) -> Optional[pa.Table]:
    """The query's Arrow result through the chunked host-egress path, or
    None when the plan's shape or the budget does not call for it."""
    from ..io.device_cache import admit_scan_resident, out_of_core_active
    from ..parallel.mesh import mesh_size
    if not out_of_core_active(conf):
        return None
    if mesh_size(conf) > 1:
        return None  # the mesh streams its own such runs
    m = _match_shape(plan)
    if m is None:
        return None
    limit, sort, chain, leaf = m
    if not hasattr(leaf.source, "load_chunks"):
        return None
    if admit_scan_resident(conf, leaf):
        return None  # fits resident: the normal path keeps it on device
    host_keys = None
    if sort is not None and limit is None:
        host_keys = _host_sort_keys(sort, plan.schema())
        if host_keys is None:
            return None
    device = session.device
    chunks = _open_chunks(leaf, conf, device, recovery)
    try:
        table = _stream(conf, device, recovery, chunks, chain, sort, limit)
    finally:
        # an early LIMIT break, a fault or a cancellation: join the
        # prefetch worker (it may hold one decoded chunk)
        if hasattr(chunks, "close"):
            chunks.close()
    if table is None:
        return None
    if sort is not None and limit is not None:
        # the tournament's final: one small device sort + limit over the
        # concatenated per-chunk top-n
        ctx = P.ExecContext(conf, device)
        b = Batch.from_arrow(table, device)
        b = sort.compute(ctx, [b])
        b = limit.compute(ctx, [b])
        return b.to_arrow()
    if sort is not None:
        keys, placement = host_keys
        idx = pc.sort_indices(
            table, options=pc.SortOptions(sort_keys=keys,
                                          null_placement=placement))
        return table.take(idx)
    if limit is not None:
        return table.slice(0, limit.n)
    return table


def _stream(conf, device, recovery, chunks, chain, sort, limit
            ) -> Optional[pa.Table]:
    first, wait = _next_chunk(iter(chunks))
    if first is None:
        return None
    joins, builds, _saved = prepare_chunk_joins(
        chain, conf, first.capacity, device, recovery)
    topn = sort is not None and limit is not None

    def run_chunk(b):
        b = replay_checked(chain, joins, conf, device, b, builds,
                           "external-collect")
        if topn:
            # the chunk's top-n: sorting compacts the selection, the
            # limit keeps n
            ctx = P.ExecContext(conf, device)
            b = limit.compute(ctx, [sort.compute(ctx, [b])])
        return b.to_arrow()

    # chunk-granular retry: a transient fault replays only the failed
    # chunk; nothing spilled already runs again
    retrier = ChunkRetrier(conf, recovery)
    clock = _ChunkClock(recovery, "external", chunks)
    spilled: List[pa.Table] = []
    total_rows = 0
    ci, b = 0, first
    first = None
    while b is not None:
        tick = clock.start(device)
        t = retrier.run(lambda bb=b: run_chunk(bb), chunk=ci)
        clock.stop(tick, wait)
        spilled.append(t)
        total_rows += t.num_rows
        if limit is not None and sort is None and total_rows >= limit.n:
            break  # plain LIMIT: enough live rows spilled
        ci += 1
        b, wait = _next_chunk(chunks)  # ingest is not retried
    return pa.concat_tables(spilled, promote_options="permissive")


# ---------------------------------------------------------------------------
# Host-spillable keyed state (streaming event-time aggregation)
# ---------------------------------------------------------------------------

class SpillableKeyedState:
    """Hash-partitioned parquet working set for event-time streaming
    state that exceeds `spark_tpu.streaming.state.spillBytes`.

    The contract that keeps exactly-once trivial: partitions hold ONLY
    the COMMITTED state. A trigger's merge is pure — `merge` reads the
    partitions the batch's keys hash to and returns the merged full
    frame WITHOUT writing anything; the partitions move only in
    `adopt`, which the query calls strictly AFTER its commit-log write
    (the same place the resident path adopts its pending frame). A
    crash anywhere therefore leaves the partitions at (or rebuildable
    from) a committed version, and recovery just `reset`s them from
    the store's last committed frame.

    `state_spill` (testing/faults.py) fires before every partition
    write; written bytes count in `streaming_spill_bytes`. The state
    store never sees this class — it keeps diffing full frames, so the
    persisted deltas/snapshots are identical to a resident run.

    Thread-confined: owned and driven by the query's trigger thread
    (or the manual process_available caller), never shared."""

    def __init__(self, path: str, key_cols: List[str], nparts: int,
                 metrics=None):
        self.path = path
        self.key_cols = list(key_cols)
        self.nparts = max(1, int(nparts))
        self.metrics = metrics
        os.makedirs(path, exist_ok=True)

    def _part_path(self, pid: int) -> str:
        return os.path.join(self.path, f"part-{pid:04d}.parquet")

    def _part_ids(self, pdf) -> "np.ndarray":
        """Stable partition id per row: hash the key columns' string
        forms (stable across processes, unlike Python's seeded
        hash())."""
        import pandas as pd
        key = pdf[self.key_cols[0]].astype(str)
        for c in self.key_cols[1:]:
            key = key + "\x00" + pdf[c].astype(str)
        return (pd.util.hash_pandas_object(key, index=False).to_numpy()
                % self.nparts).astype(np.int64)

    def touched_by(self, pdf) -> List[int]:
        """Partition ids a frame's keys hash to — the eviction path
        uses this to extend a trigger's touched set with the
        partitions that LOST rows (emitted-and-dropped groups)."""
        if pdf is None or not len(pdf):
            return []
        return sorted(int(p) for p in np.unique(self._part_ids(pdf)))

    def _read_part(self, pid: int):
        import pandas as pd
        p = self._part_path(pid)
        if not os.path.exists(p):
            return None
        pdf = pd.read_parquet(p)
        return pdf if len(pdf) else None

    def _write_part(self, pid: int, pdf) -> None:
        """One partition write = one spill unit: seam first (nothing
        written when an armed rule kills here), then fsync + atomic
        rename like every other checkpoint artifact."""
        import pyarrow.parquet as pq
        from ..testing import faults
        from .state_store import fsync_replace
        faults.fire("state_spill")
        full = self._part_path(pid)
        tmp = full + ".tmp"
        pq.write_table(
            pa.Table.from_pandas(pdf, preserve_index=False), tmp)
        fsync_replace(tmp, full)
        if self.metrics is not None:
            self.metrics.counter("streaming_spill_bytes").inc(
                os.path.getsize(full))

    def reset(self, full_pdf) -> None:
        """Rewrite EVERY partition from a committed full frame —
        engagement and crash recovery (partitions are a working set,
        the state store stays the durability tier)."""
        import pandas as pd
        if full_pdf is None:
            full_pdf = pd.DataFrame(columns=self.key_cols)
        pids = self._part_ids(full_pdf) if len(full_pdf) else None
        for pid in range(self.nparts):
            part = full_pdf.iloc[0:0] if pids is None \
                else full_pdf[pids == pid]
            self._write_part(pid, part.reset_index(drop=True))

    def materialize(self):
        """The full committed frame, concatenated from the partitions
        (the transient host materialization the persistence diff needs
        each trigger — the same O(state) host cost the resident path
        already pays; residency BETWEEN triggers is what spill buys)."""
        import pandas as pd
        frames = [f for f in (self._read_part(p)
                              for p in range(self.nparts))
                  if f is not None]
        if not frames:
            return None
        return pd.concat(frames, ignore_index=True)

    def merge(self, partial_pdf, merge_fn):
        """Pure per-partition merge of one trigger's partial table:
        returns (merged full frame, touched partition ids) and writes
        NOTHING — the caller persists the frame through the state
        store, commits, then calls `adopt` with the touched set."""
        import pandas as pd
        pids = self._part_ids(partial_pdf)
        touched = sorted(int(p) for p in np.unique(pids))
        frames = []
        for pid in range(self.nparts):
            part = self._read_part(pid)
            if pid in touched:
                part_partial = partial_pdf[pids == pid] \
                    .reset_index(drop=True)
                part = merge_fn(part, part_partial)
            if part is not None and len(part):
                frames.append(part)
        if not frames:
            return None, touched
        return pd.concat(frames, ignore_index=True), touched

    def adopt(self, full_pdf, touched=None) -> None:
        """Move the touched partitions to the adopted (committed)
        frame; `touched=None` rewrites everything (reset). Called only
        after the commit-log write."""
        import pandas as pd
        if touched is None:
            self.reset(full_pdf)
            return
        if full_pdf is None:
            full_pdf = pd.DataFrame(columns=self.key_cols)
        pids = self._part_ids(full_pdf) if len(full_pdf) else None
        for pid in sorted(set(int(p) for p in touched)):
            part = full_pdf.iloc[0:0] if pids is None \
                else full_pdf[pids == pid]
            self._write_part(pid, part.reset_index(drop=True))
