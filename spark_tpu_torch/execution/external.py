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
whole-input residency and device sorts. The streaming state that spills
to disk (`SpillableKeyedState`) comes with streaming queries.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

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
