"""Streaming (chunked) aggregation (the port of the single-device
part of `spark_tpu/execution/streaming_agg.py`; reference: the
produce/consume loop of `WholeStageCodegenExec` and
`TungstenAggregationIterator.scala:82`, which never materialize a scan).

A scan past the device budget is not loaded whole: its chunks (host
ingested, or synthesized on the device for a Range) go one at a time
through the aggregate's chain of Project/Filter (and probe-side joins,
whose build sides are materialized once), and each chunk is folded into
accumulator tables carried across chunks. Two loops:

- **direct stream** (`stream_range_aggregate`, `stream_scan_aggregate`):
  the aggregate takes the dense-domain path; each chunk calls
  `HashAggregateExec.direct_update_tables` eagerly, whose sums run in the
  hand-written group-by kernels (`dense_sums_smem`, `dense_sums_global`),
  one launch per chunk. The tables are a few KiB to a few MiB; each chunk
  replaces them, so a replayed chunk starts from the tables as they were.
  The host syncs per chunk only where a join's overflow flags must be
  read.
- **partial spill** (`stream_scan_aggregate_spill`): keys without a static
  domain (TPC-H Q3's l_orderkey). Each chunk is reduced by a partial-mode
  sort aggregate and its partials copied to host Arrow; the executor
  re-reduces them in a final-mode aggregate. Engages under a deviceBudget
  the scan does not fit.

The JAX package compiles one jitted update per stream and caches it per
conf (`conf_compile_suffix`); eager torch has no compiled stages, so
neither exists here. The mesh stream, its checkpoints and the resume
from them (`stream_scan_aggregate_mesh`, `resume_from_mesh_checkpoint`,
`checkpoint_key`) come with the elastic mesh; until then
`mesh_stream_applies` names the plans they would take. The arbiter's
leases of `_prefer_resident` come with the service.
"""

from __future__ import annotations

import copy
import time
from typing import List, Optional, Tuple

import torch

from .. import types as T
from ..columnar import Batch, Column, bucket_capacity
from ..plan import physical as P
from .recovery import ChunkRetrier

CHUNK_ROWS_KEY = "spark_tpu.sql.execution.streamingChunkRows"

#: join types where per-probe-chunk execution is sound: each probe row's
#: output is independent of the other probe rows (right/full joins add
#: build rows once globally, so chunking the probe would add them per
#: chunk)
_CHUNKABLE_JOINS = ("inner", "left", "left_semi", "left_anti")

#: packed first/last positions carry 30 bits
_ROW_BASE_BOUND = 1 << 30


def find_streamable_chain(agg: "P.HashAggregateExec",
                          allow_joins: bool = True
                          ) -> Optional[Tuple[List, P.LeafExec]]:
    """agg.child must be a chain of Project/Filter — and, when
    `allow_joins`, probe-side-chunkable joins (the build side is an
    independent subtree, materialized once) — over a single leaf."""
    chain = []
    node = agg.child
    while True:
        if isinstance(node, (P.ProjectExec, P.FilterExec)):
            chain.append(node)
            node = node.children[0]
        elif isinstance(node, P.RuntimeFilterExec):
            # a runtime filter only prunes: the join it guards checks
            # every key again, so the streamed replay drops it
            node = node.children[0]
        elif allow_joins and isinstance(node, P.JoinExec) \
                and node.how in _CHUNKABLE_JOINS:
            chain.append(node)
            node = node.children[0]  # on down the probe side
        else:
            break
    if isinstance(node, (P.RangeExec, P.ScanExec)):
        return chain, node
    return None


def _replay_chain(chain: List, ctx, batch: Batch,
                  builds: Optional[dict] = None) -> Batch:
    for op in reversed(chain):
        if isinstance(op, P.JoinExec):
            batch = op.compute(ctx, [batch, builds[op.tag]])
        else:
            batch = op.compute(ctx, [batch])
    return batch


def apply_join_overflow(flags, metrics, joins) -> bool:
    """Read one chunk's `join_overflow_`/`join_nonunique_`/`join_hashsat_`
    flags (host values) and apply capacity growth, the unique-build and
    the hash-kernel fallbacks to `joins`. True when anything changed: the
    caller runs the same chunk again against the pre-chunk state. The one
    copy of the chunked-join re-plan protocol, shared by every chunk
    loop."""
    overflow = [k for k, v in flags.items()
                if k.startswith(("join_overflow_", "join_nonunique_",
                                 "join_hashsat_"))
                and bool(v)]
    if not overflow:
        return False
    for k in overflow:
        if k.startswith("join_nonunique_"):
            tag = k[len("join_nonunique_"):]
            for j in joins:
                if j.tag == tag:
                    j.unique_build = False
            continue
        if k.startswith("join_hashsat_"):
            tag = k[len("join_hashsat_"):]
            for j in joins:
                if j.tag == tag:
                    j.hash_fallback = False
            continue
        tag = k[len("join_overflow_"):]
        total = int(metrics[f"join_rows_{tag}"])
        for j in joins:
            if j.tag == tag:
                j.out_cap = bucket_capacity(max(total, 8))
    return True


def replay_checked(chain: List, joins: List, conf, device, batch: Batch,
                   builds: dict, what: str) -> Batch:
    """Replay `chain` over one chunk; with joins, read their flags and,
    after a capacity or kernel re-plan, replay the same chunk again."""
    from .executor import host_metrics
    for _attempt in range(8):
        ctx = P.ExecContext(conf, device)
        out = _replay_chain(chain, ctx, batch, builds)
        if not joins:
            return out
        flags = host_metrics(ctx.flags)
        if not apply_join_overflow(flags, host_metrics(ctx.metrics), joins):
            return out
    raise RuntimeError(f"{what} join capacity did not converge")


def prepare_chunk_joins(chain: List, conf, first_cap: int, device,
                        recovery=None):
    """Shared chunk-loop set-up: materialize each probe-side join's
    build subtree once (the QueryStageExec role) and seed missing output
    capacities with the chunk capacity. Returns (joins, builds,
    saved_caps); learned capacities stay on the plan nodes, so the
    executor keeps them — callers restore `saved_caps` only when they
    give up before any chunk ran."""
    joins = [op for op in chain if isinstance(op, P.JoinExec)]
    builds = {j.tag: _materialize_subtree(j.children[1], conf, device,
                                          recovery)
              for j in joins}
    saved_caps = {j.tag: j.out_cap for j in joins}
    for j in joins:
        if j.out_cap is None:
            j.out_cap = first_cap
    return joins, builds, saved_caps


def _materialize_subtree(root: P.PhysicalPlan, conf, device,
                         recovery=None) -> Batch:
    """Run an independent subtree (a join's build side) with its own
    re-plan loop — a stage materialization, like the reference's
    QueryStageExec. The result lands in the recovery memo, so a
    downstream failure's re-execution reuses it."""
    from .executor import (_REPLAN_FLAGS, MAX_ATTEMPTS, apply_flags,
                           host_metrics, load_scans, run_plan)
    if recovery is not None:
        hit = recovery.memo_get(("build", id(root)),
                                label=root.simple_string())
        if hit is not None:
            return hit
    loaded = load_scans(root, conf, device)
    adaptive = bool(conf.get("spark_tpu.sql.adaptive.enabled"))
    for _attempt in range(MAX_ATTEMPTS):
        ctx = P.ExecContext(conf, device)
        batch = run_plan(root, ctx, loaded=loaded)
        flags = host_metrics(ctx.flags)
        overflow = [k for k, v in flags.items()
                    if k.startswith(_REPLAN_FLAGS) and bool(v)]
        if not overflow:
            if recovery is not None:
                recovery.memo_put(("build", id(root)), batch)
            return batch
        if not adaptive and any(
                not k.startswith(("join_nonunique_", "join_hashsat_"))
                for k in overflow):
            raise RuntimeError(
                f"build-side capacity overflow in {overflow} with "
                f"adaptive re-planning disabled")
        apply_flags(root, overflow, host_metrics(ctx.metrics))
    raise RuntimeError("build-side capacity did not converge")


def _range_chunk(leaf: P.RangeExec, start: int, chunk_rows: int,
                 rows_total: int, device) -> Batch:
    """One chunk of a Range, synthesized on the device."""
    offs = start + torch.arange(chunk_rows, dtype=torch.int64, device=device)
    ids = leaf.start + leaf.step * offs
    return Batch({"id": Column(ids, T.LONG, bits=leaf._id_bits())},
                 offs < rows_total, device)


class _ChunkClock:
    """Per-chunk timings of one stream, kept on the recovery context's
    `chunk_stats` list: the consumer's wait for the chunk (host decode
    and copy when nothing prefetches), its host decode and copy, and the
    update's host time, with CUDA events around the update on a card."""

    def __init__(self, recovery, kind: str, chunks=None):
        self.records = []
        self._chunks = chunks
        if recovery is not None:
            recovery.chunk_stats.append({"kind": kind,
                                         "chunks": self.records})

    def start(self, device):
        cuda = torch.device(device).type == "cuda"
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) if cuda else None
        if ev is not None:
            ev[0].record()
        return time.perf_counter(), ev

    def stop(self, token, wait_s: float) -> None:
        t0, ev = token
        if ev is not None:
            ev[1].record()
        rec = {"wait_s": wait_s, "update_s": time.perf_counter() - t0,
               "events": ev}
        i = len(self.records)
        for name in ("decode_s", "copy_s"):
            vals = getattr(self._chunks, name, None)
            if vals is not None and i < len(vals):
                rec[name] = vals[i]
        self.records.append(rec)


def stream_range_aggregate(agg: "P.HashAggregateExec", chain: List,
                           leaf: P.RangeExec, conf, device,
                           recovery=None) -> Optional[Batch]:
    """Run agg over a big Range in chunks synthesized on the device;
    None when the direct path does not apply."""
    chunk_rows = int(conf.get(CHUNK_ROWS_KEY))
    rows_total = leaf.num_rows()
    probe = _replay_chain(chain, P.ExecContext(conf, device),
                          _range_chunk(leaf, 0, 8, rows_total, device))
    prep = agg.prepare_direct(probe, conf)
    if prep is None:
        return None
    n_chunks = -(-rows_total // chunk_rows)
    if any(a.func.uses_row_base for a in agg.agg_exprs) \
            and n_chunks * chunk_rows >= _ROW_BASE_BOUND:
        raise RuntimeError(
            "first/last over a streamed range exceeds the 2^30 "
            f"packed-position bound ({rows_total} rows)")
    from .lifecycle import checkpoint
    clock = _ChunkClock(recovery, "range")
    tables = agg.direct_init_tables(prep)
    for i in range(n_chunks):
        # the source is on the device: no ingest to retry, but each
        # chunk is a cancellation boundary
        checkpoint("chunk")
        tick = clock.start(device)
        b = _replay_chain(chain, P.ExecContext(conf, device),
                          _range_chunk(leaf, i * chunk_rows, chunk_rows,
                                       rows_total, device))
        tables = agg.direct_update_tables(tables, b, prep, conf,
                                          row_base=i * chunk_rows)
        clock.stop(tick, 0.0)
    return agg.direct_finalize_tables(tables, prep)


def _open_chunks(leaf: P.ScanExec, conf, device, recovery):
    from ..io.sources import maybe_prefetch
    chunk_rows = int(conf.get(CHUNK_ROWS_KEY))
    return maybe_prefetch(
        leaf.source.load_chunks(leaf.required_columns, leaf.pushed_filters,
                                chunk_rows, device),
        conf, recovery)


def _next_chunk(chunks):
    """The next chunk (None at the end) and the consumer's wait for it."""
    t0 = time.perf_counter()
    b = next(chunks, None)
    return b, time.perf_counter() - t0


def stream_scan_aggregate(agg: "P.HashAggregateExec", chain: List,
                          leaf: P.ScanExec, conf, device,
                          recovery=None) -> Optional[Batch]:
    """Run agg over a chunked Scan: the host ingests chunks (one bucketed
    capacity for all) while the device reduces; with prefetch on, chunk
    N+1 decodes on a worker thread while chunk N computes."""
    chunks = _open_chunks(leaf, conf, device, recovery)
    try:
        return _stream_scan_aggregate_inner(agg, chain, conf, device,
                                            recovery, chunks)
    finally:
        # join the prefetch worker on every exit: the end, a fallback, a
        # fault or a cancellation unwinding mid-stream
        if hasattr(chunks, "close"):
            chunks.close()


def _stream_scan_aggregate_inner(agg, chain, conf, device, recovery,
                                 chunks):
    first, wait0 = _next_chunk(iter(chunks))
    if first is None:
        return None

    joins, builds, saved_caps = prepare_chunk_joins(
        chain, conf, first.capacity, device, recovery)
    probe = replay_checked(chain, joins, conf, device, first, builds,
                           "streamed")
    prep = agg.prepare_direct(probe, conf)
    if prep is None:
        for j in joins:  # leave the whole-input fallback's caps alone
            j.out_cap = saved_caps[j.tag]
        return None

    check_dicts = _dict_growth_guard(agg, prep)
    tables = agg.direct_init_tables(prep)
    needs_base = any(a.func.uses_row_base for a in agg.agg_exprs)

    # running row base for position-packed aggregates: each chunk's
    # stride covers the largest post-replay capacity (join out_caps only
    # grow, so bases stay unique across re-plans)
    row_base = 0

    def chunk_stride(b):
        return max([b.capacity] + [j.out_cap or 0 for j in joins])

    def run_chunk(tables, b, replayed=None):
        if needs_base and row_base + chunk_stride(b) >= _ROW_BASE_BOUND:
            raise RuntimeError(
                "first/last over a streamed scan exceeds the 2^30 "
                "packed-position bound")
        if replayed is None:
            replayed = replay_checked(chain, joins, conf, device, b, builds,
                                      "streamed")
        return agg.direct_update_tables(tables, replayed, prep, conf,
                                        row_base=row_base)

    # chunk-granular retry: the tables advance only after a chunk
    # succeeds, so a TRANSIENT fault replays exactly the failed chunk
    retrier = ChunkRetrier(conf, recovery)
    clock = _ChunkClock(recovery, "direct", chunks)
    ci, b, wait = 0, first, wait0
    while b is not None:
        check_dicts(b)
        tick = clock.start(device)
        # the first chunk's chain ran for prepare_direct: a first attempt
        # reuses it, a replay runs it again
        first_try = [probe if ci == 0 else None]
        tables = retrier.run(
            lambda bb=b: run_chunk(tables, bb, first_try.pop()
                                   if first_try else None), chunk=ci)
        clock.stop(tick, wait)
        row_base += chunk_stride(b)
        ci += 1
        first = probe = None  # hold no chunk past its update
        b, wait = _next_chunk(chunks)  # ingest is not retried

    dict_overrides = dict(chunks.dictionaries) if hasattr(
        chunks, "dictionaries") else {}
    return agg.direct_finalize_tables(tables, prep, dict_overrides or None)


def stream_scan_aggregate_spill(agg: "P.HashAggregateExec", chain: List,
                                leaf: P.ScanExec, conf, device,
                                recovery=None):
    """Out-of-core aggregation for keys without a static domain (TPC-H
    Q3's l_orderkey): probe chunks stream through device-resident build
    sides, each chunk is reduced by a partial-mode sort aggregate (its
    table holds the chunk's capacity, so it cannot overflow), and the
    compacted partials are copied to host Arrow — host RAM in the role
    of the reference's executor disk (`UnsafeExternalSorter.java:1`,
    `ExternalAppendOnlyMap.scala:55`). Returns (the concatenated host
    partial table, the partial node) for the caller to re-reduce in a
    final-mode aggregate; None when nothing streamed."""
    chunks = _open_chunks(leaf, conf, device, recovery)
    try:
        return _stream_scan_aggregate_spill_inner(agg, chain, conf, device,
                                                  recovery, chunks)
    finally:
        if hasattr(chunks, "close"):
            chunks.close()


def _stream_scan_aggregate_spill_inner(agg, chain, conf, device, recovery,
                                       chunks):
    import pyarrow as pa
    first, wait = _next_chunk(iter(chunks))

    partial = copy.copy(agg)
    partial.mode = "partial"
    # the partial's table falls back to the chunk's capacity: a chunk has
    # no more groups than rows, so it needs no overflow retry of its own
    partial.est_groups = None

    if first is None:
        return None

    joins, builds, saved_caps = prepare_chunk_joins(
        chain, conf, first.capacity, device, recovery)

    def run_chunk(b):
        replayed = replay_checked(chain, joins, conf, device, b, builds,
                                  "spilled")
        out = partial.compute(P.ExecContext(conf, device), [replayed])
        # dictionary-encoded keys decode to strings here, so per-chunk
        # dictionaries unify by value in the concat
        return out.to_arrow()

    # the host copy rides inside the retried step: a flake there replays
    # only this chunk (its partial was not yet spilled)
    retrier = ChunkRetrier(conf, recovery)
    clock = _ChunkClock(recovery, "spill", chunks)
    spilled: List = []
    ci, b = 0, first
    while b is not None:
        tick = clock.start(device)
        spilled.append(retrier.run(lambda bb=b: run_chunk(bb), chunk=ci))
        clock.stop(tick, wait)
        ci += 1
        b, wait = _next_chunk(chunks)  # ingest is not retried
    for j in joins:
        j.out_cap = saved_caps[j.tag] if saved_caps[j.tag] is not None \
            else j.out_cap
    table = pa.concat_tables(spilled, promote_options="permissive")
    return table, partial


def try_stream_aggregate_spill(agg: "P.HashAggregateExec", conf, device,
                               recovery=None):
    """Device-budget gate of the partial-spill path: engages when the
    probe scan's estimated footprint exceeds the per-query
    `spark_tpu.sql.memory.deviceBudget`."""
    from ..io.device_cache import admit_scan_resident, out_of_core_active
    if not out_of_core_active(conf) or agg.mode != "complete":
        return None
    if any(a.func.uses_row_base for a in agg.agg_exprs):
        return None  # packed positions need whole-input row order
    if any(getattr(a.func, "positional", False) for a in agg.agg_exprs):
        return None  # no accumulator decomposition: whole input only
    found = find_streamable_chain(agg)
    if found is None:
        return None
    chain, leaf = found
    if not isinstance(leaf, P.ScanExec) or \
            not hasattr(leaf.source, "load_chunks"):
        return None
    if admit_scan_resident(conf, leaf):
        return None
    return stream_scan_aggregate_spill(agg, chain, leaf, conf, device,
                                       recovery)


def _dict_growth_guard(agg: "P.HashAggregateExec", prep):
    """A chunk whose dictionary outgrows the padded direct domain would
    alias groups: fail loudly instead."""
    dict_limits = {}
    for g, (dom, _lo), dic in zip(agg.group_exprs, prep.domains,
                                  prep.key_dicts):
        if dic is not None and len(g.references()) == 1:
            dict_limits[next(iter(g.references()))] = dom

    def check_dicts(b: Batch):
        for name, limit in dict_limits.items():
            col = b.columns.get(name)
            if col is not None and col.dictionary is not None \
                    and len(col.dictionary) > limit:
                raise RuntimeError(
                    f"dictionary of {name!r} grew past the padded direct "
                    f"domain ({len(col.dictionary)} > {limit}); raise "
                    f"spark_tpu.sql.aggregate.maxDirectDomain or disable "
                    f"streaming")

    return check_dicts


def _streamable_string_keys(agg, child_schema) -> bool:
    """Only bare string column references stream (their dictionary grows
    append-only through DictUnifier); derived string keys rebuild
    per-chunk dictionaries with unstable codes."""
    from ..expr import Alias, ColumnRef
    for g in agg.group_exprs:
        e = g
        while isinstance(e, Alias):
            e = e.child
        if not isinstance(e, ColumnRef) and \
                isinstance(e.dtype(child_schema), T.StringType):
            return False
    return True


def _prefer_resident(leaf: "P.ScanExec", conf, device) -> bool:
    """True when the scan should load whole and ride the device table
    cache instead of streaming: it is cached already, or its estimated
    footprint fits half the cache budget (so repeated queries skip host
    ingest)."""
    from ..io.device_cache import (CACHE_BYTES_KEY, admit_scan_resident,
                                   estimated_scan_bytes, is_cached,
                                   scan_cache_key)
    budget = int(conf.get(CACHE_BYTES_KEY))
    if budget <= 0:
        return False
    if scan_cache_key(leaf, device) is None:
        return False  # uncacheable source: residency would re-ingest
    if not is_cached(leaf, device):
        est_b = estimated_scan_bytes(leaf)
        if est_b is None or est_b > budget // 2:
            return False
    return admit_scan_resident(conf, leaf)


def mesh_stream_applies(agg: "P.HashAggregateExec", conf, device) -> bool:
    """Whether the JAX package would stream `agg` per shard on a mesh
    (`stream_scan_aggregate_mesh`'s gate): a partial aggregate over a
    unary chain from a chunkable scan past the chunk size that does not
    stay resident. That stream is slice 10b, not ported: the executor
    raises for such a plan rather than run it on one device."""
    if agg.mode != "partial":
        return False
    if any(getattr(a.func, "positional", False) for a in agg.agg_exprs):
        return False
    found = find_streamable_chain(agg, allow_joins=False)
    if found is None:
        return False
    chain, leaf = found
    if not isinstance(leaf, P.ScanExec):
        return False  # a Range synthesizes its stripe: nothing to stream
    if not _streamable_string_keys(agg, agg.child.schema()):
        return False
    if not hasattr(leaf.source, "load_chunks"):
        return False
    est = leaf.source.estimated_rows()
    if est is not None and est <= int(conf.get(CHUNK_ROWS_KEY)):
        return False
    return not _prefer_resident(leaf, conf, device)


def try_stream_aggregate(agg: "P.HashAggregateExec", conf, device,
                         recovery=None) -> Optional[Batch]:
    """The direct stream of `agg`, or None when it does not apply (not a
    complete dense aggregate over a chunkable chain, or a scan small
    enough to load whole)."""
    if agg.mode != "complete":
        return None
    if any(getattr(a.func, "positional", False) for a in agg.agg_exprs):
        return None  # no accumulator decomposition: whole input only
    found = find_streamable_chain(agg)
    if found is None:
        return None
    if not _streamable_string_keys(agg, agg.child.schema()):
        return None
    chain, leaf = found
    chunk_rows = int(conf.get(CHUNK_ROWS_KEY))
    if isinstance(leaf, P.RangeExec):
        if any(isinstance(op, P.JoinExec) for op in chain):
            return None  # a joined Range runs whole
        if leaf.num_rows() <= chunk_rows:
            return None
        return stream_range_aggregate(agg, chain, leaf, conf, device,
                                      recovery)
    est = leaf.source.estimated_rows()
    if est is not None and est <= chunk_rows:
        return None
    if not hasattr(leaf.source, "load_chunks"):
        return None
    if _prefer_resident(leaf, conf, device):
        return None
    return stream_scan_aggregate(agg, chain, leaf, conf, device, recovery)
