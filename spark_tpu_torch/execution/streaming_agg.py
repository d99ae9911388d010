"""Streaming (chunked) aggregation (the port of
`spark_tpu/execution/streaming_agg.py`; reference: the produce/consume
loop of `WholeStageCodegenExec` and
`TungstenAggregationIterator.scala:82`, which never materialize a scan).

A scan past the device budget is not loaded whole: its chunks (host
ingested, or synthesized on the device for a Range) go one at a time
through the aggregate's chain of Project/Filter (and probe-side joins,
whose build sides are materialized once), and each chunk is folded into
accumulator tables carried across chunks. Three loops:

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
  the scan does not fit, and resumes a failed mesh stream on one device
  from its checkpoint (`resume_from_mesh_checkpoint`).
- **mesh stream** (`stream_scan_aggregate_mesh`): a partial aggregate on
  a mesh. Each chunk is decoded on the host, padded (or re-assigned
  away from a straggler, `parallel/elastic.py`) and striped over the
  shards; one `run_on_shards` call a chunk has every shard copy its
  stripe to its own device and fold it into its own tables with
  `direct_update_tables` (the hand kernel on a card). The stream ends
  with each shard's partial rows on its device, which the exchange and
  final aggregate above consume. Every `checkpoint.everyChunks` chunks
  the tables are snapshotted to the host (execution/recovery.py), a
  drain request is honoured at each chunk boundary, and the per-shard
  live-row counts feed `spans.ShardStreamTelemetry`.

The JAX package compiles one jitted update per stream (one `shard_map`ped
step on a mesh) and caches it per conf (`conf_compile_suffix`); eager
torch has no compiled stages, so neither exists here. The arbiter's
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
from .recovery import CHECKPOINT_EVERY_KEY, ChunkRetrier

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
    update's host time, with CUDA events around the update on a card.
    The mesh stream adds each shard's stripe copy seconds
    (`stripe_copy_s`), CUDA events around each shard's update
    (`shard_events`) and its agreements' seconds (`agree_s`: the drain
    request and the per-shard records' gather, outside `update_s`)."""

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

    def stop(self, token, wait_s: float, outside_s: float = 0.0,
             **extra) -> None:
        """`outside_s`: seconds since `start` that were not the update's
        (a cluster's gathers, which the mesh stream records apart)."""
        t0, ev = token
        if ev is not None:
            ev[1].record()
        rec = {"wait_s": wait_s,
               "update_s": time.perf_counter() - t0 - outside_s,
               "events": ev, **extra}
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
                                recovery=None, skip_chunks: int = 0,
                                seed_partials: Optional[List] = None):
    """Out-of-core aggregation for keys without a static domain (TPC-H
    Q3's l_orderkey): probe chunks stream through device-resident build
    sides, each chunk is reduced by a partial-mode sort aggregate (its
    table holds the chunk's capacity, so it cannot overflow), and the
    compacted partials are copied to host Arrow — host RAM in the role
    of the reference's executor disk (`UnsafeExternalSorter.java:1`,
    `ExternalAppendOnlyMap.scala:55`). Returns (the concatenated host
    partial table, the partial node) for the caller to re-reduce in a
    final-mode aggregate; None when nothing streamed.

    The checkpoint restore resumes a failed mesh stream on one device
    through this loop: `skip_chunks` moves the cursor past what the
    checkpoint covers, and `seed_partials` (the checkpoint's partial
    rows) go before the spilled chunks."""
    chunks = _open_chunks(leaf, conf, device, recovery)
    try:
        return _stream_scan_aggregate_spill_inner(
            agg, chain, conf, device, recovery, chunks, skip_chunks,
            seed_partials)
    finally:
        if hasattr(chunks, "close"):
            chunks.close()


def _stream_scan_aggregate_spill_inner(agg, chain, conf, device, recovery,
                                       chunks, skip_chunks=0,
                                       seed_partials=None):
    import pyarrow as pa
    if skip_chunks:
        if not hasattr(chunks, "skip_chunks") or \
                chunks.skip_chunks(skip_chunks) < skip_chunks:
            return None  # the stream is shorter than the cursor
    first, wait = _next_chunk(iter(chunks))

    partial = copy.copy(agg)
    partial.mode = "partial"
    # the partial's table falls back to the chunk's capacity: a chunk has
    # no more groups than rows, so it needs no overflow retry of its own
    partial.est_groups = None

    if first is None:
        if seed_partials:
            # the resume landed at the end of the stream: the checkpoint
            # covers every chunk
            return pa.concat_tables(list(seed_partials),
                                    promote_options="permissive"), partial
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
    spilled: List = list(seed_partials or [])
    ci, b = int(skip_chunks), first
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


def checkpoint_key(agg: "P.HashAggregateExec", leaf: P.ScanExec,
                   chunk_rows: int) -> str:
    """The plan-independent identity of a resumable stream: the mesh
    partial aggregate that saves a checkpoint and the single-device
    complete aggregate that restores it are different nodes of different
    plans, but stream the same source rows under the same chunk
    boundaries into the same aggregation. The source's identity, the
    pruned columns, the pushed filters (their values), the group and
    aggregate names and the chunk size pin all of that; any mismatch
    (the OOM ladder shrank streamingChunkRows) leaves the checkpoint
    unmatched, and the recovery restarts from chunk 0."""
    token = leaf.source.cache_token()
    src = repr(token) if token is not None else f"name:{leaf.source.name}"
    cols = sorted(leaf.required_columns or [])
    filters = sorted(f.name() for f in (leaf.pushed_filters or ()))
    groups = [g.name() for g in agg.group_exprs]
    aggs = [f"{type(a.func).__name__}:{a.out_name}" for a in agg.agg_exprs]
    return (f"{src}|cols{cols}|f{filters}"
            f"|g{groups}|a{aggs}|c{chunk_rows}")


def _with_dict_overrides(batch: Batch, dict_overrides: dict) -> Batch:
    """Swap a stream's grown dictionaries into a partial batch's
    dictionary-encoded columns (earlier codes stay valid: DictUnifier
    grows append-only)."""
    if not dict_overrides:
        return batch
    cols = dict(batch.columns)
    for name, dic in dict_overrides.items():
        if name in cols and cols[name].dictionary is not None:
            c = cols[name]
            cols[name] = Column(c.data, c.dtype, c.validity, dic)
    return Batch(cols, batch.selection, batch.device)


def resume_from_mesh_checkpoint(agg: "P.HashAggregateExec", conf, device,
                                recovery=None):
    """The mesh fallback's restore: when the failed mesh stream left a
    checkpoint matching this (single-device, complete-mode) aggregate,
    stream only the chunks past its cursor through the partial-spill
    loop, the checkpoint's partial rows first, for the caller to
    re-reduce in a final aggregate. Returns (partial table, partial
    node) like stream_scan_aggregate_spill, or None when no checkpoint
    applies."""
    if recovery is None or not recovery.checkpoints:
        return None
    if agg.mode != "complete":
        return None
    if any(a.func.uses_row_base for a in agg.agg_exprs):
        return None  # never checkpointed (packed positions are per run)
    if any(getattr(a.func, "positional", False) for a in agg.agg_exprs):
        return None
    found = find_streamable_chain(agg)
    if found is None:
        return None
    chain, leaf = found
    if not isinstance(leaf, P.ScanExec) or \
            not hasattr(leaf.source, "load_chunks"):
        return None
    chunk_rows = int(conf.get(CHUNK_ROWS_KEY))
    ck = recovery.get_checkpoint(checkpoint_key(agg, leaf, chunk_rows))
    if ck is None:
        return None
    out = stream_scan_aggregate_spill(agg, chain, leaf, conf, device,
                                      recovery=recovery,
                                      skip_chunks=ck.cursor,
                                      seed_partials=[ck.table])
    if out is None:
        return None
    replayed = recovery.restore_replayed(ck.key, ck.cursor)
    recovery.record("checkpoint_restore", None, cursor=int(ck.cursor),
                    ckpt_rows=int(ck.table.num_rows),
                    chunks_replayed=replayed)
    return out


def _head_rows(batch: Batch, k: int) -> Batch:
    """The first `k` rows of a batch (views of its tensors)."""
    from ..parallel.shuffle import _slice_rows
    k = min(k, batch.capacity)
    return Batch({name: _slice_rows(col, 0, k)
                  for name, col in batch.columns.items()},
                 batch.selection_mask()[:k], batch.device)


def _row_width(b: Batch) -> int:
    return sum(c.data.element_size() + (1 if c.validity is not None else 0)
               for c in b.columns.values())


def stream_scan_aggregate_mesh(agg: "P.HashAggregateExec", mesh, conf,
                               device, recovery=None):
    """A partial aggregate over a chunked scan on a mesh: each chunk is
    striped over the shards and folded into per-shard accumulator
    tables, so only the tables stay on the devices between chunks.
    Returns each shard's partial batch on its own device (a list), the
    checkpoint's rows and the resumed tail's as one batch after a
    resume, or None when the stream does not apply (the gate: a partial
    aggregate over a unary chain of a chunkable scan past the chunk size
    that does not stay resident). `device` is the session's, which the
    residency gate reads.

    On a mesh that spans engine processes every process decodes every
    chunk, as every JAX process hands the same host chunk to its sharded
    placement, and copies only its own positions' stripes; the list
    holds this process's positions' partials (None at the others'). What
    a process decides alone is agreed: the gate (two processes on one
    card see different free memory, so the scan streams unless every
    process would keep it resident, and the per-shard telemetry runs
    when any process's would), the resume cursor, a drain at each chunk
    boundary (`elastic.pending_decommission`) and the straggler flags
    (the telemetry gathers every process's waits). A checkpoint holds
    the whole gang's partial rows, gathered, so every process saves the
    same table at the same cursor. The chunk step makes no collective:
    `ChunkRetrier` replays it in one process alone."""
    if agg.mode != "partial":
        return None
    if any(getattr(a.func, "positional", False) for a in agg.agg_exprs):
        return None  # no accumulator decomposition: whole input only
    # unary chains only: a streamed join would need its build on every
    # shard
    found = find_streamable_chain(agg, allow_joins=False)
    if found is None:
        return None
    chain, leaf = found
    if not isinstance(leaf, P.ScanExec):
        return None  # a Range synthesizes its stripe: nothing to stream
    if not _streamable_string_keys(agg, agg.child.schema()):
        return None
    if not hasattr(leaf.source, "load_chunks"):
        return None
    chunk_rows = int(conf.get(CHUNK_ROWS_KEY))
    est = leaf.source.estimated_rows()
    if est is not None and est <= chunk_rows:
        return None

    from ..observability.spans import current_shard_telemetry
    telem = current_shard_telemetry()
    resident = _prefer_resident(leaf, conf, device)
    cl = mesh.cluster
    if cl is not None:
        votes = cl.all_gather_object(
            (resident, telem is not None and telem.active), "stream gate")
        resident = all(v[0] for v in votes)
        if telem is not None:
            telem.active = any(v[1] for v in votes)
    if resident:
        return None
    if telem is not None and not telem.active:
        telem = None
    needs_base = any(a.func.uses_row_base for a in agg.agg_exprs)
    every = int(conf.get(CHECKPOINT_EVERY_KEY))
    # position-packed aggregates take no checkpoint and no rebalance:
    # their packed row bases encode the assignment
    ck_key = checkpoint_key(agg, leaf, chunk_rows) \
        if recovery is not None and not needs_base else None
    save_key = ck_key if every > 0 else None
    # a gang restart (or a drain's re-execution) enters again with the
    # failed stream's checkpoint: skip the chunks it covers and add its
    # rows at the end, so the recovery replays at most everyChunks
    # chunks on the mesh
    ck = recovery.get_checkpoint(ck_key) if ck_key is not None else None
    if cl is not None and ck_key is not None:
        ck = _agree_resume(cl, recovery, ck_key, ck)
    # chunks decode on the host; each shard copies its own stripe to its
    # device
    chunks = _open_chunks(leaf, conf, torch.device("cpu"), recovery)
    try:
        return _stream_scan_aggregate_mesh_inner(
            agg, chain, mesh, conf, recovery, chunks, telem, needs_base,
            every, ck_key, save_key, ck)
    finally:
        # join the prefetch worker on every exit: a mesh fault, a drain
        # or a cancel unwinding mid-stream must not leak it
        if hasattr(chunks, "close"):
            chunks.close()


def _agree_resume(cl, recovery, ck_key: str, ck):
    """The resume every process of a cluster takes: the checkpoint when
    every process holds one at the same cursor (else none: the stream
    starts again at chunk 0 everywhere), with the consumed-chunk
    watermark the gang reached (the least of the processes'), so every
    process reports the same replay."""
    votes = cl.all_gather_object(
        (None if ck is None else int(ck.cursor), recovery.progress(ck_key)),
        "stream resume")
    cursors = {c for c, _p in votes}
    recovery.agree_progress(ck_key, min(p for _c, p in votes))
    if ck is None or len(cursors) != 1:
        return None
    return ck


def _stream_scan_aggregate_mesh_inner(agg, chain, mesh, conf, recovery,
                                      chunks, telem, needs_base, every,
                                      ck_key, save_key, ck):
    import dataclasses
    import pyarrow as pa
    from ..parallel import elastic as EL
    from ..parallel.mesh import run_on_shards
    from ..parallel.shuffle import move_batch, shard_stripes
    from ..testing import faults
    n = mesh.size
    local = mesh.local_positions
    cl = mesh.cluster
    if ck is not None:
        if not hasattr(chunks, "skip_chunks") or \
                chunks.skip_chunks(ck.cursor) < ck.cursor:
            return None  # the stream is shorter than the cursor

    def record_restore():
        replayed = recovery.restore_replayed(ck_key, ck.cursor)
        recovery.record("checkpoint_restore", None,
                        cursor=int(ck.cursor),
                        ckpt_rows=int(ck.table.num_rows),
                        chunks_replayed=replayed, driver="mesh")

    t_in0 = time.perf_counter()
    first, wait = _next_chunk(iter(chunks))
    if first is None:
        if ck is not None:
            # the resume landed at the end of the stream: the
            # checkpoint's partial rows are the stream's result
            record_restore()
            return Batch.from_arrow(ck.table, mesh.local_devices[0])
        return None
    # the layout reads dtypes and dictionaries only: a few rows do
    prep = agg.prepare_direct(
        _replay_chain(chain, P.ExecContext(conf, first.device),
                      _head_rows(first, 8)), conf)
    if prep is None:
        return None
    # one layout per local shard device: each shard keeps its tables on
    # its own
    preps = {i: dataclasses.replace(prep, device=mesh.devices[i])
             for i in local}
    tables = {i: agg.direct_init_tables(preps[i]) for i in local}
    check_dicts = _dict_growth_guard(agg, prep)
    chunk_base = 0

    # straggler rebalancing: inert until the ElasticRebalancer flags a
    # shard through on_straggler; then each chunk's rows move away from
    # it (position-packed aggregates keep the even split)
    rebal = EL.RebalanceState(n, conf, recovery=recovery) \
        if not needs_base else None

    def step(tables, b):
        nonlocal chunk_base
        padded = EL.pad_chunk_for_shards(b, n, rebal)
        if needs_base and chunk_base + padded.capacity >= _ROW_BASE_BOUND:
            raise RuntimeError(
                "first/last over a streamed mesh scan exceeds the 2^30 "
                "packed-position bound")
        stripes = shard_stripes(padded, n)
        base = chunk_base

        def shard(i, group):
            dev = mesh.devices[i]
            t0 = time.perf_counter()
            local_b = move_batch(stripes[i], dev)
            copy_s = time.perf_counter() - t0
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) \
                if dev.type == "cuda" else None
            if ev is not None:
                ev[0].record()
            local_b = _replay_chain(chain, P.ExecContext(conf, dev), local_b)
            # unique packed positions: chunks stride the padded chunk's
            # capacity, shards (by global position) the stripe's
            new = agg.direct_update_tables(
                tables[i], local_b, preps[i], conf,
                row_base=base + i * local_b.capacity)
            if ev is not None:
                ev[1].record()
            # this shard's live rows, left on its device (no sync): the
            # per-shard telemetry times readiness off it
            live = local_b.selection_mask().sum(dtype=torch.int64)
            return new, live, copy_s, ev

        t_disp = time.perf_counter()
        results = run_on_shards(mesh, shard)
        chunk_base += padded.capacity
        return ({i: results[i][0] for i in local},
                {"stripe_copy_s": [results[i][2] for i in local],
                 "shard_events": [results[i][3] for i in local]},
                [None if r is None else r[1] for r in results], t_disp)

    def partials():
        overrides = dict(chunks.dictionaries) if hasattr(
            chunks, "dictionaries") else {}
        return [_with_dict_overrides(
            agg.direct_partial_batch(tables[i], preps[i]), overrides)
            for i in local]

    def snapshot():
        # the accumulators to the host as partial rows (the shape a final
        # aggregate consumes), decoded against the dictionaries grown so
        # far, every position's in position order (a cluster gathers
        # them); a resumed stream's tables cover the chunks past the
        # cursor only, so the seed checkpoint's rows go first
        mine = [b.to_arrow() for b in partials()]
        parts = mine if cl is None else [
            t for per in cl.all_gather_object(mine, "checkpoint")
            for t in per]
        if ck is not None:
            parts = [ck.table] + parts
        return pa.concat_tables(parts, promote_options="permissive")

    def gather_records(records):
        return [r for per in cl.all_gather_object(records, "shard records")
                for r in per]

    gather = gather_records if cl is not None else None
    if ck is not None:
        # the cursor was skipped and the layout holds: the resume runs
        record_restore()
    retrier = ChunkRetrier(conf, recovery)
    clock = _ChunkClock(recovery, "mesh", chunks)
    ci = int(ck.cursor) if ck is not None else 0
    b = first
    with EL.use_rebalance(rebal):
        while b is not None:
            # graceful decommission at the chunk boundary: the seam fires
            # first (a fault there is the drain machinery dying, and
            # takes the mesh ladder), then a checkpoint at the cursor, so
            # the reduced gang resumes here; the request surfaces to the
            # executor on this thread
            t_agree = time.perf_counter()
            drain, drain_ids = EL.pending_decommission(conf, mesh)
            agree_s = time.perf_counter() - t_agree
            if drain:
                faults.fire("decommission")
                if save_key is not None and ci > 0:
                    recovery.save_checkpoint(save_key, ci, snapshot)
                raise EL.MeshDecommissionRequest(drain, drain_ids)
            if telem is not None:
                telem.chunk_ingested(ci, b.capacity,
                                     b.capacity * _row_width(b), t_in0,
                                     t_in0 + wait)
            check_dicts(b)
            tick = clock.start(torch.device("cpu"))
            tables, extra, lives, t_disp = retrier.run(
                lambda bb=b: step(tables, bb), chunk=ci)
            gather_s = 0.0
            if telem is not None:
                # the previous chunk's counts flush here, gathered across
                # processes, after the step and never inside it
                gather_s = telem.chunk_dispatched(ci, lives, _row_width(b),
                                                  t_disp, gather)
            clock.stop(tick, wait, outside_s=gather_s,
                       agree_s=agree_s + gather_s, **extra)
            ci += 1
            if ck_key is not None:
                # the consumed-chunk watermark bounds what a later
                # restore reports as replayed
                recovery.note_progress(ck_key, ci)
            if save_key is not None and ci % every == 0:
                recovery.save_checkpoint(save_key, ci, snapshot)
            t_in0 = time.perf_counter()
            b, wait = _next_chunk(chunks)  # ingest is not retried

    if telem is not None:
        telem.finish(gather)  # the last chunk's records
    if ck is not None:
        # the seed checkpoint's rows and the whole gang's resumed tails:
        # the final aggregate above reduces both, and every process
        # takes its own stripes of the same rows
        return Batch.from_arrow(snapshot(), mesh.local_devices[0])
    out = [None] * n
    for i, part in zip(local, partials()):
        out[i] = part
    return out


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
