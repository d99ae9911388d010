"""Physical-plan analyzer (the port of `spark_tpu/analysis/plan_analyzer.py`:
the same checks, finding codes, messages and details).

Runs after planning and before anything loads or launches: a walk over
the physical plan on the host -- no tensor is read, no device memory is
allocated -- that turns hazards found at runtime (or never) into typed
`Finding`s:

- **dtype-overflow**: SUM/AVG whose input-row bound x max value
  magnitude exceeds the int64 accumulator range. Magnitude bounds come
  from `expr.static_unsigned_bits` (pmod/literal shapes), integral
  widths, decimal precision, or the Parquet footers' min/max
  (`_footer_value_bits`); *unbounded* 64-bit inputs are assumed in
  range. The port's premise is the JAX package's: every integral and
  decimal SUM/AVG accumulates in int64 (`expr_agg.Sum.accumulators`,
  and `dense_sums_*` add 64-bit words), so 2^63 is the wrap point.
- **host-sync**: plans that execute through per-chunk host-driven loops
  (streaming aggregates past `streamingChunkRows`, deviceBudget spill
  reroutes, Python UDF round trips, explode under a mesh). The port's
  premise: its chunk loop (`io/sources.PrefetchChunkIterator` feeding
  `execution/streaming_agg.py`) decodes each chunk on the host, copies it
  to the card and reads the chunk's group statistics back, one blocking
  device-to-host sync per chunk, as the JAX package's `device_get` does.
- **recompile**: capacities written into the plan's `describe()` (the
  stage key in the JAX package; here the key of the kept capacities,
  `session._aqe_caps`, and of the device-cost records) that are not
  bucket-aligned, so the key varies with exact input sizes. The port's
  capacity buckets are the JAX package's (`columnar.bucket_capacity`).
- **kernel**: a join the conf would run on the hash table whose clamped
  table forces the sort fallback or outgrows the device budget
  (`execution/hash_join.kernel_choice`, the one decision procedure).
- **mesh**: exchanges that copy a full relation to every shard
  (broadcast) or gather all rows onto every shard (single partition).
- **x64**: 64-bit columns whose device representation is narrower. The
  JAX package keys this on `jax_enable_x64` being off; torch has no such
  switch, and the port's premise is its dtype map: a 64-bit column is
  truncated only if `types.torch_dtype` gives it a narrower tensor
  dtype. The map is exact for every type, so a torch plan never meets
  `X64_TRUNCATION`; the check stays so that a narrower map would show.

The walk must never fail a query: callers wrap it, and per-node checks
swallow their own analysis errors.
"""

from __future__ import annotations

import math
from typing import List, Optional

from ..columnar import bucket_capacity
from ..plan import physical as P
from .. import types as T
from .findings import Finding

#: int64 accumulator magnitude bits (AccSpec np_dtype is int64; sums
#: wrap past 2^63)
_ACC_BITS = 63

#: decimal precisions above this already exceed int64 representation —
#: the engine's scaled-int64 column is the binding cap, not the
#: accumulator, so the analyzer has nothing tighter to say
_MAX_BOUNDED_DECIMAL_PRECISION = 18


def _node_loc(node: P.PhysicalPlan) -> str:
    tag = getattr(node, "op_tag", "") or getattr(node, "tag", "")
    name = type(node).__name__
    return f"{name}[{tag}]" if tag else name


def _estimate_rows(node: P.PhysicalPlan) -> Optional[int]:
    from ..plan.runtime_filter import estimate_rows_physical
    try:
        return estimate_rows_physical(node)
    except Exception:  # noqa: BLE001 — estimates are best-effort
        return None


def _value_bits(expr, schema) -> Optional[int]:
    """Static bound b with |values| < 2^b, or None (unbounded/unknown).
    Order matters: an expression-level bound (pmod/literal) beats the
    dtype width."""
    from ..expr import static_unsigned_bits
    w = static_unsigned_bits(expr)
    if w is not None:
        return min(w, 63)
    try:
        dt = expr.dtype(schema)
    except Exception:  # noqa: BLE001 — unresolvable: no bound
        return None
    if isinstance(dt, T.DecimalType):
        if dt.precision > _MAX_BOUNDED_DECIMAL_PRECISION:
            return None
        return max(1, math.ceil(dt.precision * math.log2(10)))
    if isinstance(dt, T.BooleanType):
        return 1
    if isinstance(dt, T.IntegralType):
        width = 8 * dt.np_dtype.itemsize - 1
        return width if width < 63 else None
    return None


def _find_transparent_scan(node: P.PhysicalPlan, name: str
                           ) -> Optional[P.ScanExec]:
    """The ScanExec that produces column `name` UNCHANGED below
    `node`, or None. Same discipline as the runtime-filter descent's
    `_keys_transparent`: name resolution alone is not enough — a
    Project aliasing a different expression onto the name, an
    ambiguous join, or an aggregate computing it means the scan's
    footer bounds do not bound the column's values here."""
    from ..expr import Alias, ColumnRef
    if isinstance(node, P.ScanExec):
        try:
            names = node.schema().names
        except Exception:  # noqa: BLE001
            return None
        return node if name in names else None
    if isinstance(node, (P.FilterExec, P.ExchangeExec, P.SortExec,
                         P.LimitExec, P.RuntimeFilterExec)):
        return _find_transparent_scan(node.children[0], name)
    if isinstance(node, P.ProjectExec):
        for e in node.exprs:
            if e.name() != name:
                continue
            base = e
            while isinstance(base, Alias):
                base = base.child
            if isinstance(base, ColumnRef) and base.name() == name:
                return _find_transparent_scan(node.children[0], name)
            return None
        return None
    if isinstance(node, P.JoinExec):
        try:
            in_left = name in node.left.schema().names
            in_right = name in node.right.schema().names
        except Exception:  # noqa: BLE001
            return None
        if in_left and in_right:
            return None  # ambiguous origin
        if in_left:
            return _find_transparent_scan(node.left, name)
        if in_right:
            return _find_transparent_scan(node.right, name)
    return None


def _footer_value_bits(expr, node: P.PhysicalPlan, conf
                       ) -> Optional[int]:
    """Magnitude bound from Parquet-footer column statistics: bits b
    with |values| < 2^b for a plain column reference whose scan-level
    min/max survived the descent. Tightens (or, for unbounded 64-bit
    inputs, establishes) the dtype-width bound — the carried ROADMAP
    lever."""
    from ..expr import Alias, ColumnRef
    if conf is None or not bool(conf.get(
            "spark_tpu.sql.stats.parquetFooter")):
        return None
    base = expr
    while isinstance(base, Alias):
        base = base.child
    if not isinstance(base, ColumnRef):
        return None
    name = base.name()
    scan = _find_transparent_scan(node.children[0], name)
    if scan is None:
        return None
    try:
        stats = (scan.source.column_stats() or {}).get(name)
        dt = scan.schema().field(name).dtype
    except Exception:  # noqa: BLE001 — stats are advisory
        return None
    if stats is None:
        return None
    import decimal
    mags = []
    for v in (stats.get("min"), stats.get("max")):
        if isinstance(v, bool) or not isinstance(
                v, (int, decimal.Decimal)):
            return None
        if isinstance(dt, T.DecimalType):
            v = int(abs(decimal.Decimal(v)).scaleb(dt.scale))
        else:
            v = abs(int(v))
        mags.append(v)
    return max(1, int(max(mags)).bit_length())


def _check_agg_overflow(node: P.HashAggregateExec, out: List[Finding],
                        conf=None) -> None:
    """SUM/AVG accumulators are int64 for integral/decimal inputs
    (expr_agg.Sum.accumulators); a bound of rows x 2^value_bits past
    2^63 means the total can wrap with no error raised anywhere.
    Magnitude bounds take the TIGHTEST of the expression/dtype bound
    and the Parquet-footer min/max bound."""
    from ..expr_agg import Avg, Sum
    if node.mode == "final":
        return  # the partial stage below already carries the bound
    rows = _estimate_rows(node.children[0])
    if rows is None or rows <= 0:
        return
    rows_bits = max(1, int(rows - 1).bit_length())
    base = node._base_schema()
    for a in node.agg_exprs:
        f = a.func
        if not isinstance(f, (Sum, Avg)) or f.child is None:
            continue
        try:
            dt = f.child.dtype(base)
        except Exception:  # noqa: BLE001
            continue
        if isinstance(dt, T.FloatType) and rows >= (1 << 24):
            out.append(Finding(
                "SUM_F32_INPUT",
                f"{a.out_name}: summing ~{rows:,} float32 values; the "
                f"inputs carry 24-bit mantissas, so the accumulated "
                f"total inherits their rounding error",
                op=_node_loc(node),
                detail={"rows_bound": int(rows)}))
            continue
        if not isinstance(dt, (T.IntegralType, T.DecimalType)):
            continue
        bits = _value_bits(f.child, base)
        footer_bits = _footer_value_bits(f.child, node, conf)
        if footer_bits is not None:
            bits = footer_bits if bits is None else min(bits, footer_bits)
        if bits is None:
            continue
        if rows_bits + bits > _ACC_BITS:
            out.append(Finding(
                "SUM_I64_OVERFLOW",
                f"{a.out_name}: up to ~{rows:,} rows x |value| < "
                f"2^{bits} needs {rows_bits + bits} bits; the int64 "
                f"accumulator holds {_ACC_BITS} — the sum can wrap "
                f"silently",
                op=_node_loc(node),
                detail={"rows_bound": int(rows), "value_bits": int(bits),
                        "required_bits": int(rows_bits + bits),
                        "acc_bits": _ACC_BITS, "agg": repr(f)}))


#: scan bound above which a row-at-a-time UDF's per-row interpreter
#: crossings dominate the stage (the @pandas_udf suggestion threshold)
_UDF_SCALAR_LARGE_ROWS = 1 << 16


def _check_udf_roundtrip(root: P.PhysicalPlan, conf,
                         out: List[Finding]) -> None:
    """UDF_HOST_ROUNDTRIP with a batch-count/bytes prediction derived
    from scan estimates (graded by history.prediction_report against
    the observed `udf_batches`/`udf_rows` counters), plus an info note
    per scalar UDF sitting over a large scan."""
    from ..execution.python_eval import node_udfs
    max_rec = int(conf.get(
        "spark_tpu.sql.udf.arrow.maxRecordsPerBatch"))
    rows_total = 0
    bytes_total = 0
    udf_nodes = 0
    scalar_large: List[tuple] = []
    seen = set()

    def walk(node):
        nonlocal rows_total, bytes_total, udf_nodes
        if id(node) in seen:
            return
        seen.add(id(node))
        for c in node.children:
            walk(c)
        udfs = node_udfs(node)
        if not udfs:
            return
        udf_nodes += 1
        src = node.children[0] if node.children else node
        rows = _estimate_rows(src)
        if rows is None or rows <= 0:
            return
        rows_total += rows
        try:
            width = 8 * max(1, len(src.schema().fields))
        except Exception:  # noqa: BLE001 — width is best-effort
            width = 8
        bytes_total += rows * width
        for u in udfs:
            if not u.vectorized and rows >= _UDF_SCALAR_LARGE_ROWS:
                scalar_large.append((u.udf_name, int(rows), node))

    walk(root)
    if not udf_nodes:
        return
    detail = {"max_records_per_batch": max_rec}
    msg = ("plan contains Python UDFs: the stage splits around a "
           "device->host->device round trip per batch")
    if rows_total:
        detail.update(
            rows_bound=int(rows_total),
            batches_bound=int(-(-rows_total // max_rec)),
            bytes_bound=int(bytes_total))
        msg += (f" (~{detail['batches_bound']:,} batches of <= "
                f"{max_rec:,} rows, ~{rows_total:,} rows round-tripped)")
    out.append(Finding("UDF_HOST_ROUNDTRIP", msg,
                       op=_node_loc(root), detail=detail))
    for name, rows, node in scalar_large:
        out.append(Finding(
            "UDF_SCALAR_LARGE_INPUT",
            f"{name}: scalar UDF over ~{rows:,} input rows crosses "
            f"the interpreter once per row; @pandas_udf evaluates the "
            f"same logic once per <= {max_rec:,}-row Arrow batch",
            op=_node_loc(node),
            detail={"rows_bound": int(rows), "udf": name}))


def _check_host_sync(root: P.PhysicalPlan, conf,
                     mesh_n: int, out: List[Finding]) -> None:
    _check_udf_roundtrip(root, conf, out)

    chunk_rows = int(conf.get(
        "spark_tpu.sql.execution.streamingChunkRows"))
    budget = int(conf.get("spark_tpu.sql.memory.deviceBudget"))
    seen = set()  # runtime-filter creation chains DAG-share their
    # leaves with the join build side: analyze each node once

    def walk(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for c in node.children:
            walk(c)
        if isinstance(node, P.GenerateExec) and mesh_n > 1:
            out.append(Finding(
                "GENERATE_MESH_MATERIALIZE",
                "explode under a mesh executes its subtree single-device "
                "(host-materialized) before sharding the flat result",
                op=_node_loc(node)))
        if isinstance(node, P.HashAggregateExec) \
                and node.mode in ("complete", "partial"):
            from ..execution.streaming_agg import find_streamable_chain
            found = find_streamable_chain(node)
            if found is None:
                return
            _chain, leaf = found
            rows = _estimate_rows(leaf)
            if rows is not None and rows > chunk_rows > 0:
                n_chunks = -(-rows // chunk_rows)
                out.append(Finding(
                    "STREAMING_HOST_SYNC",
                    f"~{rows:,} input rows stream through the aggregate "
                    f"in ~{n_chunks} chunks of {chunk_rows:,}, each with "
                    f"a blocking device->host stats sync",
                    op=_node_loc(node),
                    detail={"rows_bound": int(rows),
                            "chunks": int(n_chunks)}))
        if isinstance(node, P.ScanExec) and budget > 0:
            from ..io.device_cache import estimated_scan_bytes
            try:
                est_b = estimated_scan_bytes(node)
            except Exception:  # noqa: BLE001
                est_b = None
            if est_b is not None and est_b > budget:
                out.append(Finding(
                    "SPILL_HOST_SYNC",
                    f"estimated scan footprint ~{est_b:,} bytes exceeds "
                    f"memory.deviceBudget={budget:,}: execution reroutes "
                    f"through the host-spill chunked path",
                    op=_node_loc(node),
                    detail={"estimated_bytes": int(est_b),
                            "budget_bytes": int(budget)}))

    walk(root)


def _check_recompile(root: P.PhysicalPlan, conf,
                     out: List[Finding]) -> None:
    """Every capacity below appears verbatim in `simple_string()` and
    hence in the plan's `describe()`, the key the kept capacities and the
    device-cost records go by (the JAX package's stage-cache key): an
    unbucketed value means two inputs differing by one row key two
    distinct entries (in the JAX package, compile two XLA programs).

    Alignment is checked against `bucket_capacity`'s DEFAULT growth —
    the one every producer in the engine actually pads with (planner,
    AQE cap growth, runtime-filter sizing all call it bare). The
    `bucketGrowth` conf is deliberately not consulted here: no producer
    threads it through yet, so validating against a non-default value
    would flag every engine-produced power-of-two capacity."""

    def flag(node, kind: str, value: int) -> None:
        if value is None:
            return
        if bucket_capacity(int(value)) != int(value):
            out.append(Finding(
                "UNBUCKETED_CAPACITY",
                f"{kind}={value:,} is not bucket-aligned: the "
                f"stage-cache key varies with exact input sizes — "
                f"expect a recompile per size instead of per bucket",
                op=_node_loc(node),
                detail={"kind": kind, "value": int(value),
                        "bucketed": bucket_capacity(int(value))}))

    seen = set()

    def walk(node):
        if id(node) in seen:  # runtime-filter creation chains DAG-share
            return
        seen.add(id(node))
        for c in node.children:
            walk(c)
        if isinstance(node, P.JoinExec):
            flag(node, "join.out_cap", node.out_cap)
        elif isinstance(node, P.ExchangeExec):
            flag(node, "exchange.block_cap", node.block_cap)
        elif isinstance(node, P.HashAggregateExec):
            flag(node, "aggregate.est_groups", node.est_groups)
        elif isinstance(node, P.RuntimeFilterExec):
            flag(node, "runtime_filter.est_items", node.est_items)

    walk(root)


def _check_hash_join(root: P.PhysicalPlan, conf,
                     out: List[Finding]) -> None:
    """Predict degraded hash-kernel choices (JOIN_HASH_TABLE_PRESSURE):
    for each join the conf would run on the hash kernel, size the
    open-addressing table from the ESTIMATED (bucketed) build capacity
    — exactly `hash_join.table_slots` — and warn when the
    hashMaxTableSlots clamp forces the sort fallback (load factor
    > 0.7) or the table's slot bytes exceed the device HBM budget.
    Mirrors `resolve_kernel`, so `explain(analysis=True)` shows the
    fallback BEFORE the join silently takes it. The port's table costs
    `hash_join.SLOT_BYTES` per slot, as the JAX package's does."""
    from ..execution import hash_join as HJ
    mode = str(conf.get(HJ.KERNEL_MODE_KEY))
    if mode == "sort":
        return
    # a per-query budget, else the service's device-memory pool
    budget = int(conf.get("spark_tpu.sql.memory.deviceBudget")) \
        or int(conf.get("spark_tpu.service.hbmBudget"))
    seen = set()

    def walk(node):
        if id(node) in seen:  # runtime-filter creation chains DAG-share
            return
        seen.add(id(node))
        for c in node.children:
            walk(c)
        if not isinstance(node, P.JoinExec):
            return
        build_rows = _estimate_rows(node.right)
        probe_rows = _estimate_rows(node.left)
        if build_rows is None:
            return
        if node.hash_fallback is False:
            return  # already pinned to sort by the AQE loop
        build_cap = bucket_capacity(max(int(build_rows), 8))
        probe_cap = bucket_capacity(max(int(probe_rows or 0), 8))
        # the EXACT runtime decision procedure: heuristic sort choices
        # ('small-probe'/'ratio') are not degradations, only the clamp
        # fallback and HBM pressure on a chosen hash path are
        kernel, reason = HJ.kernel_choice(conf, probe_cap, build_cap)
        if kernel == "sort" and reason != "clamp":
            return
        slots = HJ.table_slots(build_cap, conf)
        table_bytes = slots * HJ.SLOT_BYTES
        if reason == "clamp":
            out.append(Finding(
                "JOIN_HASH_TABLE_PRESSURE",
                f"estimated build capacity {build_cap:,} under the "
                f"hashMaxTableSlots clamp ({slots:,} slots) pushes the "
                f"load factor past 0.7: this join silently falls back "
                f"to the sort kernel",
                op=_node_loc(node),
                detail={"build_cap": int(build_cap),
                        "slots": int(slots), "fallback": "sort"}))
        elif budget > 0 and table_bytes > budget:
            out.append(Finding(
                "JOIN_HASH_TABLE_PRESSURE",
                f"hash table for this join needs {slots:,} slots "
                f"(~{table_bytes:,} bytes) against a device budget of "
                f"{budget:,}: the build pressures the HBM lease",
                op=_node_loc(node),
                detail={"slots": int(slots),
                        "table_bytes": int(table_bytes),
                        "budget_bytes": int(budget)}))

    walk(root)


def _check_mesh(root: P.PhysicalPlan, mesh_n: int,
                out: List[Finding]) -> None:
    if mesh_n <= 1:
        return
    seen = set()  # DAG-shared creation chains: one visit per node

    def walk(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for c in node.children:
            walk(c)
        if not isinstance(node, P.ExchangeExec):
            return
        part = node.partitioning
        rows = _estimate_rows(node.children[0])
        width = 8 * max(1, len(node.schema().fields))
        est_b = rows * width * mesh_n if rows is not None else None
        detail = {"mesh_n": mesh_n}
        if est_b is not None:
            detail["replicated_bytes_bound"] = int(est_b)
        if isinstance(part, P.Replicated):
            out.append(Finding(
                "MESH_FULL_REPLICATION",
                f"broadcast exchange all-gathers its child onto all "
                f"{mesh_n} shards"
                + (f" (~{est_b:,} bytes total)" if est_b else ""),
                op=_node_loc(node), detail=detail))
        elif isinstance(part, P.SinglePartition):
            out.append(Finding(
                "MESH_GATHER_RESULT",
                f"single-partition exchange gathers all rows onto every "
                f"shard (global sort/aggregate collection point)",
                op=_node_loc(node), detail=detail))

    walk(root)


def narrowed_dtypes() -> List:
    """The 64-bit numpy dtypes whose device tensors the port's dtype map
    (`types.torch_dtype`) makes narrower: the port's counterpart of JAX
    with x64 off. Empty for the map as it stands."""
    import numpy as np
    return [dt for dt in (np.dtype(np.int64), np.dtype(np.float64))
            if T.torch_dtype(dt).itemsize < dt.itemsize]


def _check_x64(root: P.PhysicalPlan, out: List[Finding]) -> None:
    narrow = narrowed_dtypes()
    if not narrow:
        return
    wide = {}

    def walk(node):
        for c in node.children:
            walk(c)
        try:
            fields = node.schema().fields
        except Exception:  # noqa: BLE001 — schema errors surface later
            return
        for f in fields:
            np_dtype = getattr(f.dtype, "np_dtype", None)
            if np_dtype is not None and np_dtype in narrow:
                wide.setdefault(f.name, repr(f.dtype))

    walk(root)
    if wide:
        cols = ", ".join(f"{n}:{d}" for n, d in sorted(wide.items())[:8])
        out.append(Finding(
            "X64_TRUNCATION",
            f"the device dtype map narrows 64-bit columns "
            f"({cols}{', ...' if len(wide) > 8 else ''}): device "
            f"tensors will silently truncate to 32 bits",
            op=_node_loc(root),
            detail={"columns": sorted(wide)}))


def analyze_plan(root: P.PhysicalPlan, conf,
                 mesh_n: int = 1) -> List[Finding]:
    """All plan-level findings for one physical tree. Pure host-side
    walk (microseconds); individual checks isolate their own failures
    so a broken estimator can never fail the query."""
    out: List[Finding] = []
    checks = (
        lambda: _walk_aggregates(root, out, conf),
        lambda: _check_host_sync(root, conf, mesh_n, out),
        lambda: _check_recompile(root, conf, out),
        lambda: _check_hash_join(root, conf, out),
        lambda: _check_mesh(root, mesh_n, out),
        lambda: _check_x64(root, out),
    )
    for check in checks:
        try:
            check()
        except Exception as e:  # noqa: BLE001 — analysis is advisory
            import warnings
            warnings.warn(f"plan analysis check failed (skipped): "
                          f"{type(e).__name__}: {e}")
    return out


def _walk_aggregates(root: P.PhysicalPlan, out: List[Finding],
                     conf=None) -> None:
    seen = set()

    def walk(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for c in node.children:
            walk(c)
        if isinstance(node, P.HashAggregateExec):
            _check_agg_overflow(node, out, conf)

    walk(root)
