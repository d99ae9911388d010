"""Physical operators (the port of the single-device operators of
`spark_tpu/plan/physical.py`; reference: `execution/SparkPlan.scala`).

`compute` runs eagerly on whole Batches of torch tensors; the executor
walks the tree bottom-up, computing a node that several parents share
(a runtime filter's creation chain) once. `simple_string`/`tree_string`
match the JAX package, so plan-level parity is a string compare. Ported:
Range, Scan, Project, Filter, HashAggregate (complete mode, dense-domain
and sort paths), Sort, Window, Limit, Join, RuntimeFilter, Union and the
single-device Exchange. Each operator states the distribution it needs
of its children and the partitioning it gives, as in the JAX package
(reference: `plans/physical/partitioning.scala`), so the planner inserts
the exchanges that package inserts at mesh size 0; on one device an
exchange passes its child's batch through. Generate is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import types as T
from ..columnar import Batch, Column, bucket_capacity
from ..config import Conf
from ..expr import (AnalysisError, Expression, SortOrder, Vec,
                    plain_column_name)
from ..expr_agg import AggExpr
from ..execution import aggregate as agg_kernels
from ..execution import join as join_kernels
from ..execution import sort as sort_kernels


# ---------------------------------------------------------------------------
# Partitioning algebra at mesh size 0 (reference: partitioning.scala). On
# one device every operator's output is one partition, which meets every
# requirement but a broadcast; the hash and range layouts come with the
# mesh.
# ---------------------------------------------------------------------------

class Distribution:
    pass


@dataclass(frozen=True)
class UnspecifiedDistribution(Distribution):
    pass


@dataclass(frozen=True)
class AllTuples(Distribution):
    """All rows co-located in one logical partition."""


@dataclass(frozen=True)
class BroadcastDistribution(Distribution):
    """Full copy on every partition."""


class Partitioning:
    num_partitions: int = 1

    def satisfies(self, dist: Distribution) -> bool:
        return isinstance(dist, UnspecifiedDistribution)


@dataclass(frozen=True)
class SinglePartition(Partitioning):
    num_partitions: int = 1

    def satisfies(self, dist):
        return not isinstance(dist, BroadcastDistribution)


@dataclass(frozen=True)
class Replicated(Partitioning):
    num_partitions: int = 1

    def satisfies(self, dist):
        return isinstance(dist, (UnspecifiedDistribution, BroadcastDistribution))


class ExecContext:
    """Per-execution state threaded through `compute` calls: the conf,
    the device every operator's tensors live on, runtime flags (0-d
    bool tensors the executor reads after the run, e.g. a join's output
    overflow) and per-operator metrics."""

    def __init__(self, conf: Conf, device):
        self.conf = conf
        self.device = torch.device(device)
        self.flags: Dict[str, object] = {}
        self.metrics: Dict[str, object] = {}

    def add_flag(self, name: str, value) -> None:
        if name in self.flags:
            self.flags[name] = self.flags[name] | value
        else:
            self.flags[name] = value

    def add_metric(self, name: str, value) -> None:
        self.metrics[name] = value


class PhysicalPlan:
    children: Tuple["PhysicalPlan", ...] = ()

    def schema(self) -> T.Schema:
        raise NotImplementedError

    def output_partitioning(self) -> Partitioning:
        return SinglePartition()

    def required_child_distributions(self) -> List[Distribution]:
        return [UnspecifiedDistribution() for _ in self.children]

    def compute(self, ctx: ExecContext, inputs: List[Batch]) -> Batch:
        raise NotImplementedError

    def simple_string(self) -> str:
        return type(self).__name__

    def tree_string(self, depth: int = 0) -> str:
        line = "  " * depth + self.simple_string()
        return "\n".join([line] + [c.tree_string(depth + 1)
                                   for c in self.children])

    def __repr__(self):
        return self.tree_string()


class LeafExec(PhysicalPlan):
    """Leaves either synthesize data (Range) or load a Batch from a
    source (Scan)."""


class RangeExec(LeafExec):
    def __init__(self, start: int, end: int, step: int = 1):
        self.start, self.end, self.step = start, end, step
        self.children = ()

    def schema(self):
        return T.Schema([T.Field("id", T.LONG, nullable=False)])

    def num_rows(self) -> int:
        return max(0, -(-(self.end - self.start) // self.step))

    def compute(self, ctx, inputs):
        n = self.num_rows()
        cap = bucket_capacity(n)
        offs = torch.arange(cap, dtype=torch.int64, device=ctx.device)
        ids = self.start + self.step * offs
        sel = offs < n
        return Batch({"id": Column(ids, T.LONG, bits=self._id_bits())}, sel,
                     ctx.device)

    def _id_bits(self) -> Optional[int]:
        """Static id bound: values in [0, 2^bits) when the range is
        non-negative, with slack for capacity padding (the JAX package's
        bound, kept so `Vec.bits` agrees)."""
        if self.start < 0 or self.step < 0:
            return None
        hi = self.start + self.step * (2 * max(self.num_rows(), 8) + 8192)
        return max(1, int(np.ceil(np.log2(max(hi, 2)))))

    def simple_string(self):
        return f"RangeExec({self.start},{self.end},{self.step})"


class ScanExec(LeafExec):
    def __init__(self, source, required_columns, pushed_filters):
        self.source = source
        self.required_columns = required_columns
        self.pushed_filters = tuple(pushed_filters)
        self.children = ()

    def schema(self):
        full = self.source.schema()
        if self.required_columns is None:
            return full
        return T.Schema([full.field(n) for n in self.required_columns])

    def load(self, device) -> Batch:
        """This scan's batch, read from its source onto `device`."""
        return self.source.load(self.required_columns, self.pushed_filters,
                                device)

    def compute(self, ctx, inputs):
        # the executor loads scans before it runs the plan; a plan run
        # on its own (a profiler's pass) loads through the cache here
        from ..io.device_cache import load_scan
        return load_scan(self, ctx.conf, ctx.device)

    def simple_string(self):
        cols = "*" if self.required_columns is None else \
            ",".join(self.required_columns)
        return (f"ScanExec({self.source.name},[{cols}],"
                f"pushed={[repr(f) for f in self.pushed_filters]})")


class UnaryExec(PhysicalPlan):
    @property
    def child(self) -> PhysicalPlan:
        return self.children[0]


class ProjectExec(UnaryExec):
    def __init__(self, child: PhysicalPlan, exprs: Sequence[Expression]):
        self.children = (child,)
        self.exprs = tuple(exprs)

    def schema(self):
        cs = self.child.schema()
        return T.Schema([T.Field(e.name(), e.dtype(cs), e.nullable(cs))
                         for e in self.exprs])

    def compute(self, ctx, inputs):
        batch = inputs[0]
        cap = batch.capacity
        cols = {}
        for e in self.exprs:
            v = e.eval(batch)
            data = v.data
            if data is None:
                raise AnalysisError(f"cannot project host-only value {e!r}")
            if data.dim() == 0:
                data = data.expand((cap,))
            validity = v.validity
            if validity is not None and validity.dim() == 0:
                validity = validity.expand((cap,))
            cols[e.name()] = Column(data, v.dtype, validity, v.dictionary)
        return Batch(cols, batch.selection, batch.device)

    def simple_string(self):
        return f"ProjectExec({[repr(e) for e in self.exprs]})"


class FilterExec(UnaryExec):
    def __init__(self, child: PhysicalPlan, condition: Expression):
        self.children = (child,)
        self.condition = condition

    def schema(self):
        return self.child.schema()

    def compute(self, ctx, inputs):
        batch = inputs[0]
        v = self.condition.eval(batch)
        keep = v.data
        if v.validity is not None:
            keep = keep & v.validity  # NULL predicate -> drop row
        if keep.dim() == 0:
            keep = keep.expand((batch.capacity,))
        sel = keep if batch.selection is None else (batch.selection & keep)
        return batch.with_selection(sel)

    def simple_string(self):
        return f"FilterExec({self.condition!r})"


class HashAggregateExec(UnaryExec):
    """Group-by aggregate in the `complete` mode (update + reduce +
    finalize in one node). Keys with a small static domain take the
    dense path of `execution/aggregate.py`; others the sort aggregate,
    whose output table holds `est_groups` (bucketed) groups and flags
    ``agg_overflow_<tag>`` when more arrive, for the executor to run
    again with the real count."""

    def __init__(self, child: PhysicalPlan, group_exprs: Sequence[Expression],
                 agg_exprs: Sequence[AggExpr], mode: str = "complete",
                 est_groups: Optional[int] = None):
        if mode != "complete":
            raise NotImplementedError(
                f"HashAggregateExec mode={mode} is not ported yet")
        self.children = (child,)
        self.group_exprs = tuple(group_exprs)
        self.agg_exprs = tuple(agg_exprs)
        self.mode = mode
        self.est_groups = est_groups
        self.tag = "a0"

    def schema(self):
        cs = self.child.schema()
        fields = [T.Field(g.name(), g.dtype(cs), g.nullable(cs))
                  for g in self.group_exprs]
        for a in self.agg_exprs:
            fields.append(T.Field(a.out_name, a.func.result_type(cs),
                                  a.func.result_nullable(cs)))
        return T.Schema(fields)

    def compute(self, ctx, inputs):
        batch = inputs[0]
        base = self.child.schema()
        sel = batch.selection

        key_vecs = [g.eval(batch) for g in self.group_exprs]
        specs = [a.func.accumulators(base) for a in self.agg_exprs]
        contribs = [a.func.update(batch, sel) for a in self.agg_exprs]

        domains = [agg_kernels.key_domain(g, v)
                   for g, v in zip(self.group_exprs, key_vecs)]
        max_domain = int(ctx.conf.get("spark_tpu.sql.aggregate.maxDirectDomain"))
        nullables = [g.nullable(base) for g in self.group_exprs]
        spans = agg_kernels.key_spans(
            nullables, [d for d in domains if d is not None])
        if (all(d is not None for d in domains)
                and int(np.prod(list(spans) or [1])) <= max_domain):
            key_arrays, key_valids, accs, occupied = \
                agg_kernels.direct_aggregate(
                    key_vecs, domains, spans, contribs, specs, sel,
                    ctx.device, kernel_mode=str(ctx.conf.get(
                        "spark_tpu.sql.aggregate.kernelMode")),
                    reuse_count=self._occupancy_reuse(batch))
        else:
            num_segments = batch.capacity
            if self.est_groups and self.group_exprs:
                num_segments = min(batch.capacity,
                                   bucket_capacity(self.est_groups))
            (key_arrays, key_valids, accs, occupied,
             total_groups) = agg_kernels.sort_aggregate(
                key_vecs, contribs, specs, sel, batch.capacity,
                num_segments=num_segments)
            if num_segments < batch.capacity:
                # sized-down output: surface the real group count so the
                # executor can run again with a larger table on overflow
                ctx.add_metric(f"agg_groups_{self.tag}", total_groups)
                ctx.add_flag(f"agg_overflow_{self.tag}",
                             total_groups > num_segments)

        if not self.group_exprs:
            # global aggregate: exactly one output row, always present
            occupied = torch.ones((1,), dtype=torch.bool, device=ctx.device)
            accs = [[acc[:1] for acc in row] for row in accs]

        cols: Dict[str, Column] = {}
        for g, vec, arr, kv in zip(self.group_exprs, key_vecs, key_arrays,
                                   key_valids):
            cols[g.name()] = Column(arr, vec.dtype, kv, vec.dictionary)
        for i, a in enumerate(self.agg_exprs):
            data, validity = a.func.device_finalize(accs[i], base)
            cols[a.out_name] = Column(data, a.func.result_type(base),
                                      validity)
        ctx.add_metric("agg_groups", occupied.sum())
        return Batch(cols, occupied, ctx.device)

    def required_child_distributions(self):
        if not self.group_exprs:
            return [AllTuples()]
        return [UnspecifiedDistribution()]

    def _occupancy_reuse(self, batch) -> Optional[Tuple[int, int]]:
        """(i, j) of an accumulator whose contribution equals the
        selection indicator (a count over a never-null child): the
        group-by kernel's occupancy counts ride its sums instead of a
        row of ones of their own."""
        from ..expr_agg import Avg, Count, Sum
        for i, a in enumerate(self.agg_exprs):
            f = a.func
            if isinstance(f, Count) and f.child is None:
                return (i, 0)
            if isinstance(f, (Count, Sum, Avg)) and f.child is not None:
                if f.child.eval(batch).validity is None:
                    return (i, 0 if isinstance(f, Count) else 1)
        return None

    def simple_string(self):
        return (f"HashAggregateExec(mode={self.mode}, "
                f"groups={[repr(g) for g in self.group_exprs]}, "
                f"aggs={[repr(a) for a in self.agg_exprs]}, "
                f"est={self.est_groups})")


class SortExec(UnaryExec):
    """Global sort of one device's batch (reference: SortExec.scala:40)."""

    def __init__(self, child: PhysicalPlan, orders: Sequence[SortOrder]):
        self.children = (child,)
        self.orders = tuple(orders)

    def schema(self):
        return self.child.schema()

    def required_child_distributions(self):
        return [AllTuples()]

    def compute(self, ctx, inputs):
        batch = inputs[0]
        perm, n_valid = sort_kernels.sort_permutation(batch, self.orders)
        return sort_kernels.apply_permutation(batch, perm, n_valid)

    def simple_string(self):
        return f"SortExec({[repr(o) for o in self.orders]})"


class WindowExec(UnaryExec):
    """All window functions of one spec over one sorted permutation
    (reference: execution/window/WindowExec.scala; the functions are the
    segmented scans of execution/window.py). An empty PARTITION BY needs
    all rows together."""

    def __init__(self, child: PhysicalPlan, wexprs: Sequence[Tuple],
                 out_schema: T.Schema):
        self.children = (child,)
        self.wexprs = tuple(wexprs)
        self._schema = out_schema

    def schema(self):
        return self._schema

    def _spec(self):
        return self.wexprs[0][0].spec

    def required_child_distributions(self):
        if not self._spec()._partition:
            return [AllTuples()]
        return [UnspecifiedDistribution()]

    def compute(self, ctx, inputs):
        from ..execution import window as win
        from ..expr import cast_vec
        from ..expr_agg import Sum, decimal_avg_halfup
        from ..window import UNBOUNDED_FOLLOWING, UNBOUNDED_PRECEDING
        batch = inputs[0]
        cap = batch.capacity
        dev = batch.device
        sel = batch.selection_mask()
        spec = self._spec()

        def full(op):
            return op.expand((cap,)) if op.dim() == 0 else op

        p_orders = [SortOrder(p, ascending=True) for p in spec._partition]
        p_ops = [full(o) for o in sort_kernels.sort_operands(batch,
                                                             p_orders)]
        o_ops = [full(o) for o in sort_kernels.sort_operands(
            batch, list(spec._order))]
        invalid = (~sel).to(torch.int8)
        perm = sort_kernels.stable_permutation([invalid] + p_ops + o_ops,
                                               cap, dev)
        valid_sorted = invalid[perm] == 0
        sp_ops = [op[perm] for op in p_ops]
        so_ops = [op[perm] for op in o_ops]

        starts = win._segment_starts(sp_ops, cap, valid_sorted)
        gid = torch.cumsum(starts.to(torch.int64), 0) - 1
        gid = torch.where(valid_sorted, gid, torch.full_like(gid, cap))
        change = win._peer_change(starts, so_ops, cap)
        base = self.child.schema()

        new_cols: Dict[str, Column] = dict(batch.columns)
        for w, name in self.wexprs:
            out_dtype = w.dtype(base)
            validity_sorted = None
            src_dict = None
            if w.kind == "row_number":
                vals = win.row_number(starts, cap)
            elif w.kind == "rank":
                vals = win.rank(starts, change, cap)
            elif w.kind == "dense_rank":
                vals = win.dense_rank(starts, change, cap)
            elif w.kind in ("lag", "lead"):
                v = w.arg.eval(batch)
                if v.dictionary is not None and w.default is not None:
                    raise AnalysisError(
                        "lag/lead with a default on a string column is "
                        "not supported (the default would be written in "
                        "dictionary-code space)")
                src_dict = v.dictionary
                val_s = None if v.validity is None else v.validity[perm]
                vals, validity_sorted = win.shift_in_segment(
                    full(v.data)[perm], val_s, gid, w.offset, w.default,
                    cap)
            else:
                if w.arg is None:  # count(*) over (...)
                    data_s = torch.ones((cap,), dtype=torch.int64,
                                        device=dev)
                    val_s = None
                else:
                    v = w.arg.eval(batch)
                    if v.dictionary is not None and w.kind != "count":
                        # codes are insertion-ordered, not lexicographic:
                        # min/max/sum over codes would silently corrupt
                        raise AnalysisError(
                            f"window {w.kind} over a string column is "
                            f"not supported")
                    acc_t = out_dtype if w.kind == "sum" else v.dtype
                    if w.kind == "avg":
                        acc_t = Sum(w.arg).result_type(base)
                    vv = cast_vec(v, acc_t)
                    data_s = full(vv.data)[perm]
                    val_s = None if vv.validity is None else \
                        full(vv.validity)[perm]
                val_s = valid_sorted if val_s is None else \
                    (val_s & valid_sorted)
                frame = w.spec._frame
                if frame is not None and frame[0] == "range" \
                        and frame[1] <= UNBOUNDED_PRECEDING \
                        and frame[2] == 0:
                    # RANGE UNBOUNDED PRECEDING .. CURRENT ROW is exactly
                    # the default peer frame: no value arithmetic, so any
                    # order keys are fine
                    frame = None
                kind = "sum" if w.kind == "avg" else w.kind
                if frame is None:
                    out, cnt = win.windowed_agg(
                        kind, data_s, val_s, gid, cap, starts, change,
                        bool(spec._order), cap)
                else:
                    # ROWS/RANGE BETWEEN (WindowExec.scala:36 frames)
                    if not spec._order:
                        raise AnalysisError(
                            "a window frame requires an ORDER BY in "
                            "its window specification")
                    range_key = range_key_valid = None
                    if frame[0] == "range":
                        range_key, range_key_valid = \
                            self._range_frame_key(batch, spec, frame, perm,
                                                  valid_sorted)
                    lo, hi = win.frame_bounds(
                        frame, starts, change, cap, bool(spec._order),
                        n_valid=valid_sorted.sum(),
                        range_key=range_key,
                        range_key_valid=range_key_valid)
                    max_len = None
                    if frame[0] == "rows" and frame[1] > UNBOUNDED_PRECEDING \
                            and frame[2] < UNBOUNDED_FOLLOWING:
                        max_len = min(cap, frame[2] - frame[1] + 1)
                    out, cnt = win.framed_agg(kind, data_s, val_s, lo, hi,
                                              cap, max_len=max_len)
                if w.kind == "avg":
                    safe = cnt.clamp(min=1)
                    if isinstance(out_dtype, T.DecimalType):
                        arg_t = w.arg.dtype(base)
                        vals = decimal_avg_halfup(
                            out.to(torch.int64), safe,
                            10 ** (out_dtype.scale - arg_t.scale))
                    else:
                        vals = out.to(torch.float64) / safe
                elif w.kind == "count":
                    vals = cnt
                else:
                    vals = out
                if w.kind != "count":
                    validity_sorted = cnt > 0
            # back to input row order: perm holds each row once
            out_t = T.torch_dtype(out_dtype.np_dtype)
            unsorted = torch.empty((cap,), dtype=out_t, device=dev)
            unsorted[perm] = vals.to(out_t)
            validity = None
            if validity_sorted is not None:
                validity = torch.empty((cap,), dtype=torch.bool, device=dev)
                validity[perm] = validity_sorted
            new_cols[name] = Column(unsorted, out_dtype, validity, src_dict)
        return Batch(new_cols, batch.selection, dev)

    def _range_frame_key(self, batch, spec, frame, perm, valid_sorted):
        """Sorted order-key values for a RANGE frame with value-space
        offsets: exactly one ascending numeric/date order key (the
        reference's RangeFrame constraint). Keys are sanitized so NULL
        and filtered rows carry monotone sentinels (see
        win.sanitize_range_key)."""
        from ..execution import window as win
        from ..window import UNBOUNDED_FOLLOWING, UNBOUNDED_PRECEDING
        _, a, b = frame
        if a <= UNBOUNDED_PRECEDING and b >= UNBOUNDED_FOLLOWING:
            return None, None
        if len(spec._order) != 1:
            raise AnalysisError(
                "RANGE BETWEEN with offsets requires exactly one ORDER "
                "BY key")
        o = spec._order[0]
        if not o.ascending:
            raise AnalysisError(
                "RANGE BETWEEN with offsets supports ascending order "
                "keys only")
        v = o.child.eval(batch)
        if v.dictionary is not None or isinstance(
                v.dtype, (T.StringType, T.BooleanType)):
            raise AnalysisError(
                "RANGE BETWEEN needs a numeric or date order key")
        key = v.data[perm]
        kv = None if v.validity is None else v.validity[perm]
        key = win.sanitize_range_key(key, kv, valid_sorted, o.nulls_first)
        return key, kv

    def simple_string(self):
        return f"WindowExec({[(repr(w), n) for w, n in self.wexprs]})"


class LimitExec(UnaryExec):
    """First-n selected rows."""

    def __init__(self, child: PhysicalPlan, n: int):
        self.children = (child,)
        self.n = n

    def schema(self):
        return self.child.schema()

    def required_child_distributions(self):
        return [AllTuples()]

    def compute(self, ctx, inputs):
        batch = inputs[0]
        sel = batch.selection_mask()
        s = sel.to(torch.int32)
        local_rank = torch.cumsum(s, 0) - s
        return batch.with_selection(sel & (local_rank < self.n))

    def simple_string(self):
        return f"LimitExec({self.n})"


class JoinExec(PhysicalPlan):
    """General equi-join: sorted-build binary search or a hash table
    over the sorted build (`execution/join.py`, `execution/hash_join.py`)
    with prefix-sum expansion. Build side = right child. Supports
    many-to-many matches, inner/left/right/full outer, semi/anti, and
    residual (non-equi) conditions for every join type.

    Re-plan state, set by the executor after a run that flagged it
    (the reference's `AdaptiveSparkPlanExec.scala:64` loop in miniature):
    `out_cap`, the capacity of the expanded-pair block (None = the probe
    capacity, exact for FK joins); `unique_build`, the FK->PK fast path
    (None/True = try it; False after a duplicate build key); and
    `hash_fallback` (False after the hash table saturated)."""

    #: printed for parity with the JAX package, whose mesh planner also
    #: picks "broadcast"; one device has only "shuffle"
    strategy = "shuffle"

    def __init__(self, left: PhysicalPlan, right: PhysicalPlan,
                 left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression],
                 how: str, condition: Optional[Expression],
                 out_schema: T.Schema):
        self.children = (left, right)
        self.left_keys = tuple(left_keys)
        self.right_keys = tuple(right_keys)
        self.how = how
        self.condition = condition
        self._schema = out_schema
        self.out_cap: Optional[int] = None
        self.unique_build: Optional[bool] = None
        self.hash_fallback: Optional[bool] = None
        # True for left_semi joins SYNTHESIZED by the runtime-filter rule
        # to narrow a creation chain (plan/runtime_filter.py): tagged
        # from a separate counter (cj<n>)
        self.creation_side = False
        # SQL NOT IN null-aware anti-join (left_anti only)
        self.null_aware = False
        self.tag = "j0"
        #: (kernel, reason) of the last run, for reports
        self.last_kernel: Optional[Tuple[str, str]] = None

    @property
    def left(self):
        return self.children[0]

    @property
    def right(self):
        return self.children[1]

    def schema(self):
        return self._schema

    def _has_column_keys(self) -> bool:
        """True when some key pair is a plain column on both sides (the
        pairs a mesh would hash on)."""
        return any(plain_column_name(l) is not None
                   and plain_column_name(r) is not None
                   for l, r in zip(self.left_keys, self.right_keys))

    def required_child_distributions(self):
        if not self._has_column_keys():
            if self.how in ("right", "full"):
                # a replicated build would append its unmatched rows once
                # per partition: co-locate everything instead
                return [AllTuples(), AllTuples()]
            # no hashable key columns (e.g. a cross join's literal keys):
            # every probe row must see every build row -> replicate build
            return [UnspecifiedDistribution(), BroadcastDistribution()]
        # key columns: one partition holds every key
        return [UnspecifiedDistribution(), UnspecifiedDistribution()]

    def _eval_keys(self, probe_batch, build_batch):
        def bcast(v: Vec, cap: int) -> Vec:
            # literal keys (cross join lowers to a constant-key equi-join)
            if v.data is not None and v.data.dim() == 0:
                validity = v.validity
                if validity is not None and validity.dim() == 0:
                    validity = validity.expand((cap,))
                return Vec(v.data.expand((cap,)), v.dtype, validity,
                           v.dictionary)
            return v

        lvecs = [bcast(k.eval(probe_batch), probe_batch.capacity)
                 for k in self.left_keys]
        rvecs = [bcast(k.eval(build_batch), build_batch.capacity)
                 for k in self.right_keys]
        lvecs, rvecs = _unify_key_dictionaries(lvecs, rvecs)
        if len(lvecs) != 1:
            lk, rk, exact = _pack_key_pair(lvecs, rvecs)
        else:
            lk, rk = lvecs[0], rvecs[0]
            exact = True
        return lvecs, rvecs, lk, rk, exact

    def _build_name_map(self, probe_batch, build_batch):
        """(left_names, out_names) with the `_r` collision suffix shared
        by every join type so one condition expression works for all."""
        left_names = list(probe_batch.columns.keys())
        if self.how in ("left_semi", "left_anti"):
            taken = set(left_names)
            out_names = list(left_names)
            for n in build_batch.columns.keys():
                name = n
                while name in taken:
                    name = name + "_r"
                out_names.append(name)
                taken.add(name)
        else:
            out_names = self._schema.names
        return left_names, out_names

    def _compute_unique(self, ctx, probe_batch, build_batch,
                        lvecs, rvecs, lk, keys_s, perm, n_valid, valid_s,
                        hash_lc=None):
        """Unique-build fast path: probe-layout output, zero expansion
        (HashedRelation keyIsUnique analog). Raises join_nonunique_<tag>
        when the build side has duplicate keys; the executor then runs
        again with unique_build=False. `hash_lc` is the hash kernel's
        (lo, cnt) probe result when that kernel ran (the sort kernel's
        single search `match_unique` otherwise)."""
        ctx.add_flag(f"join_nonunique_{self.tag}",
                     join_kernels.build_has_duplicates(keys_s, valid_s))
        if hash_lc is not None:
            lo, cnt = hash_lc
            build_idx = perm[lo.clamp(max=keys_s.shape[0] - 1)]
            found = cnt > 0
        else:
            build_idx, found = join_kernels.match_unique(
                keys_s, n_valid, perm, lk, probe_batch.selection)
        psel = probe_batch.selection_mask()
        if len(lvecs) != 1:
            # packed keys: verify true equality (a pack collision pair
            # in the build would have raised the nonunique flag, so the
            # single candidate is the only possible match)
            for lvec, rvec in zip(lvecs, rvecs):
                eq = lvec.data == rvec.data[build_idx]
                if lvec.validity is not None:
                    eq = eq & lvec.validity
                if rvec.validity is not None:
                    eq = eq & rvec.validity[build_idx]
                found = found & eq

        left_names, out_names = self._build_name_map(probe_batch,
                                                     build_batch)
        n_left = len(left_names)
        cols: Dict[str, Column] = {}
        for name, out_name in zip(left_names, out_names[:n_left]):
            cols[out_name] = probe_batch.columns[name]  # no gather
        build_name_map = list(zip(build_batch.columns.keys(),
                                  out_names[n_left:]))
        for (out_name, col) in join_kernels.gather_columns(
                build_batch, build_idx, found, build_name_map):
            cols[out_name] = col

        if self.condition is not None:
            out_probe = Batch(cols, psel & found, ctx.device)
            v = self.condition.eval(out_probe)
            keep = v.data if v.validity is None else (v.data & v.validity)
            found = found & keep
            for out_name, col in join_kernels.gather_columns(
                    build_batch, build_idx, found, build_name_map):
                cols[out_name] = col

        ctx.add_metric(f"join_rows_{self.tag}",
                       (psel & found).sum())
        if self.how == "left_semi":
            return probe_batch.with_selection(psel & found)
        if self.how == "left_anti":
            sel = psel & ~found
            if self.null_aware:
                sel = sel & self._null_aware_mask(lvecs[0], build_batch,
                                                  rvecs[0])
            return probe_batch.with_selection(sel)
        if self.how == "left":
            return Batch(cols, psel, ctx.device)
        return Batch(cols, psel & found, ctx.device)

    def _null_aware_mask(self, probe_key_vec, build_batch, build_key_vec):
        """Per-probe-row NOT IN adjustment (SQL three-valued logic): a
        NULL anywhere in the build keys empties the result; a NULL probe
        key survives only when the build side is empty."""
        bsel = build_batch.selection_mask()
        if build_key_vec.validity is not None:
            has_null = (bsel & ~build_key_vec.validity).any()
        else:
            has_null = torch.zeros((), dtype=torch.bool, device=bsel.device)
        empty = ~bsel.any()
        mask = (~has_null).expand((probe_key_vec.data.shape[0],))
        if probe_key_vec.validity is not None:
            mask = mask & (probe_key_vec.validity | empty)
        return mask

    def compute(self, ctx, inputs):
        import time as _time
        from ..execution import hash_join as hash_kernels
        probe_batch, build_batch = inputs
        lvecs, rvecs, lk, rk, exact = self._eval_keys(probe_batch,
                                                      build_batch)
        t_build = _time.perf_counter()
        keys_s, perm, n_valid, valid_s = join_kernels.build_sorted(
            rk, build_batch.selection)
        # kernel choice (join.kernelMode): both kernels return the same
        # (lo, cnt) sorted-order contract, so everything downstream
        # (expansion, gathers, output order) is shared and results are
        # byte-identical across modes
        self.last_kernel = hash_kernels.kernel_choice(
            ctx.conf, probe_batch.capacity, build_batch.capacity,
            self.hash_fallback)
        hash_lc = None
        if self.last_kernel[0] == "hash":
            slots = hash_kernels.table_slots(build_batch.capacity, ctx.conf)
            max_probe = int(ctx.conf.get(hash_kernels.MAX_PROBE_KEY))
            # both sides hash under the promoted common dtype
            hash_dt = torch.promote_types(lk.data.dtype, keys_s.dtype)
            t_pos, cnt_all, saturated, build_steps = \
                hash_kernels.build_table(keys_s, valid_s, slots, max_probe,
                                         hash_dtype=hash_dt)
            # a cluster longer than the probe bound: run again on sort
            ctx.add_flag(f"join_hashsat_{self.tag}", saturated)
            ctx.add_metric(f"join_table_slots_{self.tag}", slots)
            ctx.add_metric(f"join_build_steps_{self.tag}", build_steps)
            ctx.add_metric(f"join_build_ms_{self.tag}",
                           (_time.perf_counter() - t_build) * 1e3)
            t_probe = _time.perf_counter()
            lo, cnt, probe_steps = hash_kernels.probe_table(
                t_pos, cnt_all, keys_s, lk, probe_batch.selection,
                slots, max_probe, hash_dtype=hash_dt)
            hash_lc = (lo, cnt)
            ctx.add_metric(f"join_probe_steps_{self.tag}", probe_steps)
            ctx.add_metric(f"join_probe_ms_{self.tag}",
                           (_time.perf_counter() - t_probe) * 1e3)
        if (self.unique_build is not False
                and self.how in ("inner", "left", "left_semi",
                                 "left_anti")):
            return self._compute_unique(ctx, probe_batch, build_batch,
                                        lvecs, rvecs, lk, keys_s, perm,
                                        n_valid, valid_s, hash_lc=hash_lc)
        if hash_lc is not None:
            lo, cnt = hash_lc
        else:
            lo, cnt = join_kernels.match_ranges(keys_s, n_valid, lk,
                                                probe_batch.selection)
        psel = probe_batch.selection_mask()
        semi_anti = self.how in ("left_semi", "left_anti")

        if semi_anti and exact and self.condition is None:
            found = cnt > 0
            if self.how == "left_semi":
                return probe_batch.with_selection(psel & found)
            sel = psel & ~found
            if self.null_aware:
                sel = sel & self._null_aware_mask(lvecs[0], build_batch,
                                                  rvecs[0])
            return probe_batch.with_selection(sel)

        dev = ctx.device
        probe_cap = probe_batch.capacity
        build_cap = build_batch.capacity
        out_cap = self.out_cap if self.out_cap is not None else probe_cap
        outer_probe = self.how in ("left", "full")
        zero = torch.zeros_like(cnt)
        if outer_probe:
            cnt_eff = torch.where(psel, cnt.clamp(min=1), zero)
        else:
            cnt_eff = torch.where(psel, cnt, zero)
        p, build_idx, is_pair, valid, total = join_kernels.expand(
            lo, cnt, cnt_eff, perm, out_cap)
        ctx.add_metric(f"join_rows_{self.tag}", total)
        ctx.add_flag(f"join_overflow_{self.tag}", total > out_cap)

        pair_pass = is_pair
        if not exact:
            # hashed key pack: verify true per-key equality on each pair
            for lvec, rvec in zip(lvecs, rvecs):
                eq = lvec.data[p] == rvec.data[build_idx]
                if lvec.validity is not None:
                    eq = eq & lvec.validity[p]
                if rvec.validity is not None:
                    eq = eq & rvec.validity[build_idx]
                pair_pass = pair_pass & eq

        # assemble the expanded block: probe columns at p, build at build_idx
        left_names, out_names = self._build_name_map(probe_batch,
                                                     build_batch)
        n_left = len(left_names)
        cols: Dict[str, Column] = {}
        for (out_name, col) in join_kernels.gather_columns(
                probe_batch, p, valid,
                list(zip(left_names, out_names[:n_left]))):
            cols[out_name] = col
        build_name_map = list(zip(build_batch.columns.keys(),
                                  out_names[n_left:]))
        for (out_name, col) in join_kernels.gather_columns(
                build_batch, build_idx, pair_pass, build_name_map):
            cols[out_name] = col

        if self.condition is not None:
            out_probe = Batch(cols, valid & pair_pass, dev)
            v = self.condition.eval(out_probe)
            keep = v.data if v.validity is None else (v.data & v.validity)
            pair_pass = pair_pass & keep
            # pairs dropped by the residual must also null the build side
            for out_name, col in join_kernels.gather_columns(
                    build_batch, build_idx, pair_pass, build_name_map):
                cols[out_name] = col

        # per-probe-row "any pair survived" (drives null-extension +
        # semi/anti). p is non-decreasing (output rows are emitted in
        # probe order), so count survivors per p-run with a prefix-sum
        # difference at run bounds
        m = (valid & pair_pass).to(torch.int64)
        csum_m = torch.cumsum(m, 0)
        ex_m = csum_m - m
        rpos = torch.arange(out_cap, dtype=torch.int64, device=dev)
        run_start = (rpos == 0) | (p != torch.roll(p, 1))
        nxt_p = torch.cat([p[1:], p.new_full((1,), probe_cap)])
        run_end = nxt_p != p
        # no `valid` mask: tail rows (r >= total) share the last emitting
        # row's p, so they extend its run with m=0 — harmless — while
        # masking would lose that run's end marker entirely
        drop = torch.full_like(p, probe_cap)
        sidx_p = torch.where(run_start, p, drop)
        eidx_p = torch.where(run_end, p, drop)

        def per_probe(idx, values, dtype):
            out = torch.zeros((probe_cap + 1,), dtype=dtype, device=dev)
            out[idx] = values
            return out[:probe_cap]

        pstart = per_probe(sidx_p, rpos, torch.int64)
        pend = per_probe(eidx_p, rpos, torch.int64)
        ppresent = per_probe(sidx_p, True, torch.bool)
        any_pass = ppresent & ((csum_m[pend] - ex_m[pstart]) > 0)

        if semi_anti:
            if self.how == "left_semi":
                return probe_batch.with_selection(psel & any_pass)
            sel = psel & ~any_pass
            if self.null_aware:
                sel = sel & self._null_aware_mask(lvecs[0], build_batch,
                                                  rvecs[0])
            return probe_batch.with_selection(sel)

        if outer_probe:
            # keep surviving pairs; for probe rows with none, keep exactly
            # the first emitted row as a null-extended row
            off_p = (torch.cumsum(cnt_eff, 0) - cnt_eff)[p]
            is_first = rpos == off_p
            null_ext = is_first & ~any_pass[p]
            sel = valid & (pair_pass | null_ext)
            # null-extended rows must show NULL build columns even when
            # they reused a failed pair slot
            for out_name, col in join_kernels.gather_columns(
                    build_batch, build_idx, pair_pass & ~null_ext,
                    build_name_map):
                cols[out_name] = col
        else:
            sel = valid & pair_pass

        if self.how in ("right", "full"):
            # append build rows no surviving pair touched, null-extended left
            scatter_b = torch.where(valid & pair_pass, build_idx,
                                    torch.full_like(build_idx, build_cap))
            matched_b = torch.zeros((build_cap + 1,), dtype=torch.bool,
                                    device=dev)
            matched_b[scatter_b] = True
            app_sel = build_batch.selection_mask() & ~matched_b[:build_cap]
            merged: Dict[str, Column] = {}
            for out_name, col in cols.items():
                if out_name in out_names[:n_left]:
                    b_data = torch.zeros((build_cap,), dtype=col.data.dtype,
                                         device=dev)
                    b_valid = torch.zeros((build_cap,), dtype=torch.bool,
                                          device=dev)
                else:
                    src = build_batch.columns[
                        build_name_map[out_names.index(out_name)
                                       - n_left][0]]
                    b_data = src.data.to(col.data.dtype)
                    b_valid = src.validity if src.validity is not None \
                        else torch.ones((build_cap,), dtype=torch.bool,
                                        device=dev)
                a_valid = col.validity if col.validity is not None else \
                    torch.ones((out_cap,), dtype=torch.bool, device=dev)
                merged[out_name] = Column(
                    torch.cat([col.data, b_data]), col.dtype,
                    torch.cat([a_valid, b_valid]), col.dictionary)
            return Batch(merged, torch.cat([sel, app_sel]), dev)

        return Batch(cols, sel, dev)

    def simple_string(self):
        return (f"JoinExec({self.how}, {[repr(k) for k in self.left_keys]} = "
                f"{[repr(k) for k in self.right_keys]}, "
                f"cond={self.condition!r}, cap={self.out_cap}, "
                f"uniq={self.unique_build}, "
                + ("null_aware, " if self.null_aware else "")
                # only when the re-plan forced the sort fallback
                + ("hash_fallback, " if self.hash_fallback is False
                   else "")
                + f"strategy={self.strategy})")


class RuntimeFilterExec(PhysicalPlan):
    """Probe-side runtime join filter (reference: the exec side of
    `InjectRuntimeFilter.scala:1`, with `common/sketch/BloomFilter.java`
    replaced by `sketch.py`).

    children = (probe_child, creation_plan). The creation plan is the
    join build side's cheap Project/Filter-over-leaf chain (the same
    node objects — the tree becomes a DAG, and the executor computes a
    shared node once). compute() builds a Bloom filter + min/max bounds
    from the creation keys and narrows the probe batch's selection.

    Dropping this node never changes results (the join re-checks every
    key)."""

    def __init__(self, child: PhysicalPlan, creation: PhysicalPlan,
                 probe_key: Expression, build_key: Expression,
                 est_items: Optional[int] = None, fpp: float = 0.03):
        self.children = (child, creation)
        self.probe_key = probe_key
        self.build_key = build_key
        self.est_items = est_items
        self.fpp = fpp
        self.tag = "rf0"

    @property
    def creation(self) -> PhysicalPlan:
        return self.children[1]

    def schema(self):
        return self.children[0].schema()

    def compute(self, ctx, inputs):
        import time as _time
        probe, build = inputs
        # the planner estimate is pre-filter; the batch capacity is a
        # tighter bound on insertable rows — don't size the bit array
        # past it
        n_items = build.capacity if self.est_items is None else \
            min(self.est_items, build.capacity)
        t0 = _time.perf_counter()
        filt = join_kernels.build_runtime_filter(
            build, self.build_key, expected_items=max(int(n_items), 8),
            fpp=self.fpp)
        build_ms = (_time.perf_counter() - t0) * 1e3
        keep = join_kernels.apply_runtime_filter(filt, probe,
                                                 self.probe_key)
        psel = probe.selection_mask()
        ctx.add_metric(f"rtf_tested_{self.tag}", psel.sum())
        ctx.add_metric(f"rtf_pruned_{self.tag}", (psel & ~keep).sum())
        # host time spent building the filter (kernels are queued, not
        # awaited: on the card this is launch time)
        ctx.add_metric(f"rtf_build_ms_{self.tag}", build_ms)
        return probe.with_selection(psel & keep)

    def simple_string(self):
        return (f"RuntimeFilterExec({self.probe_key!r} IN "
                f"bloom({self.build_key!r}), est={self.est_items}, "
                f"fpp={self.fpp})")


class ExchangeExec(UnaryExec):
    """Repartitioning boundary (reference: BroadcastExchangeExec.scala:78).
    The planner inserts one where a child's partitioning does not meet
    its parent's requirement, on one device only the replicated build
    side of a join without key columns. There every partition is the
    whole batch, so it passes its child's batch through."""

    def __init__(self, child: PhysicalPlan, partitioning: Partitioning):
        self.children = (child,)
        self.partitioning = partitioning
        #: per-(src,dst) receive block size of a mesh exchange; always
        #: None on one device, printed as the JAX package prints it
        self.block_cap: Optional[int] = None
        self.tag = "e0"

    def schema(self):
        return self.child.schema()

    def output_partitioning(self):
        return self.partitioning

    def compute(self, ctx, inputs):
        return inputs[0]

    def simple_string(self):
        return f"ExchangeExec({self.partitioning!r}, block={self.block_cap})"


class UnionExec(PhysicalPlan):
    """UNION ALL: the left batch's rows, then the right's. String columns
    move onto one merged dictionary (the right side's codes remapped);
    validity is padded to each side's capacity."""

    def __init__(self, left: PhysicalPlan, right: PhysicalPlan,
                 out_schema: T.Schema):
        self.children = (left, right)
        self._schema = out_schema

    def schema(self):
        return self._schema

    def compute(self, ctx, inputs):
        from ..columnar import unify_string_columns
        lb, rb = inputs
        dev = ctx.device
        cols = {}
        for out_f, ln, rn in zip(self._schema.fields, lb.names, rb.names):
            lc, rc = lb.columns[ln], rb.columns[rn]
            l_data, r_data = lc.data, rc.data
            dictionary = None
            if isinstance(out_f.dtype, T.StringType):
                # raw right codes under the left dictionary would decode
                # to the wrong strings: merge the dictionaries, remap
                if lc.dictionary is None or rc.dictionary is None:
                    raise AnalysisError(
                        "UNION of string columns requires dictionaries")
                l_data, r_data, dictionary = unify_string_columns(
                    l_data, lc.dictionary, r_data, rc.dictionary)
            # the raw values at the common type, as the JAX package
            # concatenates them
            out_t = T.torch_dtype(out_f.dtype.np_dtype)
            data = torch.cat([l_data.to(out_t), r_data.to(out_t)])
            if lc.validity is None and rc.validity is None:
                validity = None
            else:
                lv = lc.validity if lc.validity is not None else \
                    torch.ones((lb.capacity,), dtype=torch.bool, device=dev)
                rv = rc.validity if rc.validity is not None else \
                    torch.ones((rb.capacity,), dtype=torch.bool, device=dev)
                validity = torch.cat([lv, rv])
            cols[out_f.name] = Column(data, out_f.dtype, validity, dictionary)
        sel = torch.cat([lb.selection_mask(), rb.selection_mask()])
        return Batch(cols, sel, dev)


def _unify_key_dictionaries(lvecs: List[Vec], rvecs: List[Vec]
                            ) -> Tuple[List[Vec], List[Vec]]:
    """Re-encode string join keys onto one shared dictionary per key
    pair: two independently-encoded string columns assign codes
    independently, so comparing raw codes is meaningless. The merge
    happens on host; codes are remapped with a device gather. Non-string
    keys pass through."""
    from ..columnar import unify_string_columns
    out_l, out_r = [], []
    for lv, rv in zip(lvecs, rvecs):
        if not isinstance(lv.dtype, T.StringType) and \
                not isinstance(rv.dtype, T.StringType):
            out_l.append(lv)
            out_r.append(rv)
            continue
        if lv.dictionary is None or rv.dictionary is None:
            raise AnalysisError(
                "string join keys require dictionary-encoded columns")
        l_data, r_data, merged = unify_string_columns(
            lv.data, lv.dictionary, rv.data, rv.dictionary)
        out_l.append(Vec(l_data, T.STRING, lv.validity, merged))
        out_r.append(Vec(r_data, T.STRING, rv.validity, merged))
    return out_l, out_r


def _key_width(v: Vec) -> Optional[int]:
    """Bits needed to represent the key's domain, or None when unbounded."""
    if v.dictionary is not None:
        n = len(v.dictionary)
        return max(1, (n - 1).bit_length()) if n > 1 else 1
    if isinstance(v.dtype, T.BooleanType):
        return 1
    if isinstance(v.dtype, T.ByteType):
        return 8
    if isinstance(v.dtype, T.ShortType):
        return 16
    if isinstance(v.dtype, (T.IntegerType, T.DateType)):
        return 32
    return None  # int64/timestamp: full range, cannot pack with others


def _unsigned_key(v: Vec, width: int):
    """Map key values to [0, 2^width) preserving distinctness (bias the
    sign bit for signed dtypes; dictionary codes are already unsigned)."""
    data = v.data.to(torch.int64)
    if v.dictionary is None and not isinstance(v.dtype, T.BooleanType):
        data = data + (1 << (width - 1))
    return data


def _mix64(x):
    """splitmix64 finalizer (wrapping 64-bit arithmetic, unsalted)."""
    from ..sketch import _finalize64
    return _finalize64(x.to(torch.int64))


def _pack_key_pair(lvecs: List[Vec], rvecs: List[Vec]
                   ) -> Tuple[Vec, Vec, bool]:
    """Combine multi-key join keys into one int64 key per side.

    Widths are derived JOINTLY per key position (max of the two sides)
    so both sides share one bit layout. Returns (lk, rk, exact): when the
    combined widths fit in 63 bits the packing is collision-free
    (exact=True); otherwise both sides are hash-mixed and the caller MUST
    re-verify per-key equality on matches."""
    validity_l = None
    validity_r = None
    for lv, rv in zip(lvecs, rvecs):
        for v in (lv, rv):
            if not isinstance(v.dtype, (T.IntegralType, T.StringType,
                                        T.DateType, T.BooleanType,
                                        T.TimestampType)):
                raise AnalysisError(
                    f"multi-key join on {v.dtype!r} unsupported")
        if lv.validity is not None:
            validity_l = lv.validity if validity_l is None else \
                (validity_l & lv.validity)
        if rv.validity is not None:
            validity_r = rv.validity if validity_r is None else \
                (validity_r & rv.validity)

    def kind(v):
        if v.dictionary is not None:
            return "dict"
        return "bool" if isinstance(v.dtype, T.BooleanType) else "int"

    widths = []
    for lv, rv in zip(lvecs, rvecs):
        wl, wr = _key_width(lv), _key_width(rv)
        if wl is None or wr is None or kind(lv) != kind(rv):
            widths.append(None)  # hash path (+ per-key re-verify)
        else:
            widths.append(max(wl, wr))
    if all(w is not None for w in widths) and sum(widths) <= 63:
        acc_l = acc_r = 0
        for lv, rv, w in zip(lvecs, rvecs, widths):
            acc_l = (acc_l << w) | _unsigned_key(lv, w)
            acc_r = (acc_r << w) | _unsigned_key(rv, w)
        return (Vec(acc_l, T.LONG, validity_l),
                Vec(acc_r, T.LONG, validity_r), True)
    hl = hr = 0
    for lv, rv in zip(lvecs, rvecs):
        hl = _mix64(_mix64(lv.data) ^ hl)
        hr = _mix64(_mix64(rv.data) ^ hr)
    return Vec(hl, T.LONG, validity_l), Vec(hr, T.LONG, validity_r), False
