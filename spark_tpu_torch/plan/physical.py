"""Physical operators (the port of the single-device operators of
`spark_tpu/plan/physical.py`; reference: `execution/SparkPlan.scala`).

`compute` runs eagerly on whole Batches of torch tensors; the executor
walks the tree bottom-up, computing a node that several parents share
(a runtime filter's creation chain) once. `simple_string`/`tree_string`
match the JAX package, so plan-level parity is a string compare
(`describe()` prints the JAX package's compiled-stage key). Ported:
Range, Scan, Input (a spliced stage output), Project, Filter,
HashAggregate (complete, partial and final modes; dense-domain and sort
paths), Sort, Window, Limit, Join (shuffle and broadcast strategies),
RuntimeFilter, Union, Generate (explode) and Exchange. Each operator
states the distribution it needs of its children and the partitioning it
gives, as in the JAX package (reference:
`plans/physical/partitioning.scala`), so the planner inserts the
exchanges that package inserts.

On a mesh (`parallel/`) every shard runs the same tree over its own
rows, each on its own thread and device, and `ExecContext` carries the
shard's index and its group: the counterpart of the `lax` collectives
the JAX package's operators call inside `shard_map`. Leaves synthesize
(Range) or receive (Scan, Input) only the shard's stripe; an exchange
lowers to the collectives of `parallel/shuffle.py`; Limit over a range
layout, the null-aware anti join and the runtime filter reduce across
the shards. On one device the context has no axis and an exchange
passes its child's batch through.
"""

from __future__ import annotations

import dataclasses
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
from ..observability.metrics import is_registered_metric


# ---------------------------------------------------------------------------
# Partitioning algebra (reference: partitioning.scala). On one device every
# operator's output is one partition, which meets every requirement but a
# broadcast; on a mesh the leaves are sharded (UnknownPartitioning) and the
# planner inserts hash, range and gather exchanges.
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
class ClusteredDistribution(Distribution):
    keys: Tuple[str, ...]


@dataclass(frozen=True)
class BroadcastDistribution(Distribution):
    """Full copy on every shard."""


@dataclass(frozen=True)
class OrderedDistribution(Distribution):
    """Rows range-partitioned by sort key: shard i's keys all <= shard
    i+1's (reference: OrderedDistribution in partitioning.scala:79)."""

    order_key: Tuple[str, ...]  # repr of the SortOrders (equality basis)


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
class HashPartitioning(Partitioning):
    keys: Tuple[str, ...] = ()
    num_partitions: int = 1

    def satisfies(self, dist):
        if isinstance(dist, UnspecifiedDistribution):
            return True
        if isinstance(dist, ClusteredDistribution):
            return set(self.keys).issubset(set(dist.keys)) and len(self.keys) > 0
        return False


@dataclass(frozen=True)
class Replicated(Partitioning):
    num_partitions: int = 1

    def satisfies(self, dist):
        return isinstance(dist, (UnspecifiedDistribution, BroadcastDistribution))


@dataclass(frozen=True)
class RangePartitioning(Partitioning):
    """Contiguous key ranges over the mesh axis in shard order
    (reference: RangePartitioning, partitioning.scala:255). `orders`
    carries the SortOrder objects for the exchange; equality and hashing
    use their repr (SortOrder overloads no __eq__)."""

    order_key: Tuple[str, ...] = ()
    num_partitions: int = 1
    orders: Tuple = dataclasses.field(default=(), compare=False, hash=False)

    def satisfies(self, dist):
        if isinstance(dist, UnspecifiedDistribution):
            return True
        if isinstance(dist, OrderedDistribution):
            return self.order_key == dist.order_key
        return False


@dataclass(frozen=True)
class UnknownPartitioning(Partitioning):
    num_partitions: int = 1


class ExecContext:
    """Per-execution state threaded through `compute` calls: the conf,
    the device every operator's tensors live on, runtime flags (0-d
    bool tensors the executor reads after the run, e.g. a join's output
    overflow) and per-operator metrics.

    On a mesh, `axis_name`/`n_shards`/`shard_index` identify the shard
    and `group` is the rendezvous of its mesh (`parallel/mesh.py`): the
    methods below are the counterparts of `lax.axis_index`, `psum`,
    `pmax`, `pmin` and `all_gather`. Every shard must call the same
    collectives in the same order, as under `shard_map`.

    `spans` is the query's `SpanRecorder`, in which `run_plan` records an
    `op:<PhysicalClass>` span a node; None (no query, or a mesh shard's
    thread, which does not own the recorder) records nothing."""

    def __init__(self, conf: Conf, device, axis_name: Optional[str] = None,
                 n_shards: int = 1, shard_index: int = 0, group=None,
                 spans=None):
        self.conf = conf
        self.spans = spans
        self.device = torch.device(device)
        self.axis_name = axis_name
        self.n_shards = n_shards
        self.shard_index = shard_index
        self.group = group
        self.flags: Dict[str, object] = {}
        self.metrics: Dict[str, object] = {}

    @property
    def on_mesh(self) -> bool:
        return self.axis_name is not None and self.n_shards > 1

    @property
    def on_cluster(self) -> bool:
        """The mesh spans engine processes (`parallel/cluster.py`)."""
        return getattr(self.group, "cluster", None) is not None

    def axis_index(self) -> int:
        return self.shard_index

    def exchange(self, value) -> list:
        """Every shard's `value`, in shard order (host objects)."""
        return self.group.exchange(self.shard_index, value)

    def gather_tensors(self, value, what: str) -> list:
        """Every shard's `value` (tensors, in dicts, lists and tuples),
        in shard order: this process's shards' as deposited, another
        process's on this process's device (`ShardGroup`)."""
        return self.group.gather_tensors(self.shard_index, value, what)

    def all_to_all(self, value, what: str) -> list:
        """Every shard's `value` of `[n, ...]` send buffers, in shard
        order; read row `axis_index()` of each (a shard of another
        process sends only the rows this process's shards receive)."""
        return self.group.all_to_all(self.shard_index, value, what)

    def all_gather(self, t):
        """Every shard's tensor on this shard's device, concatenated in
        shard order along dim 0 (0-d tensors are stacked)."""
        from ..parallel.mesh import gather_to
        parts = gather_to(self.gather_tensors(t, "all_gather"), self.device,
                          "all_gather")
        if t.dim() == 0:
            return torch.stack(parts)
        return torch.cat(parts)

    def _reduce(self, t, op: str):
        from ..parallel.mesh import gather_to
        parts = gather_to(self.gather_tensors(t, op), self.device, op)
        out = parts[0]
        for p in parts[1:]:  # shard order: float sums repeat bit for bit
            out = out + p if op == "psum" else (
                torch.maximum(out, p) if op == "pmax"
                else torch.minimum(out, p))
        return out

    def psum(self, t):
        return self._reduce(t, "psum")

    def pmax(self, t):
        return self._reduce(t, "pmax")

    def pmin(self, t):
        return self._reduce(t, "pmin")

    def add_flag(self, name: str, value) -> None:
        if name in self.flags:
            self.flags[name] = self.flags[name] | value
        else:
            self.flags[name] = value

    def add_metric(self, name: str, value) -> None:
        # registered prefixes only (observability/metrics.py): an
        # unregistered name would flow into the event log but silently
        # miss every history summary — fail where it is emitted instead
        if not is_registered_metric(name):
            raise ValueError(
                f"unregistered metric name {name!r}: add its prefix to "
                f"observability.metrics.METRIC_PREFIXES and a history "
                f"summary consumer")
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

    def describe(self) -> str:
        """Stable structural fingerprint of the subtree, printed as the
        JAX package prints its compiled-stage key."""
        parts = [self.simple_string()]
        for c in self.children:
            parts.append(c.describe())
        return "(" + " ".join(parts) + ")"

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

    #: mesh data-axis size the planner targeted (1 = one device). When
    #: >1, the leaf's rows are sharded over the axis, so its output
    #: partitioning is unknown and exchanges get inserted above it.
    dist_n: int = 1

    def output_partitioning(self):
        if self.dist_n > 1:
            return UnknownPartitioning(self.dist_n)
        return SinglePartition()


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
        if ctx.on_mesh:
            # synthesize only this shard's contiguous stripe
            cap += (-cap) % ctx.n_shards
            local = cap // ctx.n_shards
            offs = ctx.axis_index() * local + torch.arange(
                local, dtype=torch.int64, device=ctx.device)
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


class InputExec(LeafExec):
    """A leaf holding an already-computed device Batch (the result of a
    streamed aggregate, or its spilled partials) — the analog of a
    materialized QueryStageExec in the reference's adaptive loop
    (`AdaptiveSparkPlanExec.scala:64`)."""

    def __init__(self, batch: Optional[Batch], schema: T.Schema,
                 label: str = "input", shards: Optional[List[Batch]] = None):
        self._batch = batch
        self._schema = schema
        self.label = label
        self.children = ()
        #: a mesh stream's result: one batch per shard, each on its
        #: shard's device, handed to the shards as they are (the batch
        #: is then their concatenation, made only when asked for)
        self.shards = shards

    def schema(self):
        return self._schema

    def load(self) -> Batch:
        if self._batch is None:
            from ..parallel.shuffle import concat_batches
            self._batch = concat_batches(self.shards, self.shards[0].device)
        return self._batch

    def compute(self, ctx, inputs):
        return self.load()

    def simple_string(self):
        return f"InputExec({self.label},{self._schema!r})"


class UnaryExec(PhysicalPlan):
    @property
    def child(self) -> PhysicalPlan:
        return self.children[0]

    def output_partitioning(self):
        return self.child.output_partitioning()


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
            cols[e.name()] = Column(data, v.dtype, validity, v.dictionary,
                                    offsets=v.offsets,
                                    elem_validity=v.elem_validity)
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
    """Group-by aggregate. Keys with a small static domain take the dense
    path of `execution/aggregate.py`; others the sort aggregate, whose
    output table holds `est_groups` (bucketed) groups and flags
    ``agg_overflow_<tag>`` when more arrive, for the executor to run
    again with the real count. `mode` follows the reference's
    partial/final split (`AggUtils.scala`):

    - complete: update + reduce + finalize in one node;
    - partial:  update + reduce, outputs the raw accumulator columns
      (each chunk of the out-of-core spill path);
    - final:    re-reduces accumulator columns by key, then finalizes
      (over the spilled partials).

    The dense-path steps (`prepare_direct`, `direct_init_tables`,
    `direct_update_tables`, `direct_finalize_tables`) are the streaming
    loop's: it folds chunk after chunk into one set of tables."""

    def __init__(self, child: PhysicalPlan, group_exprs: Sequence[Expression],
                 agg_exprs: Sequence[AggExpr], mode: str = "complete",
                 est_groups: Optional[int] = None):
        assert mode in ("complete", "partial", "final")
        self.children = (child,)
        self.group_exprs = tuple(group_exprs)
        self.agg_exprs = tuple(agg_exprs)
        self.mode = mode
        self.est_groups = est_groups
        self.tag = "a0"

    def _acc_col_name(self, i: int, j: int, spec) -> str:
        return f"__acc_{i}_{j}_{spec.suffix}"

    def schema(self):
        cs = self.child.schema()
        fields = [T.Field(g.name(), g.dtype(cs), g.nullable(cs))
                  for g in self.group_exprs]
        base = self._base_schema()
        if self.mode == "partial":
            for i, a in enumerate(self.agg_exprs):
                for j, spec in enumerate(a.func.accumulators(base)):
                    fields.append(T.Field(
                        self._acc_col_name(i, j, spec),
                        _np_to_logical(spec.np_dtype), False))
        else:
            for a in self.agg_exprs:
                fields.append(T.Field(a.out_name, a.func.result_type(base),
                                      a.func.result_nullable(base)))
        return T.Schema(fields)

    def _base_schema(self) -> T.Schema:
        """The schema the aggregate functions' children resolve against:
        the pre-aggregation input schema. A final stage looks through its
        exchange to its partial stage, or to the schema a spliced
        InputExec keeps (`_agg_base_schema`)."""
        node: PhysicalPlan = self.children[0]
        while isinstance(node, ExchangeExec):
            node = node.children[0]
        if self.mode == "final":
            if isinstance(node, HashAggregateExec):
                return node._base_schema()
            stashed = getattr(node, "_agg_base_schema", None)
            if stashed is not None:
                return stashed
        return node.schema()

    def compute(self, ctx, inputs):
        batch = inputs[0]
        base = self._base_schema()
        sel = batch.selection

        if any(getattr(a.func, "positional", False)
               for a in self.agg_exprs):
            return self._compute_positional(ctx, batch, base)

        key_vecs = [g.eval(batch) for g in self.group_exprs]
        specs = [a.func.accumulators(base) for a in self.agg_exprs]
        if self.mode == "final":
            contribs = []
            for i in range(len(self.agg_exprs)):
                row = []
                for j, spec in enumerate(specs[i]):
                    data = batch.columns[self._acc_col_name(i, j, spec)].data
                    if sel is not None:
                        data = torch.where(
                            sel, data, torch.full_like(
                                data, spec.neutral.item()))
                    row.append(data)
                contribs.append(row)
        else:
            contribs = self._updates(batch, sel, ctx)

        domains = [agg_kernels.key_domain(g, v)
                   for g, v in zip(self.group_exprs, key_vecs)]
        max_domain = int(ctx.conf.get("spark_tpu.sql.aggregate.maxDirectDomain"))
        cs = self.child.schema()
        nullables = [g.nullable(cs) for g in self.group_exprs]
        spans = agg_kernels.key_spans(
            nullables, [d for d in domains if d is not None])
        if (all(d is not None for d in domains)
                and int(np.prod(list(spans) or [1])) <= max_domain):
            key_arrays, key_valids, accs, occupied = \
                agg_kernels.direct_aggregate(
                    key_vecs, domains, spans, contribs, specs, sel,
                    ctx.device, kernel_mode=str(ctx.conf.get(
                        "spark_tpu.sql.aggregate.kernelMode")),
                    merge=(self.mode == "final"),
                    reuse_count=None if self.mode == "final"
                    else self._occupancy_reuse(batch))
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
        if self.mode == "partial":
            for i in range(len(self.agg_exprs)):
                for j, spec in enumerate(specs[i]):
                    cols[self._acc_col_name(i, j, spec)] = Column(
                        accs[i][j], _np_to_logical(spec.np_dtype))
        else:
            for i, a in enumerate(self.agg_exprs):
                data, validity = a.func.device_finalize(accs[i], base)
                cols[a.out_name] = Column(
                    data, a.func.result_type(base), validity,
                    getattr(a.func, "output_dictionary", None))
        ctx.add_metric("agg_groups", occupied.sum())
        return Batch(cols, occupied, ctx.device)

    def _compute_positional(self, ctx, batch: Batch, base) -> Batch:
        """Aggregates with percentile/median/collect_list/collect_set
        (Percentile.scala, ApproximatePercentile.scala:1, collect.scala):
        one complete pass over a (group keys, value) sort per distinct
        value child. Regular functions in the same SELECT ride a
        sort_aggregate over the SAME key order, so all output columns
        align group for group. The collect outputs are array columns of
        the input's capacity (`num_segments = cap`), as in the JAX
        package."""
        from ..expr import cast_vec
        if self.mode != "complete":
            raise AnalysisError(
                "positional aggregates (percentile/median/collect_*) "
                "have no partial/final decomposition")
        sel = batch.selection
        cap = batch.capacity
        key_vecs = [g.eval(batch) for g in self.group_exprs]
        num_segments = cap

        regular = [(i, a) for i, a in enumerate(self.agg_exprs)
                   if not getattr(a.func, "positional", False)]
        specs = [a.func.accumulators(base) for _, a in regular]
        contribs = [a.func.update(batch, sel) for _, a in regular]
        (key_arrays, key_valids, accs, occupied,
         _total) = agg_kernels.sort_aggregate(
            key_vecs, contribs, specs, sel, cap, num_segments=num_segments)
        if not self.group_exprs:
            occupied = torch.arange(num_segments, device=ctx.device) < 1
            key_arrays, key_valids = [], []

        out_cols: Dict[str, Column] = {}
        for g, vec, arr, kv in zip(self.group_exprs, key_vecs, key_arrays,
                                   key_valids):
            out_cols[g.name()] = Column(arr, vec.dtype, kv, vec.dictionary)

        results: Dict[int, Column] = {}
        for j, (i, a) in enumerate(regular):
            data, validity = a.func.device_finalize(accs[j], base)
            results[i] = Column(data, a.func.result_type(base), validity,
                                getattr(a.func, "output_dictionary", None))

        from ..expr_agg import Percentile
        sorts = {}  # (value child repr, cast) -> positional_sort outputs
        for i, a in enumerate(self.agg_exprs):
            f = a.func
            if not getattr(f, "positional", False):
                continue
            vec = f.child.eval(batch)
            is_pct = isinstance(f, Percentile)
            if is_pct:
                vec = cast_vec(vec, T.DOUBLE)
            skey = (repr(f.child), is_pct)
            if skey not in sorts:
                sorts[skey] = agg_kernels.positional_sort(
                    key_vecs, vec, sel, cap)
            vals_s, vvalid_s, gid, gstart = sorts[skey]
            if is_pct:
                out, ok = agg_kernels.positional_percentile(
                    vals_s, vvalid_s, gid, gstart, num_segments, f.q, cap)
                results[i] = Column(out, T.DOUBLE, ok & occupied)
            else:
                data, offs = agg_kernels.positional_collect(
                    vals_s, vvalid_s, gid, gstart, num_segments,
                    f.distinct, cap)
                results[i] = Column(data, T.ArrayType(vec.dtype), occupied,
                                    vec.dictionary, offsets=offs)

        for i, a in enumerate(self.agg_exprs):
            out_cols[a.out_name] = results[i]
        ctx.add_metric("agg_groups", occupied.sum())
        return Batch(out_cols, occupied, ctx.device)

    def output_partitioning(self):
        if self.mode == "partial":
            # per-shard accumulator tables: rows for one key exist on
            # every shard, so nothing stronger than the child's layout
            return self.child.output_partitioning()
        if not self.group_exprs:
            return SinglePartition()
        return self.child.output_partitioning()

    def required_child_distributions(self):
        if self.mode in ("complete", "final"):
            if not self.group_exprs:
                return [AllTuples()]
            names = []
            for g in self.group_exprs:
                name = plain_column_name(g)
                if name is None:
                    # a computed group key has no child column to hash
                    # (mesh positional aggregates reach complete mode
                    # directly): gather instead of a broken exchange
                    return [AllTuples()]
                names.append(name)
            return [ClusteredDistribution(tuple(names))]
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

    # -- the dense-path steps of the streaming loop -----------------------

    def prepare_direct(self, probe_batch: Batch, conf,
                       pad_dict: bool = True) -> Optional["DirectAggPlan"]:
        """The dense path's layout for a stream whose first chunk (after
        the replayed chain) is `probe_batch`; None when a key has no
        static domain or the domain is too large (the sort path).
        Dictionary domains get headroom for growth across chunks."""
        base = self._base_schema()
        cs = self.child.schema()
        key_vecs = [g.eval(probe_batch) for g in self.group_exprs]
        domains = []
        for g, v in zip(self.group_exprs, key_vecs):
            dom = agg_kernels.key_domain(g, v)
            if dom is None:
                return None
            d, lo = dom
            if pad_dict and v.dictionary is not None:
                d = bucket_capacity(max(16, 2 * d))
            domains.append((d, lo))
        spans = agg_kernels.key_spans(
            [g.nullable(cs) for g in self.group_exprs], domains)
        total = int(np.prod(list(spans) or [1]))
        if total > int(conf.get("spark_tpu.sql.aggregate.maxDirectDomain")):
            return None
        strides = []
        t = 1
        for span in spans:
            strides.append(t)
            t *= span
        specs = [a.func.accumulators(base) for a in self.agg_exprs]
        return DirectAggPlan(
            domains=domains, spans=spans, strides=strides, total=total,
            key_dtypes=[v.dtype for v in key_vecs],
            key_dicts=[v.dictionary for v in key_vecs], specs=specs,
            device=probe_batch.device)

    def direct_init_tables(self, prep: "DirectAggPlan"):
        return agg_kernels.direct_init(prep.spans, prep.specs, prep.device)

    def _updates(self, batch: Batch, sel, ctx=None, row_base=None):
        """Per-row accumulator contributions. Position-packed aggregates
        (first/last/any_value, `uses_row_base`) get a globally unique row
        base: `row_base` spaces host-driven chunks and the shard index
        spaces mesh shards, so merges never tie on in-chunk position."""
        if ctx is not None and ctx.on_mesh and any(
                a.func.uses_row_base for a in self.agg_exprs):
            if ctx.n_shards * batch.capacity >= (1 << 30):
                raise RuntimeError(
                    "first/last aggregation input exceeds the 2^30 "
                    "packed-position bound "
                    f"({ctx.n_shards} shards x {batch.capacity} rows)")
            row_base = (row_base or 0) + ctx.axis_index() * batch.capacity
        return [a.func.update(batch, sel, row_base=row_base)
                if a.func.uses_row_base else a.func.update(batch, sel)
                for a in self.agg_exprs]

    def direct_update_tables(self, tables, batch: Batch,
                             prep: "DirectAggPlan", conf=None,
                             row_base=None):
        """Fold one chunk into the carried tables; returns new tables
        (the old ones stay as they were, so a replayed chunk starts from
        them)."""
        sel = batch.selection
        key_vecs = [g.eval(batch) for g in self.group_exprs]
        idx, _, _ = agg_kernels.direct_index(key_vecs, prep.domains,
                                             prep.spans, sel, prep.device)
        contribs = self._updates(batch, sel, row_base=row_base)
        mode = str(conf.get("spark_tpu.sql.aggregate.kernelMode")) \
            if conf is not None else "auto"
        return agg_kernels.direct_update(
            tables, idx, prep.total, contribs, prep.specs, kernel_mode=mode,
            reuse_count=self._occupancy_reuse(batch))

    def direct_finalize_tables(self, tables, prep: "DirectAggPlan",
                               dict_overrides: Optional[Dict] = None) -> Batch:
        """The complete-mode output batch from the carried tables;
        `dict_overrides` swaps in the dictionaries a stream grew."""
        cnt, accs = tables
        base = self._base_schema()
        occupied = cnt > 0
        key_arrays, key_valids = agg_kernels.direct_keys(
            prep.domains, prep.spans, prep.strides, prep.key_dtypes,
            prep.device)
        if not self.group_exprs:
            occupied = torch.ones((1,), dtype=torch.bool, device=prep.device)
        cols: Dict[str, Column] = {}
        for g, arr, kv, dt, dic in zip(self.group_exprs, key_arrays,
                                       key_valids, prep.key_dtypes,
                                       prep.key_dicts):
            if dict_overrides and g.name() in dict_overrides:
                dic = dict_overrides[g.name()]
            cols[g.name()] = Column(arr, dt, kv, dic)
        for i, a in enumerate(self.agg_exprs):
            data, validity = a.func.device_finalize(accs[i], base)
            cols[a.out_name] = Column(
                data, a.func.result_type(base), validity,
                getattr(a.func, "output_dictionary", None))
        return Batch(cols, occupied, prep.device)

    def direct_partial_batch(self, tables, prep: "DirectAggPlan",
                             dict_overrides: Optional[Dict] = None) -> Batch:
        """The partial-mode output batch of carried tables: the group
        keys, the raw accumulator columns and the occupancy as selection
        (what the exchange and the final aggregate above consume)."""
        cnt, accs = tables
        key_arrays, key_valids = agg_kernels.direct_keys(
            prep.domains, prep.spans, prep.strides, prep.key_dtypes,
            prep.device)
        cols: Dict[str, Column] = {}
        for g, arr, kv, dt, dic in zip(self.group_exprs, key_arrays,
                                       key_valids, prep.key_dtypes,
                                       prep.key_dicts):
            if dict_overrides and g.name() in dict_overrides:
                dic = dict_overrides[g.name()]
            cols[g.name()] = Column(arr, dt, kv, dic)
        for i, a in enumerate(self.agg_exprs):
            for j, spec in enumerate(prep.specs[i]):
                cols[self._acc_col_name(i, j, spec)] = Column(
                    accs[i][j], _np_to_logical(spec.np_dtype))
        return Batch(cols, cnt > 0, prep.device)

    def simple_string(self):
        return (f"HashAggregateExec(mode={self.mode}, "
                f"groups={[repr(g) for g in self.group_exprs]}, "
                f"aggs={[repr(a) for a in self.agg_exprs]}, "
                f"est={self.est_groups})")


@dataclass
class DirectAggPlan:
    """The dense-domain layout of a streamed aggregate. `domains` entries
    are (domain, lo) pairs — see `aggregate.key_domain`."""

    domains: List[Tuple[int, int]]
    spans: List[int]  # domain + null slot for schema-nullable keys
    strides: List[int]
    total: int
    key_dtypes: List[T.DataType]
    key_dicts: List
    specs: List
    device: object


def _np_to_logical(np_dtype) -> T.DataType:
    m = {np.dtype(np.int64): T.LONG, np.dtype(np.float64): T.DOUBLE,
         np.dtype(np.int32): T.INT, np.dtype(np.float32): T.FLOAT,
         np.dtype(np.bool_): T.BOOLEAN, np.dtype(np.int16): T.SHORT,
         np.dtype(np.int8): T.BYTE}
    return m[np.dtype(np_dtype)]


class SortExec(UnaryExec):
    """Global sort: range-partition over the mesh (sampled bounds +
    all_to_all), then sort locally — shard i's keys <= shard i+1's, so
    the ordered concatenation of the shards is the global order
    (reference: SortExec.scala:40 + RangePartitioning). On one device
    the requirement is met already and this is the local sort."""

    def __init__(self, child: PhysicalPlan, orders: Sequence[SortOrder]):
        self.children = (child,)
        self.orders = tuple(orders)

    def schema(self):
        return self.child.schema()

    def order_key(self) -> Tuple[str, ...]:
        return tuple(repr(o) for o in self.orders)

    def required_child_distributions(self):
        return [OrderedDistribution(self.order_key())]

    def compute(self, ctx, inputs):
        batch = inputs[0]
        perm, n_valid = sort_kernels.sort_permutation(batch, self.orders)
        return sort_kernels.apply_permutation(batch, perm, n_valid)

    def simple_string(self):
        return f"SortExec({[repr(o) for o in self.orders]})"


class GenerateExec(UnaryExec):
    """explode: one output row per flattened array element. The output
    capacity is the values capacity (the flattened element column's
    padded length), so unlike the reference's `GenerateExec.scala:1`
    row iterator no re-plan sizing is needed: element slots map back to
    their rows with one searchsorted over the offsets, and every child
    column gathers by that row index. `outer` appends one slot per
    input row, live for empty/NULL arrays (explode_outer)."""

    def __init__(self, child: PhysicalPlan, gen_expr, out_name: str,
                 out_schema: T.Schema, outer: bool = False):
        self.children = (child,)
        self.gen_expr = gen_expr
        self.out_name = out_name
        self._schema = out_schema
        self.outer = outer

    def schema(self):
        return self._schema

    def compute(self, ctx, inputs):
        batch = inputs[0]
        cap = batch.capacity
        v = self.gen_expr.eval(batch)
        if v.offsets is None:
            raise AnalysisError(
                f"explode() needs an array, got {v.dtype!r}")
        device = v.data.device
        vcap = max(int(v.data.shape[0]), 1)
        iota = torch.arange(vcap, dtype=torch.int32, device=device)
        seg = torch.searchsorted(v.offsets, iota, right=True) - 1
        seg_c = seg.clamp(0, cap - 1)
        row_live = batch.selection_mask()
        live = (iota < v.offsets[-1]) & row_live[seg_c]
        if v.validity is not None:
            live = live & v.validity[seg_c]

        parts = {}
        for name, col in batch.columns.items():
            if col.offsets is not None:
                continue  # array columns do not replicate (see schema)
            parts[name] = (col.data[seg_c], None if col.validity is None
                           else col.validity[seg_c])
        elem_data = v.data
        elem_valid = v.elem_validity
        sel = live
        if self.outer:
            # one extra slot per input row, live only for empty/NULL
            # arrays; its element is NULL (explode_outer semantics)
            empty = v.offsets[1:] == v.offsets[:-1]
            if v.validity is not None:
                empty = empty | ~v.validity
            for name, (d, va) in parts.items():
                col = batch.columns[name]
                parts[name] = (torch.cat([d, col.data]),
                               None if va is None
                               else torch.cat([va, col.validity]))
            elem_data = torch.cat([elem_data, torch.zeros(
                (cap,), dtype=elem_data.dtype, device=device)])
            ev_main = elem_valid if elem_valid is not None else \
                torch.ones((vcap,), dtype=torch.bool, device=device)
            elem_valid = torch.cat([ev_main, torch.zeros(
                (cap,), dtype=torch.bool, device=device)])
            sel = torch.cat([live, row_live & empty])

        cols = {n: Column(d, batch.columns[n].dtype, va,
                          batch.columns[n].dictionary)
                for n, (d, va) in parts.items()}
        cols[self.out_name] = Column(elem_data, v.dtype.element, elem_valid,
                                     v.dictionary)
        ctx.add_metric(f"gen_rows_{self.out_name}", sel.sum())
        return Batch(cols, sel, ctx.device)

    def simple_string(self):
        return (f"GenerateExec(explode{'_outer' if self.outer else ''}"
                f"({self.gen_expr!r}) AS {self.out_name})")


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
        """Partitions co-locate through a hash exchange on the PARTITION
        BY columns; an empty or computed PARTITION BY needs all rows."""
        spec = self._spec()
        if not spec._partition:
            return [AllTuples()]
        names = []
        for p in spec._partition:
            name = plain_column_name(p)
            if name is None:
                return [AllTuples()]
            names.append(name)
        return [ClusteredDistribution(tuple(names))]

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
    """First-n. Over a range-partitioned (sorted) child it stays
    distributed: shard i keeps rows whose global rank — its local rank
    plus the gathered counts of lower shards — is under n, with no
    gather of the data (reference: the GlobalLimit/LocalLimit split in
    limit.scala). Otherwise it collapses to one logical partition."""

    def __init__(self, child: PhysicalPlan, n: int):
        self.children = (child,)
        self.n = n

    def schema(self):
        return self.child.schema()

    def required_child_distributions(self):
        if isinstance(self.child.output_partitioning(), RangePartitioning):
            return [UnspecifiedDistribution()]
        return [AllTuples()]

    def compute(self, ctx, inputs):
        batch = inputs[0]
        sel = batch.selection_mask()
        s = sel.to(torch.int32)
        local_rank = torch.cumsum(s, 0) - s
        if ctx.on_mesh and isinstance(self.child.output_partitioning(),
                                      RangePartitioning):
            counts = ctx.all_gather(s.sum())
            offset = counts[:ctx.axis_index()].sum()
            keep = local_rank < torch.clamp(self.n - offset, min=0)
            return batch.with_selection(sel & keep)
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

    def __init__(self, left: PhysicalPlan, right: PhysicalPlan,
                 left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression],
                 how: str, condition: Optional[Expression],
                 out_schema: T.Schema, strategy: str = "shuffle"):
        self.children = (left, right)
        self.left_keys = tuple(left_keys)
        self.right_keys = tuple(right_keys)
        self.how = how
        self.condition = condition
        self._schema = out_schema
        self.out_cap: Optional[int] = None
        self.unique_build: Optional[bool] = None
        self.hash_fallback: Optional[bool] = None
        #: the reorder cost model's output-row estimate (advisory)
        self.cbo_est_rows: Optional[int] = None
        # True for left_semi joins SYNTHESIZED by the runtime-filter rule
        # to narrow a creation chain (plan/runtime_filter.py): tagged
        # from a separate counter (cj<n>)
        self.creation_side = False
        # SQL NOT IN null-aware anti-join (left_anti only)
        self.null_aware = False
        self.tag = "j0"
        #: (kernel, reason) of the last run, for reports
        self.last_kernel: Optional[Tuple[str, str]] = None
        # "shuffle": co-partition both sides (ShuffledHashJoinExec.scala:37
        # analog); "broadcast": replicate the small build side with an
        # all_gather and leave the probe side in place
        # (BroadcastHashJoinExec.scala:40 analog). Picked by the planner
        # from source row estimates against autoBroadcastJoinThreshold;
        # on one device the two coincide.
        self.strategy = strategy

    @property
    def left(self):
        return self.children[0]

    @property
    def right(self):
        return self.children[1]

    def schema(self):
        return self._schema

    def _clusterable_key_names(self):
        """Key positions usable for hash partitioning: both sides must be
        plain column references (the exchange hashes child columns by
        name; a computed key has no column to hash)."""
        lk, rk = [], []
        for l, r in zip(self.left_keys, self.right_keys):
            ln, rn = plain_column_name(l), plain_column_name(r)
            if ln is not None and rn is not None:
                lk.append(ln)
                rk.append(rn)
        return tuple(lk), tuple(rk)

    def required_child_distributions(self):
        if self.strategy == "broadcast":
            return [UnspecifiedDistribution(), BroadcastDistribution()]
        lk, rk = self._clusterable_key_names()
        if not lk:
            if self.how in ("right", "full"):
                # a replicated build would append its locally-unmatched
                # rows on every shard: with no key columns to hash on,
                # co-locate everything and let the striped output dedupe
                return [AllTuples(), AllTuples()]
            # no hashable key columns (e.g. a cross join's literal keys):
            # every probe row must see every build row -> replicate build
            return [UnspecifiedDistribution(), BroadcastDistribution()]
        return [ClusteredDistribution(lk), ClusteredDistribution(rk)]

    def output_partitioning(self):
        lp = self.left.output_partitioning()
        rp = self.right.output_partitioning()
        if isinstance(lp, SinglePartition) and \
                isinstance(rp, (SinglePartition, Replicated)):
            # both sides fully co-located: every shard computed the same
            # complete result (valid for every join type incl. outer)
            return SinglePartition()
        if self.how in ("right", "full"):
            # appended null-extended rows carry NULL left keys on whatever
            # shard held the unmatched build row: no layout guarantee
            return UnknownPartitioning()
        return lp

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
                sel = sel & self._null_aware_mask(ctx, lvecs[0], build_batch,
                                                  rvecs[0])
            return probe_batch.with_selection(sel)
        if self.how == "left":
            return Batch(cols, psel, ctx.device)
        return Batch(cols, psel & found, ctx.device)

    def _null_aware_mask(self, ctx, probe_key_vec, build_batch,
                         build_key_vec):
        """Per-probe-row NOT IN adjustment (SQL three-valued logic): a
        NULL anywhere in the build keys empties the result; a NULL probe
        key survives only when the build side is empty. On a mesh both
        reduce over the shards: NULL build rows hash to one shard but
        empty every shard's output."""
        bsel = build_batch.selection_mask()
        if build_key_vec.validity is not None:
            has_null = (bsel & ~build_key_vec.validity).any()
        else:
            has_null = torch.zeros((), dtype=torch.bool, device=bsel.device)
        empty = ~bsel.any()
        if ctx.on_mesh:
            has_null = ctx.psum(has_null.to(torch.int32)) > 0
            empty = ctx.psum((~empty).to(torch.int32)) == 0
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
                sel = sel & self._null_aware_mask(ctx, lvecs[0], build_batch,
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
                sel = sel & self._null_aware_mask(ctx, lvecs[0], build_batch,
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

    def output_partitioning(self):
        return self.children[0].output_partitioning()

    def compute(self, ctx, inputs):
        import time as _time
        probe, build = inputs
        # the planner estimate is pre-filter; the batch capacity (times
        # the shards, whose bits combine) is a tighter bound on
        # insertable rows — don't size the bit array past it
        global_cap = build.capacity * max(1, ctx.n_shards)
        n_items = global_cap if self.est_items is None else \
            min(self.est_items, global_cap)
        t0 = _time.perf_counter()
        filt = join_kernels.build_runtime_filter(
            build, self.build_key, expected_items=max(int(n_items), 8),
            fpp=self.fpp, ctx=ctx)
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
    """Repartitioning boundary (reference: ShuffleExchangeExec.scala:115
    for the hash case, BroadcastExchangeExec.scala:78 for Replicated).

    On one device this is the identity; on a mesh it lowers to the
    collectives of `parallel/shuffle.py`:
      HashPartitioning           -> partition by key hash + all_to_all
      RangePartitioning          -> sampled bounds + all_to_all
      SinglePartition/Replicated -> all_gather"""

    def __init__(self, child: PhysicalPlan, partitioning: Partitioning):
        self.children = (child,)
        self.partitioning = partitioning
        #: per-(src,dst) receive block size; None = seeded from the input
        #: capacity (2x uniform spread), grown by the executor on overflow
        self.block_cap: Optional[int] = None
        self.tag = "e0"

    def schema(self):
        return self.child.schema()

    def output_partitioning(self):
        return self.partitioning

    def compute(self, ctx, inputs):
        if not ctx.on_mesh:
            return inputs[0]
        from ..parallel import shuffle
        if isinstance(self.partitioning, HashPartitioning):
            return shuffle.exchange_hash(inputs[0], self.partitioning.keys,
                                         ctx, block_cap=self.block_cap,
                                         tag=self.tag)
        if isinstance(self.partitioning, RangePartitioning):
            return shuffle.exchange_range(inputs[0],
                                          self.partitioning.orders, ctx,
                                          block_cap=self.block_cap,
                                          tag=self.tag)
        if isinstance(self.partitioning, (SinglePartition, Replicated)):
            return shuffle.all_gather_batch(inputs[0], ctx, tag=self.tag)
        raise AnalysisError(
            f"no collective lowering for {self.partitioning!r}")

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

    def output_partitioning(self):
        # a per-shard concatenation of sharded children is not a single
        # partition: claiming one would skip needed exchanges above and
        # make the executor stripe the (distinct) per-shard output
        lp = self.children[0].output_partitioning()
        rp = self.children[1].output_partitioning()
        if isinstance(lp, SinglePartition) and isinstance(rp, SinglePartition):
            return SinglePartition()
        return UnknownPartitioning(
            max(lp.num_partitions, rp.num_partitions))

    def compute(self, ctx, inputs):
        from ..columnar import unify_string_columns
        lb, rb = inputs
        dev = ctx.device
        if ctx.on_mesh:
            # a SinglePartition child is replicated on every shard: take
            # this shard's stripe so the union holds one copy of it
            from ..parallel.shuffle import stripe_batch
            parts = [c.output_partitioning() for c in self.children]
            if not all(isinstance(p, SinglePartition) for p in parts):
                if isinstance(parts[0], (SinglePartition, Replicated)):
                    lb = stripe_batch(lb, ctx)
                if isinstance(parts[1], (SinglePartition, Replicated)):
                    rb = stripe_batch(rb, ctx)
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
