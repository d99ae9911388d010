"""Query execution pipeline, eager (the port of `QueryExecution` in
`spark_tpu/execution/executor.py`; reference: `QueryExecution.scala`).

analyzed -> optimized_plan -> executed_plan -> execute_batch -> collect.
Before optimization, subtrees the session's data cache holds (a
`cache()`-marked plan, a WITH-clause view) are replaced by scans of
their materialized tables (`__cached__`), and uncorrelated scalar
subqueries run and become literals, as in the JAX package. After the
root of a marked plan runs, its result fills the cache; when the
outermost execution ends, only the statement-scoped (implicit) entries
are evicted. `explain()` prints the plans, the cost-based reorder's
decisions, per-operator output rows after a run (`rows_<op_tag>`), the
optimizer's rule trace and the static analyzer's findings. There is no jit stage or
compile cache: torch runs every operator
eagerly on the session's device, bottom-up over the physical tree. A
node that several parents share (a runtime filter's creation chain is
the same node objects as its join's build side) runs once per attempt.

The adaptive re-plan loop is the JAX package's, in eager form: after a
run, the executor reads the flags operators raised (a join's output
overflowed its capacity, a unique-build join met a duplicate key, a hash
table saturated, a sort aggregate met more groups than its table holds),
sets the node's state as the reference does, and runs the query again,
at most `MAX_ATTEMPTS` times. After a converged run it shrinks the
output capacity of every join a runtime filter pruned for (the
reference's `_shrink_caps_from_rtf`), so node state — and the printed
plan — match the JAX package's after a run.

Two kinds of state outlive an execution, as in the JAX package. Scans
load once per execution, before the re-plan loop, through the device
table cache (`io/device_cache.py`), so every attempt and every later
query over the same data reuses the loaded batches. And the capacities a
converged run settled on are kept in `session._aqe_caps`, keyed by the
optimized plan and its sources' identity stamps: the next execution of
that plan starts from them and skips the re-plan attempts.

Out-of-core execution and recovery (the JAX package's single-device
half): before the scans load, every streamable aggregate over a scan
past the device budget runs chunk by chunk (`streaming_agg.py`) and its
result is spliced back as an `InputExec` (`InputExec(streamed_agg,...)`,
or `InputExec(spilled_partials,...)` under a final-mode aggregate);
`collect()` first offers the plan to the chunked host-egress path
(`external.py`). Failures go through the taxonomy of `failures.py`
(`_execute_recover`, `_handle_failure`): a cancel or a blown deadline
surfaces unchanged; a transient fault or a stage timeout retries with
jittered backoff under `spark_tpu.execution.maxRetries`; running out of
device memory (`torch.cuda.OutOfMemoryError`) evicts the stage-output
memo and the device table cache and empties torch's allocator cache,
then re-plans under a 1-byte deviceBudget so the chunked paths take over
(`oom.spillOnExhausted`), then raises a diagnostic; anything else —
a sticky CUDA error included — raises. Every action lands in
`fault_summary`. Each execution registers a cancel token
(`lifecycle.py`), and the wait for a stage's device work polls a CUDA
event so that a cancel lands within `dispatchPollMs`.

On a mesh (`spark_tpu.sql.mesh.size` > 1, `parallel/`) each attempt runs
the plan once per shard, each shard on its own thread and device over its
stripe (`_run_mesh`, the JAX package's `run_shard`): the loaded leaves
are padded to a multiple of the shards and striped, a replicated output
is striped back, the outputs concatenate in shard order, flags reduce by
sum and metrics by max for the capacity-sizing prefixes (`MAX_METRICS`)
and by sum for the rest. An exchange whose receive block overflowed
grows it, unless the overflow is a skewed shuffle join's, which re-plans
the join as broadcast (`_maybe_skew_replan`, `join_strategy_overrides`).
Explode subtrees run on one device first (`_materialize_generates`). A
partial aggregate over a scan past the device budget streams per shard
(`streaming_agg.stream_scan_aggregate_mesh`) and is spliced in as
`InputExec(streamed_partial_agg,...)`, each shard's rows staying on its
device. A mesh failure (a broken rendezvous, a collective's peer copy,
the `mesh`, `mesh_checkpoint` and `decommission` fault sites) climbs the
elastic ladder (`parallel/elastic.py`): a gang restart still on the mesh
(`execution.meshRestart.*`; the mesh stream resumes at its checkpoint,
and a smaller healthy pool shrinks the gang), then the re-plan on one
device (`execution.meshFallback.enabled`; `mesh_fallback` in
fault_summary and `last_metrics`), whose stream resumes from the same
checkpoint. A drain request (`session.decommission_shards`) surfaces at
a chunk boundary; the executor excludes the drained device ids and runs
on again over the smaller gang. On a mesh that spans engine processes
the drain is agreed at the boundary, so every process records the same
`decommission` and re-plans alike (no abort is written for it), and the
whole ladder holds the cluster's run lock (`_execute_recover`).

Static analysis (`analysis/`, the JAX package's): the optimizer runs
under the plan-integrity validator and tracer
(`spark_tpu.sql.planChangeValidation`, `planChangeLog`); after planning,
before any UDF stage, stream, ingest or launch, the plan analyzer walks
the physical tree (`_analyze_plan_phase`, the `analyze` span) and
`predictions.py` writes down its size predictions; the findings post
once as `on_analysis` before the first launch, and under
`spark_tpu.sql.analysis.strict` an error-severity finding raises
`AnalysisFindingError` with no device work done.

Observability (`observability/`, the JAX package's spine): each
execution records spans (`self.spans`: parse for a SQL statement,
analysis, optimize, plan, analyze, ingest, one dispatch per attempt
holding an `op:<PhysicalClass>` span a computed node, egress; the host
work between them: admit, begin, start_event, caps_lookup, predict,
python_udfs, streaming (when a streamed aggregate ran; streamed chunks
record no operator spans), execution, stage_completed, grow_caps,
readback, caps_store, end_event; marks for
`aqe_replan`, `aqe_overflow`, `retry:<action>` and `cancelled`), each a
`spark_tpu/<span>` profiler range while a torch.profiler is active, and
posts its lifecycle on `session.listeners`: `on_query_start`,
`on_analysis`, `on_stage_completed` per attempt, `on_fault` per recovery action and
`on_query_end` with status ok, error, cancelled or deadline_exceeded and
the event-log record `_build_event` makes. With no observability output
configured and no user listener, no event is built (`_events_enabled`).
Eager torch compiles no stage, so `on_stage_compiled` is never posted.
Under `spark_tpu.sql.observability.xlaCost` each attempt's device-memory
cost is captured (`device_cost.py`, `self.stage_costs`); on a mesh, each
exchange's per-shard rows and bytes become `transfer` records under
`observability.shardSpans`; `spark_tpu.sql.profile.dir` wraps the
attempts in a torch.profiler trace. A surfaced failure (not a cancel)
asks the session's flight recorder for a diagnostic bundle. `collect()`
posts the query's end after the egress to Arrow, so the record's phase
times and spans include it.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional, Tuple

import pyarrow as pa
import torch

from ..columnar import Batch, bucket_capacity
from ..expr import Literal
from ..io.sources import ArrowTableSource
from ..plan import logical as L
from ..plan import physical as P
from ..plan.optimizer import default_optimizer
from ..plan.planner import plan_physical
from ..observability.device_cost import (AttemptCost, batch_bytes,
                                          device_hbm_capacity)
from .failures import (FailureClass, RetryPolicy, StageOOMError,
                       StageTimeoutError, classify)

#: attempts of the re-plan loop before it gives up
MAX_ATTEMPTS = 8

#: recovery actions before the failure ladder gives up
MAX_RECOVERY_ACTIONS = 32

DISPATCH_POLL_KEY = "spark_tpu.execution.dispatchPollMs"

#: the dispatch wait's shortest poll tick, seconds
POLL_MIN_TICK_S = 5e-5


def stage_events(device) -> List:
    """A CUDA event recorded behind the work queued so far on `device`'s
    current stream; none on the CPU, whose work is done when queued."""
    if torch.device(device).type != "cuda":
        return []
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return [ev]


def _sync_dispatched(events, conf) -> None:
    """Wait for a stage's device work, cancellably.

    With a cancel token installed and dispatchPollMs > 0, poll each
    event's `query()` instead of blocking: every tick checks the token,
    so a cancel or a blown queryDeadlineMs raises within about one tick
    (the kernels already queued run on; the host thread is released).
    The tick is an eighth of the time waited so far, from 50 us up to
    dispatchPollMs: a stage that ends during a tick is seen at most an
    eighth of its wait (or 50 us) late, and a long stage is polled
    every dispatchPollMs. The token is checked directly, not through
    `lifecycle.checkpoint`: readiness is timing-dependent, and the
    `cancel_point` seam's hit counts must stay deterministic."""
    from . import lifecycle
    tok = lifecycle.current_token()
    poll_s = float(conf.get(DISPATCH_POLL_KEY) or 0) / 1e3
    if tok is not None and poll_s > 0:
        t0 = time.monotonic()
        while not all(e.query() for e in events):
            tok.check("dispatch_wait")
            tok.wait(min(poll_s, max(POLL_MIN_TICK_S,
                                     (time.monotonic() - t0) / 8)))
    for e in events:
        e.synchronize()


_REPLAN_FLAGS = ("join_overflow_", "join_nonunique_", "join_hashsat_",
                 "exch_overflow_", "agg_overflow_")

#: metrics a mesh run reduces by max over the shards (capacity-sizing
#: stats take the worst shard); every other metric sums
MAX_METRICS = ("join_rows_", "exch_max_", "agg_groups_", "rtf_build_ms_",
               "join_build_ms_", "join_probe_ms_", "join_table_slots_")


class _ReplanRequest(Exception):
    """The adaptive re-planner changed a join's strategy: the physical
    plan rebuilds with `_join_overrides` and execution starts again."""


#: most plans `session._aqe_caps` keeps (plan strings are large)
MAX_SAVED_PLANS = 256


def run_plan(root: P.PhysicalPlan, ctx: P.ExecContext,
             visit=None, loaded: Optional[Dict[int, Batch]] = None
             ) -> Batch:
    """Compute `root` bottom-up, each node once however many parents
    share it. `loaded` maps node ids to batches computed already (the
    scans `load_scans` loaded), which are not computed again.
    `visit(node, compute)` wraps each node's computation when given (a
    profiler's seam). Each node it computes is the span
    `op:<PhysicalClass>` (attribute `op_tag` where the node has one) on
    the query's recorder, `ctx.spans`, when there is one. Under
    `spark_tpu.sql.metrics.enabled` each node it computes (not the loaded
    scans, which the JAX package feeds in as inputs) keeps its live
    output rows as the metric `rows_<op_tag>` (the SQLMetrics analog),
    counted inside the computation `visit` times."""
    memo: Dict[int, Batch] = dict(loaded or {})

    per_op = bool(ctx.conf.get("spark_tpu.sql.metrics.enabled"))
    spans = ctx.spans

    def compute(node: P.PhysicalPlan, inputs: List[Batch]) -> Batch:
        out = node.compute(ctx, inputs)
        if per_op and hasattr(node, "op_tag"):
            ctx.add_metric(f"rows_{node.op_tag}",
                           out.capacity if out.selection is None
                           else out.selection.sum())
        return out

    def computed(node: P.PhysicalPlan, inputs: List[Batch]) -> Batch:
        if visit is None:
            return compute(node, inputs)
        return visit(node, lambda: compute(node, inputs))

    def run(node: P.PhysicalPlan) -> Batch:
        out = memo.get(id(node))
        if out is None:
            inputs = [run(c) for c in node.children]
            if spans is None:
                out = computed(node, inputs)
            else:
                tag = getattr(node, "op_tag", None)
                with spans.span("op:" + type(node).__name__,
                                **({"op_tag": tag} if tag else {})):
                    out = computed(node, inputs)
            memo[id(node)] = out
        return out

    return run(root)


def host_metrics(metrics: Dict[str, object]) -> Dict[str, object]:
    """Metric values on the host: floats stay floats, the rest become
    ints; the device tensors among them leave the card in one copy per
    dtype class."""
    out: Dict[str, object] = {}
    pending = {True: [], False: []}  # is float -> [(name, tensor)]
    for k, v in metrics.items():
        if isinstance(v, torch.Tensor):
            pending[v.is_floating_point()].append((k, v))
        else:
            out[k] = float(v) if isinstance(v, float) else int(v)
    for is_float, items in pending.items():
        if not items:
            continue
        dtype = torch.float64 if is_float else torch.int64
        values = torch.stack([t.reshape(()).to(dtype)
                              for _, t in items]).tolist()
        for (k, _), v in zip(items, values):
            out[k] = float(v) if is_float else int(v)
    return out


def plan_nodes(root: P.PhysicalPlan, kind) -> List:
    """Every node of type `kind` in post-order, each once (the plan is a
    DAG)."""
    seen, out = set(), []

    def walk(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for c in node.children:
            walk(c)
        if isinstance(node, kind):
            out.append(node)

    walk(root)
    return out


def load_scans(root: P.PhysicalPlan, conf, device) -> Dict[int, Batch]:
    """Every ScanExec's batch, loaded once through the device table
    cache, by node id (a scan that several parents share loads once)."""
    from ..io.device_cache import load_scan
    return {id(s): load_scan(s, conf, device)
            for s in plan_nodes(root, P.ScanExec)}


def load_shards(root: P.PhysicalPlan, conf, mesh) -> List[Dict[int, Batch]]:
    """Per shard, the stripe of every loaded leaf by node id: scans
    through the device table cache (one entry per shard and card), the
    spliced InputExec batches padded and striped, each stripe on its
    shard's device; a mesh stream's per-shard partials as they are. On a
    mesh that spans processes, this process's positions only (the
    others' maps stay empty)."""
    from ..io.device_cache import load_scan_shards
    from ..parallel.shuffle import move_batch, shard_stripes
    n = mesh.size
    local = mesh.local_positions
    out: List[Dict[int, Batch]] = [{} for _ in range(n)]
    for s in plan_nodes(root, P.ScanExec):
        parts = load_scan_shards(s, conf, mesh)
        for i in local:
            out[i][id(s)] = parts[i]
    for s in plan_nodes(root, P.InputExec):
        parts = s.shards if s.shards is not None and len(s.shards) == n \
            else shard_stripes(s.load(), n)
        for i in local:
            out[i][id(s)] = move_batch(parts[i], mesh.devices[i])
    return out


def reduce_shard_metrics(per_shard: List[Dict[str, object]]
                         ) -> Dict[str, object]:
    """The shards' host metrics as one map: max for `MAX_METRICS`, sum
    (in shard order) for the rest."""
    out: Dict[str, object] = {}
    for m in per_shard:
        for k, v in m.items():
            if k not in out:
                out[k] = v
            elif k.startswith(MAX_METRICS):
                out[k] = max(out[k], v)
            else:
                out[k] = out[k] + v
    return out


def collect_caps(root: P.PhysicalPlan) -> Dict[str, int]:
    """Every re-plan state of a converged plan, keyed `kind:tag` (the
    JAX package's `_collect_caps`): join output capacities, the
    unique-build and hash fallbacks, exchange blocks and aggregate group
    estimates."""
    out: Dict[str, int] = {}
    for j in plan_nodes(root, P.JoinExec):
        if j.out_cap is not None:
            out[f"join:{j.tag}"] = j.out_cap
        if j.unique_build is False:
            out[f"uniq:{j.tag}"] = 0
        if j.hash_fallback is False:
            out[f"hashfb:{j.tag}"] = 0
    for e in plan_nodes(root, P.ExchangeExec):
        if e.block_cap is not None:
            out[f"exch:{e.tag}"] = e.block_cap
    for a in plan_nodes(root, P.HashAggregateExec):
        if a.est_groups:
            out[f"agg:{a.tag}"] = a.est_groups
    return out


def apply_saved_caps(root: P.PhysicalPlan, caps: Dict[str, int]) -> None:
    """Set the state `collect_caps` harvested on the nodes of a fresh
    plan with the same tags (the JAX package's `_apply_saved_caps`)."""
    joins = {j.tag: j for j in plan_nodes(root, P.JoinExec)}
    exchanges = {e.tag: e for e in plan_nodes(root, P.ExchangeExec)}
    aggs = {a.tag: a for a in plan_nodes(root, P.HashAggregateExec)}
    for key, cap in caps.items():
        kind, tag = key.split(":", 1)
        if kind == "join" and tag in joins:
            joins[tag].out_cap = cap
        elif kind == "uniq" and tag in joins:
            joins[tag].unique_build = False
        elif kind == "hashfb" and tag in joins:
            joins[tag].hash_fallback = False
        elif kind == "exch" and tag in exchanges:
            exchanges[tag].block_cap = cap
        elif kind == "agg" and tag in aggs:
            aggs[tag].est_groups = cap


def apply_flags(root: P.PhysicalPlan, flags: List[str],
                metrics: Dict[str, object]) -> None:
    """Set the node state each raised re-plan flag asks for."""
    joins = {j.tag: j for j in plan_nodes(root, P.JoinExec)}
    aggs = {a.tag: a for a in plan_nodes(root, P.HashAggregateExec)}
    exchanges = {e.tag: e for e in plan_nodes(root, P.ExchangeExec)}
    for k in flags:
        if k.startswith("join_nonunique_"):
            joins[k[len("join_nonunique_"):]].unique_build = False
        elif k.startswith("join_hashsat_"):
            # a correctness re-plan like the unique-build fallback:
            # pin this join to the sort kernel
            joins[k[len("join_hashsat_"):]].hash_fallback = False
        elif k.startswith("join_overflow_"):
            tag = k[len("join_overflow_"):]
            total = int(metrics[f"join_rows_{tag}"])
            joins[tag].out_cap = bucket_capacity(max(total, 8))
        elif k.startswith("exch_overflow_"):
            tag = k[len("exch_overflow_"):]
            mx = int(metrics[f"exch_max_{tag}"])
            exchanges[tag].block_cap = bucket_capacity(max(mx, 8))
        else:
            tag = k[len("agg_overflow_"):]
            total = int(metrics[f"agg_groups_{tag}"])
            aggs[tag].est_groups = bucket_capacity(max(total, 8))


def shrink_caps_from_rtf(root: P.PhysicalPlan,
                         metrics: Dict[str, object], n: int = 1) -> None:
    """Shrink the output capacity of each join a runtime filter guards,
    and on a mesh (`n` shards) the receive blocks of the exchanges
    between them: both were seeded from the unpruned probe capacity,
    and the survivors (rtf_tested - rtf_pruned) bound what they hold on
    the next run. The measured join_rows / exch_max floor the new
    values, so a shrunk capacity never overflows on the same data."""
    def walk(node, ancestors):
        for c in node.children:
            walk(c, ancestors + (node,))
        if not isinstance(node, P.RuntimeFilterExec):
            return
        tested = metrics.get(f"rtf_tested_{node.tag}")
        pruned = metrics.get(f"rtf_pruned_{node.tag}")
        if tested is None or pruned is None:
            return
        surv = int(tested) - int(pruned)
        if int(tested) <= 0 or int(pruned) <= 0 or surv < 0:
            return  # the filter never pruned: nothing to shrink from
        # climb from the filter to the join it guards (narrow ops pass)
        for anc in reversed(ancestors):
            if isinstance(anc, (P.ProjectExec, P.FilterExec,
                                P.RuntimeFilterExec)):
                continue
            if isinstance(anc, P.ExchangeExec):
                if n <= 1:
                    continue  # the identity on one device
                actual = int(metrics.get(f"exch_max_{anc.tag}", 0))
                new = bucket_capacity(max(2 * (-(-surv // n)), actual, 8))
                if anc.block_cap is None or new < anc.block_cap:
                    anc.block_cap = new
                continue
            if isinstance(anc, P.JoinExec):
                actual = int(metrics.get(f"join_rows_{anc.tag}", 0))
                new = bucket_capacity(max(2 * surv, actual, 8))
                if anc.out_cap is None or new < anc.out_cap:
                    anc.out_cap = new
            break  # the guarded join (or an opaque op) ends the climb

    walk(root, ())


class QueryExecution:
    def __init__(self, session, logical: L.LogicalPlan,
                 parsed: Optional[Tuple[float, float]] = None):
        """`parsed` is the perf_counter interval in which `session.sql`
        parsed and lowered the statement, the query's `parse` span and
        phase time; None for a plan built otherwise."""
        self.session = session
        self.logical = logical
        self._analyzed: Optional[L.LogicalPlan] = None
        self._optimized: Optional[L.LogicalPlan] = None
        self._executed: Optional[P.PhysicalPlan] = None
        self.last_metrics: Dict[str, object] = {}
        #: runs the last execute_batch took (1 + re-plans)
        self.attempts = 0
        #: per-(batch, rule) optimizer records from the plan-change
        #: tracer (`analysis/plan_integrity.py`): the event log's
        #: `rule_trace` and explain(rules=True); None until the
        #: optimizer ran for this execution
        self.rule_trace: Optional[List[Dict]] = None
        #: lite-mode plan-integrity findings, merged into
        #: analysis_findings by `_analyze_plan_phase` (full mode raises
        #: PlanIntegrityError from inside the optimizer instead)
        self._integrity_findings: List = []
        #: typed findings of the static plan analyzer (`analysis/`);
        #: None until the analyzer ran for this execution, [] when it
        #: ran and found nothing
        self.analysis_findings: Optional[List] = None
        #: on_analysis posts once per QueryExecution
        self._analysis_posted = False
        #: size/capacity predictions off the planned tree
        #: (`analysis/predictions.py`), graded against the observed
        #: metrics by `history.prediction_report`
        self.plan_predictions: Optional[List[Dict]] = None
        #: the cost-based join reorder's decision records, one per
        #: eligible region; None until the optimizer ran
        self.reorder_decisions: Optional[List[Dict]] = None
        #: the Arrow result a run of a marked plan left in the data cache
        self._filled: Optional[pa.Table] = None
        #: cached tables `_apply_cache` substituted into this plan
        self._cache_hits = 0
        self.query_id: int = session._next_query_id()
        # observability: per-phase spans (Chrome-trace exportable) and
        # the device-memory cost of the stages this execution ran
        from ..observability import SpanRecorder
        self.spans = SpanRecorder(
            self.query_id,
            max_spans=int(session.conf.get(
                "spark_tpu.sql.observability.maxSpans")),
            max_shard_records=int(session.conf.get(
                "spark_tpu.sql.observability.maxShardRecords")),
            t_origin=parsed[0] if parsed is not None else None)
        #: seconds by phase, kept by the recorder's spans
        self.phase_times: Dict[str, float] = self.spans.phase_times
        if parsed is not None:
            self.spans.record("parse", *parsed, phase="parse")
        #: stage key -> its last attempt's device-memory cost record
        self.stage_costs: Dict[str, Dict] = {}
        # set per execute_batch: False keeps event construction off the
        # hot path when nothing is listening
        self._observe_events = False
        #: collect() posts the query's end itself, after the egress
        self._end_deferred = False
        #: the spliced plan of the last converged run (the event's plan)
        self._end_root: Optional[P.PhysicalPlan] = None
        #: each shard's host metrics of the last mesh attempt
        self._shard_metrics: Optional[List[Dict[str, object]]] = None
        # failure handling: a degraded rerun overlays conf (the OOM
        # ladder's spill rung) without touching the session's
        self._exec_conf = None
        self._oom_rung = 0
        self._retry_policy: Optional[RetryPolicy] = None
        #: set by the OOM rungs: free device memory once the failed
        #: attempt's frames are gone
        self._free_device_memory = False
        #: recovery actions of the last execution, by action, and up to
        #: 32 event records
        self.fault_summary: Dict[str, object] = {}
        self.fault_events: List[Dict] = []
        self._recovery = None
        #: rows of the spilled partials the last execution re-reduced
        self.spilled_partial_rows: Optional[int] = None
        #: per-stream chunk timings of the last execution
        #: (`streaming_agg._ChunkClock`)
        self.stream_stats: List[Dict] = []
        #: the plan the last execution ran: `executed_plan` with its
        #: streamed aggregates spliced in as InputExec leaves
        self.spliced_plan: Optional[P.PhysicalPlan] = None
        #: python-UDF evaluation summary of the last execution
        #: (execution/python_eval.py): mode, batch/row totals, worker
        #: restarts, evaluation milliseconds; None without UDFs
        self.udf_summary: Optional[Dict] = None
        #: the mesh failure rung re-planned this execution on one device
        self._mesh_fallback = False
        #: join tag -> strategy the adaptive skew re-planner forced
        self._join_overrides: Dict[str, str] = {}
        self._no_more_replans = False

    @property
    def _conf(self):
        """The conf planning and execution read: the session's, or the
        degraded-mode overlay of the OOM ladder's spill rung."""
        return self._exec_conf if self._exec_conf is not None \
            else self.session.conf

    def _activate_conf(self) -> None:
        from ..expr import set_case_sensitive
        set_case_sensitive(bool(
            self.session.conf.get("spark_tpu.sql.caseSensitive")))

    @property
    def analyzed(self) -> L.LogicalPlan:
        if self._analyzed is None:
            with self.spans.span("analysis", phase="analysis"):
                self._activate_conf()
                # eager name/type resolution raises here
                self.logical.schema()
                self._analyzed = self.logical
        return self._analyzed

    def _apply_cache(self, plan: L.LogicalPlan) -> L.LogicalPlan:
        """Substitute cached subtrees with scans over their materialized
        tables (reference: CacheManager.useCachedData). A marked subtree
        not yet materialized is computed on its first use inside a
        larger query, like the reference's InMemoryRelation. Matching is
        on the pre-optimization plan fingerprint. Each table found in
        the cache counts one `session.result_cache_hits` per execution
        of this plan (`_execute_batch`), not when it is only planned."""
        session = self.session
        self._cache_hits = 0
        if not len(session._data_cache) and not session._cache_requests:
            return plan
        root_fp = session._plan_fingerprint(plan)

        def f(node):
            fp = session._plan_fingerprint(node)
            table = session._data_cache.get(fp)
            if table is not None:
                self._cache_hits += 1
            if table is None and fp in session._cache_requests \
                    and fp != root_fp:
                # first use inside a larger query: compute it now (the
                # root itself runs on the normal path, which fills the
                # cache afterwards)
                table = QueryExecution(
                    session, session._cache_requests[fp]).collect()
                session._data_cache[fp] = table
            if table is not None:
                return L.Scan(ArrowTableSource("__cached__", table))
            return None

        # top-down so the largest marked subtree wins
        return plan.transform_down(f)

    def _resolve_scalar_subqueries(self, plan: L.LogicalPlan
                                   ) -> L.LogicalPlan:
        """Run uncorrelated scalar subqueries and substitute their single
        value as a Literal — before optimization, so the literal takes
        part in pushdown (reference: PlanSubqueries + ScalarSubquery
        execution). The value reaches the host with one sync."""
        def has_subquery(e) -> bool:
            return isinstance(e, L.ScalarSubqueryExpr) or \
                any(has_subquery(c) for c in e.children)

        if not any(has_subquery(e) for e in L.iter_expressions(plan)):
            return plan

        def resolve(node):
            if not isinstance(node, L.ScalarSubqueryExpr):
                return node
            fields = node.plan.schema().fields
            if len(fields) != 1:
                raise RuntimeError(
                    "scalar subquery must return exactly one column")
            table = QueryExecution(self.session, node.plan).collect()
            if table.num_rows > 1:
                raise RuntimeError(
                    "scalar subquery returned more than one row")
            val = None if table.num_rows == 0 else \
                table.column(0)[0].as_py()
            return Literal(val, fields[0].dtype)

        return L.map_expressions(plan, lambda e: e.transform_up(resolve))

    @property
    def optimized_plan(self) -> L.LogicalPlan:
        if self._optimized is None:
            with self.spans.span("optimize", phase="optimization"):
                self._optimize()
        return self._optimized

    def _optimize(self) -> None:
        plan = self._resolve_scalar_subqueries(
            self._apply_cache(self.analyzed))
        log: List[Dict] = []
        from ..analysis.plan_integrity import (PlanChangeTracer,
                                               PlanIntegrityValidator)
        mode = str(self._conf.get("spark_tpu.sql.planChangeValidation"))
        validator = PlanIntegrityValidator(mode) \
            if mode in ("lite", "full") else None
        tracer = PlanChangeTracer(diffs=bool(self._conf.get(
            "spark_tpu.sql.planChangeLog")))
        self._optimized = default_optimizer(
            self.session.conf, reorder_log=log, validator=validator,
            tracer=tracer).execute(plan)
        self.rule_trace = tracer.records
        if validator is not None:
            self._integrity_findings = validator.findings
        self.reorder_decisions = log

    @property
    def executed_plan(self) -> P.PhysicalPlan:
        if self._executed is None:
            with self.spans.span("plan", phase="planning"):
                self._executed = plan_physical(
                    self.optimized_plan, self._conf,
                    join_strategy_overrides=self._join_overrides or None)
        return self._executed

    def explain(self, extended: bool = False, runtime: bool = False,
                analysis: bool = False, rules: bool = False) -> str:
        """The plan as text: the physical plan (with each operator's
        runtime observables when `runtime` and the query ran), the
        logical and optimized plans when `extended`, the join reorder's
        decisions, the optimizer's rule trace when `rules` and the
        static analyzer's findings when `analysis`. The JAX package's
        `QueryExecution.explain`; in place of its XLA stage costs, the
        device-memory cost of each stage that ran under
        `observability.xlaCost`."""
        out = []
        if extended:
            out += ["== Logical Plan ==", self.logical.tree_string(),
                    "== Optimized Logical Plan ==",
                    self.optimized_plan.tree_string()]
        if runtime and self.last_metrics:
            out.append("== Physical Plan (runtime metrics) ==")
            out.append(self._runtime_tree(self.executed_plan))
            if self.stage_costs:
                out.append("== Stage cost (device memory) ==")
                for info in self.stage_costs.values():
                    bits = [f"stage {info.get('key_hash', '?')}"]
                    for k, label in (("peak_hbm_bytes", "peak HBM"),
                                     ("argument_bytes", "args"),
                                     ("output_bytes", "out")):
                        if info.get(k) is not None:
                            bits.append(f"{label}={info[k]:,}")
                    if info.get("memory_error"):
                        bits.append(f"none: {info['memory_error']}")
                    out.append("  " + ", ".join(bits))
        else:
            out += ["== Physical Plan ==",
                    self.executed_plan.tree_string()]
        out += ["== Join Reorder =="] + self._reorder_lines()
        if rules:
            from ..analysis.plan_integrity import render_trace
            self.optimized_plan  # the optimizer (and its trace) ran
            out.append("== Rule Trace ==")
            out += render_trace(self.rule_trace or []) or \
                ["  no rules applied"]
        if analysis:
            out.append("== Static Analysis ==")
            findings = self.analysis_findings
            if findings is None:
                # not executed yet, or the analyzer was off: run the
                # plan walk on demand (None means "never analyzed", so a
                # disabled execution never prints a false clean bill)
                from ..analysis import analyze_plan
                mesh_n = max(1, int(self._conf.get(
                    "spark_tpu.sql.mesh.size")))
                findings = analyze_plan(self.executed_plan, self._conf,
                                        mesh_n)
            if findings:
                out += ["  " + f.render() for f in findings]
            else:
                out.append("  no findings")
        return "\n".join(out)

    def _reorder_lines(self) -> List[str]:
        """The cost-based join reorder for explain(): 'reorder: yes/no'
        and, per region, the frontend order, the chosen order and the
        estimated rows of each join."""
        self.executed_plan  # the optimizer (and its log) ran
        decisions = self.reorder_decisions or []
        changed = [d for d in decisions if d.get("changed")]
        lines = [f"  reorder: {'yes' if changed else 'no'}"
                 + (f" ({len(changed)}/{len(decisions)} regions)"
                    if decisions else "")]
        for d in decisions:
            if not d.get("changed"):
                arrow = " (kept)"
            elif d.get("kind") == "orientation":
                arrow = " -> same order, probe/build orientation flipped"
            else:
                arrow = " -> " + " * ".join(d["order"])
            est = d.get("est_rows") or []
            lines.append("  " + " * ".join(d["relations"]) + arrow
                         + (f"  est rows/join: {est}" if est else ""))
        return lines

    def _runtime_tree(self, node: P.PhysicalPlan, depth: int = 0) -> str:
        """The physical tree annotated with each operator's runtime
        observables (the SQL-UI plan graph analog of
        `metric/SQLMetrics.scala:40`): output rows everywhere, a join's
        rows against its capacity and its hash table, an exchange's
        largest block, a runtime filter's pruned rows."""
        m = self.last_metrics
        notes = []
        rows = m.get(f"rows_{getattr(node, 'op_tag', '')}")
        if rows is not None:
            notes.append(f"rows out: {rows:,}")
        tag = getattr(node, "tag", None)
        if isinstance(node, P.JoinExec):
            jr = m.get(f"join_rows_{tag}")
            if jr is not None:
                cap = node.out_cap
                notes.append(f"join rows: {jr:,}"
                             + (f"/{cap:,} cap" if cap else ""))
            if getattr(node, "cbo_est_rows", None) is not None:
                notes.append(f"cbo est: {node.cbo_est_rows:,}")
            slots = m.get(f"join_table_slots_{tag}")
            if slots is not None:
                notes.append(
                    f"hash table: {slots:,} slots, build "
                    f"{m.get(f'join_build_ms_{tag}', 0)}ms, probe "
                    f"{m.get(f'join_probe_ms_{tag}', 0)}ms")
        elif isinstance(node, P.ExchangeExec):
            mx = m.get(f"exch_max_{tag}")
            if mx is not None:
                cap = node.block_cap
                notes.append(f"exch max: {mx:,}"
                             + (f"/{cap:,} cap" if cap else ""))
            er = m.get(f"exch_rows_{tag}")
            if er is not None:
                notes.append(f"exch rows: {er:,}")
        elif isinstance(node, P.RuntimeFilterExec):
            tested = m.get(f"rtf_tested_{tag}")
            pruned = m.get(f"rtf_pruned_{tag}")
            if tested is not None and pruned is not None:
                notes.append(f"rtf pruned: {pruned:,}/{tested:,}")
        note = f"   [{'; '.join(notes)}]" if notes else ""
        line = "  " * depth + node.simple_string() + note
        return "\n".join([line] + [self._runtime_tree(c, depth + 1)
                                   for c in node.children])

    def execute_batch(self) -> Batch:
        """Run the query under the failure ladder; returns its device
        Batch."""
        from ..service import arbiter as res_arbiter
        from . import lifecycle
        session = self.session
        # the execution's scopes, lease and failure state
        with self.spans.span("begin"):
            self._activate_conf()
            # every execution starts optimistic: a plan built under an
            # earlier execution's degraded overlay is rebuilt
            if self._exec_conf is not None or self._mesh_fallback:
                self._executed = None
            self._exec_conf = None
            self._mesh_fallback = False
            lc_scope = lifecycle.enter_query_scope(
                session.app_id, self.query_id, session.conf)
            # the service arbiter's lease scope (service/arbiter.py):
            # scans this execution keeps resident lease from the shared
            # pool, and all of it is released when the execution ends;
            # None when no arbiter is installed
            arb_token = res_arbiter.enter_query(
                f"{session.app_id}:q{self.query_id}", session.device)
            self.udf_summary = None
            # _analysis_posted stays: it is per QueryExecution, so an
            # external collect that falls through to here (or a
            # re-executed qe) posts on_analysis once
            self.analysis_findings = None
            for key in [k for k in self.phase_times
                        if k.startswith("udf_")]:
                del self.phase_times[key]  # python_eval's per-run sums
            self._begin_recovery()
            self._observe_events = self._events_enabled()
        if self._observe_events:
            from ..observability.listener import QueryStartEvent
            with self.spans.span("start_event"):
                session.listeners.post("on_query_start", QueryStartEvent(
                    query_id=self.query_id, ts=time.time(),
                    plan=self.logical.tree_string()))
        session._exec_depth += 1
        try:
            for _replan in range(4):
                try:
                    out = self._execute_recover()
                    break
                except _ReplanRequest:
                    # re-plan with _join_overrides: the rebuilt plan has
                    # new nodes, so memoized stage outputs do not splice
                    self._executed = None
                    self._recovery.invalidate()
                    self.spans.mark("aqe_replan", kind="join_strategy")
            else:
                # re-plan budget spent: finish with capacity growth only
                self._no_more_replans = True
                out = self._execute_recover()
            if not self._end_deferred:
                self._post_query_end(self._end_root)
            return out
        except (lifecycle.QueryCancelledError,
                lifecycle.QueryDeadlineError) as e:
            self._observe_cancel(e)
            raise
        except Exception as e:  # noqa: BLE001 — observe, then surface
            self._post_query_end(None, status="error", error=e)
            self._flightrec_dump(e)
            raise
        finally:
            res_arbiter.exit_query(arb_token)
            lifecycle.exit_query_scope(lc_scope)
            session._exec_depth -= 1
            self.stream_stats = self._recovery.chunk_stats
            # the memo spans recovery loops, not executions
            self._recovery.release()
            if session._exec_depth == 0:
                # statement-scoped materializations end with the
                # outermost execution; the marks stay, so running the
                # statement again computes a shared view once again.
                # Explicit cache() entries outlive the statement.
                session._evict_implicit_caches()

    def _begin_recovery(self) -> None:
        """Fresh failure state for one run of the ladder (execute_batch
        or the external collect): injection armed from the conf, an
        empty fault_summary, a new stage-output memo and retry budget."""
        from ..parallel.elastic import ElasticMeshState
        from ..testing import faults
        from .recovery import RecoveryContext
        conf = self.session.conf
        faults.arm(conf)
        self.fault_summary = {}
        self.fault_events = []
        self._recovery = RecoveryContext(metrics=self.session.metrics,
                                         record=self._record_fault)
        self._elastic = ElasticMeshState(conf)
        self._oom_rung = 0
        self._retry_policy = RetryPolicy(
            max_retries=self._max_retries(conf),
            backoff_ms=float(conf.get("spark_tpu.execution.backoffMs")))

    @staticmethod
    def _max_retries(conf) -> int:
        """spark_tpu.execution.maxRetries, unless the deprecated
        spark_tpu.sql.execution.maxTaskFailures was set explicitly."""
        legacy = "spark_tpu.sql.execution.maxTaskFailures"
        if conf.is_explicitly_set(legacy):
            return int(conf.get(legacy))
        return int(conf.get("spark_tpu.execution.maxRetries"))

    # -- failure recovery ---------------------------------------------------

    def _record_fault(self, action: str, exc=None, **extra) -> None:
        """Count one recovery action into fault_summary, keep a bounded
        event record (drops past 32 are counted; both land in the event
        log), mark the retry on the span trace and post the typed
        FaultEvent."""
        self.fault_summary[action] = int(self.fault_summary.get(action, 0)) + 1
        error = "" if exc is None else f"{type(exc).__name__}: {exc}"[:200]
        site = getattr(exc, "site", None)
        if len(self.fault_events) < 32:
            ev = {"action": action}
            if exc is not None:
                ev["error"] = error
                if site is not None:
                    ev["site"] = site
            ev.update(extra)
            self.fault_events.append(ev)
        else:
            self.fault_summary["events_dropped"] = int(
                self.fault_summary.get("events_dropped", 0)) + 1
        self.spans.mark(f"retry:{action}", error=error[:120])
        if self._observe_events:
            from ..observability.listener import FaultEvent
            self.session.listeners.post("on_fault", FaultEvent(
                query_id=self.query_id, ts=time.time(), action=action,
                error=error, site=site))

    def _observe_cancel(self, e: Exception) -> None:
        """A cancelled or deadlined execution: its session counter, a
        `cancel` action in fault_summary, a `cancelled` mark on the span
        trace, and a query-end event whose status is "cancelled" or
        "deadline_exceeded". No pooled UDF worker survives it, wherever
        the cancel landed (a scan, a chunk, the UDF lane): idle workers
        respawn on demand, so this costs one warm start. A cancel is
        lifecycle, not a crash: it never dumps a flight-recorder
        bundle."""
        from .lifecycle import QueryCancelledError
        cancelled = isinstance(e, QueryCancelledError)
        self.session.metrics.counter(
            "query_cancelled" if cancelled
            else "query_deadline_exceeded").inc()
        self._record_fault("cancel", e)
        self.spans.mark("cancelled",
                        reason="cancel" if cancelled else "deadline")
        self.session._udf_pool.shutdown()
        self._post_query_end(
            None, status="cancelled" if cancelled else "deadline_exceeded",
            error=e)

    def _flightrec_dump(self, e: Exception) -> None:
        """Crash-time diagnostics for a surfaced failure (the recovery
        ladder gave up): classify the terminal error and ask the
        session's flight recorder for a bundle. Cancels and deadlines
        take `_observe_cancel` and never dump. Works with events off:
        the recorder's rings may be sparse then, but the plan and the
        fault summary ride along in `extra`. A failed dump warns."""
        try:
            from ..observability.flight_recorder import FlightRecorder
            rec = FlightRecorder.of(self.session)
            if rec is None:
                return
            if isinstance(e, StageOOMError):
                reason = "oom"
            elif ("recovery did not converge" in str(e)
                  and isinstance(e, RuntimeError)):
                reason = "recovery_nonconvergent"
            else:
                reason = "fatal"
            rec.dump(reason, extra={
                "query_id": self.query_id,
                "plan": self.logical.tree_string()[:2000],
                "fault_summary": {
                    k: v for k, v in self.fault_summary.items()
                    if k != "events"},
            }, error=e)
        except Exception as dump_err:  # noqa: BLE001 — diagnostics only
            import warnings
            warnings.warn(f"flight-recorder trigger failed: {dump_err}")

    def _execute_recover(self) -> Batch:
        """Run `_execute_batch` under the failure taxonomy: each iteration
        returns, re-raises (FATAL, exhausted budgets, a cancel) or applies
        one recovery action and runs again. On a mesh that spans
        processes the whole ladder holds the cluster's run lock, so no
        other execution of this process makes collectives between a
        failed attempt and its recovery (a drain's re-execution, a gang
        restart)."""
        cl = self._cluster()
        if cl is None:
            return self._execute_ladder()
        with cl.run_lock:
            return self._execute_ladder()

    def _cluster(self):
        """This process's cluster when the conf meshes across processes
        (joined on first use), else None."""
        from ..parallel.cluster import cluster_spec, init
        from ..parallel.mesh import RENDEZVOUS_TIMEOUT_S, mesh_size
        if mesh_size(self._conf) > 1 and cluster_spec(self._conf):
            return init(self._conf, RENDEZVOUS_TIMEOUT_S)
        return None

    def _execute_ladder(self) -> Batch:
        from . import lifecycle
        last: Optional[str] = None
        for _ in range(MAX_RECOVERY_ACTIONS):
            # a cancel or deadline delivered mid-recovery stops here
            lifecycle.checkpoint("stage_attempt")
            try:
                return self._execute_batch()
            except _ReplanRequest:
                raise
            except Exception as e:  # noqa: BLE001 — classified below
                last = f"{type(e).__name__}: {str(e)[:300]}"
                self._handle_failure(e)  # raises when unrecoverable
            if self._free_device_memory:
                # outside the except block the failed attempt's frames
                # (and the tensors they held) are gone: free them before
                # the retry allocates
                self._free_device_memory = False
                import gc
                gc.collect()
                if torch.cuda.is_available():
                    torch.cuda.empty_cache()
        raise RuntimeError(
            f"stage failure recovery did not converge after "
            f"{MAX_RECOVERY_ACTIONS} recovery actions; "
            f"fault_summary={self.fault_summary}; last error: "
            + (last or "<none>"))

    def _mesh_pool(self):
        """Where this session's meshes live, as get_mesh takes it: (the
        pinned device or None, the pinned session's virtual pool)."""
        session = self.session
        if not session.device_pinned:
            return None, 0
        return session.device, session.mesh_pool

    def _handle_failure(self, e: Exception) -> None:
        """One step of the recovery ladder: returns after applying a
        recovery action (the caller runs again), raises when the failure
        is fatal or every applicable budget is spent."""
        import warnings
        from ..config import Conf
        from ..parallel import elastic as EL
        from .failures import is_mesh_failure
        from ..parallel.cluster import ClusterPeerLostError
        cls = classify(e)
        msg = f"{type(e).__name__}: {e}"
        if cls is FailureClass.CANCELLED:
            raise e  # lifecycle control outranks every rung
        if isinstance(e, ClusterPeerLostError):
            raise e  # a cluster that lost a process cannot re-form
        conf = self._conf
        mesh_on = int(conf.get("spark_tpu.sql.mesh.size")) > 1
        if mesh_on and isinstance(e, EL.MeshDecommissionRequest):
            # a planned drain, not a failure: exclude the draining ids
            # at session level (the drain outlives this query), clear the
            # request, and run again on the smaller gang, which resumes
            # from the checkpoint the drain forced
            warnings.warn(
                f"decommissioning mesh shard(s) {sorted(e.shards)} "
                f"(device ids {sorted(e.device_ids)}): draining at the "
                f"chunk boundary and continuing on the reduced gang")
            self._record_fault("decommission", None,
                               shards=sorted(e.shards),
                               devices=sorted(e.device_ids))
            EL.apply_decommission(self.session.conf, e.device_ids,
                                  *self._mesh_pool())
            self._recovery.begin_recovery_attempt()
            self._mesh_replan()  # the gang shrank: shapes differ
            return
        if mesh_on and not self._mesh_fallback and is_mesh_failure(e):
            # the mesh ladder: a gang restart first (the mesh stream
            # resumes at its checkpoint on the mesh), the one-device
            # fallback last; each rung has its own key
            healthy = EL.healthy_device_count(conf, *self._mesh_pool())
            # a pool of <= 1 cannot hold a gang: the fallback rung below
            # is that re-mesh
            restartable = healthy is None or healthy > 1
            slept = self._elastic.try_restart(self._record_fault) \
                if restartable else None
            if slept is not None:
                warnings.warn(
                    f"mesh stage failure, gang-restarting the mesh "
                    f"(attempt {self._elastic.restarts}/"
                    f"{self._elastic.max_restarts}, backoff "
                    f"{slept:.0f}ms): {msg[:160]}")
                self._record_fault("mesh_restart", e,
                                   attempt=self._elastic.restarts,
                                   backoff_ms=round(slept, 1))
                self.session.metrics.counter("mesh_restart_attempts").inc()
                self._recovery.begin_recovery_attempt()
                # a pool that lost devices shrinks the gang (shapes
                # change, so the memoized outputs go)
                n_conf = int(conf.get("spark_tpu.sql.mesh.size"))
                if healthy is not None and 1 < healthy < n_conf:
                    self._mesh_replan(mesh_size=healthy)
                return
            if bool(conf.get("spark_tpu.execution.meshFallback.enabled")):
                # the degrade rung: re-plan on one device (no exchanges,
                # no sharding), degraded but correct
                warnings.warn(f"mesh stage failure, re-planning "
                              f"single-device (mesh_fallback): "
                              f"{msg[:160]}")
                self._record_fault("mesh_fallback", e)
                self._mesh_fallback = True
                self._recovery.begin_recovery_attempt()
                self._mesh_replan(mesh_size=0)
                return
            # no degrade rung: the classification rungs below decide
        if cls in (FailureClass.TRANSIENT, FailureClass.TIMEOUT):
            self._retry_transient(e, cls)
            return
        if cls is FailureClass.OOM:
            self._oom_rung += 1
            conf = self._conf
            # release this query's arbiter leases before any degraded
            # retry: the estimates behind them were wrong, and the
            # retry's verdicts start from a clean slate (the shared pool
            # must not stay held by a query that just ran out)
            from ..service.arbiter import release_current
            release_current()
            if self._oom_rung == 1:
                # rung 1: evict the device table cache (the storage
                # pool) and the memo's device batches, then retry
                from ..io.device_cache import CACHE
                freed = CACHE.evict_bytes(CACHE.nbytes)
                warnings.warn(f"device memory exhausted: evicted the "
                              f"device cache ({freed} bytes) and "
                              f"retrying: {msg[:160]}")
                self._record_fault("oom_cache_evict", e, freed_bytes=freed)
                self._recovery.invalidate()
                self._recovery.begin_recovery_attempt()
                self._free_device_memory = True
                return
            if self._oom_rung == 2 and bool(conf.get(
                    "spark_tpu.execution.oom.spillOnExhausted")):
                # rung 2: re-plan under a 1-byte device budget, so the
                # chunked host-spill paths take over
                warnings.warn(f"device memory still exhausted: re-routing "
                              f"through the host-spill chunked path: "
                              f"{msg[:160]}")
                self._record_fault("oom_spill_reroute", e)
                self._recovery.invalidate()
                self._recovery.begin_recovery_attempt()
                overlay = Conf(parent=conf)
                overlay.set("spark_tpu.sql.memory.deviceBudget", 1)
                chunk = int(conf.get(
                    "spark_tpu.sql.execution.streamingChunkRows"))
                overlay.set("spark_tpu.sql.execution.streamingChunkRows",
                            min(chunk, 1 << 22))
                self._exec_conf = overlay
                self._executed = None
                self._free_device_memory = True
                return
            raise StageOOMError(self._oom_diagnostic(e)) from e
        raise e  # FATAL: surface unchanged

    def _mesh_replan(self, mesh_size: Optional[int] = None) -> None:
        """Reset for a rung that changes the mesh's shape: memoized stage
        outputs no longer splice, and the plan rebuilds under a
        mesh.size overlay when given."""
        from ..config import Conf
        self._recovery.invalidate()
        if mesh_size is not None:
            overlay = Conf(parent=self._conf)
            overlay.set("spark_tpu.sql.mesh.size", mesh_size)
            self._exec_conf = overlay
        self._executed = None

    def _retry_transient(self, e: Exception, cls: FailureClass) -> None:
        """The transient and stage-timeout rung: sleep a jittered backoff
        under the maxRetries budget and return (the caller runs again),
        or raise once the budget is spent."""
        import warnings
        msg = f"{type(e).__name__}: {e}"
        slept = self._retry_policy.attempt_retry()
        if slept is None:
            if cls is FailureClass.TIMEOUT:
                raise StageTimeoutError(
                    f"stage still over stageTimeoutMs after "
                    f"{self._retry_policy.attempts} retries: "
                    f"{msg[:200]}") from e
            raise e  # transient budget spent: the original error
        action = "stage_timeout" if cls is FailureClass.TIMEOUT \
            else "transient_retry"
        kind = "stage timeout" if cls is FailureClass.TIMEOUT \
            else "transient stage failure"
        warnings.warn(f"{kind}, retrying ({self._retry_policy.remaining}"
                      f" left, backoff {slept:.0f}ms): {msg[:160]}")
        self._record_fault(action, e, backoff_ms=round(slept, 1))
        # shapes unchanged: completed upstream stages replay from the
        # memo
        self._recovery.begin_recovery_attempt()

    def _oom_diagnostic(self, e: Exception) -> str:
        caps: Dict[str, int] = {}
        try:
            if self._executed is not None:
                caps = collect_caps(self._executed)
        except Exception:  # noqa: BLE001 — best-effort diagnostics only
            pass
        from ..io.device_cache import CACHE
        conf = self._conf
        stage = (self._executed.simple_string()
                 if self._executed is not None else "<unplanned>")[:400]
        device = self.session.device
        mem = "n/a (not a CUDA device)"
        if torch.device(device).type == "cuda":
            mem = (f"allocated {torch.cuda.memory_allocated(device):,} "
                   f"bytes, peak {torch.cuda.max_memory_allocated(device):,}"
                   f", reserved {torch.cuda.memory_reserved(device):,}")
        return (
            f"RESOURCE_EXHAUSTED survived the degradation ladder "
            f"(device-cache evict -> host-spill reroute): "
            f"{type(e).__name__}: {str(e)[:200]}\n"
            f"  stage: {stage}\n"
            f"  device memory: {mem}\n"
            f"  capacity stats (kind:tag -> rows): {caps or 'n/a'}\n"
            f"  deviceCacheBytes={CACHE.nbytes}, "
            f"deviceBudget={conf.get('spark_tpu.sql.memory.deviceBudget')}, "
            f"streamingChunkRows="
            f"{conf.get('spark_tpu.sql.execution.streamingChunkRows')}")

    # -- out-of-core splices ------------------------------------------------

    def _splice_stream(self, node: P.PhysicalPlan, tagged):
        """Splice one streamed-aggregate result into the plan. `tagged` is
        ("direct", Batch), ("mesh", per-shard partial batches or one
        Batch) or ("spill", (host partial table, partial node)) — the
        value the stage-output memo keeps, so a recovery re-execution
        rebuilds the splice without streaming again."""
        kind, result = tagged
        if kind == "direct":
            return P.InputExec(result, node.schema(), label="streamed_agg")
        if kind == "mesh":
            # each shard's partial rows stay on its device: the shards
            # get them as they are (load_shards)
            shards = result if isinstance(result, list) else None
            spliced = P.InputExec(None if shards else result,
                                  node.schema(),
                                  label="streamed_partial_agg",
                                  shards=shards)
            # the final aggregate above resolves its functions against
            # the pre-aggregation schema
            spliced._agg_base_schema = node._base_schema()
            return spliced
        # spilled partials re-reduce in a final aggregate (the partial ->
        # exchange -> final split of AggUtils.scala, host Arrow buffers in
        # the exchange's seat)
        from ..expr import ColumnRef
        partial_table, partial_node = result
        inp = P.InputExec(Batch.from_arrow(partial_table,
                                           self.session.device),
                          partial_node.schema(), label="spilled_partials")
        inp._agg_base_schema = node._base_schema()
        final_groups = [ColumnRef(g.name()) for g in node.group_exprs]
        final = P.HashAggregateExec(
            inp, final_groups, node.agg_exprs, mode="final",
            est_groups=bucket_capacity(max(partial_table.num_rows, 8)))
        final.tag = node.tag
        self.spilled_partial_rows = partial_table.num_rows
        return final

    def _materialize_streaming(self, node: P.PhysicalPlan,
                               mesh=None) -> P.PhysicalPlan:
        """Run the streamable aggregates chunk by chunk and splice their
        results in as InputExec leaves. Completed streams land in the
        stage-output memo: a re-execution after a downstream failure
        splices them again without streaming. On a mesh, partial
        aggregates stream per shard; after a mesh fallback, a
        single-device stream resumes from the failed mesh stream's
        checkpoint."""
        from .streaming_agg import (resume_from_mesh_checkpoint,
                                    stream_scan_aggregate_mesh,
                                    try_stream_aggregate,
                                    try_stream_aggregate_spill)
        rec = self._recovery
        device = self.session.device
        if mesh is None and isinstance(node, P.HashAggregateExec):
            memo_key = ("stream", id(node))
            hit = rec.memo_get(memo_key, label=node.simple_string())
            if hit is not None:
                return self._splice_stream(node, hit)
            if self._mesh_fallback:
                resumed = resume_from_mesh_checkpoint(node, self._conf,
                                                      device, rec)
                if resumed is not None:
                    rec.memo_put(memo_key, ("spill", resumed))
                    return self._splice_stream(node, ("spill", resumed))
            result = try_stream_aggregate(node, self._conf, device, rec)
            if result is not None:
                rec.memo_put(memo_key, ("direct", result))
                return self._splice_stream(node, ("direct", result))
            spill = try_stream_aggregate_spill(node, self._conf, device, rec)
            if spill is not None:
                rec.memo_put(memo_key, ("spill", spill))
                return self._splice_stream(node, ("spill", spill))
        if mesh is not None and isinstance(node, P.HashAggregateExec) \
                and node.mode == "partial":
            memo_key = ("stream_mesh", id(node))
            hit = rec.memo_get(memo_key, label=node.simple_string())
            if hit is not None:
                return self._splice_stream(node, hit)
            result = stream_scan_aggregate_mesh(node, mesh, self._conf,
                                                device, rec)
            if result is not None:
                rec.memo_put(memo_key, ("mesh", result))
                return self._splice_stream(node, ("mesh", result))
        new_children = tuple(self._materialize_streaming(c, mesh)
                             for c in node.children)
        if any(a is not b for a, b in zip(new_children, node.children)):
            import copy
            node = copy.copy(node)
            node.children = new_children
        return node

    def _materialize_generates(self, node: P.PhysicalPlan
                               ) -> P.PhysicalPlan:
        """Mesh runs: offsets-encoded list columns cannot shard (their
        offsets are absolute into the flattened values), so explode
        subtrees run on one device and the flat exploded result shards
        as an InputExec — the stage cut the reference makes at
        GenerateExec.scala:1, with the generate on one device."""
        new_children = tuple(self._materialize_generates(c)
                             for c in node.children)
        if any(a is not b for a, b in zip(new_children, node.children)):
            import copy
            node = copy.copy(node)
            node.children = new_children
        if isinstance(node, P.GenerateExec):
            from .streaming_agg import _materialize_subtree
            b = _materialize_subtree(node, self._conf, self.session.device,
                                     self._recovery)
            return P.InputExec(b, node.schema(), label="generated")
        return node

    def _aqe_cache_key(self, mesh=None) -> Optional[str]:
        """Plan and data identity of the capacities `session._aqe_caps`
        keeps (the JAX package's key, `#mesh{n}` included); None when a
        scan's source has no identity stamp."""
        tokens = [s.source.cache_token()
                  for s in L.iter_scans(self.optimized_plan)]
        if any(t is None for t in tokens):
            return None
        n = mesh.size if mesh is not None else 1
        return (self.optimized_plan.tree_string()
                + f"#mesh{n}#src{tokens!r}")

    def _run_mesh(self, root: P.PhysicalPlan, conf, mesh,
                  loaded: List[Dict[int, Batch]], t_att: float,
                  timeout_ms: int):
        """One attempt on the mesh: `run_plan` on every shard's thread
        (the JAX package's `run_shard`). Returns the output concatenated
        in shard order on the session's device, the flags reduced by sum
        and the metrics by `reduce_shard_metrics`, both on the host.

        On a mesh that spans processes this process runs its own shards;
        then every process agrees on every shard's flags and metrics (so
        the re-plan loop, the skew re-plan and the kept capacities decide
        alike everywhere) and on the stage-timeout verdict (an attempt
        over `timeout_ms` since `t_att` in any process fails it in
        every process), and gathers every shard's output, so that
        `collect()` in every process returns the whole result."""
        from ..parallel import AXIS, concat_batches, run_on_shards
        from ..parallel.shuffle import (batch_from_tree, batch_to_tree,
                                        stripe_batch)
        n = mesh.size
        # sorted/limited/global-aggregate results are replicated on every
        # shard; each shard emits its contiguous stripe so the shards'
        # outputs reassemble the full (ordered) result exactly once
        replicated_out = isinstance(root.output_partitioning(),
                                    (P.SinglePartition, P.Replicated))

        def shard(i, group):
            ctx = P.ExecContext(conf, mesh.devices[i], axis_name=AXIS,
                                n_shards=n, shard_index=i, group=group)
            out = run_plan(root, ctx, loaded=loaded[i])
            if replicated_out:
                out = stripe_batch(out, ctx)
            _sync_dispatched(stage_events(ctx.device), conf)
            return out, host_metrics(ctx.flags), host_metrics(ctx.metrics)

        results = run_on_shards(mesh, shard)
        local = mesh.local_positions
        if mesh.cluster is not None:
            cl = mesh.cluster
            att_ms = (time.perf_counter() - t_att) * 1e3
            late = att_ms if 0 < timeout_ms < att_ms else None
            per_rank = cl.all_gather_object(
                (late, timeout_ms,
                 [(results[i][1], results[i][2]) for i in local]), "agree")
            for rank, (ms, limit, _fm) in enumerate(per_rank):
                if ms is not None:
                    raise StageTimeoutError(
                        f"stage attempt took {ms:.0f}ms > "
                        f"stageTimeoutMs={limit} in process {rank}: "
                        f"{root.simple_string()}")
            host = [fm for _ms, _limit, per in per_rank for fm in per]
            trees = cl.merge("gather", "gather", [
                batch_to_tree(results[i][0]) for i in local],
                mesh.rank_positions, mesh.backend, mesh.local_devices[0])
            outs = [batch_from_tree(t) for t in trees]
        else:
            host = [(r[1], r[2]) for r in results]
            outs = [r[0] for r in results]
        self._shard_metrics = [m for _f, m in host]
        out = concat_batches(outs, self.session.device)
        flags: Dict[str, object] = {}
        for f, _m in host:
            for k, v in f.items():
                flags[k] = bool(flags.get(k, False)) or bool(v)
        return out, flags, reduce_shard_metrics([m for _f, m in host])

    def _maybe_skew_replan(self, root: P.PhysicalPlan, exch_tag: str,
                           metrics: Dict, mesh) -> bool:
        """On a skewed shuffle-join exchange (max bucket > factor x mean
        rows per bucket), force the join to broadcast and request a
        re-plan — the `OptimizeSkewedJoin.scala:56` /
        `DynamicJoinSelection` move, expressed as strategy re-selection.
        Returns True when an override was recorded."""
        conf = self._conf
        if self._no_more_replans:
            return False  # budget spent: capacity growth only
        if mesh is None or not bool(conf.get(
                "spark_tpu.sql.adaptive.skewJoin.enabled")):
            return False
        n = mesh.size
        factor = float(conf.get("spark_tpu.sql.adaptive.skewJoin.factor"))
        limit = int(conf.get(
            "spark_tpu.sql.adaptive.skewJoin.broadcastThreshold"))
        mx = int(metrics.get(f"exch_max_{exch_tag}", 0))
        rows = int(metrics.get(f"exch_rows_{exch_tag}", 0))
        # exch_max is the largest per-(src, dst) bucket; a uniform
        # spread puts rows/n^2 in each bucket
        if rows <= 0 or mx * n * n <= factor * rows:
            return False  # overflow without skew: capacity growth wins
        hit = []

        def walk(node, parent):
            for c in node.children:
                walk(c, node)
            if isinstance(node, P.ExchangeExec) and node.tag == exch_tag \
                    and isinstance(parent, P.JoinExec):
                hit.append(parent)

        walk(root, None)
        if not hit:
            return False
        join = hit[0]
        if join.strategy != "shuffle" or join.how in ("right", "full") \
                or join.tag in self._join_overrides:
            return False
        # measured build-side size: its own exchange's routed rows
        build = join.children[1]
        build_rows = None
        if isinstance(build, P.ExchangeExec):
            build_rows = metrics.get(f"exch_rows_{build.tag}")
        if build_rows is None:
            return False  # no measurement: keep capacity growth
        width = 8 * max(1, len(build.schema().fields))
        if int(build_rows) * width > limit:
            return False
        self._join_overrides[join.tag] = "broadcast"
        return True

    def _execute_batch(self) -> Batch:
        """One execution of the plan. On a mesh that spans processes
        the whole of it, from `get_mesh` to the last agreement, holds the
        cluster's run lock (one execution at a time of this process makes
        collectives, so they keep the order every peer keeps), and an
        error raised anywhere in it is broken to every process
        (`Cluster.abort`), which all raise the first error written and
        so take the same rung of the failure ladder."""
        from ..parallel.elastic import MeshDecommissionRequest
        cl = self._cluster()
        if cl is None:
            return self._execute_once(None)
        with cl.run_lock:
            cl.begin_attempt()
            try:
                return self._execute_once(cl)
            except (_ReplanRequest, MeshDecommissionRequest):
                # decided alike everywhere: from agreed metrics, or from
                # the drain request agreed at a chunk boundary
                raise
            except BaseException as e:
                agreed = cl.abort(e)
                if agreed is e:
                    raise
                raise agreed from e

    def _execute_once(self, cl) -> Batch:
        from ..parallel.mesh import get_mesh, pinned_pool_size
        from ..testing import faults
        from . import lifecycle
        conf = self._conf
        session = self.session
        # a session built with a device places every shard on it, over a
        # pool of virtual ids as large as the largest mesh it ran
        if session.device_pinned:
            session.mesh_pool = max(session.mesh_pool,
                                    pinned_pool_size(conf))
        mesh = get_mesh(conf, *self._mesh_pool())
        if mesh is not None:
            # a drain request no gang of this size can apply must not
            # stay armed for a later, larger mesh
            from ..parallel.elastic import discard_stale_decommission
            discard_stale_decommission(session.conf, mesh)
        root0 = self.executed_plan
        adaptive = bool(conf.get("spark_tpu.sql.adaptive.enabled"))
        # seed the capacities an earlier execution of this plan over the
        # same data converged on: repeated queries skip the re-plans
        with self.spans.span("caps_lookup"):
            aqe_key = self._aqe_cache_key(mesh)
            saved_caps = session._aqe_caps.get(aqe_key) \
                if aqe_key is not None else None
            if saved_caps:
                apply_saved_caps(root0, saved_caps)
        # static analysis: after planning (with the kept capacities
        # applied -- they are part of the key the recompile check
        # audits), before any UDF stage, stream, ingest or launch.
        # Strict mode raises here, with no device work done.
        self._analyze_plan_phase()
        # size/capacity predictions off the planned tree (a host walk),
        # graded after the run against the observed metrics
        try:
            from ..analysis.predictions import predict_plan
            with self.spans.span("predict"):
                self.plan_predictions = predict_plan(
                    root0, conf, mesh.size if mesh is not None else 1)
        except Exception as e:  # noqa: BLE001 — predictions are advisory
            import warnings
            warnings.warn(f"plan prediction walk failed (skipped): "
                          f"{type(e).__name__}: {e}")
            self.plan_predictions = None
        # UDF stages first: each UDF node's child runs, goes to the host,
        # and comes back with the UDF columns as an InputExec
        from .python_eval import extract_python_udfs, plan_has_udfs
        if plan_has_udfs(root0):
            with self.spans.span("python_udfs", phase="python_udfs"):
                root0 = extract_python_udfs(root0, conf, session.device,
                                            qe=self)
        if mesh is not None:
            root0 = self._materialize_generates(root0)
        self.spilled_partial_rows = None
        # the mesh stream finds its per-shard telemetry in the context
        from ..observability.spans import (ShardStreamTelemetry,
                                           use_shard_telemetry)
        telem = None
        if mesh is not None and (self._shard_obs_on()
                                 or mesh.cluster is not None):
            # on a cluster the stream's gate agrees whether it records:
            # any process's shardSpans setting turns it on in all
            telem = ShardStreamTelemetry(
                recorder=self.spans, mesh=mesh, query_id=self.query_id,
                bus=session.listeners)
            telem.active = self._shard_obs_on()
        # the streamable aggregates run chunk by chunk and splice in
        # (chunked ingest and the chunks' compute): the `streaming` span
        # and phase when any did (the range covers the walk either way)
        with self.spans.span("streaming", phase="streaming") as sp, \
                use_shard_telemetry(telem):
            root = self._materialize_streaming(root0, mesh)
            sp.keep = root is not root0
        self.spliced_plan = root
        # cooperative boundary before the scans load
        lifecycle.checkpoint("scan")
        with self.spans.span("ingest", phase="ingest") as sp:
            if mesh is None:
                loaded = load_scans(root, conf, session.device)
            else:
                loaded = load_shards(root, conf, mesh)
            session.result_cache_hits += self._cache_hits
            if self._cache_hits:
                # the JAX package's counter: a pooled session's hits land
                # in the service's shared registry
                session.metrics.counter("result_cache_hits").inc(
                    self._cache_hits)
            sp.attrs["scans"] = len(plan_nodes(root, P.ScanExec))
        # publish the findings on the bus before the first launch (the
        # seat of the JAX package's jaxpr phase, which the port has not)
        enabled, strict = self._analysis_conf()
        if enabled:
            self._post_analysis(strict)
        with self.spans.span("execution", phase="execution"):
            out, metrics = self._run_attempts(root, loaded, mesh, adaptive)
            with self.spans.span("readback"):
                self.last_metrics = host_metrics(metrics)
        if mesh is not None and self._shard_obs_on():
            # each exchange's per-shard rows and bytes become
            # transfer-phase records; they never enter last_metrics
            self._record_exchange_shards(self._shard_metrics or [], mesh)
        if self._mesh_fallback:
            # the degraded one-device result of a mesh-planned query
            self.last_metrics["mesh_fallback"] = 1
        # fill the data cache on the first action over a marked plan
        self._filled = None
        fp = session._plan_fingerprint(self.logical) \
            if session._cache_requests else None
        if fp in session._cache_requests and fp not in session._data_cache:
            with self.spans.span("egress", phase="egress"):
                self._filled = out.to_arrow()
        if cl is not None:
            # the last agreement: every process got past every point
            # where it could fail, so none keeps state below that a peer
            # that failed (and will retry) did not keep
            cl.all_gather_object(None, "done")
        with self.spans.span("caps_store"):
            if adaptive:
                shrink_caps_from_rtf(root, self.last_metrics,
                                     mesh.size if mesh is not None else 1)
            if aqe_key is not None:
                # harvest from the unspliced plan too (a streamed
                # aggregate's joins learned their capacities there);
                # merge, as the JAX package does, and bound the store
                converged = collect_caps(root0)
                converged.update(collect_caps(root))
                if converged:
                    store = session._aqe_caps
                    store.setdefault(aqe_key, {}).update(converged)
                    while len(store) > MAX_SAVED_PLANS:
                        store.pop(next(iter(store)))
        if self._filled is not None:
            session._data_cache[fp] = self._filled
        self._end_root = root
        return out

    def _run_attempts(self, root: P.PhysicalPlan, loaded, mesh,
                      adaptive: bool) -> Tuple[Batch, Dict[str, object]]:
        """The re-plan loop of one execution: run the plan (the
        `dispatch` span of each attempt), then grow the capacities that
        overflowed and run again, until nothing overflows. Returns the
        output and the last attempt's metrics (device tensors)."""
        from ..testing import faults
        from . import lifecycle
        conf = self._conf
        session = self.session
        timeout_ms = int(conf.get("spark_tpu.execution.stageTimeoutMs"))
        observe_cost = self._observe_cost()
        arg_bytes = self._loaded_bytes(loaded) if observe_cost else 0
        profile_dir = str(conf.get("spark_tpu.sql.profile.dir"))
        overflow: List[str] = []
        with self._profiler(profile_dir, mesh) as prof:
            for attempt in range(MAX_ATTEMPTS):
                with self.spans.span("dispatch", attempt=attempt):
                    t_att = time.perf_counter()
                    faults.fire("stage_run")  # fault seam: before each run
                    # the peak statistics are the card's: reset them
                    # before any shard thread starts
                    cost = AttemptCost(
                        mesh.local_devices if mesh is not None
                        else (session.device,)) if observe_cost else None
                    if mesh is None:
                        ctx = P.ExecContext(conf, session.device,
                                            spans=self.spans)
                        out = run_plan(root, ctx, loaded=loaded)
                        # the wait for the device is cancellable
                        # (dispatchPollMs)
                        _sync_dispatched(stage_events(ctx.device), conf)
                        flags = ctx.flags
                        metrics = ctx.metrics
                    else:
                        faults.fire("mesh")  # fault seam: each mesh run
                        out, flags, metrics = self._run_mesh(
                            root, conf, mesh, loaded, t_att, timeout_ms)
                with self.spans.span("stage_completed"):
                    key = self._stage_key(root, mesh) \
                        if cost is not None or self._observe_events \
                        else None
                    if cost is not None:
                        self._record_stage_cost(
                            key, cost.finish(arg_bytes, batch_bytes(out)))
                    # the deadline before the stage timeout: an attempt
                    # past the end-to-end budget stops the ladder, never
                    # retries
                    lifecycle.checkpoint("post_dispatch")
                    # (a cluster agreed its verdict inside _run_mesh)
                    if timeout_ms > 0 and (mesh is None
                                           or mesh.cluster is None):
                        att_ms = (time.perf_counter() - t_att) * 1e3
                        if att_ms > timeout_ms:
                            raise StageTimeoutError(
                                f"stage attempt took {att_ms:.0f}ms > "
                                f"stageTimeoutMs={timeout_ms}: "
                                f"{root.simple_string()}")
                    overflow = [k for k, v in flags.items()
                                if k.startswith(_REPLAN_FLAGS) and bool(v)]
                    self._post_stage_completed(key, attempt, t_att,
                                               metrics, overflow)
                if not overflow:
                    break
                self.spans.mark("aqe_overflow", flags=overflow[:8])
                with self.spans.span("grow_caps"):
                    # unique-build / hash-saturation fallbacks are
                    # correctness re-plans, not capacity growth — never
                    # gated by the conf
                    if not adaptive and any(
                            not k.startswith(("join_nonunique_",
                                              "join_hashsat_"))
                            for k in overflow):
                        raise RuntimeError(
                            f"capacity overflow in {overflow} with "
                            f"adaptive re-planning disabled "
                            f"(spark_tpu.sql.adaptive.enabled=false)")
                    metrics = host_metrics(metrics)
                    for k in overflow:
                        if k.startswith("exch_overflow_") and \
                                self._maybe_skew_replan(
                                    root, k[len("exch_overflow_"):],
                                    metrics, mesh):
                            raise _ReplanRequest()
                    apply_flags(root, overflow, metrics)
            else:
                raise RuntimeError(f"capacity retries did not converge; "
                                   f"still overflowing: {overflow}")
        if prof is not None:
            with self.spans.span("profile_export"):
                self._export_profile(prof, profile_dir)
        self.attempts = attempt + 1
        return out, metrics

    def collect(self) -> pa.Table:
        """The query's Arrow result: through the chunked host-egress path
        when the plan and the device budget call for it, else through
        execute_batch. One lifecycle scope spans both, so a cancel lands
        between chunks of either. One arbiter lease scope spans both
        too: residency granted at the external-collect gate stays leased
        while the resident execution uses it (execute_batch's scope
        nests onto this one)."""
        from ..service import arbiter as res_arbiter
        from . import lifecycle
        with self.spans.span("admit"):
            arb_token = res_arbiter.enter_query(
                f"{self.session.app_id}:q{self.query_id}",
                self.session.device)
            lc_scope = lifecycle.enter_query_scope(
                self.session.app_id, self.query_id, self.session.conf)
        try:
            try:
                ext = self._try_external_collect()
            except (lifecycle.QueryCancelledError,
                    lifecycle.QueryDeadlineError) as e:
                self._observe_cancel(e)
                raise
            if ext is not None:
                return ext
            self._end_deferred = True
            try:
                batch = self.execute_batch()
            finally:
                self._end_deferred = False
            if self._filled is not None:
                # already egressed into the data cache
                self._post_query_end(self._end_root)
                return self._filled
            try:
                with self.spans.span("egress", phase="egress"):
                    table = batch.to_arrow()
            except Exception as e:  # noqa: BLE001 — observe, then surface
                self._post_query_end(None, status="error", error=e)
                self._flightrec_dump(e)
                raise
            self._post_query_end(self._end_root)
            return table
        finally:
            lifecycle.exit_query_scope(lc_scope)
            res_arbiter.exit_query(arb_token)

    def _try_external_collect(self) -> Optional[pa.Table]:
        """Out-of-core host egress (`external.py`): ORDER BY / LIMIT /
        plain chains over a scan past the per-query deviceBudget, or
        denied a lease by the service's arbiter, stream chunk by chunk
        and spill to host Arrow. A transient fault that
        spends a chunk's retry budget restarts the whole stream through
        the ladder's transient rung (`_retry_transient`)."""
        from ..io.device_cache import out_of_core_active
        from .python_eval import plan_has_udfs
        conf = self.session.conf
        if not out_of_core_active(conf):
            return None
        self._activate_conf()
        if plan_has_udfs(self.executed_plan):
            return None  # UDF stages evaluate through execute_batch
        # the chunked egress never reaches execute_batch: its faults and
        # a cancel still post, as in the JAX package, and the analyzer
        # (which is where the host-spill findings live) runs and
        # strict-gates here too
        self._observe_events = self._events_enabled()
        self._analyze_plan_phase()
        self._post_analysis(self._analysis_conf()[1])
        self._begin_recovery()
        try:
            with self.spans.span("external") as sp:
                out = self._external_collect(conf)
                if out is not None:
                    sp.phase = "external"
        finally:
            self.stream_stats = self._recovery.chunk_stats
            self._recovery.release()
        return out

    def _external_collect(self, conf) -> Optional[pa.Table]:
        """`try_external_collect` under the transient rung's retries."""
        from .external import try_external_collect
        while True:
            try:
                return try_external_collect(
                    self.session, self.executed_plan, conf, self._recovery)
            except Exception as e:  # noqa: BLE001 — classified below
                cls = classify(e)
                if cls not in (FailureClass.TRANSIENT,
                               FailureClass.TIMEOUT):
                    raise
                self._retry_transient(e, cls)  # raises when spent

    # -- static analysis (analysis/) ----------------------------------------

    def _analysis_conf(self):
        conf = self._conf
        return (bool(conf.get("spark_tpu.sql.analysis.enabled")),
                bool(conf.get("spark_tpu.sql.analysis.strict")))

    def _post_analysis(self, strict: bool) -> None:
        """Publish the findings on the bus (once per QueryExecution) and
        raise under strict when any is error-severity."""
        from ..analysis import AnalysisFindingError, errors_of
        from ..observability.listener import AnalysisEvent
        findings = self.analysis_findings or []
        if findings and self._observe_events and not self._analysis_posted:
            self._analysis_posted = True
            self.session.listeners.post("on_analysis", AnalysisEvent(
                query_id=self.query_id, ts=time.time(),
                findings=[f.to_dict() for f in findings]))
        if strict and errors_of(findings):
            raise AnalysisFindingError(findings)

    def _analyze_plan_phase(self) -> None:
        """The plan walk over the planned tree (the `analyze` span),
        before any UDF stage, stream, ingest or launch, so strict mode
        rejects a hazardous plan with no device work done. It reads the
        plan, the Parquet footers and the kept capacities, never a
        tensor."""
        enabled, strict = self._analysis_conf()
        if not enabled:
            # None ("never analyzed"), not [] ("analyzed clean"):
            # explain(analysis=True) runs its on-demand walk off the
            # None sentinel. Lite-mode plan-integrity findings still
            # surface: validation ran regardless of the analyzer gate.
            self.executed_plan  # the optimizer (and validator) ran
            self.analysis_findings = \
                list(self._integrity_findings) or None
            if self.analysis_findings:
                self._post_analysis(strict=False)
            return
        from ..analysis import analyze_plan
        with self.spans.span("analyze") as sp:
            mesh_n = max(1, int(self._conf.get("spark_tpu.sql.mesh.size")))
            # lite-mode plan-integrity findings (collected while the
            # optimizer ran, triggered through executed_plan) join the
            # analyzer's in the same flow
            self.analysis_findings = analyze_plan(self.executed_plan,
                                                  self._conf, mesh_n) \
                + list(self._integrity_findings)
            sp.attrs["findings"] = len(self.analysis_findings)
        if strict:
            self._post_analysis(strict)

    # -- observability ------------------------------------------------------

    def _events_enabled(self) -> bool:
        """Whether lifecycle events are worth constructing at all: an
        observability output is configured, or a listener that is not
        built in is registered. With neither, posting would render plan
        strings and span dicts per query for subscribers that each
        check the conf and do nothing."""
        conf = self.session.conf
        if str(conf.get("spark_tpu.sql.eventLog.dir")) \
                or str(conf.get("spark_tpu.sql.trace.dir")) \
                or str(conf.get("spark_tpu.sql.metrics.sink")):
            return True
        return any(not getattr(li, "_builtin", False)
                   for li in self.session.listeners.listeners)

    def _shard_obs_on(self) -> bool:
        """Gate for per-shard telemetry (mesh runs only): 'on' always,
        'off' never, 'auto' whenever lifecycle events are observed."""
        mode = str(self._conf.get(
            "spark_tpu.sql.observability.shardSpans"))
        if mode == "off":
            return False
        if mode == "on":
            return True
        return self._observe_events

    def _observe_cost(self) -> bool:
        """Gate for the device-memory capture (`xlaCost`): 'on' always,
        'off' never, 'auto' only when an observability output is
        configured or the OOM ladder is descending."""
        mode = str(self._conf.get("spark_tpu.sql.observability.xlaCost"))
        if mode == "off":
            return False
        if mode == "on":
            return True
        conf = self.session.conf
        return bool(str(conf.get("spark_tpu.sql.eventLog.dir"))
                    or str(conf.get("spark_tpu.sql.trace.dir"))
                    or str(conf.get("spark_tpu.sql.metrics.sink"))
                    or self._oom_rung > 0)

    @staticmethod
    def _stage_key(root: P.PhysicalPlan, mesh) -> str:
        """The stage's identity: the spliced plan's structural
        fingerprint and the mesh's size (the JAX package keys its
        compiled stages on the same two)."""
        return root.describe() + (f"#mesh{mesh.size}" if mesh is not None
                                  else "")

    @staticmethod
    def _key_hash(key: str) -> str:
        import hashlib
        return hashlib.md5(key.encode()).hexdigest()[:10]

    @staticmethod
    def _loaded_bytes(loaded) -> int:
        """Bytes of the loaded leaves an attempt reads (every shard's
        stripes on a mesh); a batch shared by several leaves counts
        once."""
        maps = loaded if isinstance(loaded, list) else [loaded]
        seen, total = set(), 0
        for m in maps:
            for b in m.values():
                if id(b) not in seen:
                    seen.add(id(b))
                    total += batch_bytes(b)
        return total

    def _record_stage_cost(self, key: str, info: Dict) -> None:
        info["key_hash"] = self._key_hash(key)
        info["stage"] = key[:160]
        self.stage_costs[key] = info

    def _profiler(self, profile_dir: str, mesh):
        """A torch.profiler context over the attempts when
        `spark_tpu.sql.profile.dir` is set (CUDA activity too when the
        query runs on a card), else a context that yields None."""
        if not profile_dir:
            return contextlib.nullcontext()
        from torch.profiler import ProfilerActivity, profile
        devices = mesh.local_devices if mesh is not None \
            else (self.session.device,)
        activities = [ProfilerActivity.CPU]
        if any(torch.device(d).type == "cuda" for d in devices):
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities)

    def _export_profile(self, prof, profile_dir: str) -> None:
        """Write the attempts' profile as Chrome trace-event JSON, one
        file per execute (`torch-<app>-<query>-<ms>.trace.json`); a
        write failure warns."""
        path = os.path.join(
            profile_dir, f"torch-{self.session.app_id}-{self.query_id:05d}"
            f"-{int(time.time() * 1e3)}.trace.json")
        try:
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(path)
        except OSError as e:
            import warnings
            warnings.warn(f"profile trace write failed: {e}")

    def _record_exchange_shards(self, per_shard: List[Dict[str, object]],
                                mesh=None) -> None:
        """Each exchange's per-shard routed rows and bytes
        (`exch_rows_<tag>`/`exch_bytes_<tag>`, which `parallel/
        shuffle.py` counts on every shard) as transfer-phase records on
        the span recorder — the records the JAX package unpacks from its
        one-hot `shard_rows_`/`shard_bytes_` vectors. A shard's host is
        the rank of the process that drove it (`mesh.shard_hosts`)."""
        if not per_shard:
            return
        from ..parallel.mesh import shard_hosts
        hosts = shard_hosts(mesh) if mesh is not None \
            else [0] * len(per_shard)
        for k in per_shard[0]:
            if not k.startswith("exch_rows_"):
                continue
            tag = k[len("exch_rows_"):]
            self.spans.add_shard_records([{
                "shard": i, "host": hosts[i], "chunk": None,
                "phase": "transfer",
                "rows": int(m.get(k, 0)),
                "bytes": (int(m[f"exch_bytes_{tag}"])
                          if f"exch_bytes_{tag}" in m else None),
                "source": f"exchange:{tag}",
            } for i, m in enumerate(per_shard)])

    def _post_stage_completed(self, key: Optional[str], attempt: int,
                              t_att: float, metrics: Dict,
                              overflow: List[str]) -> None:
        if not self._observe_events:
            return
        from ..observability.listener import StageCompletedEvent
        self.session.listeners.post(
            "on_stage_completed", StageCompletedEvent(
                query_id=self.query_id, ts=time.time(), stage_key=key,
                key_hash=self._key_hash(key), attempt=attempt,
                elapsed_ms=round((time.perf_counter() - t_att) * 1e3, 2),
                metrics=host_metrics(metrics), overflow=list(overflow)))

    def _build_event(self, root: Optional[P.PhysicalPlan],
                     status: str = "ok", error=None) -> Dict:
        """The event-log record of this execution, in the JAX package's
        schema: one JSON-line serializable dict
        (`sinks.json_default` covers numpy and torch scalars)."""
        from ..observability.sinks import EVENT_LOG_SCHEMA_VERSION
        event = {
            "schema_version": EVENT_LOG_SCHEMA_VERSION,
            "query_id": self.query_id,
            "ts": time.time(),
            "status": status,
            "plan": root.describe() if root is not None else
            self.logical.tree_string(),
            "phase_times_s": {k: round(v, 4)
                              for k, v in self.phase_times.items()},
            "metrics": self.last_metrics,
        }
        if error is not None:
            event["error"] = f"{type(error).__name__}: {error}"[:300]
        if root is not None:
            try:
                # runtime-annotated physical tree (rows/caps notes)
                event["plan_tree"] = self._runtime_tree(root)
            except Exception:  # noqa: BLE001 — annotation is best-effort
                pass
        if self.spans.spans:
            event["spans"] = self.spans.to_dicts()
            if self.spans.dropped:
                event["spans_dropped"] = self.spans.dropped
        if self.spans.shard_records:
            # per-shard records (schema v3): the exchanges' transfer
            # rows and bytes
            event["shards"] = list(self.spans.shard_records)
            if self.spans.shard_dropped:
                event["shards_dropped"] = self.spans.shard_dropped
        if self.plan_predictions:
            # planner/adaptive size predictions, graded after the fact
            # against the metrics in this same record
            # (history.prediction_report)
            event["predictions"] = list(self.plan_predictions)
        if self.reorder_decisions is not None:
            event["reorder"] = {
                "enabled": bool(self.session.conf.get(
                    "spark_tpu.sql.cbo.joinReorder")),
                "changed": any(d.get("changed")
                               for d in self.reorder_decisions),
                "regions": list(self.reorder_decisions)}
        if self.rule_trace:
            # per-(batch, rule) optimizer records (schema v7)
            event["rule_trace"] = [dict(r) for r in self.rule_trace]
        if self.stage_costs:
            # per-stage device-memory records (history.hbm_summary /
            # compile_summary read these)
            event["stages"] = list(self.stage_costs.values())
            cap = device_hbm_capacity(self.session.device)
            if cap is not None:
                event["device_hbm_capacity_bytes"] = cap
        if self.analysis_findings:
            # static-analyzer findings (history.read_event_log reads
            # them back)
            event["analysis_findings"] = [
                f.to_dict() for f in self.analysis_findings]
        if self.udf_summary:
            # python-UDF lane record (schema v5)
            event["udf"] = dict(self.udf_summary)
        if self.fault_summary:
            # every retry/eviction/degradation/fallback this execution
            # survived (history.fault_summary reads these)
            event["fault_summary"] = dict(
                self.fault_summary,
                retry_backoff_ms=round(
                    self._retry_policy.total_sleep_ms, 1)
                if self._retry_policy is not None else 0.0,
                events=self.fault_events)
        return event

    def _post_query_end(self, root: Optional[P.PhysicalPlan],
                        status: str = "ok", error=None) -> None:
        """Build the event and post `on_query_end` (the JSONL writer,
        the Chrome-trace writer, the metrics sinks and the flight
        recorder are subscribers; replay with
        `spark_tpu_torch.history.read_event_log`). A failing build
        warns: observability never fails the query."""
        if not self._observe_events:
            return
        from ..observability.listener import QueryEndEvent
        try:
            with self.spans.span("end_event"):
                event = self._build_event(root, status, error)
        except Exception as e:  # noqa: BLE001 — observability only
            import warnings
            warnings.warn(f"event build failed: {e}")
            return
        self.session.listeners.post("on_query_end", QueryEndEvent(
            query_id=self.query_id, ts=event["ts"], status=status,
            event=event, spans=self.spans))
