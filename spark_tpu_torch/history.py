"""Event-log replay: the HistoryServer analog, sized to this engine
(the port's own copy of `spark_tpu/history.py`: the port imports nothing
of the JAX package; both read either package's logs).

The reference persists a typed event stream (`EventLoggingListener.scala`)
and rebuilds UI state by replay (`HistoryServer.scala:50` +
`ReplayListenerBus`). Here each query execution appends one JSON line
(plan fingerprint, phase timings, per-operator metrics) and replay is a
DataFrame over those lines — queryable with the engine itself or pandas.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import List, Optional, Tuple

import pandas as pd

#: basename shape of event-log files: app-<stem>.jsonl (live) and
#: app-<stem>.<N>.jsonl (rolled by eventLog.maxBytes)
_LOG_NAME = re.compile(r"^app-(?P<stem>.+?)(?:\.(?P<n>\d+))?\.jsonl$")


def _log_paths(log_dir: str, app: Optional[str],
               rank: Optional[int] = None) -> List[str]:
    """Event-log files in replay order: per app stem, rolled files in
    roll-index order, the live (unsuffixed) file last — so a rotated
    log replays its lines in write order. `rank` keeps the files one
    engine process of a cluster wrote (stems ending `-r<rank>`)."""
    entries: List[Tuple[str, int, str]] = []
    for path in glob.glob(os.path.join(log_dir, "app-*.jsonl")):
        m = _LOG_NAME.match(os.path.basename(path))
        if m is None:
            continue
        stem, n = m.group("stem"), m.group("n")
        if app is not None and stem != app:
            continue
        if rank is not None and not stem.endswith(f"-r{rank}"):
            continue
        # live file sorts after every rolled index
        entries.append((stem, int(n) if n is not None else 1 << 62, path))
    return [p for _, _, p in sorted(entries)]


#: event fields kept nested (object columns) rather than flattened
_NESTED = ("spans", "stages", "shards", "predictions",
           "analysis_findings", "plan_tree", "reorder", "streaming",
           "udf", "trigger", "rule_trace")


def read_event_log(log_dir: str, app: Optional[str] = None,
                   rank: Optional[int] = None) -> pd.DataFrame:
    """All logged query executions as a flat DataFrame (one row per
    execution: ts, plan, status, per-phase seconds, metric columns,
    plus nested `spans`/`stages` object columns when logged). `rank`
    reads one cluster process's files."""
    rows: List[dict] = []
    for path in _log_paths(log_dir, app, rank):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                e = json.loads(line)
                row = {"ts": e.get("ts"), "plan": e.get("plan"),
                       "app": os.path.basename(path)}
                for k in ("query_id", "status", "schema_version",
                          "device_hbm_capacity_bytes", "error"):
                    if k in e:
                        row[k] = e[k]
                for k in _NESTED:
                    if k in e:
                        row[k] = e[k]
                for k, v in (e.get("phase_times_s") or {}).items():
                    row[f"phase_{k}_s"] = v
                for k, v in (e.get("metrics") or {}).items():
                    row[k] = v
                for k, v in (e.get("fault_summary") or {}).items():
                    # recovery counters flatten to fault_* columns; the
                    # per-event record list stays nested
                    row[f"fault_{k}"] = v
                rows.append(row)
    return pd.DataFrame(rows)


#: recovery-action counters an execution's fault_summary may carry
#: (executor._record_fault actions + the aggregate backoff total).
#: chunk_retry / stage_reuse / checkpoint_restore are the
#: partial-progress actions (execution/recovery.py); mesh_restart /
#: decommission / shard_rebalance are the elastic-mesh actions
#: (parallel/elastic.py); cancel marks a query stopped by lifecycle
#: control — cancellation or a blown queryDeadlineMs
#: (execution/lifecycle.py).
FAULT_ACTIONS = ("transient_retry", "stage_timeout", "oom_cache_evict",
                 "oom_spill_reroute", "mesh_fallback", "chunk_retry",
                 "stage_reuse", "checkpoint_restore", "mesh_restart",
                 "decommission", "shard_rebalance", "cancel")


def fault_summary(events: pd.DataFrame) -> pd.DataFrame:
    """Per-execution failure-recovery summary from a read_event_log
    frame: one row per execution that survived at least one fault, with
    the count of each recovery action (retries, cache evictions, spill
    reroutes, mesh fallbacks, stage timeouts), the total backoff slept,
    and the bounded per-fault event records — the observability surface
    of the degradation ladder (execution/failures.py)."""
    rows: List[dict] = []
    cols = [c for c in events.columns if c.startswith("fault_")]
    if not cols:
        return pd.DataFrame(rows)

    def present(v) -> bool:
        if isinstance(v, (list, dict)):
            return True  # nested event records (pd.isna chokes on lists)
        return not pd.isna(v)

    for _, r in events.iterrows():
        acted = {c: r.get(c) for c in cols if present(r.get(c))}
        if not any(c != "fault_events" for c in acted):
            continue
        row = {"ts": r.get("ts"), "app": r.get("app")}
        for a in FAULT_ACTIONS:
            v = acted.get(f"fault_{a}")
            row[a] = 0 if v is None else int(v)
        bk = acted.get("fault_retry_backoff_ms")
        row["retry_backoff_ms"] = 0.0 if bk is None else float(bk)
        # events past the executor's 32-record cap are dropped from the
        # nested list but COUNTED — nonzero means `events` is truncated
        ed = acted.get("fault_events_dropped")
        row["events_dropped"] = 0 if ed is None else int(ed)
        row["events"] = acted.get("fault_events") or []
        rows.append(row)
    return pd.DataFrame(rows)


def stage_summary(events: pd.DataFrame) -> pd.DataFrame:
    """Per-(execution, span) lifecycle timing from a read_event_log
    frame: one row per recorded span (analysis/optimize/plan/compile/
    ingest/dispatch/retries), with start offset and duration — the
    stage-timeline view of the SQL UI, as a DataFrame."""
    rows: List[dict] = []
    if "spans" not in events.columns:
        return pd.DataFrame(rows)
    for _, r in events.iterrows():
        spans = r.get("spans")
        if not isinstance(spans, list):
            continue
        for s in spans:
            rows.append({"ts": r.get("ts"), "app": r.get("app"),
                         "query_id": r.get("query_id"),
                         "span": s.get("name"),
                         "t0_ms": s.get("t0_ms"),
                         "dur_ms": s.get("dur_ms"),
                         "attrs": s.get("attrs") or {}})
    return pd.DataFrame(rows)


def compile_summary(events: pd.DataFrame) -> pd.DataFrame:
    """Per-(execution, compiled stage) XLA cost accounting: flops,
    bytes accessed, argument/output/temp sizes, peak HBM demand and
    the analysis-compile cost — from the `stages` records the executor
    captures via cost_analysis()/memory_analysis()."""
    rows: List[dict] = []
    if "stages" not in events.columns:
        return pd.DataFrame(rows)
    for _, r in events.iterrows():
        stages = r.get("stages")
        if not isinstance(stages, list):
            continue
        for s in stages:
            rows.append({"ts": r.get("ts"), "app": r.get("app"),
                         "query_id": r.get("query_id"),
                         "stage": s.get("key_hash"),
                         "flops": s.get("flops"),
                         "bytes_accessed": s.get("bytes_accessed"),
                         "argument_bytes": s.get("argument_bytes"),
                         "output_bytes": s.get("output_bytes"),
                         "temp_bytes": s.get("temp_bytes"),
                         "peak_hbm_bytes": s.get("peak_hbm_bytes"),
                         "analysis_ms": s.get("analysis_ms")})
    return pd.DataFrame(rows)


def hbm_summary(events: pd.DataFrame) -> pd.DataFrame:
    """Per-execution HBM headroom: the max per-stage peak demand
    (memory_analysis) against the device capacity when known — the
    'how close was this query to RESOURCE_EXHAUSTED' view the OOM
    ladder is tuned from."""
    rows: List[dict] = []
    if "stages" not in events.columns:
        return pd.DataFrame(rows)
    for _, r in events.iterrows():
        stages = r.get("stages")
        if not isinstance(stages, list):
            continue
        peaks = [s.get("peak_hbm_bytes") for s in stages
                 if s.get("peak_hbm_bytes") is not None]
        if not peaks:
            continue
        peak = max(peaks)
        worst = next(s for s in stages
                     if s.get("peak_hbm_bytes") == peak)
        cap = r.get("device_hbm_capacity_bytes")
        cap = None if pd.isna(cap) else int(cap)
        rows.append({"ts": r.get("ts"), "app": r.get("app"),
                     "query_id": r.get("query_id"),
                     "plan": r.get("plan"),
                     "n_stages": len(stages),
                     "peak_hbm_bytes": int(peak),
                     "peak_stage": worst.get("key_hash"),
                     "argument_bytes": worst.get("argument_bytes"),
                     "temp_bytes": worst.get("temp_bytes"),
                     "output_bytes": worst.get("output_bytes"),
                     "capacity_bytes": cap,
                     "headroom_ratio": (round(peak / cap, 4)
                                        if cap else None)})
    return pd.DataFrame(rows)


def streaming_summary(events: pd.DataFrame) -> pd.DataFrame:
    """Per-micro-batch lifecycle from a read_event_log frame: one row
    per `streaming` record (schema v4) — batch id, offset range, rows
    in/out, state persistence kind (delta vs snapshot) and bytes,
    changed groups, quarantined files, sink parts and wall time — and
    one row per `trigger` record (schema v6, record='trigger') — tick
    id, wall-clock skew, batches run, supervisor restarts and
    reconnects. The replay surface of the durable-streaming tier
    (streaming.py + execution/state_store.py); the incremental-
    checkpointing claim (steady-state delta bytes << snapshot bytes)
    and the unattended-operation story (reconnects, restarts, skew)
    are both checkable straight off this frame."""
    rows: List[dict] = []
    for _, r in events.iterrows():
        s = r.get("streaming") \
            if "streaming" in events.columns else None
        if isinstance(s, dict):
            rows.append({"ts": r.get("ts"), "app": r.get("app"),
                         "query_id": r.get("query_id"),
                         "record": "batch",
                         "batch_id": s.get("batch_id"),
                         "start": s.get("start"), "end": s.get("end"),
                         "rows_in": s.get("rows_in"),
                         "rows_out": s.get("rows_out"),
                         "kind": s.get("kind"),
                         "state_bytes": s.get("state_bytes"),
                         "changed_groups": s.get("changed_groups"),
                         "quarantined": s.get("quarantined"),
                         "sink_parts": s.get("sink_parts"),
                         "source": s.get("source"),
                         "wall_ms": s.get("wall_ms")})
        t = r.get("trigger") if "trigger" in events.columns else None
        if isinstance(t, dict):
            rows.append({"ts": r.get("ts"), "app": r.get("app"),
                         "query_id": r.get("query_id"),
                         "record": "trigger",
                         "tick": t.get("tick"),
                         "skew_ms": t.get("skew_ms"),
                         "batches_run": t.get("batches_run"),
                         "restarts": t.get("restarts"),
                         "reconnects": t.get("reconnects"),
                         "source": t.get("source")})
    return pd.DataFrame(rows)


def shard_summary(events: pd.DataFrame) -> pd.DataFrame:
    """Per-(execution, shard, chunk) telemetry from a read_event_log
    frame: one row per flight-recorder record (schema v3 `shards`) —
    shard id, host, chunk index, phase (ingest/compute/transfer),
    rows, bytes, dispatch duration and the per-shard completion wait.
    The per-shard stage-timeline view the elastic-mesh rebalancer (and
    straggler_report below) consumes."""
    rows: List[dict] = []
    if "shards" not in events.columns:
        return pd.DataFrame(rows)
    for _, r in events.iterrows():
        recs = r.get("shards")
        if not isinstance(recs, list):
            continue
        for s in recs:
            rows.append({"ts": r.get("ts"), "app": r.get("app"),
                         "query_id": r.get("query_id"),
                         "shard": s.get("shard"), "host": s.get("host"),
                         "chunk": s.get("chunk"), "phase": s.get("phase"),
                         "source": s.get("source"),
                         "rows": s.get("rows"), "bytes": s.get("bytes"),
                         "dur_ms": s.get("dur_ms"),
                         "wait_ms": s.get("wait_ms")})
    return pd.DataFrame(rows)


def straggler_report(events: pd.DataFrame, factor: Optional[float] = None,
                     min_chunks: Optional[int] = None,
                     min_latency_ms: Optional[float] = None
                     ) -> pd.DataFrame:
    """Offline straggler detection over a replayed event log: the live
    StragglerMonitor's detection math (rolling-WINDOW medians per
    shard, baseline = median of qualified shards' medians, factor
    threshold over the minLatencyMs floor) applied to the logged
    per-shard compute waits — one row per (execution, shard).

    Caveat vs the live verdict: thresholds default to the conf
    REGISTRY values — a logged session's runtime overrides are not in
    the log, so pass the session's factor/minChunks/minLatencyMs
    explicitly to reproduce its live verdicts. Shards with fewer than
    min_chunks samples are reported but excluded from the baseline and
    never flagged (the live monitor's `ready` gate — the detection
    rule itself is the SHARED `evaluate_waits`, so the two
    implementations cannot drift)."""
    from .config import Conf
    from .observability.straggler import WINDOW, evaluate_waits
    conf = Conf()
    factor = float(conf.get("spark_tpu.sql.straggler.factor")) \
        if factor is None else float(factor)
    min_chunks = int(conf.get("spark_tpu.sql.straggler.minChunks")) \
        if min_chunks is None else int(min_chunks)
    floor_ms = float(conf.get("spark_tpu.sql.straggler.minLatencyMs")) \
        if min_latency_ms is None else float(min_latency_ms)
    shards = shard_summary(events)
    rows: List[dict] = []
    if shards.empty:
        return pd.DataFrame(rows)
    compute = shards[(shards["phase"] == "compute")
                     & shards["shard"].notna()]
    for (app, qid), grp in compute.groupby(["app", "query_id"],
                                           dropna=False):
        per_shard = {}
        hosts = {}
        for shard, g in grp.groupby("shard"):
            # the live monitor's rolling window: the LAST
            # max(WINDOW, min_chunks) waits in chunk order, so long
            # streams judge recent behavior, not ancient warmup chunks
            # (and a large min_chunks widens the window rather than
            # making the ready gate unsatisfiable)
            g = g.sort_values("chunk")
            waits = [float(w) for w in g["wait_ms"]
                     if not pd.isna(w)][-max(WINDOW, min_chunks):]
            if not waits:
                continue
            per_shard[int(shard)] = waits
            hosts[int(shard)] = g["host"].iloc[0]
        medians, baseline, flag_now = evaluate_waits(
            per_shard, factor, min_chunks, floor_ms)
        for shard, med in sorted(medians.items()):
            rows.append({
                "app": app, "query_id": qid, "shard": shard,
                "host": hosts.get(shard),
                "chunks": len(per_shard[shard]),
                "median_wait_ms": round(med, 3),
                "baseline_ms": (round(baseline, 3)
                                if baseline is not None else None),
                "ratio": (round(med / baseline, 3)
                          if baseline else None),
                "flagged": shard in flag_now})
    return pd.DataFrame(rows)


#: prediction kind -> observed traced-metric column pattern
_PRED_OBSERVED = {"exch_rows": "exch_rows_{tag}",
                  "exch_bytes": "exch_bytes_{tag}",
                  "join_rows": "join_rows_{tag}",
                  "agg_groups": "agg_groups_{tag}",
                  # worker-lane UDF traffic: untagged counters, so the
                  # pattern is the metric name itself (schema v5 also
                  # mirrors them in the nested `udf` record)
                  "udf_rows": "udf_rows",
                  "udf_batches": "udf_batches"}


def grade_predictions(predictions, metrics) -> List[dict]:
    """Grade plan-time size predictions (analysis/predictions.py)
    against one execution's observed metrics dict. hit = the bound
    held without gross waste (obs <= pred <= 4*obs); under = the
    prediction was exceeded (an AQE overflow / undersized filter);
    over = more than 4x slack (wasted capacity/HBM). Shared by
    history.prediction_report (event-log replay) and the bench
    `tpch_*_pred_err_pct` sidecar (live qe)."""
    out: List[dict] = []
    for p in predictions or []:
        kind, tag = p.get("kind"), p.get("tag")
        pattern = _PRED_OBSERVED.get(kind)
        if pattern is None or tag is None:
            continue
        obs = metrics.get(pattern.format(tag=tag))
        if obs is None:
            continue
        try:
            obs = float(obs)
            pred = float(p.get("predicted"))
        except (TypeError, ValueError):
            continue
        if obs <= 0:
            grade = "hit" if pred <= 8 else "over"
            err = None
        else:
            err = round((pred - obs) / obs * 100.0, 1)
            grade = ("under" if pred < obs
                     else "hit" if pred <= 4 * obs else "over")
        out.append({"kind": kind, "tag": tag, "basis": p.get("basis"),
                    "predicted": int(pred), "observed": int(obs),
                    "err_pct": err, "grade": grade})
    return out


#: finding codes whose detail carries a byte/row bound gradeable
#: against observables: code -> (detail key, what it bounds)
_FINDING_BOUNDS = {
    "MESH_FULL_REPLICATION": ("replicated_bytes_bound", "exch_bytes"),
    "MESH_GATHER_RESULT": ("replicated_bytes_bound", "exch_bytes"),
    "JOIN_HASH_TABLE_PRESSURE": ("table_bytes", "peak_hbm"),
    "SPILL_HOST_SYNC": ("estimated_bytes", "peak_hbm"),
}


def prediction_report(events: pd.DataFrame) -> pd.DataFrame:
    """Analyzer/planner self-grading over a replayed event log: every
    logged prediction joined against the observed metric of the same
    tag, plus analyzer findings whose details carry byte bounds graded
    against observed exchange bytes and stage peak-HBM. One row per
    graded prediction with hit/over/under and signed error percent."""
    rows: List[dict] = []
    metric_skip = ("ts", "plan", "app", "query_id", "status",
                   "schema_version")
    for _, r in events.iterrows():
        metrics = {c: r[c] for c in events.columns
                   if c not in metric_skip and c not in _NESTED
                   and not isinstance(r[c], (list, dict))
                   and pd.notna(r[c])}
        u = r.get("udf") if "udf" in events.columns else None
        if isinstance(u, dict):
            # the nested `udf` record (schema v5) carries the same
            # totals as the udf_* counters; merge them in (counters
            # win) so udf_batches/udf_rows predictions grade even on
            # logs where the metrics channel was trimmed
            for rec_key, col in (("batches", "udf_batches"),
                                 ("rows", "udf_rows")):
                v = u.get(rec_key)
                if v is not None and col not in metrics:
                    metrics[col] = v
        base = {"ts": r.get("ts"), "app": r.get("app"),
                "query_id": r.get("query_id")}
        preds = r.get("predictions") if "predictions" in events.columns \
            else None
        if isinstance(preds, list):
            for g in grade_predictions(preds, metrics):
                rows.append(dict(base, **g))
        finds = r.get("analysis_findings") \
            if "analysis_findings" in events.columns else None
        stages = r.get("stages") if "stages" in events.columns else None
        peak = None
        if isinstance(stages, list):
            peaks = [s.get("peak_hbm_bytes") for s in stages
                     if s.get("peak_hbm_bytes") is not None]
            peak = max(peaks) if peaks else None
        if isinstance(finds, list):
            for f in finds:
                rows.extend(_grade_finding(f, metrics, peak, base))
    return pd.DataFrame(rows)


def rule_report(events: pd.DataFrame) -> pd.DataFrame:
    """Optimizer-rule activity over a replayed event log (schema v7
    `rule_trace`): one row per (execution, batch, rule) that was
    INVOKED, with invocation/effective counts, total rule ms, and the
    execution's PLAN_INTEGRITY finding count — the replay surface for
    'which rewrites actually fire, how often, at what cost, and did
    the verifier ever object'."""
    rows: List[dict] = []
    if "rule_trace" not in events.columns:
        return pd.DataFrame(rows)
    for _, r in events.iterrows():
        trace = r.get("rule_trace")
        if not isinstance(trace, list):
            continue
        finds = r.get("analysis_findings") \
            if "analysis_findings" in events.columns else None
        integrity = sum(1 for f in finds or []
                        if isinstance(f, dict)
                        and f.get("code") == "PLAN_INTEGRITY") \
            if isinstance(finds, list) else 0
        base = {"ts": r.get("ts"), "app": r.get("app"),
                "query_id": r.get("query_id"),
                "integrity_findings": integrity}
        for rec in trace:
            if not isinstance(rec, dict):
                continue
            rows.append(dict(
                base, batch=rec.get("batch"), rule=rec.get("rule"),
                invocations=rec.get("invocations"),
                effective=rec.get("effective"), ms=rec.get("ms"),
                traced_diff="diff" in rec))
    return pd.DataFrame(rows)


def _grade_finding(f: dict, metrics: dict, peak_hbm, base: dict
                   ) -> List[dict]:
    spec = _FINDING_BOUNDS.get(f.get("code"))
    if spec is None:
        return []
    key, target = spec
    pred = (f.get("detail") or {}).get(key)
    if pred is None:
        return []
    if target == "peak_hbm":
        obs = peak_hbm
        tag = f.get("op")
    else:
        # op is "ExchangeExec[e1]" — observed metric keys on the tag
        op = str(f.get("op") or "")
        tag = op[op.find("[") + 1:op.rfind("]")] \
            if "[" in op and "]" in op else None
        obs = metrics.get(f"exch_bytes_{tag}") if tag else None
    if obs is None:
        return []
    obs, pred = float(obs), float(pred)
    err = round((pred - obs) / obs * 100.0, 1) if obs > 0 else None
    # findings state upper BOUNDS: holding (obs <= pred) is a hit even
    # with slack; an exceeded bound is the miss that matters
    grade = "under" if pred < obs else "hit"
    return [dict(base, kind=f"finding:{f.get('code')}", tag=tag,
                 basis=key, predicted=int(pred), observed=int(obs),
                 err_pct=err, grade=grade)]


def compare_runs(base: pd.DataFrame, other: pd.DataFrame,
                 on: str = "plan") -> pd.DataFrame:
    """Compare two read_event_log frames (e.g. two BENCH rounds, or
    before/after a conf change): for each key present in both, the
    LAST execution's numeric columns side by side with delta and
    ratio. The regression-hunting view of the replay store."""
    rows: List[dict] = []
    if base.empty or other.empty or on not in base.columns \
            or on not in other.columns:
        return pd.DataFrame(rows)
    # whole last ROW per key — groupby().last() would take the last
    # NON-NULL per column, splicing values from different executions
    b_last = base.drop_duplicates(subset=[on], keep="last").set_index(on)
    o_last = other.drop_duplicates(subset=[on], keep="last").set_index(on)
    numeric = [c for c in b_last.columns
               if c in o_last.columns
               and pd.api.types.is_numeric_dtype(b_last[c])
               and pd.api.types.is_numeric_dtype(o_last[c])]
    for key in b_last.index.intersection(o_last.index):
        for c in numeric:
            bv, ov = b_last.at[key, c], o_last.at[key, c]
            if pd.isna(bv) and pd.isna(ov):
                continue
            rows.append({
                on: key, "column": c,
                "base": None if pd.isna(bv) else float(bv),
                "other": None if pd.isna(ov) else float(ov),
                "delta": (None if pd.isna(bv) or pd.isna(ov)
                          else float(ov) - float(bv)),
                "ratio": (None if pd.isna(bv) or pd.isna(ov) or not bv
                          else round(float(ov) / float(bv), 4))})
    return pd.DataFrame(rows)


def runtime_filter_summary(events: pd.DataFrame) -> pd.DataFrame:
    """Per-(execution, filter) runtime-filter pruning summary from a
    read_event_log frame: tag, rows tested, rows pruned, pruning ratio
    and the trace-time build cost — the observability surface of the
    runtime-filter subsystem (rtf_* metrics emitted by
    RuntimeFilterExec)."""
    rows: List[dict] = []
    tested_cols = [c for c in events.columns
                   if c.startswith("rtf_tested_")]
    for _, r in events.iterrows():
        for c in tested_cols:
            tag = c[len("rtf_tested_"):]
            tested = r.get(c)
            if pd.isna(tested):
                continue
            pruned = r.get(f"rtf_pruned_{tag}")
            rows.append({
                "ts": r.get("ts"),
                "app": r.get("app"),
                "tag": tag,
                "tested": int(tested),
                "pruned": None if pd.isna(pruned) else int(pruned),
                # None (not 0.0) when the pruned metric is absent:
                # "unknown" must not read as "pruned nothing"
                "ratio": (float(pruned) / float(tested)
                          if not pd.isna(pruned) and tested else None),
                "build_ms": r.get(f"rtf_build_ms_{tag}"),
            })
    return pd.DataFrame(rows)


def status_summary(events: pd.DataFrame) -> pd.DataFrame:
    """Offline replay of the live status store: the per-app health
    view `GET /status` serves, rebuilt from a read_event_log frame —
    one row per app with per-status outcome counts, cumulative
    per-phase seconds, and end-to-end latency percentiles (sum of the
    phase_*_s columns per execution, in ms). Rows with no phase data
    (streaming/trigger lines) are excluded: they are lifecycle
    records, not query executions."""
    rows: List[dict] = []
    phase_cols = [c for c in events.columns
                  if c.startswith("phase_") and c.endswith("_s")]
    if not phase_cols or "app" not in events.columns:
        return pd.DataFrame(rows)
    execs = events[events[phase_cols].notna().any(axis=1)].copy()
    if execs.empty:
        return pd.DataFrame(rows)
    execs["e2e_ms"] = execs[phase_cols].sum(axis=1,
                                            skipna=True) * 1e3
    for app, grp in execs.groupby("app"):
        row = {"app": app, "queries": len(grp)}
        statuses = grp["status"].value_counts() \
            if "status" in grp.columns else {}
        for status, n in dict(statuses).items():
            row[f"n_{status}"] = int(n)
        for c in phase_cols:
            total = grp[c].sum(skipna=True)
            if total:
                row[c.replace("phase_", "total_", 1)] = round(
                    float(total), 4)
        q = grp["e2e_ms"].quantile
        row["p50_ms"] = round(float(q(0.50)), 3)
        row["p95_ms"] = round(float(q(0.95)), 3)
        row["p99_ms"] = round(float(q(0.99)), 3)
        rows.append(row)
    return pd.DataFrame(rows)
