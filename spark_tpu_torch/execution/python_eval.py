"""ExtractPythonUDFs: cut the device plan at Python UDF call sites (the
port of `spark_tpu/execution/python_eval.py`).

The reference pulls PythonUDF expressions out of projections/filters
into BatchEvalPythonExec / ArrowEvalPythonExec stages that stream Arrow
batches to worker processes (`ExtractPythonUDFs.scala`,
`ArrowEvalPythonExec.scala:1`). Here the executor materializes the UDF
node's child subtree (one stage), copies it to the host as a compacted
Arrow table, evaluates the functions there (in process, or in the
worker pool of `udf_worker/`), and copies child plus results back to
the card as an InputExec with appended ``__udf_i`` columns — the
surrounding plan stays on the card. The spliced batch is new on every
run, so the device table cache never holds it.

The JAX package also records one span per worker batch; the port has no
span recorder yet (it comes with observability), so the `udf_*` session
counters and `qe.udf_summary` carry what the spans would.
"""

from __future__ import annotations

import copy
import decimal as _decimal
import time
from typing import List

import numpy as np
import pyarrow as pa
import torch

from .. import types as T
from ..columnar import Batch
from ..expr import Alias, ColumnRef
from ..plan import physical as P
from ..udf import PythonUDF, evaluate_udf, result_to_arrow

EPOCH = np.datetime64("1970-01-01", "D")

UDF_MODE_KEY = "spark_tpu.sql.udf.mode"
UDF_BATCH_KEY = "spark_tpu.sql.udf.arrow.maxRecordsPerBatch"
UDF_TIMEOUT_KEY = "spark_tpu.sql.udf.batchTimeoutMs"
UDF_MAX_WORKERS_KEY = "spark_tpu.sql.udf.pool.maxWorkers"
UDF_IDLE_KEY = "spark_tpu.sql.udf.pool.idleTimeoutMs"


def _collect_udfs(e, out: List[PythonUDF]):
    """Collect INNERMOST-first extractable call sites: a UDF whose args
    contain another UDF waits for the next extraction pass (its args
    must resolve to already-spliced ``__udf_i`` columns first)."""
    if isinstance(e, PythonUDF):
        inner: List[PythonUDF] = []
        for c in e.children:
            _collect_udfs(c, inner)
        out.extend(inner if inner else [e])
        return
    for c in e.children:
        _collect_udfs(c, out)


def node_udfs(node: P.PhysicalPlan) -> List[PythonUDF]:
    out: List[PythonUDF] = []
    if isinstance(node, P.ProjectExec):
        for e in node.exprs:
            _collect_udfs(e, out)
    elif isinstance(node, P.FilterExec):
        _collect_udfs(node.condition, out)
    elif isinstance(node, P.HashAggregateExec) and node.mode != "final":
        # UDFs in group keys or aggregate arguments (group_by(udf(x)),
        # sum(udf(x)) — incl. projections the optimizer collapsed in).
        # FINAL-mode aggregates merge accumulator columns and never
        # evaluate their function children, so they are left alone.
        for g in node.group_exprs:
            _collect_udfs(g, out)
        for a in node.agg_exprs:
            for c in a.func.children:
                _collect_udfs(c, out)
    return out


def plan_has_udfs(root: P.PhysicalPlan) -> bool:
    if node_udfs(root):
        return True
    return any(plan_has_udfs(c) for c in root.children)


def _vec_to_host(vec, n_rows: int):
    """Device Vec -> (python-friendly host array, validity|None) over a
    fully-live (compacted) batch: one copy of the data and one of the
    validity."""
    valid = None
    if vec.validity is not None:
        valid = vec.validity[:n_rows].cpu().numpy()
    data = vec.data[:n_rows].cpu().numpy()
    if vec.dictionary is not None:
        values = np.asarray(vec.dictionary.to_pandas(), dtype=object)
        codes = np.clip(data, 0, len(values) - 1)
        data = values[codes] if len(values) else \
            np.full(n_rows, None, dtype=object)
    elif isinstance(vec.dtype, T.DateType):
        data = (EPOCH + data.astype("timedelta64[D]")).astype(object)
    elif isinstance(vec.dtype, T.TimestampType):
        data = data.astype("datetime64[us]").astype(object)
    elif isinstance(vec.dtype, T.DecimalType):
        q = _decimal.Decimal(1).scaleb(-vec.dtype.scale)
        data = np.array([_decimal.Decimal(int(x)) * q for x in data],
                        dtype=object)
    return data, valid


def _eval_udfs_host(udfs: List[PythonUDF], batch: Batch,
                    table: pa.Table, base: int) -> pa.Table:
    """Append one ``__udf_i`` column per call site to the host table."""
    n = table.num_rows
    for i, u in enumerate(udfs, start=base):
        arg_arrays, arg_valids = [], []
        for a in u.children:
            vec = a.eval(batch)  # eager device eval of the arg exprs
            data, valid = _vec_to_host(vec, n)
            arg_arrays.append(data)
            arg_valids.append(valid)
        values, valid = evaluate_udf(u, arg_arrays, arg_valids, n)
        table = table.append_column(f"__udf_{i}", result_to_arrow(
            u, values, valid))
    return table


def _rt_name(rt: T.DataType) -> str:
    """Return-type NAME for the wire: the worker child never imports
    the engine, so type objects cannot cross the pipe."""
    if isinstance(rt, T.StringType):
        return "string"
    if isinstance(rt, T.DateType):
        return "date"
    if isinstance(rt, T.LongType):
        return "long"
    if isinstance(rt, T.IntegerType):
        return "int"
    if isinstance(rt, T.DoubleType):
        return "double"
    if isinstance(rt, T.FloatType):
        return "float"
    if isinstance(rt, T.BooleanType):
        return "boolean"
    raise TypeError(f"UDF return type {rt!r} has no worker-lane name")


def _host_to_arrow(data, valid, n: int) -> pa.Array:
    """(host array, validity|None) from `_vec_to_host` -> one Arrow arg
    column for the worker. Object arrays (strings, dates, timestamps,
    decimals, dictionary-decoded) go through inference with NULLs
    substituted at invalid slots; numeric arrays keep their dtype with
    the validity as a mask — the worker's `_column_to_args` inverts
    both exactly, so both lanes feed the user function identical
    values."""
    if data.dtype == object:
        if valid is None:
            vals = list(data)
        else:
            vals = [data[i] if valid[i] else None for i in range(n)]
        return pa.array(vals)
    if valid is None:
        return pa.array(data)
    return pa.array(data, mask=~np.asarray(valid, dtype=bool))


def _dumps_fn(fn, name: str) -> bytes:
    """The user function as bytes for a worker: cloudpickle carries
    lambdas and closures by value; without it, pickle carries only
    functions importable by module and name, and any other function
    raises UdfNotShippable (never a silent switch of lanes)."""
    try:
        import cloudpickle
    except ImportError:
        import pickle
        from ..udf_worker import UdfNotShippable
        try:
            return pickle.dumps(fn, protocol=pickle.HIGHEST_PROTOCOL)
        except (pickle.PicklingError, AttributeError, TypeError) as e:
            raise UdfNotShippable(name, f"{type(e).__name__}: {e}") from e
    return cloudpickle.dumps(fn)


def session_pool(session, conf):
    """The session's shared UdfWorkerPool (created in the session's
    __init__; it spawns nothing until its first checkout), with its
    bounds refreshed from conf — workers are reused across queries."""
    pool = session._udf_pool
    pool.max_workers = max(1, int(conf.get(UDF_MAX_WORKERS_KEY)))
    pool.idle_timeout_ms = float(conf.get(UDF_IDLE_KEY))
    return pool


def _note_udf_summary(qe, mode: str, batches: int, rows: int,
                      exec_ms: float, restarts: int, max_rec: int) -> None:
    """Accumulate the query's `udf_summary` (the JAX package's event-log
    `udf` record: one per query, summed across UDF nodes and nesting
    passes)."""
    if qe is None:
        return
    s = getattr(qe, "udf_summary", None)
    if not s:
        s = {"mode": mode, "batches": 0, "rows": 0, "exec_ms": 0.0,
             "worker_restarts": 0, "max_records_per_batch": int(max_rec)}
    s["batches"] += int(batches)
    s["rows"] += int(rows)
    s["exec_ms"] = round(s["exec_ms"] + float(exec_ms), 3)
    s["worker_restarts"] += int(restarts)
    qe.udf_summary = s


def _note_stage_times(qe, **seconds) -> None:
    """Add one UDF stage's host-clock split to `qe.phase_times` under
    `udf_<part>` (summed across UDF nodes): `child` runs the node's
    child on the device, `egress` copies it to host Arrow, `eval` runs
    the lane (argument expressions on the device, their copies to the
    host, the user function, the result to Arrow), `ingest` copies the
    child (for the arguments) and then child plus results back."""
    if qe is None:
        return
    for part, s in seconds.items():
        key = f"udf_{part}"
        qe.phase_times[key] = qe.phase_times.get(key, 0.0) + s


def _eval_udfs_worker(udfs: List[PythonUDF], batch: Batch,
                      table: pa.Table, base: int, conf, qe) -> pa.Table:
    """The out-of-process lane (`spark_tpu.sql.udf.mode=worker`): arg
    expressions still evaluate on device over the whole batch (exactly
    like `_eval_udfs_host`, so results stay byte-identical), but the
    user function runs in pooled subprocess workers, fed Arrow slices
    of `udf.arrow.maxRecordsPerBatch` rows. Each slice is one
    ChunkRetrier chunk at the `udf_batch` fault site: a worker that
    dies (UdfWorkerLost, TRANSIENT) or wedges past `udf.batchTimeoutMs`
    (StageTimeoutError, TIMEOUT) is killed and ONLY the in-flight
    batch replays on a fresh worker (`rec_chunks_replayed`). The
    lifecycle token is checked between batches AND every ~50ms during
    one (the eval poll), and cancel/deadline kills the in-flight
    worker + shuts the pool down — no child survives a cancelled
    query."""
    from ..testing import faults
    from ..udf_worker import UdfError
    from ..udf_worker import protocol
    from ..udf_worker.pool import UdfWorkerLost
    from . import lifecycle
    from .failures import StageTimeoutError
    from .recovery import ChunkRetrier

    n = table.num_rows
    session = qe.session
    metrics = session.metrics
    arg_cols, names, spec_udfs = [], [], []
    for i, u in enumerate(udfs):
        for j, a in enumerate(u.children):
            vec = a.eval(batch)  # eager device eval, same as in-process
            data, valid = _vec_to_host(vec, n)
            arg_cols.append(_host_to_arrow(data, valid, n))
            names.append(f"u{i}_a{j}")
        spec_udfs.append({"fn": _dumps_fn(u.fn, u.udf_name),
                          "rt": _rt_name(u.return_type),
                          "vectorized": bool(u.vectorized),
                          "name": u.udf_name,
                          "n_args": len(u.children)})
    args_table = (pa.Table.from_arrays(arg_cols, names=names)
                  if arg_cols else None)

    max_rec = max(1, int(conf.get(UDF_BATCH_KEY)))
    timeout_ms = float(conf.get(UDF_TIMEOUT_KEY))
    timeout_s = timeout_ms / 1e3 if timeout_ms > 0 else None
    pool = session_pool(session, conf)
    retrier = ChunkRetrier(conf, recovery=getattr(qe, "_recovery", None),
                           site="udf_batch")
    held = [None]       # the one worker this query thread holds
    stats = {"batches": 0, "rows": 0, "exec_ms": 0.0, "restarts": 0,
             "had_worker": False}

    def _kill_held():
        h = held[0]
        if h is not None:
            held[0] = None
            pool.discard(h)

    def _poll_cancel():
        tok = lifecycle.current_token()
        if tok is not None and (tok.cancelled or tok.expired()):
            # kill BEFORE raising: the structured cancel error must
            # not leave a child running mid-batch
            _kill_held()
            tok.check("udf_batch")

    def _make_step(ci: int, start: int, ln: int):
        def step() -> pa.Table:
            # chaos seam fires INSIDE the step (ChunkRetrier's
            # udf_batch branch defers to here) so a `fatal` rule can
            # model SIGKILL-mid-batch: kill the in-flight worker for
            # real, then surface as UdfWorkerLost (UNAVAILABLE ->
            # TRANSIENT) — exactly this batch replays on a fresh
            # worker, which is the acceptance contract
            try:
                faults.fire("udf_batch")
            except faults.FaultInjected as fe:
                if fe.fault == "fatal":
                    pid = held[0].pid if held[0] is not None else -1
                    _kill_held()
                    raise UdfWorkerLost(
                        pid, "injected SIGKILL (udf_batch:fatal)") from fe
                raise
            _poll_cancel()
            if held[0] is not None and not held[0].alive():
                _kill_held()
            if held[0] is None:
                held[0] = pool.checkout()
                if stats["had_worker"]:
                    stats["restarts"] += 1
                    metrics.counter("udf_worker_restarts").inc()
                stats["had_worker"] = True
            h = held[0]
            sl = (args_table.slice(start, ln) if args_table is not None
                  else pa.Table.from_arrays([], names=[]))
            payload = protocol.encode_eval(
                {"kind": "batch", "base": base, "udfs": spec_udfs,
                 "n_rows": ln}, sl)
            with qe.spans.span("udf_batch", chunk=ci, rows=ln) as sp:
                try:
                    ftype, pl = h.eval(payload, timeout_s, _poll_cancel)
                except (UdfWorkerLost, StageTimeoutError):
                    # dead or wedged: kill + release the slot so the
                    # replay (and concurrent queries) get a fresh worker
                    _kill_held()
                    raise
            t0, t1 = sp.t0, sp.t1
            if ftype == protocol.FRAME_ERROR:
                err = protocol.decode_error(pl)
                raise UdfError(", ".join(u["name"] for u in spec_udfs),
                               err["etype"], err["message"],
                               err["traceback"])
            out = protocol.ipc_to_table(pl)
            if out.num_rows != ln:
                raise protocol.ProtocolError(
                    f"worker returned {out.num_rows} rows for a "
                    f"{ln}-row batch")
            stats["batches"] += 1
            stats["rows"] += ln
            stats["exec_ms"] += (t1 - t0) * 1e3
            metrics.counter("udf_batches").inc()
            metrics.counter("udf_rows").inc(ln)
            metrics.counter("udf_exec_ms").inc(int((t1 - t0) * 1e3))
            return out
        return step

    starts = list(range(0, n, max_rec)) or [0]
    result_chunks: List[pa.Table] = []
    try:
        for ci, start in enumerate(starts):
            ln = min(max_rec, n - start) if n else 0
            result_chunks.append(
                retrier.run(_make_step(ci, start, ln), chunk=ci))
    except (lifecycle.QueryCancelledError, lifecycle.QueryDeadlineError):
        # the no-orphan contract: cancel/deadline kills the in-flight
        # worker AND the pool's idle ones — zero children survive a
        # cancel landing mid-UDF
        _kill_held()
        pool.shutdown()
        raise
    finally:
        h = held[0]
        if h is not None:
            held[0] = None
            if h.alive():
                pool.checkin(h)   # reuse across batches AND queries
            else:
                pool.discard(h)

    combined = pa.concat_tables(result_chunks)
    for i in range(base, base + len(udfs)):
        name = f"__udf_{i}"
        table = table.append_column(name, combined.column(name))
    _note_udf_summary(qe, "worker", stats["batches"], stats["rows"],
                      stats["exec_ms"], stats["restarts"], max_rec)
    return table


def eval_grouped_map_worker(session, fn, groups, field_names):
    """Grouped-map pandas UDF through the worker pool: one EVAL frame
    per key group (`FlatMapGroupsInPandasExec` over the same pipe
    protocol as the scalar lane). A worker that dies or wedges past
    `udf.batchTimeoutMs` mid-group is killed and only that group
    replays once on a fresh worker; a user exception surfaces as a
    structured UdfError carrying the worker traceback. Returns one
    result frame per group, already projected to `field_names`."""
    from ..udf_worker import UdfError
    from ..udf_worker import protocol
    from ..udf_worker.pool import UdfWorkerLost
    from . import lifecycle
    from .failures import StageTimeoutError

    conf = session.conf
    pool = session_pool(session, conf)
    metrics = session.metrics
    timeout_ms = float(conf.get(UDF_TIMEOUT_KEY))
    timeout_s = timeout_ms / 1e3 if timeout_ms > 0 else None
    spec = {"kind": "grouped_map",
            "fn": _dumps_fn(fn, getattr(fn, "__name__", "grouped_map")),
            "fields": list(field_names)}

    def _poll():
        tok = lifecycle.current_token()
        if tok is not None and (tok.cancelled or tok.expired()):
            tok.check("udf_grouped_map")

    out = []
    for g in groups:
        payload = protocol.encode_eval(
            spec, pa.Table.from_pandas(g, preserve_index=False))
        ftype = pl = None
        t0 = time.perf_counter()
        for attempt in (0, 1):
            h = pool.checkout()
            try:
                ftype, pl = h.eval(payload, timeout_s, _poll)
            except (UdfWorkerLost, StageTimeoutError):
                pool.discard(h)
                metrics.counter("udf_worker_restarts").inc()
                if attempt:
                    raise
                continue
            except BaseException:
                # cancel/deadline (or anything else) mid-group: the
                # in-flight worker's pipe holds a half-read frame —
                # kill it rather than pool a poisoned handle
                pool.discard(h)
                raise
            pool.checkin(h)
            break
        t1 = time.perf_counter()
        if ftype == protocol.FRAME_ERROR:
            err = protocol.decode_error(pl)
            raise UdfError(getattr(fn, "__name__", "grouped_map"),
                           err["etype"], err["message"],
                           err["traceback"])
        res = protocol.ipc_to_table(pl)
        metrics.counter("udf_batches").inc()
        metrics.counter("udf_rows").inc(res.num_rows)
        metrics.counter("udf_exec_ms").inc(int((t1 - t0) * 1e3))
        out.append(res.to_pandas())
    return out


def _rewrite(e, udfs: List[PythonUDF], base: int, top_level: bool):
    """Replace PythonUDF call sites with refs to their ``__udf_i``
    columns (identity-matched: the same call site object evaluates
    once)."""
    for i, u in enumerate(udfs, start=base):
        if e is u:
            ref = ColumnRef(f"__udf_{i}")
            # a bare top-level UDF projects under its pretty name
            return Alias(ref, e.name()) if top_level else ref
    return e.map_children(lambda c: _rewrite(c, udfs, base, False))


def _agg_rewrite(a, udfs: List[PythonUDF], base: int):
    na = copy.copy(a)
    na.func = a.func.with_args(
        [_rewrite(c, udfs, base, False) for c in a.func.children])
    return na


def extract_python_udfs(root: P.PhysicalPlan, conf, device,
                        qe=None) -> P.PhysicalPlan:
    """Bottom-up: materialize each UDF-bearing node's child on `device`,
    copy it to the host, evaluate the UDFs (in-process, or through the
    worker pool when `spark_tpu.sql.udf.mode=worker` — `qe` carries the
    session/pool and the recovery context), splice an InputExec (child
    cols + __udf cols) back on `device`, and rewrite the node's
    expressions over it."""
    new_children = tuple(extract_python_udfs(c, conf, device, qe=qe)
                         for c in root.children)
    if new_children != root.children:
        root = copy.copy(root)
        root.children = new_children
    from .streaming_agg import _materialize_subtree
    node = root
    worker_mode = (str(conf.get(UDF_MODE_KEY) or "inprocess") == "worker"
                   and qe is not None)
    recovery = getattr(qe, "_recovery", None)
    # nested calls (udf(udf(x))) extract one layer per iteration
    for _depth in range(16):
        udfs = node_udfs(node)
        if not udfs:
            return node
        child = node.children[0]
        t0 = time.perf_counter()
        b = _materialize_subtree(child, conf, device, recovery)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)  # the child's time, not egress's
        t1 = time.perf_counter()
        table = b.to_arrow()                      # compact live rows
        t2 = time.perf_counter()
        cb = Batch.from_arrow(table, device)      # fully-live device batch
        t3 = time.perf_counter()
        base = sum(1 for n_ in table.column_names
                   if n_.startswith("__udf_"))
        if worker_mode:
            table = _eval_udfs_worker(udfs, cb, table, base, conf, qe)
        else:
            table = _eval_udfs_host(udfs, cb, table, base)
            _note_udf_summary(
                qe, "inprocess", batches=1, rows=table.num_rows,
                exec_ms=(time.perf_counter() - t3) * 1e3, restarts=0,
                max_rec=int(conf.get(UDF_BATCH_KEY)))
        t4 = time.perf_counter()
        nb = Batch.from_arrow(table, device)
        _note_stage_times(qe, child=t1 - t0, egress=t2 - t1,
                          eval=t4 - t3,
                          ingest=t3 - t2 + time.perf_counter() - t4)
        inp = P.InputExec(nb, nb.schema(), label="python_udf")
        node = copy.copy(node)
        node.children = (inp,)
        if isinstance(node, P.ProjectExec):
            node.exprs = tuple(_rewrite(e, udfs, base, True)
                               for e in node.exprs)
        elif isinstance(node, P.FilterExec):
            node.condition = _rewrite(node.condition, udfs, base, False)
        else:
            node.group_exprs = tuple(_rewrite(g, udfs, base, True)
                                     for g in node.group_exprs)
            node.agg_exprs = tuple(
                _agg_rewrite(a, udfs, base) for a in node.agg_exprs)
    raise RuntimeError("python UDF nesting did not resolve in 16 passes")
