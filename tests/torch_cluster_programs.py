"""Programs the cluster tests run in each engine process of a two-process
CPU cluster (`spark_tpu_torch.parallel.launch.run_cluster`). Each takes
the process's session (pinned to the CPU, joined to the cluster) and
returns its Arrow results by name; what the tests read besides goes into
`proc.report`. This module imports the port only: the launcher's
processes must load no JAX module."""

import time

import numpy as np
import pandas as pd

from spark_tpu_torch import functions as F
from spark_tpu_torch.functions import col

MESH = "spark_tpu.sql.mesh.size"
N_SHARDS = 4
CLUSTER_KEYS = ("spark_tpu.sql.cluster.coordinator",
                "spark_tpu.sql.cluster.numProcesses",
                "spark_tpu.sql.cluster.processId")
BCAST = "spark_tpu.sql.autoBroadcastJoinThreshold"
SKEW_LIMIT = "spark_tpu.sql.adaptive.skewJoin.broadcastThreshold"
RESTART = "spark_tpu.execution.meshRestart.enabled"
FALLBACK = "spark_tpu.execution.meshFallback.enabled"
RANGE_ROWS = 50_000
RANGE_MOD = 1024
TPCH_QUERIES = ("q1", "q3", "q5", "q6")
#: the mesh stream's conf (`tests/torch_ooc_parity.py` STREAMING): chunks
#: of 1,024 rows, the device table cache off, millisecond backoffs
STREAMING = (("spark_tpu.sql.execution.streamingChunkRows", 1024),
             ("spark_tpu.sql.io.deviceCacheBytes", 0),
             ("spark_tpu.execution.backoffMs", 1))
STREAMED = ("stream_q1", "stream_q6")
CKPT = "spark_tpu.execution.checkpoint.everyChunks"
RESTART_MAX = "spark_tpu.execution.meshRestart.maxRestarts"
DRAIN = "spark_tpu.execution.decommission.shards"
EXCLUDE = "spark_tpu.sql.mesh.excludeDevices"
SPANS = "spark_tpu.sql.observability.shardSpans"
#: the straggler monitor's conf of `tests/test_torch_elastic.py`
STRAGGLER = (("spark_tpu.sql.straggler.minChunks", 3),
             ("spark_tpu.sql.straggler.factor", 4.0))
#: the drained position, the slowed one, its wait a chunk (ms), and the
#: chunks a Q1 stream at SF 0.002 can take at most
DRAIN_POSITION = 3
SLOW_POSITION = 3
SLOW_MS = 60
MAX_CHUNKS = 16
COUNTERS = ("rec_chunks_replayed", "mesh_restart_attempts",
            "rebalance_rows")


def exchange_program(session):
    """The hash exchange whose cross-process bytes a test counts."""
    return session.range(4096).group_by((col("id") % 37).alias("k")).agg(
        F.count().alias("c"), F.sum(col("id")).alias("s"))


def range_program(session, ns=None):
    ns = ns or F
    return session.range(RANGE_ROWS).group_by(
        ns.col("id") % RANGE_MOD).agg(ns.count(), ns.sum(ns.col("id")),
                                      ns.avg(ns.col("id")))


def skew_tables():
    """The skewed fact and dimension of the overflow cases (the JAX
    package's `tests/test_adaptive_skew.py` shapes, smaller)."""
    rs = np.random.RandomState(4)
    n = 40_000
    k = rs.randint(0, 500, n).astype(np.int64)
    k[: int(n * 0.9)] = 3
    fact = pd.DataFrame({"k": k, "v": np.ones(n)})
    dim = pd.DataFrame({"k": np.arange(500, dtype=np.int64),
                        "w": np.arange(500, dtype=np.float64)})
    return fact, dim


def skew_program(session, ns=None):
    ns = ns or F
    return session.table("skew_fact").join(
        session.table("skew_dim"), left_on=ns.col("k"),
        right_on=ns.col("k")).agg(
        ns.sum(ns.col("v") * ns.col("w")).alias("s"),
        ns.count().alias("c"))


def dryrun(session, proc):
    """`dryrun_mesh` at mesh.size 4 over the cluster (each process holds
    every case to its own one-device run), then one hash exchange with
    the crossed bytes counted, under a shared event-log directory."""
    from spark_tpu_torch.parallel import cluster
    from spark_tpu_torch.parallel.dryrun import dryrun_cases, dryrun_mesh
    from spark_tpu_torch.history import read_event_log
    confs = [(k, session.conf.get(k)) for k in CLUSTER_KEYS]
    confs.append(("spark_tpu.sql.eventLog.dir", proc.args["log_dir"]))
    confs.append(("spark_tpu.sql.metrics.sink", "jsonl"))
    confs.append(("spark_tpu.sql.metrics.dir", proc.args["log_dir"]))
    tables = {}
    t0 = time.perf_counter()
    proc.report["done"] = dryrun_mesh(N_SHARDS, "cpu", confs, tables)
    proc.report["dryrun_s"] = time.perf_counter() - t0
    out = {f"case{i}": tables[name]
           for i, (name, _b, _s) in enumerate(dryrun_cases())}
    session.conf.set(MESH, N_SHARDS)
    cluster.reset_cluster_stats()
    qe = exchange_program(session)._qe()
    out["exchange"] = qe.collect()
    proc.report["exchange_plan"] = qe.executed_plan.tree_string()
    proc.report["exchange_stats"] = {
        k: list(v) for k, v in cluster.CLUSTER_STATS.items()}
    proc.report["logged_queries"] = len(read_event_log(
        proc.args["log_dir"], rank=proc.rank))
    return out


def tpch(session, proc):
    """TPC-H Q1, Q3, Q5, Q6 (the DataFrame programs) and the range
    group-by at mesh.size 4, the two skew cases (the join re-plans to
    broadcast; the receive blocks grow), each a result by name with
    its attempts and executed plan in the report."""
    from spark_tpu_torch.tpch.queries import QUERIES, register_tables
    register_tables(session, proc.args["path"])
    fact, dim = skew_tables()
    session.register_table("skew_fact", fact)
    session.register_table("skew_dim", dim)
    session.conf.set(MESH, N_SHARDS)
    out, plans = {}, {}

    def run(name, make, confs=()):
        for k, v in confs:
            session.conf.set(k, v)
        try:
            t0 = time.perf_counter()
            qe = make()._qe()
            out[name] = qe.collect()
            plans[name] = {"plan": qe.executed_plan.tree_string(),
                           "spliced": qe.spliced_plan.tree_string(),
                           "chunks": stream_chunks(qe),
                           "attempts": qe.attempts,
                           "faults": qe.fault_summary,
                           "wall_s": time.perf_counter() - t0}
        finally:
            for k, _v in confs:
                session.conf.unset(k)

    for q in TPCH_QUERIES:
        run(q, lambda q=q: QUERIES[q](session))
    run("range", lambda: range_program(session))
    # the broadcast re-plan first: the capacities the grown run keeps
    # would leave no overflow to re-plan on
    run("skew_broadcast", lambda: skew_program(session), ((BCAST, 0),))
    run("skew_grow", lambda: skew_program(session),
        ((BCAST, 0), (SKEW_LIMIT, 1)))
    # the mesh stream: Q1 and Q6 past streamingChunkRows, cache off
    for q in ("q1", "q6"):
        run(f"stream_{q}", lambda q=q: QUERIES[q](session), STREAMING)
    proc.report["plans"] = plans
    return out


def faults(session, proc):
    """A fault at the `mesh` seam in rank 1 only: with the restart on,
    both processes gang-restart; with both rungs off, both raise it."""
    from spark_tpu_torch.testing import faults as FT
    session.conf.set(MESH, N_SHARDS)
    spec = "mesh:fatal:1" if proc.rank == 1 else ""
    runs = {}
    for label, confs in (("restart", ((RESTART, True),)),
                         ("raise", ((RESTART, False), (FALLBACK, False)))):
        for k, v in confs:
            session.conf.set(k, v)
        t0 = time.perf_counter()
        with FT.inject(session.conf, spec):
            qe = range_program(session)._qe()
            try:
                table = qe.collect()
                runs[label] = {"rows": table.num_rows,
                               "faults": qe.fault_summary}
                if label == "restart":
                    out = table
            except Exception as e:  # noqa: BLE001 — the test reads it
                runs[label] = {"error": type(e).__name__,
                               "message": str(e)[:300]}
        runs[label]["wall_s"] = time.perf_counter() - t0
    proc.report["runs"] = runs
    return {"restart": out}


def killed(session, proc):
    """Rank 1 slows at the `mesh` seam and is killed there (the launcher
    kills it after its mark); rank 0, waiting at a collective, raises."""
    from spark_tpu_torch.testing import faults as FT
    session.conf.set(MESH, N_SHARDS)
    spec = "mesh:slow:1:20000" if proc.rank == 1 else ""
    with FT.inject(session.conf, spec):
        proc.mark("query")
        t0 = time.time()
        try:
            range_program(session).collect()
            proc.report["outcome"] = "finished"
        except Exception as e:  # noqa: BLE001 — the test reads it
            proc.report["outcome"] = type(e).__name__
            proc.report["message"] = str(e)[:300]
        proc.report["raised_at"] = time.time()
        proc.report["wait_s"] = time.time() - t0
    return {}


def seams(session, proc):
    """Failures outside the `mesh` seam, armed in rank 1 only: a fatal
    fault at `stage_run` (before each attempt, after the scans load), and
    a stage timeout that only rank 1's conf sets. Each case's outcome in
    each process goes into the report; then one clean query shows the
    cluster still runs."""
    from spark_tpu_torch.testing import faults as FT
    session.conf.set(MESH, N_SHARDS)
    session.conf.set("spark_tpu.execution.maxRetries", 1)
    cases = (("stage_run", "stage_run:fatal:1", ()),
             ("timeout", "", (("spark_tpu.execution.stageTimeoutMs", 1),)))
    runs = {}
    for label, spec, confs in cases:
        mine = confs if proc.rank == 1 else ()
        for k, v in mine:
            session.conf.set(k, v)
        t0 = time.perf_counter()
        try:
            with FT.inject(session.conf, spec if proc.rank == 1 else ""):
                qe = range_program(session)._qe()
                table = qe.collect()
                runs[label] = {"rows": table.num_rows,
                               "faults": qe.fault_summary}
        except Exception as e:  # noqa: BLE001 — the test reads it
            runs[label] = {"error": type(e).__name__,
                           "message": str(e)[:300]}
        finally:
            for k, _v in mine:
                session.conf.unset(k)
        runs[label]["wall_s"] = time.perf_counter() - t0
    proc.report["runs"] = runs
    return {"after": range_program(session).collect()}


# -- the elastic mesh across processes -----------------------------------------

def stream_chunks(qe) -> int:
    """Chunks the query's mesh streams folded."""
    return sum(len(st["chunks"]) for st in qe.stream_stats
               if st["kind"] == "mesh")


def stream_session(session, path, confs=()):
    """A fresh session of this process (pinned to its device, joined to
    its cluster) over the TPC-H tables at `path`, at mesh.size 4 under
    the streaming conf and `confs`: each case starts from a gang of 4
    with nothing drained."""
    from spark_tpu_torch.tpch.queries import register_tables
    builder = type(session).builder().device(session.device)
    for k in CLUSTER_KEYS:
        builder = builder.config(k, session.conf.get(k))
    s = builder.get_or_create()
    register_tables(s, path)
    s.conf.set(MESH, N_SHARDS)
    for k, v in STREAMING + tuple(confs):
        s.conf.set(k, v)
    return s


def counters(session) -> dict:
    return {k: session.metrics.counter(k).value for k in COUNTERS}


def outcome(session, make, spec=""):
    """One execution of `make(session)` under the fault spec (armed in
    this process): (table or None, what the tests read of it)."""
    from spark_tpu_torch.testing import faults as FT
    before = counters(session)
    t0 = time.perf_counter()
    rec = {}
    table = None
    with FT.inject(session.conf, spec) as plan:
        qe = make(session)._qe()
        try:
            table = qe.collect()
        except Exception as e:  # noqa: BLE001 — the test reads it
            rec["error"] = type(e).__name__
            rec["message"] = str(e)[:400]
        rec["fired"] = [list(f) for f in plan.fired_log] if plan else []
    rec["wall_s"] = time.perf_counter() - t0
    rec["faults"] = qe.fault_summary
    # each process jitters its own backoff
    rec["events"] = [{k: v for k, v in ev.items()
                      if k not in ("error", "backoff_ms")}
                     for ev in qe.fault_events]
    rec["delta"] = {k: v - before[k] for k, v in counters(session).items()}
    # the last stream's chunks: a failed attempt's count depends on when
    # each process saw the abort
    rec["chunks"] = len(qe.stream_stats[-1]["chunks"]) \
        if qe.stream_stats else 0
    rec["shards_by_chunk"] = shards_by_chunk(qe)
    rec["spliced"] = qe.spliced_plan.tree_string() \
        if qe.spliced_plan is not None else None
    return table, rec


def shards_by_chunk(qe) -> dict:
    """This process's compute records: chunk -> {position: live rows}."""
    out = {}
    for r in qe.spans.shard_records:
        if r["phase"] == "compute":
            out.setdefault(str(r["chunk"]), {})[str(r["shard"])] = r["rows"]
    return out


def q1(session):
    from spark_tpu_torch.tpch.queries import QUERIES
    return QUERIES["q1"](session)


def q6(session):
    from spark_tpu_torch.tpch.queries import QUERIES
    return QUERIES["q6"](session)


def drain(session, proc):
    """(b) Position 3 drained mid-stream by a request rank 1 alone makes
    (from a listener, once chunk 1's records are posted), then Q6 on the
    drained gang; (c) a drain of positions 2 and 3, requested in rank 1
    alone before the query, which would leave rank 1 without a
    position."""
    from spark_tpu_torch.observability import QueryListener
    path = proc.args["path"]
    s = stream_session(session, path, ((CKPT, 2), (SPANS, "on")))

    class Drainer(QueryListener):
        done = False

        def on_shard_records(self, event):
            if not self.done and event.chunk >= 1:
                self.done = True
                s.decommission_shards([DRAIN_POSITION])

    if proc.rank == 1:
        s.add_listener(Drainer())
    out, runs = {}, {}
    out["drain"], runs["drain"] = outcome(s, q1)
    runs["drain"]["after"] = {k: str(s.conf.get(k))
                              for k in (MESH, EXCLUDE, DRAIN)}
    out["after"], runs["after"] = outcome(s, q6)
    s2 = stream_session(session, path)
    if proc.rank == 1:
        s2.decommission_shards([2, 3])
    _t, runs["refused"] = outcome(s2, q1)
    runs["refused"]["after"] = {k: str(s2.conf.get(k))
                                for k in (MESH, EXCLUDE, DRAIN)}
    proc.report["runs"] = runs
    return out


def straggler(session, proc):
    """(d) Position 3 slowed SLOW_MS at the `shard_chunk` seam every
    chunk, armed in rank 1 alone: the monitor's flags and the chunk each
    came at, from a listener."""
    from spark_tpu_torch.observability import QueryListener
    s = stream_session(session, proc.args["path"],
                       ((SPANS, "on"),) + STRAGGLER)
    seen = {"chunk": None, "flags": []}

    class Watcher(QueryListener):
        def on_shard_records(self, event):
            seen["chunk"] = event.chunk

        def on_straggler(self, event):
            seen["flags"].append([event.shard, seen["chunk"]])

    s.add_listener(Watcher())
    spec = ",".join(f"shard_chunk:slow:{c * N_SHARDS + SLOW_POSITION + 1}:"
                    f"{SLOW_MS}" for c in range(MAX_CHUNKS)) \
        if proc.rank == 1 else ""
    out, runs = {}, {}
    out["straggler"], runs["straggler"] = outcome(s, q1, spec)
    runs["straggler"]["flags"] = seen["flags"]
    proc.report["runs"] = runs
    return out


def stream_faults(session, proc):
    """(e) A shard lost at the 2nd checkpoint (`mesh_checkpoint:fatal:2`,
    a checkpoint every 2 chunks) in rank 1 alone: with the gang restart,
    then with its budget spent (maxRestarts 0)."""
    path = proc.args["path"]
    spec = "mesh_checkpoint:fatal:2" if proc.rank == 1 else ""
    out, runs = {}, {}
    s = stream_session(session, path, ((CKPT, 2),))
    out["restart"], runs["restart"] = outcome(s, q1, spec)
    s = stream_session(session, path, ((CKPT, 2), (RESTART_MAX, 0)))
    out["spent"], runs["spent"] = outcome(s, q1, spec)
    proc.report["runs"] = runs
    return out


def stream_killed(session, proc):
    """(f) Rank 1 marks once chunk 1's records are posted, then sleeps
    at chunk 3's `stream_chunk` seam, where the launcher kills it; rank
    0, waiting at the next chunk boundary's agreement, raises."""
    from spark_tpu_torch.observability import QueryListener
    from spark_tpu_torch.testing import faults as FT
    s = stream_session(session, proc.args["path"], ((SPANS, "on"),))

    class Marker(QueryListener):
        def on_shard_records(self, event):
            if event.chunk == 1:
                proc.mark("stream")

    s.add_listener(Marker())
    spec = "stream_chunk:slow:4:20000" if proc.rank == 1 else ""
    with FT.inject(s.conf, spec):
        t0 = time.time()
        try:
            q1(s).collect()
            proc.report["outcome"] = "finished"
        except Exception as e:  # noqa: BLE001 — the test reads it
            proc.report["outcome"] = type(e).__name__
            proc.report["message"] = str(e)[:300]
        proc.report["raised_at"] = time.time()
        proc.report["wait_s"] = time.time() - t0
    return {}
