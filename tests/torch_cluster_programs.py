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
    proc.report["plans"] = plans
    proc.report["stream_refusal"] = _stream_refusal(session)
    return out


def _stream_refusal(session):
    """Q1 past streamingChunkRows with the device cache off: the mesh
    stream, which a cluster refuses with a named error."""
    from spark_tpu_torch.tpch.queries import QUERIES
    confs = (("spark_tpu.sql.execution.streamingChunkRows", 1024),
             ("spark_tpu.sql.io.deviceCacheBytes", 0))
    for k, v in confs:
        session.conf.set(k, v)
    try:
        QUERIES["q1"](session).collect()
    except Exception as e:  # noqa: BLE001 — the test reads it
        return f"{type(e).__name__}: {e}"
    finally:
        for k, _v in confs:
            session.conf.unset(k)
    return None


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
