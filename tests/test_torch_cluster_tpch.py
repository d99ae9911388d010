"""TPC-H and the failure paths on a two-process CPU cluster at mesh.size 4
(`tests/torch_cluster_programs.py` `tpch`, `faults`, `killed`; see
`test_torch_cluster.py` for the setup). TPC-H Q1, Q3, Q5 and Q6 (the
DataFrame programs) and the range group-by at SF 0.002: each process's
result byte-equal to the port's one-process mesh-4 run and equal to the
JAX package's mesh-4 run. A skewed shuffle join whose receive buckets
overflow: both processes grow the blocks alike (same attempts, same
executed plan as one process), and with the skew re-plan on both
re-plan it to broadcast. A fault at the `mesh` seam in one process:
both gang-restart to the right result, or with the rungs off both raise
it, within 30 s. A peer killed with SIGKILL mid-query: the survivor
raises `ClusterPeerLostError` within 30 s. The mesh stream on a cluster:
Q1 and Q6 past streamingChunkRows (1,024-row chunks, the device cache
off) stream per shard in both processes, each process's result
byte-equal to the one-process mesh-4 stream and equal to the JAX
package's mesh-4 stream. The drain, the straggler, the checkpointed
restart and a peer killed mid-stream are in
`test_torch_cluster_elastic.py`."""

import pytest

from spark_tpu import functions as RF
from spark_tpu.session import SparkTpuSession as RefSession
from spark_tpu.tpch import queries as RQ
from spark_tpu_torch import SparkTpuSession
from spark_tpu_torch.tpch import queries as PQ

import torch_cluster_programs as CP
from torch_cluster_parity import assert_close, run_cpu_cluster, run_ok
from torch_sql_parity import write_data

SF = 0.002
NAMES = CP.TPCH_QUERIES + ("range", "skew_broadcast", "skew_grow") \
    + CP.STREAMED
#: seconds within which every process leaves a failed cluster run
BOUND_S = 30.0


def _programs(port: bool):
    """Each case's DataFrame builder for a session of the port or of the
    JAX package."""
    Q = PQ if port else RQ
    ns = None if port else RF
    progs = {q: (lambda s, q=q: Q.QUERIES[q](s)) for q in CP.TPCH_QUERIES}
    progs["range"] = lambda s: CP.range_program(s, ns)
    progs["skew_grow"] = lambda s: CP.skew_program(s, ns)
    progs["skew_broadcast"] = lambda s: CP.skew_program(s, ns)
    for name in CP.STREAMED:
        progs[name] = progs[name.split("_")[1]]
    return progs


CONFS = {"skew_grow": ((CP.BCAST, 0), (CP.SKEW_LIMIT, 1)),
         "skew_broadcast": ((CP.BCAST, 0),),
         **{name: CP.STREAMING for name in CP.STREAMED}}


def _run_local(session, name, build):
    for k, v in CONFS.get(name, ()):
        session.conf.set(k, v)
    try:
        qe = build(session)._qe()
        return qe.collect(), qe
    finally:
        for k, _v in CONFS.get(name, ()):
            session.conf.unset(k)


def _sessions(path):
    fact, dim = CP.skew_tables()
    port = SparkTpuSession.builder().device("cpu").get_or_create()
    ref = RefSession(register_active=False)
    PQ.register_tables(port, path)
    RQ.register_tables(ref, path)
    for s in (port, ref):
        s.register_table("skew_fact", fact)
        s.register_table("skew_dim", dim)
        s.conf.set(CP.MESH, CP.N_SHARDS)
    return port, ref


@pytest.fixture(scope="module")
def tpch_path(tmp_path_factory):
    return write_data(tmp_path_factory, SF)


@pytest.fixture(scope="module")
def tpch_cluster(tpch_path, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("cluster_tpch"))
    return run_ok("tpch", out, {"path": tpch_path})


@pytest.fixture(scope="module")
def references(tpch_path):
    """The port's one-process mesh-4 run and the JAX package's, by case
    name: (port table, port qe, reference table)."""
    port, ref = _sessions(tpch_path)
    mine, theirs = _programs(True), _programs(False)
    out = {}
    for name in NAMES:
        got, qe = _run_local(port, name, mine[name])
        want, _rqe = _run_local(ref, name, theirs[name])
        out[name] = (got, qe, want)
    return out


@pytest.mark.parametrize("name", NAMES)
def test_result_equals_one_process_and_matches_jax(tpch_cluster,
                                                    references, name):
    one, _qe, want = references[name]
    for r in tpch_cluster:
        got = r.results[name]
        assert got.equals(one), (r.rank, name)
        assert_close(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_processes_run_the_one_process_plan(tpch_cluster, references,
                                            name):
    """Both processes converge on the one-process mesh's executed plan in
    as many attempts (the agreed flags drive one re-plan loop)."""
    _one, qe, _want = references[name]
    plans = [r.report["plans"][name] for r in tpch_cluster]
    for p in plans:
        assert p["plan"] == qe.executed_plan.tree_string(), name
        assert p["attempts"] == qe.attempts, name
        assert p["faults"] == {}
    assert "ExchangeExec(" in plans[0]["plan"]


def test_overflow_grows_blocks_in_both_processes(tpch_cluster):
    grow = [r.report["plans"]["skew_grow"] for r in tpch_cluster]
    assert grow[0]["attempts"] == grow[1]["attempts"] > 1
    assert "strategy=shuffle" in grow[0]["plan"]
    bcast = [r.report["plans"]["skew_broadcast"]["plan"]
             for r in tpch_cluster]
    assert all("strategy=broadcast" in p for p in bcast)


def test_mesh_stream_on_a_cluster(tpch_cluster, references):
    """Q1 and Q6 stream per shard in both processes (the spliced
    `InputExec(streamed_partial_agg,...)`), over as many chunks as the
    one-process mesh-4 stream."""
    for name in CP.STREAMED:
        _one, qe, _want = references[name]
        assert "InputExec(streamed_partial_agg," in \
            qe.spliced_plan.tree_string()
        for r in tpch_cluster:
            plan = r.report["plans"][name]
            assert plan["spliced"] == qe.spliced_plan.tree_string(), name
            assert plan["chunks"] == CP.stream_chunks(qe) >= 1, name


def test_fault_in_one_process_gives_both_the_same_outcome(
        tmp_path, tpch_cluster):
    res = run_ok("faults", str(tmp_path / "run"))
    runs = [r.report["runs"] for r in res]
    for rr in runs:
        assert rr["restart"]["faults"] == {"mesh_restart": 1}
        assert rr["raise"]["error"] == "FaultInjected"
        assert "unrecoverable failure at mesh" in rr["raise"]["message"]
        assert rr["raise"]["wall_s"] < BOUND_S
    assert runs[0]["raise"]["message"] == runs[1]["raise"]["message"]
    want = tpch_cluster[0].results["range"]
    for r in res:
        assert r.results["restart"].equals(want)
        assert r.wall_s < 60.0


def test_killed_peer_ends_the_survivor(tmp_path):
    """Rank 1 is killed with SIGKILL while rank 0 waits at a collective
    of the same query: rank 0 raises the named mesh failure in time."""
    res = run_cpu_cluster("killed", str(tmp_path / "run"),
                          kill_at=(1, "query", 1.0))
    survivor, killed = res
    assert killed.returncode == -9
    assert survivor.returncode == 0, survivor.log
    assert survivor.report["outcome"] == "ClusterPeerLostError", \
        survivor.report
    assert "peer process lost" in survivor.report["message"]
    assert 0 <= survivor.report["raised_at"] - killed.report["killed_at"] \
        < BOUND_S
