"""The mesh across engine processes (`spark_tpu_torch/parallel/cluster.py`)
on the CPU: two engine processes, each with two shards pinned to the CPU,
joined over gloo by `spark_tpu_torch.parallel.launch.run_cluster`, run
every `dryrun_mesh` case at mesh.size 4 (`tests/torch_cluster_programs.py`
`dryrun`). Each process's result of each case must be byte-equal to the
port's one-process mesh-4 run and equal to the JAX package's mesh-4 run
on its virtual CPU devices (ints, strings and validity exactly, floats
within a relative 1e-9, in the reference's row order). Also here: the
port's twin of `tests/test_rules.py::test_init_distributed_mocked`, the
bytes an all_to_all moves across processes, the per-rank event logs and
metrics files, the named refusal of a drain that would leave a process
without a mesh position, and
failures armed in one process outside the `mesh` seam (a fatal fault
at `stage_run`, a stage timeout only one process's conf sets), which
both processes must leave alike within 30 s, and the loss of a peer
whose store heartbeat stops while a wait is pending. TPC-H, the re-plan
loop, the `mesh` seam's faults and a killed peer are in
`test_torch_cluster_tpch.py`."""

import os
from types import SimpleNamespace

import pytest

from spark_tpu import functions as RF
from spark_tpu.session import SparkTpuSession as RefSession
from spark_tpu.window import Window as RefWindow
from spark_tpu_torch import config as port_config
from spark_tpu_torch.parallel import cluster
from spark_tpu_torch.parallel import mesh as M
from spark_tpu_torch.parallel.dryrun import dryrun_cases, dryrun_mesh

from torch_cluster_parity import assert_close, run_ok
import torch_cluster_programs as CP

MESH = "spark_tpu.sql.mesh.size"
N = 4
CASES = [name for name, _b, _s in dryrun_cases()]
REF = SimpleNamespace(F=RF, col=RF.col, Window=RefWindow)


@pytest.fixture(scope="module")
def dryrun_cluster(tmp_path_factory):
    base = tmp_path_factory.mktemp("cluster_dryrun")
    logs = str(base / "logs")
    return run_ok("dryrun", str(base / "run"), {"log_dir": logs}), logs


@pytest.fixture(scope="module")
def one_process():
    """The port's one-process mesh-4 result of every case."""
    tables = {}
    dryrun_mesh(N, "cpu", tables=tables)
    return tables


def test_init_distributed_twin(monkeypatch):
    """One `init_process_group` call over tcp://host0:8476 with world
    size 2 and rank 1, idempotent, returning the global device count
    (every process's local count gathered); a no-op without a
    coordinator (the port of `test_init_distributed_mocked`)."""
    import torch.distributed as dist
    calls = []

    def fake_init(backend, init_method=None, world_size=None, rank=None,
                  timeout=None):
        calls.append((backend, init_method, world_size, rank))

    monkeypatch.setattr(dist, "init_process_group", fake_init)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(cluster, "_CLUSTER", None)
    monkeypatch.setattr(cluster.Cluster, "all_gather_object",
                        lambda self, obj, what="": [obj] * self.world)
    # the heartbeat dials the coordinator's store, which is not there
    monkeypatch.setattr(cluster.Cluster, "start_heartbeat",
                        lambda self: None)
    conf = port_config.Conf()
    conf.set(MESH, 4)
    assert M.init_distributed(conf, "cpu") == 4  # no coordinator: local
    assert calls == []
    conf.set("spark_tpu.sql.cluster.coordinator", "host0:8476")
    conf.set("spark_tpu.sql.cluster.numProcesses", 2)
    conf.set("spark_tpu.sql.cluster.processId", 1)
    assert M.init_distributed(conf, "cpu") == 4  # 2 a process, gathered
    assert M.init_distributed(conf, "cpu") == 4
    assert calls == [("gloo", "tcp://host0:8476", 2, 1)]
    assert cluster.current().rank == 1 and cluster.process_rank() == 1


def test_cluster_keys_validate_the_rank():
    conf = port_config.Conf()
    conf.set("spark_tpu.sql.cluster.coordinator", "127.0.0.1:1")
    conf.set("spark_tpu.sql.cluster.numProcesses", 2)
    conf.set("spark_tpu.sql.cluster.processId", 2)
    with pytest.raises(ValueError, match="not a rank"):
        cluster.cluster_spec(conf)


@pytest.mark.parametrize("i", range(len(CASES)))
def test_case_equals_the_one_process_mesh(dryrun_cluster, one_process, i):
    res, _logs = dryrun_cluster
    for r in res:
        assert r.report["done"] == CASES
        assert r.results[f"case{i}"].equals(one_process[CASES[i]]), \
            (r.rank, CASES[i])


@pytest.mark.parametrize("i", range(len(CASES)))
def test_case_matches_the_jax_mesh(dryrun_cluster, i):
    res, _logs = dryrun_cluster
    _name, build, _sort = dryrun_cases()[i]
    ref = RefSession(register_active=False)
    ref.conf.set(MESH, N)
    want = build(ref, REF).collect()
    for r in res:
        assert_close(r.results[f"case{i}"], want)


def test_all_to_all_moves_only_the_received_blocks(dryrun_cluster):
    """Each process receives, of the other process's [4, block] send
    buffers, only the two rows its own shards take: half of what the
    peer's shards deposited (a broadcast of the buffers would move all
    of it), and its result equals the other process's."""
    res, _logs = dryrun_cluster
    stats = [r.report["exchange_stats"]["all_to_all e0"] for r in res]
    for me, peer in ((0, 1), (1, 0)):
        sent, received, calls, _s, deposited = stats[me]
        assert calls == 1
        assert received == stats[peer][4] // 2 == stats[peer][0]
        assert sent == deposited // 2
    assert res[0].results["exchange"].equals(res[1].results["exchange"])
    assert res[0].report["exchange_plan"] == res[1].report["exchange_plan"]
    assert "HashPartitioning" in res[0].report["exchange_plan"]


def test_event_log_and_metrics_are_per_rank(dryrun_cluster):
    """Two processes with one conf write one event-log and metrics
    directory: each its own files (`-r<rank>`), read back per rank."""
    from spark_tpu_torch.history import read_event_log
    res, logs = dryrun_cluster
    names = sorted(os.listdir(logs))
    for r in res:
        assert any(n.startswith("app-") and n.endswith(f"-r{r.rank}.jsonl")
                   for n in names), names
        assert f"metrics-r{r.rank}.jsonl" in names
        assert r.report["logged_queries"] == len(
            read_event_log(logs, rank=r.rank)) > 0
    assert len(read_event_log(logs)) == sum(
        r.report["logged_queries"] for r in res)


def test_decommission_refused_on_a_cluster():
    """On a cluster a drain is requested as in one process (each process
    its own request, agreed at the next chunk boundary); the drain
    refused is one that would leave a process without a mesh position:
    a named AnalysisError, raised in every process alike from the agreed
    request, with no conf changed."""
    from spark_tpu_torch import SparkTpuSession
    from spark_tpu_torch.expr import AnalysisError
    from spark_tpu_torch.parallel import elastic as EL

    class Peer:
        rank, world, pool_sizes = 0, 2, [2, 2]

        def all_gather_object(self, obj, what=""):
            return [obj, [1]]  # the peer asks for position 1

    s = SparkTpuSession.builder().device("cpu").get_or_create()
    s.conf.set("spark_tpu.sql.cluster.coordinator", "127.0.0.1:1")
    s.conf.set("spark_tpu.sql.cluster.numProcesses", 2)
    s.conf.set(MESH, N)
    s.decommission_shards([0])
    assert s.conf.get(EL.DECOMMISSION_KEY) == "0"
    mesh = M.Mesh(["cpu", "cpu", None, None], [0, 1, 2, 3], [0, 0, 1, 1],
                  cluster=Peer(), backend="gloo")
    with pytest.raises(AnalysisError, match=r"\[0, 1\] refused: it would "
                       r"leave cluster process\(es\) \[0\]"):
        EL.pending_decommission(s.conf, mesh)
    assert s.conf.get(EL.DECOMMISSION_KEY) == "0"
    assert s.conf.get(EL.EXCLUDE_KEY) == "" and int(s.conf.get(MESH)) == N


def test_failure_outside_the_mesh_seam_ends_both_alike(tmp_path):
    """A fault at `stage_run` and a stage timeout, each armed in rank 1
    only: both processes leave each with the same outcome within 30 s
    (the first error written under the abort key, or the same retried
    result), and the cluster then runs a query to the same result."""
    res = run_ok("seams", str(tmp_path / "run"))
    runs = [r.report["runs"] for r in res]
    for label in ("stage_run", "timeout"):
        a, b = (dict(rr[label]) for rr in runs)
        assert a.pop("wall_s") < 30.0 and b.pop("wall_s") < 30.0
        assert a == b, (label, a, b)
    assert runs[0]["timeout"]["error"] == "StageTimeoutError"
    assert "in process 1" in runs[0]["timeout"]["message"]
    assert res[0].results["after"].equals(res[1].results["after"])
    assert res[0].results["after"].num_rows == CP.RANGE_MOD


def test_silent_peer_is_lost_while_a_wait_is_pending(monkeypatch):
    """A peer whose store heartbeat stops while this process waits on a
    collective that never completes (what an NCCL wait on a dead peer
    sees: it does not fail by itself) is lost after PEER_SILENCE_S: the
    wait raises ClusterPeerLostError and leaves the work abandoned."""
    import time

    class Store:
        def check(self, keys):
            return True

        def multi_get(self, keys):
            return [b"7" for _ in keys]  # a heartbeat that never moves

    class Work:
        def is_completed(self):
            return False

    monkeypatch.setattr(cluster, "HEARTBEAT_S", 0.05)
    monkeypatch.setattr(cluster, "PEER_SILENCE_S", 0.3)
    cl = cluster.Cluster(("127.0.0.1:1", 2, 0), 0.0, 600.0)
    cl._peer_store = Store()
    monkeypatch.setattr(cl, "check_abort", lambda what: None)
    work = Work()
    t0 = time.monotonic()
    with pytest.raises(cluster.ClusterPeerLostError,
                       match="process 1 wrote no heartbeat"):
        cl._wait(work, "test", "group")
    assert 0.3 <= time.monotonic() - t0 < 5.0
    assert cl.lost and cl._abandoned == [("group", work)]
    with pytest.raises(cluster.ClusterPeerLostError):
        cl.group("gloo")  # every later collective raises at once
