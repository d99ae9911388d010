"""The elastic mesh across engine processes on the CPU: two engine
processes with two shards each pinned to the CPU, over gloo, at mesh.size
4, stream TPC-H SF 0.002 in 1,024-row chunks with the device cache off
(`tests/torch_cluster_programs.py` `drain`, `straggler`, `stream_faults`,
`stream_killed`; one launch each). Each result is held to the port's
one-process mesh-4 run (byte-equal) and the JAX package's mesh-4 run
(ints and decimals exactly, floats within a relative 1e-9), both under
the same request or fault where the case has one.

- A drain of position 3, requested in rank 1 alone mid-stream: both
  processes drain at the same chunk with the same fault summary and
  `rec_chunks_replayed`, and the next query runs on 3 shards in both.
- A drain of positions 2 and 3 would leave rank 1 without a position:
  the named AnalysisError in both, nothing excluded.
- Position 3 slowed at the `shard_chunk` seam in rank 1 alone: both
  processes flag it at the same chunk and move the same rows.
- A shard lost at a checkpoint in rank 1 alone: both gang-restart from
  the same cursor; with the restart budget spent both land on the
  single-device rung with the same result.
- Rank 1 killed with SIGKILL mid-stream: rank 0 raises
  `ClusterPeerLostError` within 30 s.

And, with no process started: the agreed drain, the cluster's healthy
device count and the refusal, on a stand-in cluster.
"""

import warnings
from types import SimpleNamespace

import pytest

from spark_tpu_torch.config import Conf
from spark_tpu_torch.expr import AnalysisError
from spark_tpu_torch.parallel import cluster
from spark_tpu_torch.parallel import elastic as EL
from spark_tpu_torch.parallel.mesh import Mesh

import torch_cluster_programs as CP
import torch_ooc_parity as H
from torch_cluster_parity import assert_close, run_cpu_cluster, run_ok
from torch_elastic_parity import both

#: seconds within which the survivor of a killed peer raises
BOUND_S = 30.0


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return H.Pair(H.write_data(tmp_path_factory, "cluster_elastic"),
                  "cluster_elastic")


@pytest.fixture(autouse=True)
def streaming(pair):
    pair.reset()
    yield
    pair.reset()


def q1(session):
    return H.query("q1")(session)._qe()


def run(program, tmp_path, pair, **kw):
    res = run_ok(program, str(tmp_path / program), {"path": pair.path}, **kw)
    return [r.report["runs"] for r in res], res


def clean_q1(pair):
    """The port's and the JAX package's clean mesh-4 Q1 streams."""
    port, _ref = both(pair, q1, confs=((CP.MESH, CP.N_SHARDS),))
    return port.got, _ref.got


def same_in_both(runs, label, keys=("faults", "events", "delta",
                                    "chunks", "error", "message")):
    a, b = (rr[label] for rr in runs)
    for k in keys:
        assert a.get(k) == b.get(k), (label, k, a.get(k), b.get(k))
    return a


def test_drain_requested_in_one_process_drains_both(pair, tmp_path):
    """(b) and (c)."""
    from spark_tpu_torch.observability import QueryListener as PortL
    from spark_tpu.observability import QueryListener as RefL

    def drained(session):
        base = PortL if isinstance(session, type(pair.port)) else RefL

        class Drainer(base):
            done = False

            def on_shard_records(self, e):
                if not self.done and e.chunk >= 1:
                    self.done = True
                    session.decommission_shards([CP.DRAIN_POSITION])

        drainer = Drainer()
        session.add_listener(drainer)
        try:
            qe = q1(session)
            got[session is pair.port] = qe.collect()
        finally:
            session.remove_listener(drainer)
        return qe

    got = {}
    port, ref = both(pair, drained, confs=(
        (CP.MESH, CP.N_SHARDS), (CP.CKPT, 2), (CP.SPANS, "on")),
        collect=False)
    port.got, ref.got = got[True], got[False]
    assert_close(port.got, ref.got)
    runs, res = run("drain", tmp_path, pair)
    drain = same_in_both(runs, "drain")
    assert drain["faults"] == port.qe.fault_summary == {
        "decommission": 1, "checkpoint_restore": 1}
    restore = [ev for ev in port.qe.fault_events
               if ev["action"] == "checkpoint_restore"]
    assert [ev for ev in drain["events"]
            if ev["action"] == "checkpoint_restore"] == restore
    assert drain["delta"]["rec_chunks_replayed"] == \
        port.delta["rec_chunks_replayed"]
    for rr in runs:
        assert rr["drain"]["after"] == {CP.MESH: "3", CP.EXCLUDE: "3",
                                        CP.DRAIN: ""}
    # the drained gang: rank 0 keeps positions 0 and 1, rank 1 position 2
    cursor = restore[0]["cursor"]
    mine = [{int(p) for c, per in rr["drain"]["shards_by_chunk"].items()
             if int(c) >= cursor for p in per} for rr in runs]
    assert mine == [{0, 1}, {2}]
    after = [{int(p) for per in rr["after"]["shards_by_chunk"].values()
              for p in per} for rr in runs]
    assert after == [{0, 1}, {2}]
    for r in res:
        assert r.results["drain"].equals(port.got)
        assert_close(r.results["drain"], ref.got)
    assert res[0].results["after"].equals(res[1].results["after"])
    # (c): refused in both, before anything is excluded or cleared
    refused = same_in_both(runs, "refused")
    assert refused["error"] == "AnalysisError"
    assert "would leave cluster process(es) [1] without a mesh " \
        "position" in refused["message"]
    assert [rr["refused"]["after"] for rr in runs] == [
        {CP.MESH: "4", CP.EXCLUDE: "", CP.DRAIN: ""},
        {CP.MESH: "4", CP.EXCLUDE: "", CP.DRAIN: "2,3"}]


def test_straggler_flagged_alike_in_both(pair, tmp_path):
    """(d): the same flag at the same chunk and the same rows moved in
    both processes, as many as the one-process mesh moves under the same
    slowed position."""
    hit = CP.SLOW_POSITION + 1
    spec = ",".join(f"shard_chunk:slow:{c * CP.N_SHARDS + hit}:{CP.SLOW_MS}"
                    for c in range(CP.MAX_CHUNKS))
    port, ref = both(pair, q1, spec, ((CP.MESH, CP.N_SHARDS),
                                      (CP.SPANS, "on")) + CP.STRAGGLER)
    runs, res = run("straggler", tmp_path, pair)
    st = same_in_both(runs, "straggler", ("faults", "events", "delta",
                                          "chunks", "flags"))
    assert st["faults"] == port.qe.fault_summary == {"shard_rebalance": 1}
    assert st["flags"] and all(f[0] == CP.SLOW_POSITION
                               for f in st["flags"])
    assert st["delta"]["rebalance_rows"] == port.delta["rebalance_rows"] > 0
    moved = runs[1]["straggler"]["shards_by_chunk"]
    rows3 = [per[str(CP.SLOW_POSITION)] for _c, per in sorted(
        moved.items(), key=lambda kv: int(kv[0]))]
    assert rows3[0] == 256 and min(rows3) <= 128
    for r in res:
        assert r.results["straggler"].equals(port.got)
        assert_close(r.results["straggler"], ref.got)


def test_fault_in_one_process_restarts_both_from_one_checkpoint(
        pair, tmp_path):
    """(e): `mesh_checkpoint:fatal:2` in rank 1 alone, a checkpoint every
    2 chunks: one gang restart in both, resumed at the same cursor,
    replaying at most 2 chunks; with maxRestarts 0 both take the
    single-device rung and resume from the same checkpoint."""
    clean, want = clean_q1(pair)
    runs, res = run("stream_faults", tmp_path, pair)
    restart = same_in_both(runs, "restart")
    assert restart["faults"] == {"mesh_restart": 1,
                                 "checkpoint_restore": 1}
    (ev,) = [e for e in restart["events"]
             if e["action"] == "checkpoint_restore"]
    assert ev["driver"] == "mesh" and ev["cursor"] == 2
    assert 0 < ev["chunks_replayed"] <= 2
    assert restart["delta"]["rec_chunks_replayed"] == ev["chunks_replayed"]
    spent = same_in_both(runs, "spent")
    assert spent["faults"] == {"mesh_fallback": 1, "checkpoint_restore": 1}
    assert "InputExec(spilled_partials," in spent["spliced"]
    assert runs[1]["restart"]["fired"] == [["mesh_checkpoint", 2, "fatal"]]
    assert runs[0]["restart"]["fired"] == []
    for r in res:
        assert r.results["restart"].equals(clean)
        assert_close(r.results["restart"], want)
        assert_close(r.results["spent"], want)
    assert res[0].results["spent"].equals(res[1].results["spent"])


def test_killed_peer_mid_stream_ends_the_survivor(pair, tmp_path):
    """(f): rank 1 killed with SIGKILL while it sleeps mid-stream; rank 0
    raises the named loss at its next chunk boundary."""
    res = run_cpu_cluster("stream_killed", str(tmp_path / "run"),
                          {"path": pair.path}, kill_at=(1, "stream", 1.0))
    survivor, killed = res
    assert killed.returncode == -9
    assert survivor.returncode == 0, survivor.log
    assert survivor.report["outcome"] == "ClusterPeerLostError", \
        survivor.report
    assert 0 <= survivor.report["raised_at"] - killed.report["killed_at"] \
        < BOUND_S


# -- with no process started ---------------------------------------------------

class StandIn:
    """A two-process cluster seen from one rank: `all_gather_object`
    answers with the objects the test gives for every rank."""

    def __init__(self, rank, peers, pool_sizes=(2, 2)):
        self.rank, self.world = rank, 2
        self.pool_sizes = list(pool_sizes)
        self.peers = peers
        self.calls = []

    def all_gather_object(self, obj, what=""):
        self.calls.append(what)
        return [obj if r == self.rank else self.peers for r in range(2)]


def stand_in_mesh(cl, conf):
    """Rank 0's view of a mesh of 4 over two processes of two shards."""
    conf.set(CP.MESH, 4)
    return Mesh(["cpu", "cpu", None, None], [0, 1, 2, 3], [0, 0, 1, 1],
                cluster=cl, backend="gloo")


def test_agreed_drain_is_every_process_request():
    """A drain pending in the peer alone is drained here too, at the
    same boundary: one gather, the union of the requests."""
    conf = Conf()
    cl = StandIn(0, [3])
    mesh = stand_in_mesh(cl, conf)
    assert EL.pending_decommission(conf, mesh) == ((3,), (3,))
    assert cl.calls == ["decommission"]
    conf.set(CP.DRAIN, "1")
    assert EL.pending_decommission(conf, mesh) == ((1, 3), (1, 3))
    cl.peers = []
    assert EL.pending_decommission(conf, mesh) == ((1,), (1,))
    conf.set(CP.DRAIN, "")
    assert EL.pending_decommission(conf, mesh) == ((), ())
    assert len(cl.calls) == 4  # every boundary gathers, pending or not


def test_cluster_healthy_device_count(monkeypatch):
    """The global pool less the exclusions, from the sizes the last mesh
    gathered; None before any mesh formed."""
    conf = Conf()
    conf.set(cluster.COORDINATOR_KEY, "127.0.0.1:1")
    conf.set(cluster.NUM_PROCESSES_KEY, 2)
    conf.set(cluster.PROCESS_ID_KEY, 0)
    conf.set(CP.MESH, 4)
    cl = SimpleNamespace(pool_sizes=None)
    monkeypatch.setattr(cluster, "_CLUSTER", cl)
    assert EL.healthy_device_count(conf, "cpu", 2) is None
    cl.pool_sizes = [2, 2]
    assert EL.healthy_device_count(conf, "cpu", 2) == 4
    conf.set(CP.EXCLUDE, "3,9")  # an id past the pool counts for nothing
    assert EL.healthy_device_count(conf, "cpu", 2) == 3
    EL.apply_decommission(conf, [1], "cpu", 2)
    assert conf.get(CP.EXCLUDE) == "1,3,9"
    assert int(conf.get(CP.MESH)) == 2


def test_drain_emptying_a_process_is_refused_alike():
    """Positions 2 and 3 are rank 1's: draining both (one requested in
    each process) raises the named error, and no conf changes."""
    conf = Conf()
    conf.set(CP.DRAIN, "2")
    cl = StandIn(0, [3])
    mesh = stand_in_mesh(cl, conf)
    with pytest.raises(AnalysisError, match=r"process\(es\) \[1\] without "
                       r"a mesh position"):
        EL.pending_decommission(conf, mesh)
    assert conf.get(CP.DRAIN) == "2" and conf.get(CP.EXCLUDE) == ""
    assert int(conf.get(CP.MESH)) == 4
    # one of rank 1's positions may go
    cl.peers = []
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert EL.pending_decommission(conf, mesh) == ((2,), (2,))
