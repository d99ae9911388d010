"""The mesh's failure handling against the JAX package (the mesh cases of
`tests/test_faults.py:225-290`), on the CPU over TPC-H SF 0.002: a fault
at the `mesh` site re-plans on one device (`mesh_fallback`) and keeps
the golden; with the fallback off it surfaces; a `shuffle` fault
retries; a short device pool raises its setup diagnostic. Then the
port's own: a shard that raises ends the query (no hang), a rendezvous
that times out and a failed peer copy are mesh failures, and a scan past
the device budget streams per shard."""

import threading
import time
import warnings

import pyarrow as pa
import pytest

from spark_tpu.testing import faults as ref_faults
from spark_tpu.testing.faults import FaultInjected as RefFaultInjected
from spark_tpu.tpch import queries as RQ
from spark_tpu_torch.execution.failures import is_mesh_failure
from spark_tpu_torch.parallel import mesh as M
from spark_tpu_torch.plan import physical as P
from spark_tpu_torch.testing import faults
from spark_tpu_torch.testing.faults import FaultInjected
from spark_tpu_torch.tpch import queries as PQ
from torch_mesh_parity import MESH
from torch_sql_parity import (assert_tables_match, check_golden, sessions,
                              write_data)

FALLBACK = "spark_tpu.execution.meshFallback.enabled"
RESTART = "spark_tpu.execution.meshRestart.enabled"
BACKOFF = "spark_tpu.execution.backoffMs"


@pytest.fixture(scope="module")
def tpch_path(tmp_path_factory):
    return write_data(tmp_path_factory, 0.002)


@pytest.fixture(autouse=True)
def quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the ladder's warnings
        yield


def _pair(path, tag):
    port, ref = sessions(path, tag, confs=((MESH, 8), (BACKOFF, 1)))
    # these cases hold the one-device fallback rung: the gang restart
    # before it would take the fault first, in both packages
    for s in (port, ref):
        s.conf.set(RESTART, False)
    return port, ref


@pytest.mark.parametrize("qname", ["q1", "q3"])
def test_mesh_failure_falls_back_single_device(tpch_path, qname):
    port, ref = _pair(tpch_path, f"mf_{qname}")
    with faults.inject(port.conf, "mesh:fatal:1") as plan:
        pqe = PQ.QUERIES[qname](port)._qe()
        got = pqe.collect()
        assert plan.fired_log == [("mesh", 1, "fatal")]
    with ref_faults.inject(ref.conf, "mesh:fatal:1"):
        rqe = RQ.QUERIES[qname](ref)._qe()
        want = rqe.collect()
    assert pqe.fault_summary.get("mesh_fallback") == 1 == \
        rqe.fault_summary.get("mesh_fallback")
    assert pqe.last_metrics.get("mesh_fallback") == 1
    assert "ExchangeExec(Hash" not in pqe.executed_plan.tree_string()
    assert_tables_match(got, want)
    check_golden(got, qname, tpch_path)


def test_mesh_misconfiguration_surfaces(tpch_path):
    """The 'devices visible' diagnostic of a mesh with no device given
    and too few cards is a setup error: it surfaces with its hint and
    never degrades to one device through the mesh fallback."""
    port, ref = _pair(tpch_path, "mcfg")
    port.device_pinned = False  # as if built without a device
    for s in (port, ref):
        s.conf.set(MESH, 64)
    with pytest.raises(RuntimeError, match="devices visible"):
        port.range(100).agg(PQ.F.sum(PQ.col("id")).alias("s")).collect()
    with pytest.raises(RuntimeError, match="devices visible"):
        ref.range(100).agg(RQ.F.sum(RQ.col("id")).alias("s")).collect()
    assert not is_mesh_failure(RuntimeError(
        "mesh.size=64 but only 0 devices visible"))


def test_mesh_fallback_disabled_surfaces(tpch_path):
    port, ref = _pair(tpch_path, "mfd")
    for s in (port, ref):
        s.conf.set(FALLBACK, False)
    with faults.inject(port.conf, "mesh:fatal:1"):
        with pytest.raises(FaultInjected, match="INTERNAL"):
            PQ.QUERIES["q1"](port).collect()
    with ref_faults.inject(ref.conf, "mesh:fatal:1"):
        with pytest.raises(RefFaultInjected, match="INTERNAL"):
            RQ.QUERIES["q1"](ref).collect()


def test_shuffle_fault_retries_under_mesh(tpch_path):
    port, ref = _pair(tpch_path, "shf")
    with faults.inject(port.conf, "shuffle:unavailable:1") as plan:
        pqe = PQ.QUERIES["q1"](port)._qe()
        got = pqe.collect()
        assert plan.fired_log == [("shuffle", 1, "unavailable")]
    with ref_faults.inject(ref.conf, "shuffle:unavailable:1"):
        rqe = RQ.QUERIES["q1"](ref)._qe()
        want = rqe.collect()
    assert pqe.fault_summary.get("transient_retry", 0) >= 1
    assert rqe.fault_summary.get("transient_retry", 0) >= 1
    assert "mesh_fallback" not in pqe.fault_summary
    assert_tables_match(got, want)
    check_golden(got, "q1", tpch_path)


def test_shard_error_ends_the_query(tpch_path, monkeypatch):
    """A shard that raises before a collective releases the others: the
    query ends with the shard's own error, fast, and no shard thread is
    left behind."""
    port, _ = _pair(tpch_path, "sherr")
    port.conf.set(FALLBACK, False)
    orig = P.FilterExec.compute

    def boom(self, ctx, inputs):
        if ctx.axis_index() == 3:
            raise ValueError("shard 3 failed")
        return orig(self, ctx, inputs)

    monkeypatch.setattr(P.FilterExec, "compute", boom)
    before = threading.active_count()
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="shard 3 failed"):
        PQ.QUERIES["q3"](port).collect()
    assert time.monotonic() - t0 < 30
    assert threading.active_count() == before


def test_rendezvous_timeout_is_a_mesh_failure():
    mesh = M.Mesh(["cpu"] * 4)

    def fn(i, group):
        if i == 1:
            time.sleep(2.0)  # misses the rendezvous
            return None
        return group.exchange(i, i)

    t0 = time.monotonic()
    with pytest.raises(M.MeshCollectiveError, match="collective") as e:
        M.run_on_shards(mesh, fn, timeout_s=0.5)
    assert time.monotonic() - t0 < 10
    assert is_mesh_failure(e.value)
    assert M.run_on_shards(mesh, lambda i, g: g.exchange(i, i * i)) == \
        [[0, 1, 4, 9]] * 4


def test_peer_copy_failure_takes_the_fallback(tpch_path, monkeypatch):
    """A failed peer copy is a mesh failure: the fallback rung re-plans
    on one device (recorded, never silent), and with the rung off the
    query fails with the collective's error."""
    port, _ = _pair(tpch_path, "pcopy")
    orig = M.gather_to
    calls = {"n": 0}

    def flaky(values, device, what):
        calls["n"] += 1
        if what.startswith("all_to_all") and calls["n"] > 2:
            raise M.MeshCollectiveError(
                f"collective {what}: peer copy from shard 1 to {device} "
                f"failed: RuntimeError: injected")
        return orig(values, device, what)

    monkeypatch.setattr(M, "gather_to", flaky)
    qe = PQ.QUERIES["q1"](port)._qe()
    got = qe.collect()
    assert qe.fault_summary.get("mesh_fallback") == 1
    assert qe.last_metrics.get("mesh_fallback") == 1
    check_golden(got, "q1", tpch_path)
    port.conf.set(FALLBACK, False)
    calls["n"] = 0
    with pytest.raises(M.MeshCollectiveError, match="peer copy"):
        PQ.QUERIES["q1"](port).collect()


def test_mesh_stream_is_not_yet_ported(tpch_path):
    """A scan past the device budget streams per shard on the mesh (the
    name is from before the mesh stream was ported, when such a plan
    raised): the spliced plan holds the per-shard partials, the result
    passes the golden and equals the one-device stream's rows."""
    port, _ = _pair(tpch_path, "mstream")
    port.conf.set("spark_tpu.sql.execution.streamingChunkRows", 1024)
    port.conf.set("spark_tpu.sql.io.deviceCacheBytes", 0)
    qe = PQ.QUERIES["q1"](port)._qe()
    got = qe.collect()
    assert "InputExec(streamed_partial_agg," in \
        qe.spliced_plan.tree_string()
    assert qe.fault_summary == {}
    check_golden(got, "q1", tpch_path)
    port.conf.set(MESH, 0)  # one device streams it
    one = PQ.QUERIES["q1"](port).collect()
    check_golden(one, "q1", tpch_path)
    assert_tables_match(got, one)
