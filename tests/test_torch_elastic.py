"""The elastic mesh of the port (`spark_tpu_torch/parallel/elastic.py`)
against the JAX package's: every case of `tests/test_elastic.py`, on the
CPU over TPC-H SF 0.002 (about 12,000 lineitem rows) in chunks of 1,024
rows with the device cache off, so every mesh query streams per shard.

The port runs at mesh 8 pinned to the CPU (8 shard threads, virtual
device ids 0-7), the JAX package at mesh 8 on its 8 virtual CPU
devices. Each case runs in both under the same conf and fault spec:
the results equal in row order (ints and decimals exactly, floats
within a relative 1e-9, as `tests/torch_mesh_parity.py` holds mesh
results), the same fault summaries and fired rules, the same counter
deltas (`rec_chunks_replayed`, `mesh_restart_attempts`,
`rebalance_rows`) and each package's golden. The cases: the gang
restart (from a checkpoint, without one, on a non-streamed plan, its
budget spent, disabled, with the fallback disabled, a collapsed pool),
the drain requests (stale, merged, unparseable, at a chunk boundary,
before the first chunk, a fault at its seam), the exclusions, a
fallback that must not stick across executions, the straggler
rebalance (its shift, disabled, its math and decay on seeded inputs,
rows preserved) and the actions in either package's history.
"""

import warnings

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

from spark_tpu import functions as RF
from spark_tpu import history as RH
from spark_tpu.config import Conf as RefConf
from spark_tpu.observability import QueryListener as RefListener
from spark_tpu.parallel import elastic as REL
from spark_tpu.parallel.mesh import get_mesh as ref_get_mesh
from spark_tpu_torch import SparkTpuSession
from spark_tpu_torch import functions as PF
from spark_tpu_torch import history as PH
from spark_tpu_torch.config import Conf as PortConf
from spark_tpu_torch.observability import QueryListener as PortListener
from spark_tpu_torch.parallel import elastic as PEL
from spark_tpu_torch.parallel.mesh import get_mesh as port_get_mesh

import torch_ooc_parity as H
from torch_elastic_parity import assert_rows_equal, both

MESH_KEY = "spark_tpu.sql.mesh.size"
CKPT_KEY = "spark_tpu.execution.checkpoint.everyChunks"
RESTART_KEY = "spark_tpu.execution.meshRestart.enabled"
RESTART_MAX_KEY = "spark_tpu.execution.meshRestart.maxRestarts"
DRAIN_KEY = "spark_tpu.execution.decommission.shards"
EXCLUDE_KEY = "spark_tpu.sql.mesh.excludeDevices"
SPANS_KEY = "spark_tpu.sql.observability.shardSpans"
REBALANCE_KEY = "spark_tpu.sql.straggler.rebalance.enabled"
DECAY_KEY = "spark_tpu.sql.straggler.rebalance.decayChunks"
FALLBACK_KEY = "spark_tpu.execution.meshFallback.enabled"
LOG_KEY = "spark_tpu.sql.eventLog.dir"
STRAGGLER = (("spark_tpu.sql.straggler.minChunks", 3),
             ("spark_tpu.sql.straggler.factor", 4.0))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return H.Pair(H.write_data(tmp_path_factory, "elastic"), "elastic")


@pytest.fixture(autouse=True)
def streaming(pair):
    pair.reset()
    yield
    pair.reset()


def is_port(session) -> bool:
    return isinstance(session, SparkTpuSession)


def q(name):
    mk = H.query(name)
    return lambda session: mk(session)._qe()


def group_sum(n_rows=16000, name="elastic_t", mod=13):
    """The JAX tests' `_mesh_stream_qe`: sum(v) by v % mod over an
    in-memory table of n_rows, 16 chunks of 1,024 rows."""
    pdf = pd.DataFrame({"v": np.arange(n_rows, dtype=np.int64)})

    def make(session):
        F = PF if is_port(session) else RF
        tag = "p" if is_port(session) else "r"
        session.register_table(f"{name}_{tag}", pdf)
        return (session.table(f"{name}_{tag}")
                .group_by((F.col("v") % mod).alias("k"))
                .agg(F.sum(F.col("v")).alias("s")))._qe()
    return make, pdf


def groupsum_parity(got, pdf, mod=13):
    got = got.to_pandas()
    want = pdf.assign(k=pdf.v % mod).groupby("k")["v"].sum()
    res = got.set_index("k")["s"].sort_index()
    assert (res == want).all(), (res, want)


def golden(pair, runs, qname):
    for r in runs:
        H.check_golden(r.got, qname, pair.path)


# -- gang restart ------------------------------------------------------------

def test_kill_one_host_converges_on_mesh(pair):
    """A shard lost mid-stream (fatal at the 2nd snapshot point)
    gang-restarts the mesh and resumes at the chunk-2 checkpoint on the
    mesh, replaying at most checkpoint.everyChunks chunks."""
    runs = both(pair, q("q1"), "mesh_checkpoint:fatal:2",
                ((MESH_KEY, 8), (CKPT_KEY, 2)))
    for r in runs:
        assert r.plan.fired_log == [("mesh_checkpoint", 2, "fatal")]
        assert r.qe.fault_summary.get("mesh_restart") == 1
        assert "mesh_fallback" not in r.qe.fault_summary
        assert r.qe.last_metrics.get("mesh_fallback") is None
        assert 0 < r.delta["rec_chunks_replayed"] <= 2
        assert r.delta["mesh_restart_attempts"] == 1
        assert r.delta["rec_ckpt_bytes"] > 0
        restore = next(ev for ev in r.qe.fault_events
                       if ev["action"] == "checkpoint_restore")
        assert restore["cursor"] == 2 and restore["driver"] == "mesh"
        assert restore["chunks_replayed"] <= 2
    assert "InputExec(streamed_partial_agg," in \
        runs[0].qe.spliced_plan.tree_string()
    golden(pair, runs, "q1")


def test_gang_restart_without_checkpoint_restarts_stream(pair):
    runs = both(pair, q("q1"), "mesh:fatal:1", ((MESH_KEY, 8),
                                                (CKPT_KEY, 0)))
    for r in runs:
        assert r.plan.fired_log == [("mesh", 1, "fatal")]
        assert r.qe.fault_summary.get("mesh_restart") == 1
        assert "mesh_fallback" not in r.qe.fault_summary
        assert "checkpoint_restore" not in r.qe.fault_summary
    golden(pair, runs, "q1")


def test_gang_restart_non_streamed_plan(pair):
    """Q3 (joins and exchanges, no mesh stream): a mesh fault restarts
    the gang instead of degrading."""
    runs = both(pair, q("q3"), "mesh:fatal:1", ((MESH_KEY, 8),))
    for r in runs:
        assert r.plan.fired_log == [("mesh", 1, "fatal")]
        assert r.qe.fault_summary.get("mesh_restart") == 1
        assert "mesh_fallback" not in r.qe.fault_summary
    golden(pair, runs, "q3")


def test_restart_budget_exhaustion_lands_single_device(pair):
    """`mesh_restart:fatal` kills the only restart attempt: the ladder
    lands on the single-device rung, which resumes from the checkpoint
    (resume_from_mesh_checkpoint)."""
    runs = both(pair, q("q1"), "mesh_checkpoint:fatal:2,mesh_restart:fatal:1",
                ((MESH_KEY, 8), (CKPT_KEY, 2), (RESTART_MAX_KEY, 1)))
    for r in runs:
        assert ("mesh_restart", 1, "fatal") in r.plan.fired_log
        assert r.qe.fault_summary.get("mesh_restart") == 1
        assert r.qe.fault_summary.get("mesh_fallback") == 1
        assert r.qe.last_metrics.get("mesh_fallback") == 1
        failed = next(ev for ev in r.qe.fault_events
                      if ev["action"] == "mesh_restart")
        assert failed.get("ok") is False and "INTERNAL" in failed["error"]
        assert r.qe.fault_summary.get("checkpoint_restore") == 1
    assert "InputExec(spilled_partials," in \
        runs[0].qe.spliced_plan.tree_string()
    golden(pair, runs, "q1")


def test_restarts_disabled_preserves_fallback(pair):
    runs = both(pair, q("q1"), "mesh:fatal:1",
                ((MESH_KEY, 8), (RESTART_KEY, False)))
    for r in runs:
        assert "mesh_restart" not in r.qe.fault_summary
        assert r.qe.fault_summary.get("mesh_fallback") == 1
    golden(pair, runs, "q1")


def test_restart_runs_even_with_fallback_disabled(pair):
    runs = both(pair, q("q1"), "mesh:fatal:1",
                ((MESH_KEY, 8), (FALLBACK_KEY, False)))
    for r in runs:
        assert r.qe.fault_summary.get("mesh_restart") == 1
        assert "mesh_fallback" not in r.qe.fault_summary
    golden(pair, runs, "q1")


def test_restart_skipped_when_pool_collapsed(pair, monkeypatch):
    """A healthy pool of <= 1 cannot hold a gang: no restart, straight
    to the single-device rung."""
    for mod in (PEL, REL):
        monkeypatch.setattr(mod, "healthy_device_count",
                            lambda *a, **k: 1)
    runs = both(pair, q("q1"), "mesh:fatal:1", ((MESH_KEY, 8),))
    for r in runs:
        assert "mesh_restart" not in r.qe.fault_summary
        assert r.qe.fault_summary.get("mesh_fallback") == 1
    golden(pair, runs, "q1")


# -- drain requests ----------------------------------------------------------

def test_stale_decommission_request_discarded(pair):
    make, pdf = group_sum(name="stale_t")
    pair.set((MESH_KEY, 8))
    for s in (pair.port, pair.ref):
        s.decommission_shards([9])  # 8-gang: no valid position
        with pytest.warns(UserWarning, match="stale decommission"):
            qe = make(s)
            got = qe.collect()
        assert "decommission" not in qe.fault_summary
        assert s.conf.get(DRAIN_KEY) == ""
        groupsum_parity(got, pdf)


def test_decommission_requests_merge(pair):
    for s in (pair.port, pair.ref):
        s.decommission_shards([1])
        s.decommission_shards([2])
        assert s.conf.get(DRAIN_KEY) == "1,2"


def test_unparseable_decommission_request_discarded(pair):
    make, pdf = group_sum(name="unparse_t")
    pair.set((MESH_KEY, 8), (DRAIN_KEY, "x3"))
    for s in (pair.port, pair.ref):
        with pytest.warns(UserWarning, match="unparseable decommission"):
            qe = make(s)
            got = qe.collect()
        assert s.conf.get(DRAIN_KEY) == ""
        assert "decommission" not in qe.fault_summary
        groupsum_parity(got, pdf)


def test_exclusions_do_not_mask_misconfiguration():
    """A pool short before exclusions still raises its setup
    diagnostic: the JAX package's 8 devices at mesh 64, the port's 0
    cards (a session built without a device) here."""
    for conf, get_mesh in ((PortConf(), port_get_mesh),
                           (RefConf(), ref_get_mesh)):
        conf.set(MESH_KEY, 64)
        conf.set(EXCLUDE_KEY, "3")
        with pytest.raises(RuntimeError, match="devices visible"):
            get_mesh(conf)


def test_mesh_fallback_not_sticky_across_executions(pair):
    make, pdf = group_sum(name="sticky_t")
    port, ref = both(pair, make, "mesh:fatal:1",
                     ((MESH_KEY, 8), (RESTART_KEY, False)))
    for r in (port, ref):
        assert r.plan.fired_log, "the mesh fault never fired"
        assert r.qe.fault_summary.get("mesh_fallback") == 1
        assert r.qe.last_metrics.get("mesh_fallback") == 1
        groupsum_parity(r.got, pdf)
    # the mesh healed: the same executions run on the mesh again
    again = [r.qe.collect() for r in (port, ref)]
    assert_rows_equal(*again)
    for r, got in zip((port, ref), again):
        assert r.qe.fault_summary == {}
        assert r.qe.last_metrics.get("mesh_fallback") is None
        groupsum_parity(got, pdf)


def _shards_by_chunk(qe) -> dict:
    out = {}
    for r in qe.spans.shard_records:
        if r["phase"] == "compute":
            out.setdefault(r["chunk"], set()).add(r["shard"])
    return out


def test_decommission_drains_at_chunk_boundary(pair):
    """A drain requested mid-stream applies at the next chunk boundary:
    a checkpoint at the cursor, `decommission` recorded, the shard's id
    excluded at session level and mesh.size lowered to 7, the stream
    resumed on 7 shards."""
    make, pdf = group_sum(name="drain_t")

    def drained(session):
        base = PortListener if is_port(session) else RefListener

        class Drainer(base):
            done = False

            def on_shard_records(self, e):
                if not self.done and e.chunk >= 1:
                    self.done = True
                    session.decommission_shards([3])

        drainer = Drainer()
        session.add_listener(drainer)
        try:
            qe = make(session)
            qe.execute_batch()
        finally:
            session.remove_listener(drainer)
        assert drainer.done, "the drain request was never posted"
        return qe

    port, ref = both(pair, drained, confs=((MESH_KEY, 8), (CKPT_KEY, 2),
                                           (SPANS_KEY, "on")),
                     collect=False)
    for r in (port, ref):
        conf = r.session.conf
        assert r.qe.fault_summary.get("decommission") == 1
        assert conf.get(EXCLUDE_KEY) == "3"
        assert conf.get(DRAIN_KEY) == ""
        assert int(conf.get(MESH_KEY)) == 7
        assert r.qe.fault_summary.get("checkpoint_restore") == 1
        by_chunk = _shards_by_chunk(r.qe)
        assert max(len(s) for s in by_chunk.values()) == 8
        assert len(by_chunk[max(by_chunk)]) == 7
    assert _shards_by_chunk(port.qe) == _shards_by_chunk(ref.qe)
    drain = next(ev for ev in port.qe.fault_events
                 if ev["action"] == "decommission")
    assert drain["shards"] == [3] and drain["devices"] == [3]
    got = [r.qe.collect() for r in (port, ref)]
    assert_rows_equal(*got)
    groupsum_parity(got[0], pdf)


def test_decommission_before_first_chunk(pair):
    pair.set((MESH_KEY, 8), (SPANS_KEY, "on"))
    for s in (pair.port, pair.ref):
        s.decommission_shards([7])
    runs = both(pair, q("q1"))
    for r in runs:
        assert r.qe.fault_summary.get("decommission") == 1
        assert "checkpoint_restore" not in r.qe.fault_summary
        comp = [x for x in r.qe.spans.shard_records
                if x["phase"] == "compute"]
        assert comp and {x["shard"] for x in comp} == set(range(7))
    golden(pair, runs, "q1")


def test_decommission_seam_fault_rides_mesh_ladder(pair):
    make, pdf = group_sum(name="drainfault_t")
    pair.set((MESH_KEY, 8))
    for s in (pair.port, pair.ref):
        s.decommission_shards([2])
    runs = both(pair, make, "decommission:fatal:1")
    for r in runs:
        assert r.plan.fired_log == [("decommission", 1, "fatal")]
        assert r.qe.fault_summary.get("mesh_restart") == 1
        assert r.qe.fault_summary.get("decommission") == 1
        groupsum_parity(r.got, pdf)


def test_pending_decommission_parsing():
    for conf, get_mesh, mod, dev in (
            (PortConf(), port_get_mesh, PEL, "cpu"),
            (RefConf(), ref_get_mesh, REL, None)):
        conf.set(MESH_KEY, 8)
        mesh = get_mesh(conf, dev) if dev else get_mesh(conf)
        assert mod.pending_decommission(conf, mesh) == ((), ())
        conf.set(DRAIN_KEY, "3,5")
        assert mod.pending_decommission(conf, mesh) == ((3, 5), (3, 5))
        conf.set(DRAIN_KEY, "64")
        assert mod.pending_decommission(conf, mesh) == ((), ())
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            conf.set(DRAIN_KEY, "junk,2")
            assert mod.pending_decommission(conf, mesh)[0] == (2,)


def test_get_mesh_exclusions_shrink():
    """Exclusions shrink the gang to the surviving pool; <= 1 survivor
    is no mesh. The port's pinned mesh gives the JAX package's answers
    at mesh 8 with its virtual ids."""
    import jax
    ids = [int(d.id) for d in jax.devices()]
    assert ids[:8] == list(range(8))
    port, ref = PortConf(), RefConf()
    for conf in (port, ref):
        conf.set(MESH_KEY, 8)
        conf.set(EXCLUDE_KEY, "0")
    pm, rm = port_get_mesh(port, "cpu"), ref_get_mesh(ref)
    assert pm.size == int(rm.devices.size) == 7
    assert list(pm.ids) == [int(d.id) for d in rm.devices.flat]
    assert 0 not in pm.ids
    for conf in (port, ref):
        conf.set(EXCLUDE_KEY, ",".join(str(i) for i in range(7)))
    assert port_get_mesh(port, "cpu") is None and ref_get_mesh(ref) is None
    # a drained id below a lowered mesh.size: the pool is the session's
    for conf in (port, ref):
        conf.set(EXCLUDE_KEY, "3")
        conf.set(MESH_KEY, 7)
    pm, rm = port_get_mesh(port, "cpu", pinned_pool=8), ref_get_mesh(ref)
    assert list(pm.ids) == [int(d.id) for d in rm.devices.flat] \
        == [0, 1, 2, 4, 5, 6, 7]
    assert PEL.healthy_device_count(port, "cpu", 8) == \
        REL.healthy_device_count(ref) - (len(ids) - 8) == 7


# -- straggler rebalancing -----------------------------------------------------

def _slow_shard_rules(shard, chunks, n=8, ms=60):
    return ",".join(f"shard_chunk:slow:{c * n + shard + 1}:{ms}"
                    for c in range(chunks))


def test_rebalance_shifts_rows_off_flagged_shard(pair, tmp_path):
    """A shard slowed by the `shard_chunk` seam is flagged mid-stream and
    later chunks give it half its fair share: the same per-(shard,
    chunk) rows in both packages' event logs, `shard_rebalance` once and
    the same rebalance_rows."""
    make, pdf = group_sum(name="rebal_t")
    dirs = {}

    def logged(session):
        d = str(tmp_path / ("port" if is_port(session) else "ref"))
        dirs[is_port(session)] = d
        session.conf.set(LOG_KEY, d)
        return make(session)

    port, ref = both(pair, logged, _slow_shard_rules(5, 6),
                     ((MESH_KEY, 8), (SPANS_KEY, "on")) + STRAGGLER)
    rows = []
    for r, hist in ((port, PH), (ref, RH)):
        groupsum_parity(r.got, pdf)
        assert r.qe.fault_summary.get("shard_rebalance") == 1
        assert r.delta["rebalance_rows"] > 0
        shards = hist.shard_summary(hist.read_event_log(
            dirs[r is port]))
        mine = shards[(shards["query_id"] == r.qe.query_id)
                      & (shards["phase"] == "compute")]
        s5 = mine[mine["shard"] == 5].set_index("chunk")["rows"]
        assert s5.iloc[0] == 128  # the even split before the flag
        assert s5.min() <= 64  # moved away after it
        assert int(mine["rows"].sum()) == len(pdf)
        rows.append(mine.sort_values(["chunk", "shard"])[
            ["chunk", "shard", "rows"]].reset_index(drop=True))
    pd.testing.assert_frame_equal(rows[0], rows[1], check_dtype=False)


def test_rebalance_disabled_keeps_even_assignment(pair):
    make, pdf = group_sum(name="rebal_off_t")
    runs = both(pair, make, _slow_shard_rules(5, 6),
                ((MESH_KEY, 8), (SPANS_KEY, "on"), (REBALANCE_KEY, False))
                + STRAGGLER)
    for r in runs:
        assert "shard_rebalance" not in r.qe.fault_summary
        full = [x["rows"] for x in r.qe.spans.shard_records
                if x["phase"] == "compute" and x["shard"] == 5
                and x["chunk"] < 15]
        assert full and all(x == 128 for x in full), full
        groupsum_parity(r.got, pdf)


def _states(n, **confs):
    out = []
    for mod, conf in ((PEL, PortConf()), (REL, RefConf())):
        for k, v in confs.items():
            conf.set(k, v)
        out.append(mod.RebalanceState(n, conf))
    return out


def test_rebalance_state_math():
    """Targets sum to the live count, the slow shard's share drops by
    maxSkew, slot capacity bounds every target, flagging is bounded and
    idempotent — and both packages give the same numbers on seeded live
    counts."""
    port, ref = _states(8)
    rng = np.random.default_rng(7)
    lives = [int(x) for x in rng.integers(0, 5000, 24)] + [1024, 1000]
    for st in (port, ref):
        assert not st.active
        assert set(st.targets(1024)) == {128}
    for flag in (5, 5, 1):
        for st in (port, ref):
            st.flag(flag)
        assert port.slow == ref.slow
        for live in lives:
            t = port.targets(live)
            assert t.sum() == live
            np.testing.assert_array_equal(t, ref.targets(live))
        for cap in (1024, 4096, 1000):
            assert port.slot_capacity(cap) == ref.slot_capacity(cap)
            assert all(int(x) <= port.slot_capacity(cap)
                       for x in port.targets(cap))
    one, _ = _states(8)
    one.flag(5)
    assert one.targets(1024)[5] == 64  # (1 - 0.5) x fair
    for st in (port, ref):
        for s in range(8):
            st.flag(s)
        assert len(st.slow) == 7  # someone must take the rows
    assert port.slow == ref.slow


def test_rebalance_weight_decay_returns_to_uniform():
    port, ref = _states(4, **{DECAY_KEY: 4})
    shares = []
    for st in (port, ref):
        st.flag(1)
        cap = st.slot_capacity(1024)
        t0 = st.targets(1024)
        assert t0[1] == 128
        seen = [int(t0[1])]
        for _ in range(4):
            st.tick()
            if st.active:
                assert st.slot_capacity(1024) == cap  # one shape
                seen.append(int(st.targets(1024)[1]))
        assert seen == sorted(seen) and not st.active
        assert set(st.targets(1024)) == {256}
        st.flag(2)
        st.tick()
        st.flag(2)
        assert st.penalty[2] == 1.0
        shares.append(seen)
    assert shares[0] == shares[1]
    for st in _states(4):
        st.flag(1)
        for _ in range(10):
            st.tick()
        assert st.active and st.slow == {1}


def test_rebalance_batch_preserves_rows():
    """pad_chunk_for_shards with an active state moves rows between
    shard segments, never losing or duplicating one, and lays them out
    as the JAX package does."""
    import jax
    from spark_tpu.columnar import Batch as RefBatch
    from spark_tpu_torch.columnar import Batch
    vals = np.arange(100, dtype=np.int64)
    table = pa.table({"v": vals})
    port, ref = _states(4)
    port.flag(1)
    ref.flag(1)
    out = PEL.pad_chunk_for_shards(Batch.from_arrow(table, "cpu"), 4, port)
    rout = REL.pad_chunk_for_shards(RefBatch.from_numpy({"v": vals}), 4,
                                    ref)
    assert out.capacity == rout.capacity and out.capacity % 4 == 0
    mask = out.selection_mask().numpy()
    data = out.columns["v"].data.numpy()
    np.testing.assert_array_equal(
        mask, np.asarray(jax.device_get(rout.selection_mask())))
    np.testing.assert_array_equal(
        data[mask], np.asarray(jax.device_get(rout.columns["v"].data))[mask])
    assert sorted(data[mask].tolist()) == vals.tolist()
    s_cap = out.capacity // 4
    seg = [int(mask[i * s_cap:(i + 1) * s_cap].sum()) for i in range(4)]
    assert seg[1] < min(seg[0], seg[2], seg[3])


# -- observability -----------------------------------------------------------

def test_elastic_actions_reach_history(pair, tmp_path):
    """mesh_restart and checkpoint_restore reach the event log and
    history.fault_summary; each package's history reads either log the
    same."""
    dirs = {}

    def logged(session):
        d = str(tmp_path / ("port" if is_port(session) else "ref"))
        dirs[is_port(session)] = d
        session.conf.set(LOG_KEY, d)
        return q("q1")(session)

    both(pair, logged, "mesh_checkpoint:fatal:2", ((MESH_KEY, 8),
                                                   (CKPT_KEY, 2)))
    rows = []
    for d in dirs.values():
        for hist in (PH, RH):
            summary = hist.fault_summary(hist.read_event_log(d))
            assert len(summary) >= 1
            row = summary.iloc[-1]
            assert row["mesh_restart"] == 1
            assert row["mesh_fallback"] == 0
            assert row["checkpoint_restore"] == 1
            assert any(ev.get("action") == "mesh_restart"
                       for ev in row["events"])
            rows.append([ev["action"] for ev in row["events"]])
    assert all(r == rows[0] for r in rows)
