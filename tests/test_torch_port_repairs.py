"""The port faults P1-P4 that the mesh slice repairs first, each held
against the JAX package on the CPU: the `like`/`startswith`/`substr`
column methods (P1); keys of unported slices refused unless set to
their default (P2); `Conf.unset` and `hash_join.resolve_kernel` (P3);
`PhysicalPlan.describe()` (P4), equal to the JAX package's for the 22
TPC-H SQL plans at mesh 0 and 8."""

import numpy as np
import pandas as pd
import pytest

from spark_tpu import config as ref_config
from spark_tpu.execution import hash_join as ref_hash_join
from spark_tpu_torch import config as port_config
from spark_tpu_torch.execution import hash_join as port_hash_join
from spark_tpu_torch.tpch.sql_queries import SQL_QUERIES
from torch_mesh_parity import MESH, PORT, REF
from torch_mesh_parity import sessions as mesh_sessions
from torch_sql_parity import assert_tables_match, sessions, write_data

EST = "spark_tpu.sql.aggregate.estimatedGroups"
CHUNK = "spark_tpu.sql.execution.streamingChunkRows"

#: the keys this slice registers (the mesh's)
MESH_KEYS = ("spark_tpu.sql.mesh.size", "spark_tpu.sql.mesh.excludeDevices",
             "spark_tpu.sql.shuffle.partitions",
             "spark_tpu.sql.autoBroadcastJoinThreshold",
             "spark_tpu.sql.adaptive.skewJoin.enabled",
             "spark_tpu.sql.adaptive.skewJoin.factor",
             "spark_tpu.sql.adaptive.skewJoin.broadcastThreshold",
             "spark_tpu.execution.meshFallback.enabled")


@pytest.fixture(scope="module")
def pair():
    return mesh_sessions()


def both(pair, build):
    port, ref = pair
    return build(port, PORT).collect(), build(ref, REF).collect()


# -- P1 -----------------------------------------------------------------------

def test_substring_groupby_merges_colliding_codes(pair):
    pdf = pd.DataFrame({"s": ["aa1", "aa2", "bb1", "aa3"],
                        "v": np.array([1, 2, 3, 4], dtype=np.int64)})
    got, want = both(pair, lambda s, x: s.create_dataframe(pdf, "p1sub")
                     .group_by(x.col("s").substr(1, 2).alias("p"))
                     .agg(x.F.sum(x.col("v")).alias("sv"))
                     .sort(x.col("p")))
    assert_tables_match(got, want)
    assert got.column("p").to_pylist() == ["aa", "bb"]
    assert got.column("sv").to_pylist() == [7, 3]


def test_streamed_substr_groupby_multichunk(pair):
    strs = [f"aa{i}" for i in range(100)] + \
        [f"bb{i}" for i in range(100)] + [f"cc{i}" for i in range(100)]
    pdf = pd.DataFrame({"s": strs, "v": np.ones(300, dtype=np.int64)})
    for s in pair:
        s.conf.set(CHUNK, 64)
    try:
        got, want = both(pair, lambda s, x: s.create_dataframe(pdf, "p1st")
                         .group_by(x.col("s").substr(1, 2).alias("p"))
                         .agg(x.F.count().alias("c")).sort(x.col("p")))
    finally:
        for s in pair:
            s.conf.unset(CHUNK)
    assert_tables_match(got, want)
    assert got.column("p").to_pylist() == ["aa", "bb", "cc"]
    assert got.column("c").to_pylist() == [100, 100, 100]


def test_like_and_startswith(pair):
    pdf = pd.DataFrame({"s": ["a%b", "a_c", "abc", "xa%"],
                        "v": np.arange(4, dtype=np.int64)})
    got, want = both(pair, lambda s, x: s.create_dataframe(pdf, "p1like")
                     .filter(x.col("s").startswith("a%")
                             | x.col("s").like("%c"))
                     .sort(x.col("v")))
    assert_tables_match(got, want)
    assert got.column("s").to_pylist() == ["a%b", "a_c", "abc"]


# -- P2 -----------------------------------------------------------------------

def test_every_reference_key_is_registered_or_listed():
    ref = ref_config.registry()
    port = port_config.registry()
    listed = port_config.UNPORTED_KEYS
    assert set(port) | set(listed) == set(ref)
    assert not set(port) & set(listed)
    for key, (part, default) in listed.items():
        assert default == ref[key].default, key
        assert part.startswith("slice"), key
    for key in MESH_KEYS:
        assert key in port and key not in listed
        assert port[key].default == ref[key].default


@pytest.mark.parametrize("key,value,part", [
    # slice 12b registered analysis.strict and planChangeValidation; the
    # jaxpr key stays listed (the port leaves the jaxpr analyzer out)
    ("spark_tpu.sql.analysis.jaxpr", "on", "slice 12b"),
    ("spark_tpu.sql.analysis.jaxpr", "off", "jaxpr analyzer"),
    # slice 14 registered the cluster keys; the compile cache's maxBytes
    # stays listed in their place
    ("spark_tpu.sql.compileCache.maxBytes", 1 << 20, "slice 12c part 2"),
    # slice 12c part 2 registered the fleet's keys; the compile cache's
    # and bucketGrowth stay listed, left out by choice
    ("spark_tpu.sql.compileCache.dir", "/var/cc", "out by choice"),
    ("spark_tpu.sql.execution.bucketGrowth", 1.5, "slice 12c part 2"),
    ("spark_tpu.sql.compileCache.enabled", True, "slice 12c"),
])
def test_unported_key_raises_unless_default(key, value, part):
    conf = port_config.Conf()
    with pytest.raises(port_config.UnportedConfError, match=part):
        conf.set(key, value)
    assert not conf.is_explicitly_set(key)
    default = port_config.UNPORTED_KEYS[key][1]
    conf.set(key, default)  # the default means what the port does
    assert conf.get(key) == default


def test_unknown_keys_stay_an_open_map():
    """A key neither package registers passes through, as in SparkConf."""
    conf = port_config.Conf()
    conf.set("myapp.report.owner", "x")
    assert conf.get("myapp.report.owner") == "x"


# -- P3 -----------------------------------------------------------------------

def test_conf_unset():
    conf = port_config.Conf()
    conf.set(EST, 64)
    assert conf.get(EST) == 64 and conf.is_explicitly_set(EST)
    conf.unset(EST)
    conf.unset(EST)  # unsetting twice is fine
    assert conf.get(EST) == port_config.registry()[EST].default
    assert not conf.is_explicitly_set(EST)


@pytest.mark.parametrize("probe,build,fallback", [
    (1 << 10, 1 << 8, None), (1 << 20, 1 << 10, None),
    (1 << 20, 1 << 19, None), (1 << 21, 1 << 12, False)])
@pytest.mark.parametrize("mode", ["auto", "hash", "sort"])
def test_resolve_kernel(probe, build, fallback, mode):
    key = "spark_tpu.sql.join.kernelMode"
    pc, rc = port_config.Conf(), ref_config.Conf()
    pc.set(key, mode)
    rc.set(key, mode)
    got = port_hash_join.resolve_kernel(pc, probe, build, fallback)
    assert got == port_hash_join.kernel_choice(pc, probe, build,
                                               fallback)[0]
    assert got == ref_hash_join.resolve_kernel(rc, probe, build, fallback)


def test_agg_overflow_retry(pair):
    rs = np.random.RandomState(5)
    pdf = pd.DataFrame({
        "k": (rs.permutation(3000) * 1_000_003).astype(np.int64),
        "v": np.ones(3000, dtype=np.int64)})
    for s in pair:
        s.register_table("ovf_t", pdf)
        s.conf.set(EST, 64)
    try:
        got, want = both(pair, lambda s, x: s.table("ovf_t")
                         .group_by(x.col("k")).agg(x.F.count().alias("c"))
                         .sort(x.col("k")))
    finally:
        for s in pair:
            s.conf.unset(EST)
    assert_tables_match(got, want)
    assert got.num_rows == 3000 and sum(got.column("c").to_pylist()) == 3000
    assert all(not s.conf.is_explicitly_set(EST) for s in pair)


def test_adaptive_disabled_raises(pair):
    rs = np.random.RandomState(6)
    pdf = pd.DataFrame({
        "k": (rs.permutation(2000) * 7_000_003).astype(np.int64)})
    for s in pair:
        s.register_table("noadapt_t", pdf)
        s.conf.set(EST, 32)
        s.conf.set("spark_tpu.sql.adaptive.enabled", False)
    try:
        for s, x in zip(pair, (PORT, REF)):
            with pytest.raises(RuntimeError, match="adaptive"):
                (s.table("noadapt_t").group_by(x.col("k"))
                 .agg(x.F.count().alias("c")).collect())
    finally:
        for s in pair:
            s.conf.set("spark_tpu.sql.adaptive.enabled", True)
            s.conf.unset(EST)


# -- P4 -----------------------------------------------------------------------

@pytest.fixture(scope="module")
def tpch_path(tmp_path_factory):
    return write_data(tmp_path_factory, 0.002)


@pytest.mark.parametrize("n", [0, 8])
def test_describe_matches_reference(tpch_path, n):
    """describe() of the 22 TPC-H SQL plans, as planned (no run), equals
    the JAX package's at mesh 0 and 8."""
    port, ref = sessions(tpch_path, f"desc{n}", confs=((MESH, n),))
    for q in sorted(SQL_QUERIES, key=lambda q: int(q[1:])):
        pd_, rd = (s.sql(SQL_QUERIES[q])._qe().executed_plan.describe()
                   for s in (port, ref))
        assert pd_ == rd, q
        assert pd_.startswith("(") and pd_.endswith(")")
        assert ("ExchangeExec(" in pd_) == (n > 1), q


# -- slice 12c, part 1: the service's keys and device ---------------------------

#: the fourteen keys the SQL service reads, each with a value other than
#: its default
SERVICE_KEYS = {
    "spark_tpu.service.maxConcurrent": 3,
    "spark_tpu.service.queueDepth": 4,
    "spark_tpu.service.queueTimeoutMs": 500,
    "spark_tpu.service.host": "0.0.0.0",
    "spark_tpu.service.port": 8470,
    "spark_tpu.service.hbmBudget": 1 << 30,
    "spark_tpu.service.maxSessions": 4,
    "spark_tpu.service.session.maxConcurrent": 2,
    "spark_tpu.service.session.hbmShare": 0.25,
    "spark_tpu.service.idPrefix": "w0-",
    "spark_tpu.service.fleet.drainTimeoutMs": 2500,
    "spark_tpu.service.queryLogSize": 64,
    "spark_tpu.service.slo.latencyMs": 250,
    "spark_tpu.service.historySize": 32,
}


def test_unported_list_after_slice_12c_part_1():
    """Six keys stay listed: the compile cache's four and bucketGrowth
    (left out by choice in part 2) and the jaxpr analyzer's one. The
    fleet's ten left the list in part 2, the multi-host mesh's three in
    slice 14."""
    listed = port_config.UNPORTED_KEYS
    assert len(listed) == 6
    assert not any(k.startswith("spark_tpu.sql.cluster.") for k in listed)
    assert not set(SERVICE_KEYS) & set(listed)
    assert not set(FLEET_KEYS) & set(listed)
    part2 = [k for k, (part, _) in listed.items()
             if part.startswith("slice 12c part 2")]
    assert len(part2) == 5
    assert all(k.startswith(("spark_tpu.sql.compileCache.",
                             "spark_tpu.sql.execution.bucketGrowth"))
               for k in part2)


CLUSTER_KEYS = {"spark_tpu.sql.cluster.coordinator": "host0:8476",
                "spark_tpu.sql.cluster.numProcesses": 2,
                "spark_tpu.sql.cluster.processId": 1}


@pytest.mark.parametrize("key", sorted(CLUSTER_KEYS))
def test_cluster_key_is_ported_with_the_reference_default(key):
    """Slice 14 registered the three cluster keys with the JAX package's
    defaults ("", 1, 0); a value other than the default is taken and
    reads back as the JAX package's does."""
    assert key in port_config.registry() and \
        key not in port_config.UNPORTED_KEYS
    assert port_config.registry()[key].default == \
        ref_config.registry()[key].default
    pc, rc = port_config.Conf(), ref_config.Conf()
    assert pc.get(key) == rc.get(key)
    pc.set(key, CLUSTER_KEYS[key])
    rc.set(key, CLUSTER_KEYS[key])
    assert pc.get(key) == rc.get(key) and pc.is_explicitly_set(key)


@pytest.mark.parametrize("key", sorted(SERVICE_KEYS))
def test_service_key_is_ported(key):
    """Each key the service reads is registered with the JAX package's
    default, and a value other than the default is taken (no
    UnportedConfError) and reads back as the JAX package's does."""
    assert key in port_config.registry()
    assert port_config.registry()[key].default == \
        ref_config.registry()[key].default
    pc, rc = port_config.Conf(), ref_config.Conf()
    pc.set(key, SERVICE_KEYS[key])
    rc.set(key, SERVICE_KEYS[key])
    assert pc.get(key) == rc.get(key) and pc.is_explicitly_set(key)


def test_sql_service_without_device_raises_when_cuda_is_absent(
        monkeypatch):
    """The service raises where a session does: with no device given and
    no CUDA, constructing it fails before any pooled session exists."""
    import torch

    from spark_tpu_torch.service.server import SqlService
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SqlService()
    svc = SqlService(device="cpu")
    try:
        assert str(svc.device) == "cpu"
    finally:
        svc.stop()


# -- slice 12c, part 2: the fleet's keys, the compile-cache decision ----------

#: the ten keys the fleet supervisor reads (beside drainTimeoutMs, which
#: the service registered), each with a value other than its default
FLEET_KEYS = {
    "spark_tpu.service.fleet.workers": 4,
    "spark_tpu.service.fleet.restartMaxPerWindow": 5,
    "spark_tpu.service.fleet.restartWindowMs": 30000,
    "spark_tpu.service.fleet.restartBackoffMs": 50,
    "spark_tpu.service.fleet.failoverReads": False,
    "spark_tpu.service.fleet.healthIntervalMs": 100,
    "spark_tpu.service.fleet.spawnTimeoutMs": 60000,
    "spark_tpu.service.fleet.proxyTimeoutMs": 120000,
    "spark_tpu.service.fleet.dir": "/tmp/fleet",
    "spark_tpu.service.fleet.init": "myapp.serving:init_session",
}

#: the compile-cache decision, in the words `config.py`,
#: `service/fleet.py` and ROADMAP.md share
LEFT_OUT = ("out by choice: the port runs eagerly and compiles no stages; "
            "its one compiled artifact, the kernel library, is kept on "
            "disk by mtime and replaced atomically")


@pytest.mark.parametrize("key", sorted(FLEET_KEYS))
def test_fleet_key_is_ported(key):
    """Each fleet key is registered with the JAX package's default, and
    a value other than the default is taken (no UnportedConfError) and
    reads back as the JAX package's does."""
    assert key in port_config.registry()
    assert key not in port_config.UNPORTED_KEYS
    assert port_config.registry()[key].default == \
        ref_config.registry()[key].default
    pc, rc = port_config.Conf(), ref_config.Conf()
    pc.set(key, FLEET_KEYS[key])
    rc.set(key, FLEET_KEYS[key])
    assert pc.get(key) == rc.get(key) and pc.is_explicitly_set(key)


@pytest.mark.parametrize("key,value", [
    ("spark_tpu.sql.compileCache.enabled", True),
    ("spark_tpu.sql.compileCache.dir", "/var/cc"),
    ("spark_tpu.sql.compileCache.maxBytes", 1 << 20),
    ("spark_tpu.sql.compileCache.warmStart", False),
    ("spark_tpu.sql.execution.bucketGrowth", 1.5),
])
def test_compile_cache_keys_are_left_out_by_choice(key, value):
    """The compile cache's four keys and bucketGrowth still raise, with
    the decision's reason, which `config.py`, `service/fleet.py` and
    ROADMAP.md state in the same words."""
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    with pytest.raises(port_config.UnportedConfError) as exc:
        port_config.Conf().set(key, value)
    assert LEFT_OUT in str(exc.value)
    for rel in ("spark_tpu_torch/config.py",
                "spark_tpu_torch/service/fleet.py", "ROADMAP.md"):
        text = (root / rel).read_text()
        words = " ".join(text.replace('"', " ").replace("#", " ").split())
        assert LEFT_OUT in words, rel


def test_warmup_returns_zero_stages(monkeypatch):
    """`session.warmup()`: the JAX package's replays its compile cache
    (0 entries with the cache off); the port's has no stages to replay
    and returns 0, loading the kernel library first on a CUDA session
    only (a CPU session never touches it)."""
    from spark_tpu.session import SparkTpuSession as RefSession

    import spark_tpu_torch.execution.dense_groupby as D
    from spark_tpu_torch import SparkTpuSession
    loads = []
    monkeypatch.setattr(D, "_load", lambda: loads.append(1))
    assert RefSession(register_active=False).warmup() == 0
    assert SparkTpuSession(device="cpu", register_active=False) \
        .warmup() == 0
    assert loads == []
    cuda = SparkTpuSession(device="cuda", register_active=False)
    assert cuda.warmup() == 0 and loads == [1]
