"""The port's concurrency analyzer (`spark_tpu_torch/analysis/concurrency/`)
and lockwatch (`spark_tpu_torch/testing/lockwatch.py`) against the JAX
package's, on the CPU.

- The port's registry: ids, ranks and sites unique, every guard naming a
  registered lock, every waiver and confined class with a reason, the
  33 lock sites of the package all declared; the SQL service's locks
  with the JAX package's ids and ranks, and `install_service` wrapping
  each of them.
- Every guarded-by and lock-order synthetic case of
  `tests/test_concurrency.py`, the same source through both packages'
  analyses with the same synthetic declarations: the same violations
  (code, line, message) and the same edges.
- The real port tree clean under both passes, the static graph's edges
  ascending in rank.
- The lockwatch unit cases of `tests/test_concurrency.py` through both
  packages' LockWatch: edges, an inversion, a condition wait releasing
  its hold, contention, the ABBA shape, a reentrant lock not flagged, a
  thread leak.
- A CPU stress of chip_smoke.py phase 18(d)'s shape at a small size:
  one session, four threads running TPC-H Q1/Q5/Q6 and the range with
  the observability outputs on, a supervised streaming query triggering
  beside them, under lockwatch; every result equal to its
  single-thread result.
"""

import ast
import os
import sys
import threading
import time

import pytest

from spark_tpu.analysis.concurrency import guarded as ref_guarded
from spark_tpu.analysis.concurrency import lockorder as ref_lockorder
from spark_tpu.analysis.concurrency import registry as ref_registry
from spark_tpu.testing import lockwatch as ref_lockwatch
from spark_tpu_torch.analysis.concurrency import guarded as port_guarded
from spark_tpu_torch.analysis.concurrency import lockorder as port_lockorder
from spark_tpu_torch.analysis.concurrency import registry as port_registry
from spark_tpu_torch.analysis.concurrency.registry import (
    CONFINED, GUARDED_BY, LOCKS, WAIVERS)
from spark_tpu_torch.testing import lockwatch as port_lockwatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (registry, guarded, lockorder, lockwatch) of each package
PACKAGES = {
    "port": (port_registry, port_guarded, port_lockorder, port_lockwatch),
    "jax": (ref_registry, ref_guarded, ref_lockorder, ref_lockwatch),
}


# ---------------------------------------------------------------------------
# registry sanity
# ---------------------------------------------------------------------------


def test_registry_ids_and_ranks_unique():
    ids = [d.lock_id for d in LOCKS]
    assert len(ids) == len(set(ids)), "duplicate lock ids"
    ranks = [d.rank for d in LOCKS]
    assert len(ranks) == len(set(ranks)), \
        "ranks must be distinct: they are the canonical total order"
    sites = [(d.relpath, d.cls, d.attr) for d in LOCKS]
    assert len(sites) == len(set(sites)), "duplicate lock sites"


def test_fleet_locks_are_the_reference_ones():
    """The fleet's two locks keep the JAX package's ids, kinds, ranks,
    classes and attributes, and guard the same fields; with them every
    `service.*` lock of the JAX package is the port's too."""
    ref = {d.lock_id: d for d in ref_registry.LOCKS}
    port = {d.lock_id: d for d in LOCKS}
    for lid, rank in (("service.fleet_inflight", 12),
                      ("service.fleet_worker", 13)):
        p, r = port[lid], ref[lid]
        assert (p.rank, p.kind, p.cls, p.attr) == \
            (r.rank, r.kind, r.cls, r.attr)
        assert p.rank == rank
        assert p.relpath == "spark_tpu_torch/service/fleet.py"
    assert {i for i in ref if i.startswith("service.")} <= set(port)

    def guards(reg):
        return sorted((g.cls, g.attr, g.lock) for g in reg.GUARDED_BY
                      if g.relpath.endswith("service/fleet.py"))
    assert guards(port_registry) == guards(ref_registry)
    assert len(guards(port_registry)) == 14


def test_registry_guards_reference_real_locks():
    lock_attrs = {}
    for d in LOCKS:
        lock_attrs.setdefault((d.relpath, d.cls), set()).add(d.attr)
    for g in GUARDED_BY:
        assert g.lock in lock_attrs.get((g.relpath, g.cls), set()), \
            f"GuardDecl {g} names a lock with no LockDecl"


def test_registry_waivers_and_confined_carry_reasons():
    for w in WAIVERS:
        assert w.reason.strip(), f"empty waiver reason: {w}"
    for c in CONFINED:
        assert c.reason.strip(), f"empty confined reason: {c}"


def test_registry_declares_every_lock_of_the_package():
    """Every threading.Lock/RLock/Condition construction in
    spark_tpu_torch/ (the package's 38, the SQL service's eleven, the
    fleet's two and the cluster transport's three among them, and
    lockwatch's own recorder lock) is declared, each under the JAX
    package's id and rank where it is the same lock."""
    calls = 0
    for dirpath, _, files in os.walk(os.path.join(REPO, "spark_tpu_torch")):
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(dirpath, name)) as f:
                tree = ast.parse(f.read())
            calls += sum(
                1 for n in ast.walk(tree)
                if isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and isinstance(n.func.value, ast.Name)
                and n.func.value.id == "threading"
                and n.func.attr in ("Lock", "RLock", "Condition"))
    assert calls == len(LOCKS) == 39
    ref = {d.lock_id: d.rank for d in ref_registry.LOCKS}
    shared = [d for d in LOCKS if d.lock_id in ref]
    assert len(shared) == 31
    for d in shared:
        assert d.rank == ref[d.lock_id], d.lock_id
    assert {d.lock_id for d in LOCKS} - set(ref) == {
        "dense_groupby.build", "dense_groupby.launch", "session.query_seq",
        "mesh.copy_stats", "mesh.shard_errors", "cluster.run",
        "cluster.init", "cluster.stats"}


# ---------------------------------------------------------------------------
# guarded-by and lock-order: synthetic cases through both packages
# ---------------------------------------------------------------------------

_MOD = "spark_tpu/fake.py"


def _view(pkg, locks=(), guards=(), waivers=(), confined=()):
    return PACKAGES[pkg][1].RegistryView(
        locks=locks, guards=guards, waivers=waivers, confined=confined,
        receiver_names={}, receiver_attrs={}, factory_returns={},
        context_managers={}, extra_edges=(), held_callees={})


def _decls(pkg):
    reg = PACKAGES[pkg][0]
    return reg.LockDecl, reg.GuardDecl, reg.Waiver, reg.ConfinedDecl


def _run_guarded(pkg, src, view):
    a = PACKAGES[pkg][1].GuardedAnalysis(view)
    a.add_file(_MOD, ast.parse(src))
    return a.finish()


def _run_lockorder(pkg, src, view):
    a = PACKAGES[pkg][2].LockOrderAnalysis(view)
    a.add_file(_MOD, ast.parse(src))
    return a.finish()


def _both(fn):
    """fn(pkg) for each package; the two results must be equal (the
    registry paths in lock-order messages put aside)."""
    out = {pkg: fn(pkg) for pkg in PACKAGES}

    def norm(x):
        return repr(x).replace("spark_tpu_torch/", "spark_tpu/")

    assert norm(out["port"]) == norm(out["jax"]), out
    return out["port"]


_BOX = (
    "import threading\n"
    "class Box:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.Lock()\n"
    "        self.items = []\n")


def _box(pkg):
    LockDecl, GuardDecl, _, _ = _decls(pkg)
    return (LockDecl("t.box", _MOD, "Box", "_lock", "lock", 10),), \
        (GuardDecl(_MOD, "Box", "items", "_lock"),)


def test_guarded_by_clean_class():
    src = _BOX + ("    def add(self, x):\n"
                  "        with self._lock:\n"
                  "            self.items.append(x)\n")
    assert _both(lambda p: _run_guarded(p, src, _view(p, *_box(p)))) == []


def test_guarded_by_flags_unguarded_write():
    src = _BOX + ("    def add(self, x):\n"
                  "        self.items.append(x)\n"
                  "    def reset(self):\n"
                  "        self.items = []\n")
    out = _both(lambda p: _run_guarded(p, src, _view(p, *_box(p))))
    codes = [(code, line) for _, line, code, _ in out]
    assert ("GB101", 7) in codes and ("GB101", 9) in codes, out


def test_guarded_by_flags_undeclared_shared_state():
    src = (
        "import threading\n"
        "class Box:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self.items = []\n"
        "        self.extra = 0\n"
        "    def bump(self):\n"
        "        with self._lock:\n"
        "            self.extra += 1\n")
    out = _both(lambda p: _run_guarded(p, src, _view(p, *_box(p))))
    assert [code for _, _, code, _ in out] == ["GB102"], out

    def waived(p):
        Waiver = _decls(p)[2]
        locks, guards = _box(p)
        return _run_guarded(p, src, _view(
            p, locks, guards,
            waivers=(Waiver(_MOD, "Box", "extra", "benign test race"),)))

    assert _both(waived) == []


def test_guarded_by_flags_unregistered_and_stale_locks():
    src = ("import threading\n"
           "class Rogue:\n"
           "    def __init__(self):\n"
           "        self._mystery = threading.Lock()\n")
    out = _both(lambda p: _run_guarded(p, src, _view(p, _box(p)[0])))
    assert {code for _, _, code, _ in out} == {"GB104", "GB105"}, out


def test_guarded_by_confined_class_skips_checks():
    src = ("class Cursor:\n"
           "    def step(self):\n"
           "        self.cursor = 1\n")
    out = _both(lambda p: _run_guarded(p, src, _view(
        p, confined=(_decls(p)[3](_MOD, "Cursor", "ctxvar"),))))
    assert out == []


def test_guarded_by_module_globals_and_contextvar():
    src = ("from contextvars import ContextVar\n"
           "V = ContextVar('v', default=None)\n"
           "STATE = {}\n"
           "def set_v(x):\n"
           "    global V\n"
           "    V = x\n"
           "def poke(k):\n"
           "    STATE[k] = 1\n")
    out = _both(lambda p: _run_guarded(p, src, _view(
        p, guards=(_decls(p)[1](_MOD, "", "OTHER", "_L"),))))
    gb102 = [msg for _, _, code, msg in out if code == "GB102"]
    assert any("STATE" in m for m in gb102), out
    assert not any("module global V " in m for m in gb102)


def test_guarded_by_multi_item_with_counts_earlier_items_held():
    src = _BOX + ("    def add(self, x):\n"
                  "        with self._lock, open('f'):\n"
                  "            self.items.append(x)\n")
    assert _both(lambda p: _run_guarded(p, src, _view(p, *_box(p)))) == []


def test_guarded_by_nested_function_global_reported_once():
    src = ("STATE = {}\n"
           "def outer():\n"
           "    def inner():\n"
           "        STATE['k'] = 1\n"
           "    inner()\n")
    out = _both(lambda p: _run_guarded(p, src, _view(
        p, guards=(_decls(p)[1](_MOD, "", "STATE", "_L"),))))
    assert len([v for v in out if v[2] == "GB101"]) == 1, out


def _two_locks(p, cls, rank_b=20, kind="lock"):
    LockDecl = _decls(p)[0]
    return (LockDecl("t.a", _MOD, cls, "_a", kind, 10),
            LockDecl("t.b", _MOD, cls, "_b", "lock", rank_b))


def test_lock_order_nested_with_edge_and_inversion():
    good = ("class Two:\n"
            "    def fwd(self):\n"
            "        with self._a:\n"
            "            with self._b:\n"
            "                pass\n")
    edges, out = _both(lambda p: _run_lockorder(
        p, good, _view(p, _two_locks(p, "Two"))))
    assert ("t.a", "t.b") in edges and out == [], (edges, out)
    bad = good.replace("self._a", "X").replace("self._b", "self._a") \
        .replace("X", "self._b")
    edges, out = _both(lambda p: _run_lockorder(
        p, bad, _view(p, _two_locks(p, "Two"))))
    assert ("t.b", "t.a") in edges
    assert [code for _, _, code, _ in out] == ["LO202"], out


def test_lock_order_cycle_detected_via_call_graph():
    src = ("class P:\n"
           "    def one(self):\n"
           "        with self._a:\n"
           "            self.two()\n"
           "    def two(self):\n"
           "        with self._b:\n"
           "            pass\n")

    def run(p):
        view = _view(p, _two_locks(p, "P", rank_b=10))
        view.extra_edges = (("t.b", "t.a", "synthetic reverse edge"),)
        return _run_lockorder(p, src, view)

    edges, out = _both(run)
    assert ("t.a", "t.b") in edges and ("t.b", "t.a") in edges, edges
    assert any(code == "LO201" and "cycle" in msg
               for _, _, code, msg in out), out


def test_lock_order_multi_item_with_records_inter_item_edge():
    src = ("class M:\n"
           "    def both(self):\n"
           "        with self._a, self._b:\n"
           "            pass\n")
    edges, out = _both(lambda p: _run_lockorder(
        p, src, _view(p, _two_locks(p, "M"))))
    assert ("t.a", "t.b") in edges and out == []
    inverted = src.replace("self._a, self._b", "self._b, self._a")
    edges, out = _both(lambda p: _run_lockorder(
        p, inverted, _view(p, _two_locks(p, "M"))))
    assert ("t.b", "t.a") in edges
    assert [code for _, _, code, _ in out] == ["LO202"], out


def test_lock_order_self_deadlock_on_non_reentrant_lock():
    src = ("class R:\n"
           "    def outer(self):\n"
           "        with self._a:\n"
           "            self.inner()\n"
           "    def inner(self):\n"
           "        with self._a:\n"
           "            pass\n")
    _, out = _both(lambda p: _run_lockorder(
        p, src, _view(p, _two_locks(p, "R")[:1])))
    assert any(code == "LO201" and "self-deadlock" in msg
               for _, _, code, msg in out), out
    _, out2 = _both(lambda p: _run_lockorder(
        p, src, _view(p, _two_locks(p, "R", kind="rlock")[:1])))
    assert out2 == []


# ---------------------------------------------------------------------------
# the real port tree
# ---------------------------------------------------------------------------


def test_concurrency_passes_clean_on_real_tree():
    from spark_tpu_torch.analysis.lints import run_passes
    notes = []
    out = run_passes(["guarded-by", "lock-order"], repo=REPO,
                     collect_notes=notes)
    assert [v.render() for v in out] == []
    assert sum(n.startswith("waiver:") for n in notes) == len(WAIVERS)
    assert any(n.startswith("lock-order:") for n in notes)


def test_static_graph_has_known_edges_and_ascends():
    edges, violations = port_lockorder.build_graph(REPO)
    assert violations == [], violations
    # the declared edge the extractor cannot see (the registry snapshot
    # reads each histogram under its own lock)
    assert ("metrics.registry", "metrics.histogram") in edges
    for a, b in edges:
        if a != b:
            assert port_registry.rank_of(a) < port_registry.rank_of(b), \
                (a, b)


def test_static_graph_extracts_a_nested_edge_from_code(tmp_path):
    """The extractor reads the port's code, not just EXTRA_EDGES: a
    copy of the registry's module with a nesting added yields its edge
    (and, against the ranks, its inversion)."""
    rel = "spark_tpu_torch/parallel/mesh.py"
    with open(os.path.join(REPO, rel)) as f:
        src = f.read()
    src += ("\n\ndef _nested():\n"
            "    with _COPY_LOCK:\n"
            "        with lock:\n"
            "            pass\n")
    a = port_lockorder.LockOrderAnalysis()
    a.add_file(rel, ast.parse(src))
    edges, out = a.finish()
    assert ("mesh.copy_stats", "mesh.shard_errors") in edges
    assert out == []


# ---------------------------------------------------------------------------
# lockwatch units, through both packages
# ---------------------------------------------------------------------------


class _Holder:
    def __init__(self):
        self.a = threading.Lock()
        self.b = threading.Lock()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_lockwatch_records_edges_and_asserts_order(pkg):
    h = _Holder()
    watch = PACKAGES[pkg][3].LockWatch()
    # registry ids both packages share: udf.pool (59) < metrics.registry
    watch.watch_attr(h, "a", "udf.pool")
    watch.watch_attr(h, "b", "metrics.registry")
    with h.a:
        with h.b:
            pass
    assert watch.edges() == {("udf.pool", "metrics.registry"): 1}
    watch.assert_order_consistent()
    stats = watch.report()["locks"]
    assert stats["udf.pool"]["acquires"] == 1
    assert stats["udf.pool"]["hold_s"] > 0
    watch.uninstall()
    assert h.a.__class__ is threading.Lock().__class__


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_lockwatch_detects_inverted_order(pkg):
    h = _Holder()
    watch = PACKAGES[pkg][3].LockWatch()
    watch.watch_attr(h, "a", "metrics.registry")   # rank 60
    watch.watch_attr(h, "b", "udf.pool")           # rank 59
    with h.a:
        with h.b:
            pass
    with pytest.raises(AssertionError, match="inverts the registry"):
        watch.assert_order_consistent()
    watch.uninstall()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_lockwatch_condition_wait_releases_hold(pkg):
    class _CvBox:
        def __init__(self):
            self.cv = threading.Condition()

    box = _CvBox()
    watch = PACKAGES[pkg][3].LockWatch()
    watch.watch_attr(box, "cv", "udf.pool")
    state = {"ready": False}

    def producer():
        with box.cv:
            state["ready"] = True
            box.cv.notify_all()

    with box.cv:
        t = threading.Thread(target=producer)
        t.start()
        assert box.cv.wait_for(lambda: state["ready"], timeout=5)
    t.join(5)
    watch.assert_order_consistent()
    assert watch.report()["locks"]["udf.pool"]["acquires"] >= 2
    watch.uninstall()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_lockwatch_counts_contention(pkg):
    h = _Holder()
    watch = PACKAGES[pkg][3].LockWatch()
    watch.watch_attr(h, "a", "obs.bus")
    entered = threading.Event()
    release = threading.Event()

    def holder():
        with h.a:
            entered.set()
            release.wait(5)

    t = threading.Thread(target=holder)
    t.start()
    entered.wait(5)
    assert h.a.acquire(blocking=False) is False
    release.set()
    t.join(5)
    assert watch.report()["locks"]["obs.bus"]["contended"] >= 1
    watch.uninstall()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_lockwatch_distinct_same_id_locks_flag_abba_shape(pkg):
    h = _Holder()
    watch = PACKAGES[pkg][3].LockWatch()
    watch.watch_attr(h, "a", "obs.bus")
    watch.watch_attr(h, "b", "obs.bus")  # distinct lock, same id
    with h.a:
        with h.b:
            pass
    assert ("obs.bus", "obs.bus") in watch.edges()
    with pytest.raises(AssertionError, match="ABBA"):
        watch.assert_order_consistent()
    watch.uninstall()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_lockwatch_reentrant_same_object_not_flagged(pkg):
    class _R:
        def __init__(self):
            self.lk = threading.RLock()

    h = _R()
    watch = PACKAGES[pkg][3].LockWatch()
    watch.watch_attr(h, "lk", "io.device_cache")
    with h.lk:
        with h.lk:
            pass
    assert watch.edges() == {}
    watch.assert_order_consistent()
    watch.uninstall()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_lockwatch_thread_leak_assertion(pkg):
    watch = PACKAGES[pkg][3].LockWatch()
    ok = threading.Thread(target=lambda: time.sleep(0.2), daemon=True,
                          name=f"spark-tpu-leaktest-short-{pkg}")
    ok.start()
    watch.assert_no_thread_leak(prefix=f"spark-tpu-leaktest-short-{pkg}",
                                timeout_s=5)
    bad = threading.Thread(target=lambda: time.sleep(3), daemon=True,
                           name=f"spark-tpu-leaktest-long-{pkg}")
    bad.start()
    with pytest.raises(AssertionError, match="still alive"):
        watch.assert_no_thread_leak(
            prefix=f"spark-tpu-leaktest-long-{pkg}", timeout_s=0.3)


def test_lockwatch_install_service_waits_for_serving():
    """`install_service` no longer raises: it wraps a service's locks
    and each pooled session's lease (the full check of every declared
    service lock is in `test_install_service_wraps_every_service_lock`)."""
    from spark_tpu_torch.service.server import SqlService
    svc = SqlService(device="cpu")
    svc.pool.get_or_create("a")
    watch = port_lockwatch.LockWatch()
    try:
        watch.install_service(svc)
        assert type(svc.pool._entries["a"].lock).__name__ == "_WatchedLock"
        assert type(svc.admission._cv).__name__ == "_WatchedCondition"
    finally:
        watch.uninstall()
        svc.stop()
    assert type(svc.admission._cv).__name__ == "Condition"


def test_service_locks_match_the_reference():
    """The SQL service's locks keep the JAX package's ids, kinds and
    ranks; since slice 12c part 2 the fleet's two are there too. The
    admission slot is a registered context manager in both, and every
    edge the JAX package declares out of the session lease is declared
    here but the compile cache's."""
    port = {d.lock_id: d for d in LOCKS if d.lock_id.startswith("service.")}
    ref = {d.lock_id: d for d in ref_registry.LOCKS
           if d.lock_id.startswith("service.")}
    assert set(ref) == set(port) and len(port) == 13
    for lock_id, d in port.items():
        assert (d.rank, d.kind, d.attr, d.cls) == \
            (ref[lock_id].rank, ref[lock_id].kind, ref[lock_id].attr,
             ref[lock_id].cls), lock_id
    assert port_registry.CONTEXT_MANAGERS == ref_registry.CONTEXT_MANAGERS
    ref_edges = {(a, b) for a, b, _ in ref_registry.EXTRA_EDGES
                 if a.startswith("service.") and "fleet" not in a}
    port_edges = {(a, b) for a, b, _ in port_registry.EXTRA_EDGES}
    assert ref_edges - port_edges == {
        ("service.session", "execution.compile_cache")}
    for a, b in port_edges:
        assert port_registry.rank_of(a) < port_registry.rank_of(b), (a, b)


def test_install_service_wraps_every_service_lock():
    """`install_service` wraps every lock the registry declares for the
    service (each pooled session's lease included) and `uninstall`
    restores them. The fleet's two `service.fleet_*` locks are the
    supervisor's, not a service's: no SqlService owns them."""
    from spark_tpu_torch.service.server import SqlService
    svc = SqlService(device="cpu")
    entries = [svc.pool.get_or_create(n) for n in ("a", "b")]
    owners = {"SqlService": [svc], "_Entry": entries,
              "SessionPool": [svc.pool], "SessionQuota": [svc.session_quota],
              "AdmissionController": [svc.admission],
              "DeviceResourceArbiter": [svc.arbiter],
              "ResultCache": [svc.arbiter.result_cache],
              "QueryHistoryStore": [svc.history]}
    decls = [d for d in LOCKS if d.lock_id.startswith("service.")
             and d.relpath != "spark_tpu_torch/service/fleet.py"]
    watch = port_lockwatch.LockWatch()
    try:
        watch.install_service(svc)
        for d in decls:
            for obj in owners[d.cls]:
                assert type(getattr(obj, d.attr)).__name__ in (
                    "_WatchedLock", "_WatchedCondition"), d.lock_id
                assert getattr(obj, d.attr)._lock_id == d.lock_id
        # and every pooled session's own locks, as install_session does
        assert type(entries[0].session._query_seq_lock).__name__ == \
            "_WatchedLock"
    finally:
        watch.uninstall()
        svc.stop()
    for d in decls:
        for obj in owners[d.cls]:
            assert not type(getattr(obj, d.attr)).__name__.startswith(
                "_Watched"), d.lock_id


def test_flight_recorder_bundle_carries_the_lock_report(tmp_path):
    """A bundle dumped while a lockwatch is installed holds its report
    (the JAX package's `lockwatch.json`); after uninstall, none."""
    import json
    from spark_tpu_torch import SparkTpuSession
    from spark_tpu_torch.observability.flight_recorder import FlightRecorder
    s = SparkTpuSession.builder().device("cpu").get_or_create()
    s.conf.set("spark_tpu.sql.flightRecorder.dir", str(tmp_path))
    watch = port_lockwatch.LockWatch()
    watch.install_session(s)
    try:
        s.range(8).collect()
        bundle = FlightRecorder.of(s).dump("lockwatch test")
        with open(os.path.join(bundle, "lockwatch.json")) as f:
            report = json.load(f)
        assert report["installed"] is True
        assert report["locks"]["session.query_seq"]["acquires"] >= 1
    finally:
        watch.uninstall()
    bundle = FlightRecorder.of(s).dump("after")
    with open(os.path.join(bundle, "lockwatch.json")) as f:
        assert json.load(f) == {"installed": False}


# ---------------------------------------------------------------------------
# a CPU stress of phase 18(d)'s shape
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tpch_path(tmp_path_factory):
    from spark_tpu_torch.tpch.datagen import write_parquet
    path = str(tmp_path_factory.mktemp("tpch_lockwatch") / "sf")
    write_parquet(path, 0.002)
    return path


def test_session_stress_under_lockwatch(tpch_path, tmp_path):
    """One CPU session, four threads running TPC-H Q1/Q5/Q6 (SQL) and
    `range(n).group_by(id % 64)`, with the event log, Chrome traces and
    both metrics sinks on and the ingest prefetcher streaming 1,024-row
    chunks, while a supervised streaming query triggers on its own
    thread: every result equals its single-thread result, the observed
    acquisition order is consistent with the registry ranks (every
    observed nesting is an edge of the static graph), and no prefetch or
    trigger thread outlives its query."""
    import pandas as pd

    from spark_tpu_torch import SparkTpuSession
    from spark_tpu_torch import functions as F
    from spark_tpu_torch import streaming
    from spark_tpu_torch.functions import col
    from spark_tpu_torch.testing import faults
    from spark_tpu_torch.tpch.queries import register_tables
    from spark_tpu_torch.tpch.sql_queries import SQL_QUERIES

    s = SparkTpuSession.builder().device("cpu").get_or_create()
    register_tables(s, tpch_path)
    for key, value in (
            ("spark_tpu.sql.eventLog.dir", str(tmp_path / "events")),
            ("spark_tpu.sql.trace.dir", str(tmp_path / "traces")),
            ("spark_tpu.sql.metrics.sink", "prometheus,jsonl"),
            ("spark_tpu.sql.metrics.dir", str(tmp_path / "metrics")),
            ("spark_tpu.sql.execution.streamingChunkRows", 1024),
            ("spark_tpu.sql.io.deviceCacheBytes", 0)):
        s.conf.set(key, value)

    def program(name):
        if name == "range":
            return (s.range(1 << 14).group_by((col("id") % 64).alias("k"))
                    .agg(F.sum(col("id")).alias("s"), F.count().alias("n"))
                    .sort(col("k")))
        return s.sql(SQL_QUERIES[name])

    names = ("q1", "q5", "q6", "range")
    alone = {n: program(n).collect() for n in names}

    src = streaming.MemoryStream(s, pd.DataFrame({"k": [0], "v": [0]}))
    query = (src.to_df().group_by(F.pmod(col("k"), 16).alias("g"))
             .agg(F.sum(col("v")).alias("sv"))
             .write_stream(str(tmp_path / "ckpt")))
    watch = port_lockwatch.LockWatch()
    watch.install_session(s)
    watch.install_query(query)
    faults.arm(s.conf)
    watch.install_faults()
    results, errors = [], []
    switch = sys.getswitchinterval()
    # switch threads often, so that unguarded read-modify-writes would
    # interleave
    sys.setswitchinterval(1e-5)
    try:
        query.start(trigger_ms=20)
        for i in range(6):
            src.add_data(pd.DataFrame({"k": list(range(i, i + 40)),
                                       "v": [1] * 40}))

        def run(offset):
            try:
                for i in range(4):
                    n = names[(offset + i) % len(names)]
                    results.append((n, program(n).collect()))
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(repr(e))

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads), "query wedged"
        deadline = time.monotonic() + 30
        while query.latest() is None or \
                int(query.latest()["sv"].sum()) < 240:
            assert time.monotonic() < deadline, "the stream fell behind"
            time.sleep(0.05)
        query.stop()
        assert errors == [], errors
        assert len(results) == 16
        for n, table in results:
            assert table.equals(alone[n]), n
        # one session and no service lease above its locks: every
        # nesting observed must be one the static graph predicts
        static, _ = port_lockorder.build_graph(REPO)
        assert set(watch.edges()) <= set(static), watch.edges()
        watch.assert_order_consistent()
        watch.assert_no_thread_leak()
        watch.assert_no_thread_leak(prefix="spark-tpu-stream-trigger")
        report = watch.report()["locks"]
        for lock_id in ("obs.bus", "execution.lifecycle",
                        "session.query_seq", "streaming.trigger",
                        "obs.event_log"):
            assert report[lock_id]["acquires"] > 0, lock_id
    finally:
        sys.setswitchinterval(switch)
        query.stop()
        watch.uninstall()
        faults.reset()
