"""The port's out-of-process UDF lane (`spark_tpu_torch/udf_worker/`,
`spark_tpu.sql.udf.mode=worker`) on the CPU, held to the port's
in-process lane and to the JAX package's worker lane (the single-device
cases of `tests/test_udf_worker.py`).

- Parity: each case's worker-lane result is byte-equal to the port's
  in-process result and matches the JAX package's worker lane (floats
  within rtol 1e-12, the rest exactly), over scalar, pandas and
  grouped-map UDFs, NULLs, strings, dates, decimals and nesting.
- Counters and `qe.udf_summary`, against the JAX package's.
- Batch-granular retry: a worker killed mid-batch replays exactly the
  in-flight batch; a wedged worker past `udf.batchTimeoutMs` is killed
  and its batch replays; a failed spawn is retried.
- The pool: its bound, reuse across queries, the lazy reap of workers
  that died between queries.
- A user exception surfaces as `UdfError` with the worker's traceback; a
  cancel mid-UDF raises the structured cancel error and leaves no child.
- A worker imports neither torch nor the port; without cloudpickle a
  lambda raises `UdfNotShippable` instead of changing lanes.

The JAX package's analyzer findings, predictions, event-log record and
SQL service cases wait for the port's serving slice.
"""

import decimal
import sys
import threading
import time

import numpy as np
import pandas as pd
import pytest

import spark_tpu.functions as RF
from spark_tpu.session import SparkTpuSession as RefSession
from spark_tpu.testing import faults as ref_faults
from spark_tpu_torch import SparkTpuSession
from spark_tpu_torch import functions as PF
from spark_tpu_torch.execution import lifecycle
from spark_tpu_torch.testing import faults
from spark_tpu_torch.udf_worker import UdfError, UdfNotShippable

from torch_sql_parity import assert_tables_match

MODE_KEY = "spark_tpu.sql.udf.mode"
BATCH_KEY = "spark_tpu.sql.udf.arrow.maxRecordsPerBatch"
TIMEOUT_KEY = "spark_tpu.sql.udf.batchTimeoutMs"
MAXW_KEY = "spark_tpu.sql.udf.pool.maxWorkers"
BACKOFF_KEY = "spark_tpu.execution.backoffMs"


class Side:
    def __init__(self, session, F):
        self.session = session
        self.F = F
        self.conf = session.conf
        self._base = dict(session.conf._settings)

    def table(self, name):
        return self.session.table(name)

    def reset(self):
        self.conf._settings = dict(self._base)
        self.conf.set(BACKOFF_KEY, 1)


@pytest.fixture(scope="module")
def sides():
    port = Side(SparkTpuSession.builder().device("cpu").get_or_create(), PF)
    ref = Side(RefSession(register_active=False), RF)
    frames = {
        "udfw_t": pd.DataFrame({
            "x": np.array([1.0, 2.0, np.nan, 4.0, 5.5, np.nan, 7.0]),
            "i": np.array([10, 20, 30, 40, 50, 60, 70], dtype=np.int64),
            "s": ["aa", "bb", None, "dd", None, "ff", "gg"]}),
        "udfw_dt": pd.DataFrame({
            "d": pd.to_datetime(["2023-01-15", "2024-06-30", "2025-12-01"]),
            "m": [decimal.Decimal("12.50"), decimal.Decimal("0.75"),
                  decimal.Decimal("99.99")]}),
        "udfw_gm": pd.DataFrame({
            "k": np.array([0, 0, 1, 1, 2], dtype=np.int64),
            "v": np.array([1.0, 3.0, 5.0, 7.0, 9.0])}),
    }
    for side in (port, ref):
        for name, frame in frames.items():
            side.session.register_table(name, frame)
    yield port, ref
    for side in (port, ref):
        side.session._udf_pool.shutdown()


@pytest.fixture(autouse=True)
def clean(sides):
    for side in sides:
        side.reset()
    faults.reset()
    ref_faults.reset()
    yield
    faults.reset()
    ref_faults.reset()


def lanes(side, build):
    """(in-process result, worker-lane result) of `build(side)`."""
    side.conf.set(MODE_KEY, "inprocess")
    a = build(side).collect()
    side.conf.set(MODE_KEY, "worker")
    b = build(side).collect()
    return a, b


# -- parity ------------------------------------------------------------------


def _local_functions():
    """Functions defined here, not at module level: cloudpickle ships a
    module-level function of an importable module by reference, and the
    worker cannot import the test module."""
    def center(g: pd.DataFrame) -> pd.DataFrame:
        return pd.DataFrame({"k": g["k"], "c": g["v"] - g["v"].mean()})

    def scaled(v: pd.Series) -> pd.Series:
        return v * 10.0

    return center, scaled


_center, _scaled = _local_functions()
_plus = lambda v: None if v is None else v + 1.0  # noqa: E731
_shout = lambda s: None if s in (None, "bb") else s.upper()  # noqa: E731
_is_big = lambda v: v is not None and v > 25  # noqa: E731
_double = lambda v: None if v is None else v * 2  # noqa: E731
_inc = lambda v: None if v is None else v + 1  # noqa: E731
_year = lambda d: d.year  # noqa: E731
_dollars = lambda m: float(m) * 2  # noqa: E731
_half = lambda v: v / 2.0  # noqa: E731

#: (case, rows per Arrow batch, the DataFrame of one side)
PARITY = [
    ("scalar_with_nulls", 3, lambda s: s.table("udfw_t").select(
        s.F.col("i"), s.F.udf(_plus, "double")(s.F.col("x")).alias("y"))),
    ("strings_and_null_returns", 2, lambda s: s.table("udfw_t").select(
        s.F.udf(_shout, "string")(s.F.col("s")).alias("u"))),
    ("pandas_udf", 4, lambda s: s.table("udfw_t").select(
        s.F.pandas_udf(_scaled, "double")(s.F.col("x")).alias("y"))),
    ("filter_and_nested", 2, lambda s: s.table("udfw_t").filter(
        s.F.udf(_is_big, "boolean")(s.F.col("i") + 1)).select(
        s.F.udf(_inc, "long")(s.F.udf(_double, "long")(s.F.col("i")))
        .alias("y"))),
    ("dates_and_decimals", 2, lambda s: s.table("udfw_dt").select(
        s.F.udf(_year, "int")(s.F.col("d")).alias("y"),
        s.F.udf(_dollars, "double")(s.F.col("m")).alias("v"))),
    ("grouped_map", 10000, lambda s: s.table("udfw_gm").group_by(
        s.F.col("k")).apply_in_pandas(_center, "k long, c double")),
    ("udf_under_agg", 3, lambda s: s.table("udfw_t").filter(
        s.F.col("i") > 10).select(
        s.F.udf(_half, "double")(s.F.col("i")).alias("h")).agg(
        s.F.sum(s.F.col("h")).alias("s"))),
]


@pytest.mark.parametrize("case,batch,build", PARITY,
                         ids=[c[0] for c in PARITY])
def test_worker_parity(sides, case, batch, build):
    port, ref = sides
    for side in sides:
        side.conf.set(BATCH_KEY, batch)
    inproc, worker = lanes(port, build)
    assert worker.equals(inproc)  # byte-equal across the port's lanes
    ref.conf.set(MODE_KEY, "worker")
    assert_tables_match(worker, build(ref).collect())


def test_worker_mode_metrics_and_summary(sides):
    twice = lambda v: v * 2  # noqa: E731
    summaries = []
    for side in sides:
        side.conf.set(MODE_KEY, "worker")
        side.conf.set(BATCH_KEY, 3)
        m = side.session.metrics
        b0, r0 = m.counter("udf_batches").value, m.counter("udf_rows").value
        qe = side.table("udfw_t").select(
            side.F.udf(twice, "long")(side.F.col("i")).alias("t"))._qe()
        qe.collect()
        assert m.counter("udf_batches").value - b0 == 3  # ceil(7/3)
        assert m.counter("udf_rows").value - r0 == 7
        summaries.append({k: v for k, v in qe.udf_summary.items()
                          if k != "exec_ms"})
    assert summaries[0] == summaries[1]
    assert summaries[0]["mode"] == "worker"
    assert (summaries[0]["batches"], summaries[0]["rows"]) == (3, 7)


def test_worker_imports_neither_torch_nor_the_port(sides):
    port, _ = sides
    port.conf.set(MODE_KEY, "worker")
    probe = lambda v: any(  # noqa: E731
        m == "torch" or m.startswith(("torch.", "spark_tpu"))
        for m in __import__("sys").modules)
    out = port.table("udfw_t").select(
        port.F.udf(probe, "boolean")(port.F.col("i")).alias("t")).collect()
    assert out.column("t").to_pylist() == [False] * 7
    # the probe sees them in the engine's own process
    port.conf.set(MODE_KEY, "inprocess")
    out = port.table("udfw_t").select(
        port.F.udf(probe, "boolean")(port.F.col("i")).alias("t")).collect()
    assert out.column("t").to_pylist() == [True] * 7


# -- batch-granular retry ----------------------------------------------------


def test_killed_worker_replays_exactly_one_batch(sides):
    port, ref = sides
    twice = lambda v: v * 2  # noqa: E731
    results, summaries = [], []
    for side, mod in ((port, faults), (ref, ref_faults)):
        side.conf.set(BATCH_KEY, 3)
        build = lambda: side.table("udfw_t").select(  # noqa: E731
            side.F.udf(twice, "long")(side.F.col("i")).alias("t"))
        want = build().collect()
        side.conf.set(MODE_KEY, "worker")
        metrics = side.session.metrics
        pool = side.session._udf_pool
        replayed0 = metrics.counter("rec_chunks_replayed").value
        restarts0 = metrics.counter("udf_worker_restarts").value
        before = {id(p) for p in pool.child_procs()}
        with mod.inject(side.conf, "udf_batch:fatal:2") as plan:
            qe = build()._qe()
            out = qe.collect()
            assert plan.fired_log == [("udf_batch", 2, "fatal")]
        assert out.equals(want)
        # EXACTLY the in-flight batch replayed, not the whole input
        assert metrics.counter("rec_chunks_replayed").value - replayed0 == 1
        assert metrics.counter("udf_worker_restarts").value - restarts0 == 1
        assert any(p.poll() is not None for p in pool.child_procs())
        assert [p for p in pool.child_procs() if id(p) not in before], \
            "no replacement worker was spawned"
        results.append(out)
        summaries.append((qe.fault_summary, qe.udf_summary["batches"],
                          qe.udf_summary["worker_restarts"]))
    assert_tables_match(results[0], results[1])
    assert summaries[0] == summaries[1]


def test_worker_spawn_fault_recovers(sides):
    port, ref = sides
    plus = lambda v: None if v is None else v + 1.0  # noqa: E731
    results = []
    for side, mod in ((port, faults), (ref, ref_faults)):
        side.session._udf_pool.shutdown()  # the next checkout spawns
        side.conf.set(MODE_KEY, "worker")
        with mod.inject(side.conf, "udf_worker_spawn:unavailable:1") as plan:
            qe = side.table("udfw_t").select(
                side.F.udf(plus, "double")(side.F.col("x")).alias("y"))._qe()
            results.append(qe.collect())
            assert plan.fired_log == [("udf_worker_spawn", 1,
                                       "unavailable")]
        assert qe.fault_summary.get("chunk_retry") == 1
    assert_tables_match(results[0], results[1])


def test_wedged_worker_batch_timeout_recovers(sides, tmp_path):
    """The first attempt wedges far past the batch timeout; the worker is
    killed and the batch replays on a fresh worker, where the flag file
    makes the UDF return at once."""
    port, _ = sides
    flag = str(tmp_path / "udfw_wedge_once")
    port.conf.set(MODE_KEY, "worker")
    port.conf.set(BATCH_KEY, 100)
    port.conf.set(TIMEOUT_KEY, 800)

    def wedge_once(v):
        import os as _os
        import time as _time
        if not _os.path.exists(flag):
            open(flag, "w").close()
            _time.sleep(60)
        return v if v is None else v + 1.0

    t0 = time.perf_counter()
    out = port.table("udfw_t").select(
        port.F.udf(wedge_once, "double")(port.F.col("x")).alias("y")
    ).collect().to_pandas()
    took = time.perf_counter() - t0
    assert took < 30, f"wedge recovery took {took:.1f}s"
    assert out["y"][0] == 2.0 and pd.isna(out["y"][2])


# -- the pool ----------------------------------------------------------------


def test_pool_bound_and_reuse_across_queries(sides):
    port, _ = sides
    pool = port.session._udf_pool
    pool.shutdown()
    port.conf.set(MODE_KEY, "worker")
    port.conf.set(MAXW_KEY, 1)
    port.conf.set(BATCH_KEY, 2)
    twice = lambda v: v * 2  # noqa: E731
    build = lambda: port.table("udfw_t").select(  # noqa: E731
        port.F.udf(twice, "long")(port.F.col("i")).alias("t"))
    build().collect()
    assert pool.live_count() == 1 and pool.idle_count() == 1
    pid0 = pool._idle[0].pid
    build().collect()
    assert pool.live_count() == 1, \
        "the second query must reuse the pooled worker, not spawn"
    assert pool._idle[0].pid == pid0, "the worker was not reused"


def test_worker_died_between_queries_reaped_lazily(sides):
    port, _ = sides
    port.conf.set(MODE_KEY, "worker")
    port.conf.set(BATCH_KEY, 4)
    twice = lambda v: v * 2  # noqa: E731
    build = lambda: port.table("udfw_t").select(  # noqa: E731
        port.F.udf(twice, "long")(port.F.col("i")).alias("t"))
    want = build().collect()
    pool = port.session._udf_pool
    assert pool.idle_count() >= 1
    for h in list(pool._idle):  # kill every idle worker behind its back
        h.proc.kill()
        h.proc.wait(10)
    assert build().collect().equals(want)


def test_user_error_surfaces_worker_traceback(sides):
    port, _ = sides
    port.conf.set(MODE_KEY, "worker")

    def boom(v):
        raise ValueError("user bug here")

    with pytest.raises(UdfError) as ei:
        port.table("udfw_t").select(
            port.F.udf(boom, "double")(port.F.col("x")).alias("y")).collect()
    assert "user bug here" in str(ei.value)
    assert ei.value.code == "UDF_ERROR" and ei.value.etype == "ValueError"
    assert "in boom" in ei.value.worker_traceback
    # the pool survives a user error: the next query uses the lane
    ok = lambda v: v  # noqa: E731
    port.table("udfw_t").select(
        port.F.udf(ok, "double")(port.F.col("x")).alias("y")).collect()


def test_cancel_mid_udf_no_orphans(sides):
    port, _ = sides
    port.conf.set(MODE_KEY, "worker")
    port.conf.set(BATCH_KEY, 1)
    session = port.session

    def slow(v):
        import time as _time
        _time.sleep(0.4)
        return v

    build = lambda: port.table("udfw_t").select(  # noqa: E731
        port.F.udf(slow, "double")(port.F.col("x")).alias("y"))
    qe = build()._qe()
    out = {}

    def run():
        try:
            out["table"] = qe.collect()
        except Exception as e:  # noqa: BLE001 — asserted below
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    # let the first batch reach a worker, then cancel mid-batch
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and \
            session.metrics.counter("udf_batches").value == 0 and \
            not session._udf_pool.live_count():
        time.sleep(0.01)
    time.sleep(0.2)
    assert session.cancel(qe.query_id)
    t.join(30)
    assert not t.is_alive()
    assert isinstance(out.get("error"), lifecycle.QueryCancelledError), out
    assert qe.fault_summary.get("cancel") == 1
    # zero children survive a cancelled query
    procs = session._udf_pool.child_procs()
    assert procs and all(p.poll() is not None for p in procs)
    assert session._udf_pool.live_count() == 0
    # an immediate rerun gives the in-process bytes
    port.conf.set(MODE_KEY, "inprocess")
    want = build().collect()
    port.conf.set(MODE_KEY, "worker")
    assert build().collect().equals(want)


# -- shipping functions without cloudpickle ----------------------------------


def test_without_cloudpickle_only_importable_functions_ship(sides,
                                                            monkeypatch):
    import math
    port, _ = sides
    port.conf.set(MODE_KEY, "inprocess")
    build = lambda fn: port.table("udfw_t").select(  # noqa: E731
        port.F.udf(fn, "long")(port.F.col("i")).alias("f"))
    want = build(math.isqrt).collect()
    monkeypatch.setitem(sys.modules, "cloudpickle", None)
    port.conf.set(MODE_KEY, "worker")
    # a builtin travels by reference through plain pickle
    assert build(math.isqrt).collect().equals(want)
    # a lambda cannot: a named error, never a switch to the other lane
    with pytest.raises(UdfNotShippable, match="cloudpickle is not"):
        build(lambda v: v).collect()
