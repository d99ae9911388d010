"""Shared harness of the out-of-core and recovery parity tests
(`tests/test_torch_streaming_agg.py`, `_spill.py`, `_recovery.py`,
`_faults.py`, `_lifecycle.py`).

A `Pair` holds a port session and a fresh JAX-package session over the
same TPC-H Parquet files (SF 0.002, about 12,000 lineitem rows), both
under the streaming conf of the JAX package's own chaos tests: chunks of
1,024 rows, the device table cache off (so the streams engage), and
millisecond backoffs. `run` executes one query through both, each under
the same fault spec (each package arms its own plan), and returns both
results with their QueryExecutions; `spliced` gives the plan a JAX
execution ran, with its streamed aggregates spliced in, for comparison
with the port's `QueryExecution.spliced_plan`.
"""

import contextlib
import os

import pyarrow as pa

import spark_tpu.execution.executor as RE
from spark_tpu.io.device_cache import CACHE as REF_CACHE
from spark_tpu.io.sources import ParquetSource as RefParquetSource
from spark_tpu.session import SparkTpuSession as RefSession
from spark_tpu.testing import faults as ref_faults
from spark_tpu.tpch import queries as RQ
from spark_tpu_torch import SparkTpuSession
from spark_tpu_torch.io.device_cache import CACHE
from spark_tpu_torch.io.sources import ParquetSource
from spark_tpu_torch.testing import faults
from spark_tpu_torch.tpch import golden as G
from spark_tpu_torch.tpch import queries as PQ
from spark_tpu_torch.tpch.datagen import write_parquet

SF = 0.002
CHUNK_KEY = "spark_tpu.sql.execution.streamingChunkRows"
CACHE_KEY = "spark_tpu.sql.io.deviceCacheBytes"
BUDGET_KEY = "spark_tpu.sql.memory.deviceBudget"
BACKOFF_KEY = "spark_tpu.execution.backoffMs"
DOMAIN_KEY = "spark_tpu.sql.aggregate.maxDirectDomain"
TABLES = ("lineitem", "orders", "customer", "supplier", "nation", "region",
          "part", "partsupp")

#: the streaming conf every case starts from
STREAMING = ((CHUNK_KEY, 1024), (CACHE_KEY, 0), (BACKOFF_KEY, 1))


def write_data(tmp_path_factory, tag: str) -> str:
    path = str(tmp_path_factory.mktemp(f"tpch_{tag}") / "sf_small")
    write_parquet(path, SF)
    return path


class Pair:
    """A port session and a JAX-package session over the TPC-H data."""

    def __init__(self, path: str, tag: str):
        self.path = path
        self.port = SparkTpuSession.builder().device("cpu").get_or_create()
        self.ref = RefSession(register_active=False)
        for t in TABLES:
            file = os.path.join(path, f"{t}.parquet")
            self.port.register_table(t, ParquetSource(file, f"{t}_{tag}"))
            self.ref.register_table(t, RefParquetSource(file, f"{t}_{tag}"))
        self._base = (dict(self.port.conf._settings),
                      dict(self.ref.conf._settings))

    def reset(self, confs=STREAMING) -> None:
        """Restore both confs, disarm faults, empty the device caches and
        the kept capacities, then apply `confs`."""
        self.port.conf._settings = dict(self._base[0])
        self.ref.conf._settings = dict(self._base[1])
        faults.reset()
        ref_faults.reset()
        self.cold()
        self.set(*confs)

    def cold(self) -> None:
        CACHE.clear()
        REF_CACHE.clear()
        self.port._aqe_caps.clear()
        self.ref._aqe_caps.clear()
        self.ref._stage_cache.clear()

    def set(self, *confs) -> None:
        for key, value in confs:
            self.port.conf.set(key, value)
            self.ref.conf.set(key, value)

    def run(self, make, spec: str = ""):
        """`make(session)` -> DataFrame through both packages, under the
        fault spec `spec` when given. Returns (port table, port qe, ref
        table, ref qe, port fault plan, ref fault plan); a package that
        raised has its exception in place of its table."""
        with contextlib.ExitStack() as stack:
            plans = [None, None]
            if spec:
                plans[0] = stack.enter_context(
                    faults.inject(self.port.conf, spec))
            pqe = make(self.port)._qe()
            got = _outcome(pqe.collect)
            if spec:
                faults.reset()
                plans[1] = stack.enter_context(
                    ref_faults.inject(self.ref.conf, spec))
            rqe = make(self.ref)._qe()
            want = _outcome(rqe.collect)
        return got, pqe, want, rqe, plans[0], plans[1]


def _outcome(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 — the caller compares outcomes
        return e


def query(qname):
    """The TPC-H DataFrame program `qname` of the package the session
    belongs to."""
    def make(session):
        mod = PQ if isinstance(session, SparkTpuSession) else RQ
        return mod.QUERIES[qname](session)
    return make


@contextlib.contextmanager
def spliced():
    """Capture the plans JAX executions ran (streamed aggregates spliced
    in): yields a list that each execution appends its plan to."""
    seen = []
    orig = RE.QueryExecution._materialize_streaming

    def wrap(self, node, mesh=None):
        out = orig(self, node, mesh)
        seen.append(out)
        return out

    RE.QueryExecution._materialize_streaming = wrap
    try:
        yield seen
    finally:
        RE.QueryExecution._materialize_streaming = orig


def assert_same(got, want) -> None:
    assert isinstance(got, pa.Table), got
    assert isinstance(want, pa.Table), want
    assert got.schema == want.schema
    assert got.equals(want)


def check_golden(got: pa.Table, qname: str, path: str) -> None:
    G.compare(G.normalize_decimals(got.to_pandas()).reset_index(drop=True),
              G.GOLDEN[qname](path))
