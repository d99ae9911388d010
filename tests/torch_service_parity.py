"""Shared harness of the SQL service parity tests
(`tests/test_torch_service.py`, `tests/test_torch_service_concurrency.py`).

`PORT` and `REF` name one package's service surface each: the port's
`spark_tpu_torch.service` with its pooled sessions on the CPU device,
and the JAX package's on the CPU backend `tests/conftest.py` forces.
`both(case)` runs `case(P)` once per package and returns the two
results; the case makes the JAX test's assertions on each package and
returns what it observed, which the test then holds equal.

`same_table(got, want)` holds the port's Arrow result to the
reference's: ints, decimals and strings exactly, floats within rtol
1e-12. `same_rows` does the same for the JSON rows `POST /sql` returns.
`service_counters(svc)` is the set of the `service_*`, `arbiter_*`,
`result_cache_*` and `session_quota_*` counter names a service's shared
registry holds.
"""

import math
import types

import numpy as np
import torch

import spark_tpu.history as ref_history
import spark_tpu.io.device_cache as ref_device_cache
import spark_tpu.service.admission as ref_admission
import spark_tpu.service.arbiter as ref_arbiter
import spark_tpu.service.pool as ref_pool
import spark_tpu.service.query_history as ref_history_store
import spark_tpu.service.server as ref_server
import spark_tpu.streaming as ref_streaming
from spark_tpu import functions as RF
from spark_tpu import types as RT
from spark_tpu.config import Conf as RefConf
from spark_tpu.execution.streaming_agg import \
    _prefer_resident as ref_prefer_resident
from spark_tpu.observability import QueryListener as RefListener
from spark_tpu.observability.metrics import \
    parse_prometheus_text as ref_parse
from spark_tpu.session import SparkTpuSession as RefSession
from spark_tpu.testing import lockwatch as ref_lockwatch
from spark_tpu.tpch import queries as RQ

import spark_tpu_torch.history as port_history
import spark_tpu_torch.io.device_cache as port_device_cache
import spark_tpu_torch.service.admission as port_admission
import spark_tpu_torch.service.arbiter as port_arbiter
import spark_tpu_torch.service.pool as port_pool
import spark_tpu_torch.service.query_history as port_history_store
import spark_tpu_torch.service.server as port_server
import spark_tpu_torch.streaming as port_streaming
from spark_tpu_torch import SparkTpuSession
from spark_tpu_torch import functions as PF
from spark_tpu_torch import types as PT
from spark_tpu_torch.config import Conf as PortConf
from spark_tpu_torch.execution.streaming_agg import \
    _prefer_resident as port_prefer_resident
from spark_tpu_torch.observability import QueryListener as PortListener
from spark_tpu_torch.observability.metrics import \
    parse_prometheus_text as port_parse
from spark_tpu_torch.testing import lockwatch as port_lockwatch
from spark_tpu_torch.tpch import golden as G
from spark_tpu_torch.tpch import queries as PQ

FLOAT_RTOL = 1e-12

#: the counter families the service tests compare by name
COUNTER_PREFIXES = ("service_", "arbiter_", "result_cache_",
                    "session_quota_")


def _port_batch(n):
    """A Batch stand-in the port's `batch_nbytes` can size: one uint8
    column of n bytes."""
    col = types.SimpleNamespace(data=torch.zeros(n, dtype=torch.uint8),
                                validity=None, offsets=None,
                                elem_validity=None)
    return types.SimpleNamespace(columns={"c": col}, selection=None)


def _ref_batch(n):
    """The JAX test's Batch stand-in: one numpy uint8 column."""
    col = types.SimpleNamespace(data=np.zeros(n, dtype="u1"), validity=None)
    return types.SimpleNamespace(columns={"c": col}, selection=None)


def _port_session(register_active=True, conf=None):
    return SparkTpuSession(conf, "cpu", register_active=register_active)


def _ref_session(register_active=False, conf=None):
    s = RefSession(conf, register_active=register_active)
    s.conf.set("spark_tpu.sql.analysis.enabled", False)
    return s


PORT = types.SimpleNamespace(
    name="port", Conf=PortConf, F=PF, T=PT, Session=SparkTpuSession,
    session=_port_session,
    service=lambda conf=None, init_session=None: port_server.SqlService(
        conf, init_session=init_session, device="cpu"),
    arbiter=port_arbiter,
    admission=port_admission, pool=port_pool,
    history_store=port_history_store, device_cache=port_device_cache,
    history=port_history,
    streaming=port_streaming, lockwatch=port_lockwatch,
    register_tables=PQ.register_tables, Listener=PortListener,
    parse_prometheus=port_parse, batch=_port_batch,
    prefer_resident=lambda leaf, conf: port_prefer_resident(
        leaf, conf, torch.device("cpu")))

REF = types.SimpleNamespace(
    name="ref", Conf=RefConf, F=RF, T=RT, Session=RefSession,
    session=_ref_session,
    service=lambda conf=None, init_session=None: ref_server.SqlService(
        conf, init_session=init_session),
    arbiter=ref_arbiter,
    admission=ref_admission, pool=ref_pool,
    history_store=ref_history_store, device_cache=ref_device_cache,
    history=ref_history,
    streaming=ref_streaming, lockwatch=ref_lockwatch,
    register_tables=RQ.register_tables, Listener=RefListener,
    parse_prometheus=ref_parse, batch=_ref_batch,
    prefer_resident=ref_prefer_resident)


def both(case, *args):
    """(port's result, reference's result) of `case(P, *args)`."""
    return case(PORT, *args), case(REF, *args)


def same_table(got, want) -> None:
    """The port's Arrow table equals the reference's: the same schema,
    ints, decimals, strings and NULLs exactly, floats within rtol
    1e-12."""
    import pyarrow as pa
    assert got.schema == want.schema, (got.schema, want.schema)
    assert got.num_rows == want.num_rows
    for name, g, w in zip(want.column_names, got.columns, want.columns):
        if pa.types.is_floating(w.type):
            gv = g.is_valid().to_numpy(zero_copy_only=False)
            wv = w.is_valid().to_numpy(zero_copy_only=False)
            np.testing.assert_array_equal(gv, wv, err_msg=name)
            np.testing.assert_allclose(
                g.to_numpy(zero_copy_only=False)[gv],
                w.to_numpy(zero_copy_only=False)[wv], rtol=FLOAT_RTOL,
                err_msg=name)
        else:
            assert g.equals(w), name


def same_rows(got, want) -> None:
    """JSON rows (lists of dicts) equal, floats within rtol 1e-12."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            if isinstance(w[k], float) and isinstance(g[k], float):
                assert math.isclose(g[k], w[k], rel_tol=FLOAT_RTOL), k
            else:
                assert g[k] == w[k], k


def service_counters(svc) -> set:
    counters = svc.metrics.snapshot()["counters"]
    return {k for k in counters if k.startswith(COUNTER_PREFIXES)}


def check_golden(name, table_or_df, path) -> None:
    """Hold a TPC-H result to the port's pandas golden."""
    df = table_or_df if not hasattr(table_or_df, "to_pandas") \
        else table_or_df.to_pandas()
    want = G.GOLDEN[name](path).reset_index(drop=True)
    got = G.normalize_decimals(df)[list(want.columns)]
    G.compare(got.reset_index(drop=True), want)
