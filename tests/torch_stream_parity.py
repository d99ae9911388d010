"""Shared harness of the streaming parity tests
(`tests/test_torch_streaming.py`, `_durability.py`, `_unattended.py`).

`PORT` and `REF` name one package's streaming surface each: the port's
`spark_tpu_torch` on the CPU device, and the JAX package on the CPU
backend `tests/conftest.py` forces. `both(case, tmp_path)` runs
`case(P, session, base)` once per package, each in a fresh session of
its own (the reference's analyzer off) and under a directory of its own,
and returns the two results; the case makes the JAX test's assertions
on each package and returns what it observed. `same(got, want)` holds
the port's result to the reference's: ints, timestamps, strings and
booleans exactly, floats within rtol 1e-12.
"""

import math
import os
import types

import numpy as np
import pandas as pd

import spark_tpu.execution.failures as ref_failures
import spark_tpu.execution.lifecycle as ref_lifecycle
import spark_tpu.history as ref_history
import spark_tpu.io.network_source as ref_net
import spark_tpu.streaming as ref_streaming
from spark_tpu import functions as RF
from spark_tpu.config import Conf as RefConf
from spark_tpu.execution.state_store import StateStore as RefStateStore
from spark_tpu.expr import AnalysisError as RefAnalysisError
from spark_tpu.observability.flight_recorder import \
    FlightRecorder as RefFlightRecorder
from spark_tpu.session import SparkTpuSession as RefSession
from spark_tpu.testing import faults as ref_faults

import spark_tpu_torch.execution.failures as port_failures
import spark_tpu_torch.execution.lifecycle as port_lifecycle
import spark_tpu_torch.history as port_history
import spark_tpu_torch.io.network_source as port_net
import spark_tpu_torch.streaming as port_streaming
from spark_tpu_torch import SparkTpuSession
from spark_tpu_torch import functions as PF
from spark_tpu_torch.config import Conf as PortConf
from spark_tpu_torch.execution.state_store import StateStore
from spark_tpu_torch.expr import AnalysisError
from spark_tpu_torch.observability.flight_recorder import FlightRecorder
from spark_tpu_torch.testing import faults

FLOAT_RTOL = 1e-12

#: the thread-name prefix of both packages' trigger loops
TRIGGER_PREFIX = "spark-tpu-stream-trigger"


def _port_session():
    return SparkTpuSession.builder().device("cpu").get_or_create()


def _ref_session():
    s = RefSession(register_active=False)
    s.conf.set("spark_tpu.sql.analysis.enabled", False)
    return s


def _surface(name, F, streaming, net, **extra):
    return types.SimpleNamespace(
        name=name, F=F, col=F.col, streaming=streaming,
        MemoryStream=streaming.MemoryStream,
        FileStreamSource=streaming.FileStreamSource,
        FileStreamSink=streaming.FileStreamSink,
        MetadataLog=streaming._MetadataLog, read_sink=streaming.read_sink,
        get_live=streaming.get_live, live_queries=streaming.live_queries,
        SPILL_BYTES_KEY=streaming.SPILL_BYTES_KEY,
        SPILL_PARTS_KEY=streaming.SPILL_PARTS_KEY,
        TRIGGER_BACKOFF_KEY=streaming.TRIGGER_BACKOFF_KEY,
        TRIGGER_MAX_RESTARTS_KEY=streaming.TRIGGER_MAX_RESTARTS_KEY,
        FrameProducer=net.FrameProducer,
        MAX_RECONNECTS_KEY=net.MAX_RECONNECTS_KEY, **extra)


PORT = _surface("port", PF, port_streaming, port_net, faults=faults,
                StateStore=StateStore, Conf=PortConf, history=port_history,
                lifecycle=port_lifecycle, failures=port_failures,
                AnalysisError=AnalysisError, FlightRecorder=FlightRecorder,
                session=_port_session)
REF = _surface("ref", RF, ref_streaming, ref_net, faults=ref_faults,
               StateStore=RefStateStore, Conf=RefConf, history=ref_history,
               lifecycle=ref_lifecycle, failures=ref_failures,
               AnalysisError=RefAnalysisError,
               FlightRecorder=RefFlightRecorder, session=_ref_session)


def both(case, tmp_path, *args):
    """(port result, reference result) of `case(P, session, base,
    *args)`, each package in a fresh session and its own directory."""
    out = []
    for P in (PORT, REF):
        base = os.path.join(str(tmp_path), P.name)
        os.makedirs(base, exist_ok=True)
        out.append(case(P, P.session(), base, *args))
    return out[0], out[1]


def check(case, tmp_path, *args):
    """Run `case` through both packages and hold the port to the
    reference."""
    got, want = both(case, tmp_path, *args)
    same(got, want)
    return got


def same(got, want, where: str = "result") -> None:
    if isinstance(want, pd.DataFrame):
        assert isinstance(got, pd.DataFrame), (where, type(got))
        assert list(got.columns) == list(want.columns), \
            (where, list(got.columns), list(want.columns))
        assert len(got) == len(want), (where, len(got), len(want))
        for c in want.columns:
            _same_column(got[c], want[c], f"{where}[{c!r}]")
        return
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), \
            (where, got, want)
        for k in want:
            same(got[k], want[k], f"{where}[{k!r}]")
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), (where, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{where}[{i}]")
        return
    if isinstance(want, float) and not isinstance(got, bool):
        assert (math.isnan(got) and math.isnan(want)) or math.isclose(
            got, want, rel_tol=FLOAT_RTOL, abs_tol=0.0), (where, got, want)
        return
    assert got == want, (where, got, want)


def _same_column(g: pd.Series, w: pd.Series, where: str) -> None:
    assert str(g.dtype) == str(w.dtype), (where, g.dtype, w.dtype)
    if pd.api.types.is_float_dtype(w.dtype):
        np.testing.assert_allclose(g.to_numpy(), w.to_numpy(),
                                   rtol=FLOAT_RTOL, atol=0.0,
                                   equal_nan=True, err_msg=where)
        return
    pd.testing.assert_series_equal(g.reset_index(drop=True),
                                   w.reset_index(drop=True),
                                   check_exact=True, check_names=False,
                                   obj=where)
