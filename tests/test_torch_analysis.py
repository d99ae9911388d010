"""The port's static plan analyzer (`spark_tpu_torch/analysis/`) against
the JAX package's, on the CPU: every case of `tests/test_analysis.py`
through both packages on the same inputs (tables made from a seed with
numpy or built from literals), the port on the CPU device and the JAX
package on its CPU backend. Findings are held equal as (code, severity,
op, message, detail) tuples; results as Arrow tables (the TPC-H goldens'
float tolerance, 1e-6, where a golden is involved).

Where the JAX package's case rests on a JAX-only mechanism the port's
counterpart is tested instead, and the test says so:

- strict mode: the JAX package proves "before compile" by an empty
  stage cache; the port compiles no stage, so it proves "before any
  device work" -- no launch, no device-cache entry, no ingest span;
- `X64_TRUNCATION`: JAX keys it on `jax_enable_x64`; the port's
  premise is its dtype map, which narrows no 64-bit type, so a torch
  plan never meets it (and a narrowed map would);
- the jaxpr half (`JAXPR_*`, `analysis.jaxpr`) is left out of the port:
  the JAX package's side runs with `analysis.jaxpr=off` where events
  are on (its `auto` mode would turn the jaxpr walk on), and the port
  refuses the key.

Last, the 22 TPC-H SQL queries at SF 0.002 under
`planChangeValidation=full` (tests/conftest.py's default) and
`planChangeLog=true`: each query's findings, size predictions,
`explain(analysis=True)` section and rule trace (batch, rule,
invocations, effective, diff) must be equal. The port's side is a real
execution: its findings and predictions are the ones `QueryExecution`
kept. The JAX package's side plans the query without running it (its
stage compiles would cost a minute here): its analyzer walks the same
planned tree at the same point, before any capacity of a run is
applied, which is what its execution analyzes on a first run (each
case's sources are fresh, `tests/torch_sql_parity.py`, so no kept
capacity applies).
"""

import decimal

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

from spark_tpu import config as ref_config
from spark_tpu import functions as RF
from spark_tpu import types as RT
from spark_tpu.analysis import analyze_plan as ref_analyze
from spark_tpu.session import SparkTpuSession as RefSession
from spark_tpu_torch import SparkTpuSession
from spark_tpu_torch import config as port_config
from spark_tpu_torch import functions as PF
from spark_tpu_torch import types as PT
from spark_tpu_torch.analysis import (FINDING_CODES, AnalysisFindingError,
                                      Finding, analyze_plan)

ENABLED_KEY = "spark_tpu.sql.analysis.enabled"
STRICT_KEY = "spark_tpu.sql.analysis.strict"
JAXPR_KEY = "spark_tpu.sql.analysis.jaxpr"
CHUNK_KEY = "spark_tpu.sql.execution.streamingChunkRows"
MESH_KEY = "spark_tpu.sql.mesh.size"
BUDGET_KEY = "spark_tpu.sql.memory.deviceBudget"
FOOTER_KEY = "spark_tpu.sql.stats.parquetFooter"
EVENT_KEY = "spark_tpu.sql.eventLog.dir"
SF = 0.002


def port_session(confs=()):
    s = SparkTpuSession.builder().device("cpu").get_or_create()
    for k, v in confs:
        s.conf.set(k, v)
    return s


def ref_session(confs=()):
    s = RefSession(register_active=False)
    for k, v in confs:
        s.conf.set(k, v)
    return s


#: (session maker, functions, types, analyze_plan) of each package
PKGS = ((port_session, PF, PT, analyze_plan),
        (ref_session, RF, RT, ref_analyze))


def fx(findings):
    """A findings list as comparable tuples (None stays None)."""
    if findings is None:
        return None
    return [(f.code, f.severity, f.op, f.message, f.detail)
            for f in findings]


def codes(findings):
    return [f.code for f in (findings or [])]


def both(build, confs=(), run=True):
    """`build(session, F, T)` -> DataFrame through each package. Returns
    ((port qe, port result), (ref qe, ref result)); result None unless
    `run`."""
    out = []
    for make, F, T, _ in PKGS:
        s = make(confs)
        qe = build(s, F, T)._qe()
        out.append((qe, qe.collect() if run else None))
    return out


def same_findings(pair):
    (pqe, _), (rqe, _) = pair
    assert fx(pqe.analysis_findings) == fx(rqe.analysis_findings), \
        (fx(pqe.analysis_findings), fx(rqe.analysis_findings))
    return pqe.analysis_findings


def same_results(pair):
    (_, got), (_, want) = pair
    assert got.to_pylist() == want.to_pylist()


@pytest.fixture(scope="module")
def tpch_path(tmp_path_factory):
    from spark_tpu_torch.tpch.datagen import write_parquet
    path = str(tmp_path_factory.mktemp("tpch_analysis") / "sf")
    write_parquet(path, SF)
    return path


def tpch_both(path, tag, confs=()):
    """(port, reference) sessions over the TPC-H tables at `path`, read
    through sources named after the case."""
    from torch_sql_parity import sessions
    return sessions(path, tag, confs)


# -- the registry and the keys -----------------------------------------------

def test_finding_codes_closed_registry():
    from spark_tpu.analysis import FINDING_CODES as REF_CODES
    assert FINDING_CODES == REF_CODES  # JAXPR_* included, never emitted
    with pytest.raises(ValueError, match="unknown finding code"):
        Finding("MADE_UP", "nope")
    f = Finding("SUM_I64_OVERFLOW", "msg", op="x")
    assert f.category == "dtype-overflow" and f.severity == "error"
    assert f.to_dict()["severity"] == "error"
    for code, (cat, sev, doc) in FINDING_CODES.items():
        assert sev in ("error", "warn", "info") and doc, code


@pytest.mark.parametrize("key", [ENABLED_KEY, STRICT_KEY,
                                 "spark_tpu.sql.planChangeValidation",
                                 "spark_tpu.sql.planChangeLog"])
def test_analysis_keys_registered_with_reference_defaults(key):
    assert key not in port_config.UNPORTED_KEYS
    assert port_config.registry()[key].default == \
        ref_config.registry()[key].default
    assert port_config.registry()[key].doc


def test_jaxpr_key_stays_unported_and_says_why():
    """The jaxpr half is left out (ROADMAP): its key only takes its
    default, and setting anything else names the reason."""
    s = port_session()
    assert JAXPR_KEY in port_config.UNPORTED_KEYS
    with pytest.raises(port_config.UnportedConfError,
                       match="jaxpr analyzer the eager port leaves out"):
        s.conf.set(JAXPR_KEY, "on")
    s.conf.set(JAXPR_KEY, "auto")
    import spark_tpu_torch.analysis as A
    assert not hasattr(A, "analyze_jaxpr") and not hasattr(A, "trace_stage")


def test_int_sums_accumulate_in_int64():
    """Why JAXPR_I32_ACCUMULATOR cannot arise in the port: every
    integral and decimal SUM/AVG accumulator is int64 (the kernels add
    64-bit words), whatever the input's width."""
    from spark_tpu_torch.expr import ColumnRef
    from spark_tpu_torch.expr_agg import Avg, Sum
    for dt in (PT.BYTE, PT.SHORT, PT.INT, PT.LONG, PT.DecimalType(12, 2)):
        schema = PT.Schema([PT.Field("v", dt, True)])
        for agg in (Sum(ColumnRef("v")), Avg(ColumnRef("v"))):
            spec = agg.accumulators(schema)[0]
            assert spec.np_dtype == np.dtype(np.int64), (agg, dt)


# -- dtype-overflow -----------------------------------------------------------

def _overflow_plan(s, F, T):
    """int32 sum over a lazily-planned 2^33-row range: 33 row bits + 31
    value bits > 63 accumulator bits. Never executed."""
    return (s.range(1 << 33).select(F.col("id").cast(T.INT).alias("v"))
            .agg(F.sum(F.col("v")).alias("s")))


def test_overflow_finding_int32_plan():
    got = []
    for make, F, T, analyze in PKGS:
        s = make()
        got.append(analyze(_overflow_plan(s, F, T)._qe().executed_plan,
                           s.conf, 1))
    assert fx(got[0]) == fx(got[1])
    hits = [f for f in got[0] if f.code == "SUM_I64_OVERFLOW"]
    assert hits and hits[0].severity == "error"
    assert hits[0].detail["required_bits"] > hits[0].detail["acc_bits"]


def _decimal_table(values):
    return pa.table({"d": pa.array([decimal.Decimal(int(v)) for v in values],
                                   type=pa.decimal128(18, 0))})


def test_overflow_finding_decimal_executes():
    """decimal(18,0) values near the type max (seeded): ~60 value bits by
    dtype and by the source's min/max, 16 rows: 64 > 63. Execution still
    succeeds (non-strict) and the finding lands on the execution."""
    rng = np.random.default_rng(7)
    table = _decimal_table(9 * 10**17 + rng.integers(0, 1000, 16))

    def build(s, F, T):
        s.register_table("ana_dec", table)
        return s.table("ana_dec").agg(F.sum(F.col("d")).alias("s"))

    pair = both(build)
    same_results(pair)
    assert "SUM_I64_OVERFLOW" in codes(same_findings(pair))


def test_overflow_suppressed_by_column_stats():
    """Small values in a wide decimal: the dtype alone says 60 bits (a
    finding), the source's min/max 4 bits (none); with the footer stats
    off the dtype-only verdict returns."""
    table = _decimal_table(range(16))

    def build(s, F, T):
        s.register_table("ana_dec_small", table)
        return s.table("ana_dec_small").agg(F.sum(F.col("d")).alias("s"))

    assert codes(same_findings(both(build))) == []
    pair = both(build, confs=((FOOTER_KEY, False),))
    assert "SUM_I64_OVERFLOW" in codes(same_findings(pair))


def test_no_overflow_on_bounded_sum():
    pair = both(lambda s, F, T: s.range(16)
                .select(F.pmod(F.col("id"), 256).alias("k"))
                .agg(F.sum(F.col("k")).alias("s")))
    same_results(pair)
    assert same_findings(pair) == []


def test_strict_raises_before_any_device_work():
    """The JAX package's strict case proves "before compile" by an empty
    stage cache; the port compiles nothing, so it proves no device work:
    no kernel launch, no device-cache entry, no ingest or dispatch span.
    Both raise with the same findings."""
    from spark_tpu_torch.execution import dense_groupby as D
    from spark_tpu_torch.io.device_cache import CACHE
    errors = []
    for make, F, T, _ in PKGS:
        s = make(((STRICT_KEY, True),))
        qe = _overflow_plan(s, F, T)._qe()
        before = (dict(D.LAUNCHES), CACHE.stats()["entries"])
        with pytest.raises(AnalysisFindingError if make is port_session
                           else Exception) as ei:
            qe.execute_batch()
        errors.append(ei.value)
        if make is port_session:
            assert (dict(D.LAUNCHES), CACHE.stats()["entries"]) == before
            names = [sp.name for sp in qe.spans.spans]
            assert "analyze" in names
            assert not {"ingest", "dispatch", "streaming"} & set(names)
        else:
            assert s._stage_cache == {}
    assert type(errors[1]).__name__ == "AnalysisFindingError"
    assert str(errors[0]) == str(errors[1])
    assert fx(errors[0].findings) == fx(errors[1].findings)
    assert "SUM_I64_OVERFLOW" in codes(errors[0].findings)


def _stream_agg(s, F, T):
    return (s.range(1 << 12).select(F.pmod(F.col("id"), 64).alias("k"))
            .group_by(F.col("k")).agg(F.sum(F.col("k")).alias("s")))


def test_strict_ignores_warn_findings():
    pair = both(_stream_agg, confs=((STRICT_KEY, True),
                                    (CHUNK_KEY, 1 << 10)))
    (_, got), _ = pair
    assert got.num_rows == 64
    assert sorted(got.to_pylist(), key=lambda r: r["k"]) == sorted(
        pair[1][1].to_pylist(), key=lambda r: r["k"])
    assert "STREAMING_HOST_SYNC" in codes(same_findings(pair))


# -- host-sync ----------------------------------------------------------------

def test_streaming_host_sync_finding():
    pair = both(_stream_agg, confs=((CHUNK_KEY, 1 << 10),))
    hits = [f for f in same_findings(pair)
            if f.code == "STREAMING_HOST_SYNC"]
    assert hits and hits[0].detail["chunks"] >= 4
    assert hits[0].severity == "warn"
    # the port really streamed it, in those chunks
    assert "InputExec(streamed_agg" in pair[0][0].spliced_plan.tree_string()


def test_spill_host_sync_finding_external_path(tmp_path):
    """deviceBudget reroutes collect() through the out-of-core external
    path, which never reaches execute_batch: the analyzer runs there."""
    rng = np.random.default_rng(11)
    pd.DataFrame({"v": rng.integers(0, 1 << 30, 4096)}).to_parquet(
        tmp_path / "t.parquet")
    pair = both(lambda s, F, T: s.read_parquet(str(tmp_path / "t.parquet")),
                confs=((BUDGET_KEY, 1024),))
    same_results(pair)
    assert "SPILL_HOST_SYNC" in codes(same_findings(pair))
    assert "external" in pair[0][0].phase_times


def test_no_duplicate_findings_on_dag_shared_scans(tpch_path):
    """A runtime filter's creation chain shares its scan leaf with the
    join's build side: each shared node is analyzed once."""
    from spark_tpu.tpch import queries as RQ
    from spark_tpu_torch.tpch import queries as PQ
    port, ref = tpch_both(tpch_path, "dag", ((BUDGET_KEY, 1024),))
    got = analyze_plan(PQ.QUERIES["q3"](port)._qe().executed_plan,
                       port.conf, 1)
    want = ref_analyze(RQ.QUERIES["q3"](ref)._qe().executed_plan,
                       ref.conf, 1)
    assert fx(got) == fx(want)
    ops = [f.op for f in got if f.code == "SPILL_HOST_SYNC"]
    assert ops and len(ops) == len(set(ops)), ops


def test_udf_host_roundtrip_finding():
    frame = pd.DataFrame({"v": np.random.default_rng(3).normal(size=8)})

    def build(s, F, T):
        s.register_table("ana_udf", frame)
        plus = F.udf(lambda v: v + 1.0, "double")
        return s.table("ana_udf").select(plus(F.col("v")).alias("w"))

    pair = both(build)
    same_results(pair)
    assert "UDF_HOST_ROUNDTRIP" in codes(same_findings(pair))


# -- recompile ----------------------------------------------------------------

def test_recompile_clean_on_real_plans(tpch_path):
    from spark_tpu.tpch import queries as RQ
    from spark_tpu_torch.tpch import queries as PQ
    port, ref = tpch_both(tpch_path, "rc")
    for q in ("q1", "q3"):
        got = analyze_plan(PQ.QUERIES[q](port)._qe().executed_plan,
                           port.conf, 1)
        want = ref_analyze(RQ.QUERIES[q](ref)._qe().executed_plan,
                           ref.conf, 1)
        assert fx(got) == fx(want)
        assert [f for f in got if f.category == "recompile"] == []


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_recompile_finding_seeded(seed):
    """A raw (unbucketed) group estimate drawn from a seed, set on both
    packages' aggregate: the same finding with the same bucket."""
    raw = int(np.random.default_rng(seed).integers(1000, 100000)) | 1

    def seeded(root, P):
        def seed_node(n):
            if isinstance(n, P.HashAggregateExec):
                n.est_groups = raw
            for c in n.children:
                seed_node(c)
        seed_node(root)
        return root

    import spark_tpu.plan.physical as RP
    import spark_tpu_torch.plan.physical as PP
    got = []
    for (make, F, T, analyze), P in zip(PKGS, (PP, RP)):
        s = make()
        root = seeded(_stream_agg(s, F, T)._qe().executed_plan, P)
        got.append(analyze(root, s.conf, 1))
    assert fx(got[0]) == fx(got[1])
    hits = [f for f in got[0] if f.code == "UNBUCKETED_CAPACITY"]
    assert hits and hits[0].detail["value"] == raw
    assert hits[0].detail["bucketed"] == 1 << (raw - 1).bit_length()


# -- mesh ---------------------------------------------------------------------

def test_mesh_replication_finding():
    """At mesh 8 (the port's 8 shard threads on the CPU, the JAX
    package's 8 virtual devices) a small build side is broadcast: the
    same MESH_FULL_REPLICATION finding, and the same results."""
    rng = np.random.default_rng(5)
    left = pd.DataFrame({"k": np.arange(2000), "v": rng.integers(0, 99, 2000)})
    right = pd.DataFrame({"k": np.arange(10), "n": rng.integers(0, 9, 10)})

    def build(s, F, T):
        return s.create_dataframe(left, "ana_l").join(
            s.create_dataframe(right, "ana_r"), on="k", how="inner")

    got = []
    for make, F, T, analyze in PKGS:
        s = make(((MESH_KEY, 8),))
        got.append(analyze(build(s, F, T)._qe().executed_plan, s.conf, 8))
    assert fx(got[0]) == fx(got[1])
    hits = [f for f in got[0] if f.code == "MESH_FULL_REPLICATION"]
    assert hits and hits[0].detail["mesh_n"] == 8
    pair = both(build, confs=((MESH_KEY, 8),))
    (_, a), (_, b) = pair
    assert sorted(a.to_pylist(), key=lambda r: r["k"]) == \
        sorted(b.to_pylist(), key=lambda r: r["k"])
    assert "MESH_FULL_REPLICATION" in codes(same_findings(pair))


# -- x64 ----------------------------------------------------------------------

def test_x64_truncation_never_met_by_the_port(monkeypatch):
    """The port's premise for X64_TRUNCATION is its dtype map: no 64-bit
    type maps to a narrower tensor dtype, so a plan of 64-bit columns
    has no finding (as the JAX package has none with x64 on). A map that
    narrowed int64 would be flagged."""
    from spark_tpu_torch.analysis.plan_analyzer import narrowed_dtypes
    assert narrowed_dtypes() == []
    got = []
    for make, F, T, analyze in PKGS:
        s = make()
        root = s.range(128).agg(F.sum(F.col("id")).alias("s"))._qe() \
            .executed_plan
        got.append(analyze(root, s.conf, 1))
    assert fx(got[0]) == fx(got[1])
    assert "X64_TRUNCATION" not in codes(got[0])
    import torch
    narrowed = dict(PT._TORCH_DTYPES)
    narrowed[np.dtype(np.int64)] = torch.int32
    monkeypatch.setattr(PT, "_TORCH_DTYPES", narrowed)
    s = port_session()
    root = s.range(128).agg(PF.sum(PF.col("id")).alias("s"))._qe() \
        .executed_plan
    hits = [f for f in analyze_plan(root, s.conf, 1)
            if f.code == "X64_TRUNCATION"]
    assert hits and hits[0].severity == "error"


# -- surfacing: bus, event log, explain ---------------------------------------

def test_analysis_event_on_bus():
    events = []
    for make, F, T, _ in PKGS:
        mod = __import__(
            "spark_tpu_torch.observability" if make is port_session
            else "spark_tpu.observability", fromlist=["QueryListener"])

        class Collect(mod.QueryListener):
            def __init__(self):
                self.events = []

            def on_analysis(self, event):
                self.events.append(event)

        s = make(((CHUNK_KEY, 1 << 10), (JAXPR_KEY, "off"))
                 if make is ref_session else ((CHUNK_KEY, 1 << 10),))
        listener = Collect()
        s.add_listener(listener)
        _stream_agg(s, F, T)._qe().collect()
        assert len(listener.events) == 1, "on_analysis once per execution"
        events.append(listener.events[0].findings)
    assert events[0] == events[1]
    assert "STREAMING_HOST_SYNC" in [f["code"] for f in events[0]]


def test_analysis_findings_in_event_log(tmp_path):
    """The `analysis_findings` field, and the `predictions` one, read
    back through both packages' history from each package's log."""
    from spark_tpu import history as ref_history
    from spark_tpu_torch import history as port_history
    logged = []
    for make, F, T, _ in PKGS:
        d = str(tmp_path / ("p" if make is port_session else "r"))
        confs = ((EVENT_KEY, d), (CHUNK_KEY, 1 << 10))
        if make is ref_session:
            confs += ((JAXPR_KEY, "off"),)
        _stream_agg(make(confs), F, T)._qe().collect()
        for h in (port_history, ref_history):
            events = h.read_event_log(d)
            assert len(events) == 1
            logged.append((events.iloc[0]["analysis_findings"],
                           events.iloc[0]["predictions"]))
    assert all(x == logged[0] for x in logged[1:]), logged
    rec = logged[0][0][0]
    assert set(rec) >= {"code", "category", "severity", "message"}
    reports = [h.prediction_report(h.read_event_log(str(tmp_path / d)))
               for h, d in ((port_history, "p"), (ref_history, "r"))]
    assert reports[0].to_dict("records") == reports[1].to_dict("records")


def test_explain_analysis_section():
    texts = []
    for make, F, T, _ in PKGS:
        s = make()
        text = _overflow_plan(s, F, T)._qe().explain(analysis=True)
        texts.append(text.split("== Static Analysis ==")[1])
        clean = s.range(8)._qe().explain(analysis=True)
        assert clean.endswith("== Static Analysis ==\n  no findings")
    assert texts[0] == texts[1]
    assert "SUM_I64_OVERFLOW" in texts[0]


def test_analysis_disabled_leaves_none_and_explain_still_works():
    texts = []
    for make, F, T, _ in PKGS:
        s = make(((ENABLED_KEY, False), (CHUNK_KEY, 1 << 10)))
        qe = _stream_agg(s, F, T)._qe()
        qe.collect()
        # None = "never analyzed", distinct from [] = "analyzed clean"
        assert qe.analysis_findings is None
        if make is port_session:
            assert "analyze" not in [sp.name for sp in qe.spans.spans]
        texts.append(qe.explain(analysis=True).split(
            "== Static Analysis ==")[1])
    assert texts[0] == texts[1]
    assert "STREAMING_HOST_SYNC" in texts[0]


# -- golden parity with the analyzer on ----------------------------------------

@pytest.mark.parametrize("qname", ["q1", "q3"])
def test_tpch_golden_parity_analysis_on(tpch_path, qname):
    """Identical Arrow bytes with the analyzer on and off, no findings on
    the real plans, the golden answer, and the JAX package's findings."""
    from spark_tpu.tpch import queries as RQ
    from spark_tpu_torch.tpch import golden as G
    from spark_tpu_torch.tpch import queries as PQ
    port, ref = tpch_both(tpch_path, f"gp{qname}")
    runs = []
    for s, Q in ((port, PQ), (ref, RQ)):
        s.conf.set(ENABLED_KEY, False)
        t_off = Q.QUERIES[qname](s)._qe().collect()
        s.conf.set(ENABLED_KEY, True)
        qe = Q.QUERIES[qname](s)._qe()
        runs.append((qe, qe.collect(), t_off))
    (qe, t_on, t_off), (rqe, _, _) = runs
    assert t_on.equals(t_off)
    assert qe.analysis_findings == [] and fx(rqe.analysis_findings) == []
    # the second run starts from the capacities the first kept, in both
    # packages: the joins' predictions are those capacities
    assert qe.plan_predictions == rqe.plan_predictions
    got = G.normalize_decimals(t_on.to_pandas()).reset_index(drop=True)
    G.compare(got, G.GOLDEN[qname](tpch_path))


# -- the 22 TPC-H SQL queries ----------------------------------------------------

def _trace(records):
    return [(r["batch"], r["rule"], r["invocations"], r["effective"],
             r.get("diff")) for r in records]


@pytest.mark.parametrize("q", [f"q{i}" for i in range(1, 23)])
def test_tpch_sql_analysis_matches_reference(tpch_path, q):
    from spark_tpu.analysis.predictions import predict_plan as ref_predict
    from spark_tpu_torch.tpch.sql_queries import SQL_QUERIES
    port, ref = tpch_both(tpch_path, f"an{q}",
                          (("spark_tpu.sql.planChangeLog", True),))
    assert port.conf.get("spark_tpu.sql.planChangeValidation") == "full"
    pqe = port.sql(SQL_QUERIES[q])._qe()
    pqe.collect()
    rqe = ref.sql(SQL_QUERIES[q])._qe()
    root = rqe.executed_plan
    assert pqe.analysis_findings is not None
    assert fx(pqe.analysis_findings) == fx(ref_analyze(root, ref.conf, 1))
    assert pqe.plan_predictions == ref_predict(root, ref.conf, 1)
    assert pqe.explain(analysis=True).split("== Static Analysis ==")[1] \
        == rqe.explain(analysis=True).split("== Static Analysis ==")[1]
    assert _trace(pqe.rule_trace) == _trace(rqe.rule_trace)
    assert any(r.get("diff") for r in pqe.rule_trace)
