"""Typed findings of the static plan analyzer (the port of
`spark_tpu/analysis/findings.py`, with its codes, categories, severities
and messages unchanged).

A plan that resolves can still be hazardous on a card: an int sum can
wrap its 64-bit accumulator at scale, a streaming aggregate pays a
blocking host sync per chunk, an unbucketed capacity varies with exact
input sizes, a broadcast under the mesh copies a full table to every
shard. Each of those is a typed `Finding` with a stable code, produced
by `plan_analyzer` (a walk of the physical tree) and surfaced through
the listener bus, the event log and `explain(analysis=True)`.

The registry is the JAX package's, closed and identical, the three
`JAXPR_*` codes included: the port runs eagerly, builds no stage program
to walk before dispatch, and so never emits them (ROADMAP records the
choice); a consumer keyed on codes reads either package's findings.

Severity discipline:

- ``error``: the query is likely to return WRONG RESULTS or fail
  (overflow wrap, x64 truncation). `spark_tpu.sql.analysis.strict`
  turns these into an `AnalysisFindingError` before any device work.
- ``warn``: correct but hazardous for performance/stability (host-sync
  loops, recompile churn, full replication).
- ``info``: worth recording, no action expected.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

#: category slugs (one per analyzer concern; the acceptance bar is >=1
#: distinct finding code per category on seeded-violation plans)
CAT_OVERFLOW = "dtype-overflow"
CAT_HOST_SYNC = "host-sync"
CAT_RECOMPILE = "recompile"
CAT_MESH = "mesh"
CAT_X64 = "x64"
CAT_KERNEL = "kernel"
CAT_PLAN = "plan-integrity"

CATEGORIES = (CAT_OVERFLOW, CAT_HOST_SYNC, CAT_RECOMPILE, CAT_MESH,
              CAT_X64, CAT_KERNEL, CAT_PLAN)

#: finding code -> (category, severity, one-line doc). The registry is
#: closed on purpose: an ad-hoc code would dodge the README table and
#: any consumer keying on codes (mirrors METRIC_PREFIXES discipline).
FINDING_CODES: Dict[str, tuple] = {
    "SUM_I64_OVERFLOW": (
        CAT_OVERFLOW, "error",
        "capacity x max-magnitude of a SUM/AVG input exceeds the int64 "
        "accumulator range: the sum can wrap silently"),
    "SUM_F32_INPUT": (
        CAT_OVERFLOW, "info",
        "SUM/AVG over float32 input data: each element carries only a "
        "24-bit mantissa, so the (float64-accumulated) total inherits "
        "float32 input error"),
    "STREAMING_HOST_SYNC": (
        CAT_HOST_SYNC, "warn",
        "scan exceeds streamingChunkRows: the aggregate streams in "
        "host-driven chunks with a blocking device->host sync per chunk"),
    "SPILL_HOST_SYNC": (
        CAT_HOST_SYNC, "warn",
        "estimated scan footprint exceeds memory.deviceBudget: execution "
        "reroutes through the host-spill chunked path (device_get per "
        "chunk)"),
    "UDF_HOST_ROUNDTRIP": (
        CAT_HOST_SYNC, "warn",
        "Python UDF in the plan: the stage splits around a "
        "device->host->device round trip per batch"),
    "UDF_SCALAR_LARGE_INPUT": (
        CAT_HOST_SYNC, "info",
        "a scalar (row-at-a-time) Python UDF sits over a large scan: "
        "every row crosses the interpreter individually — @pandas_udf "
        "runs the same logic vectorized over whole Arrow batches"),
    "GENERATE_MESH_MATERIALIZE": (
        CAT_HOST_SYNC, "warn",
        "explode/generate under a mesh materializes its subtree "
        "single-device on the host before sharding the flat result"),
    "JAXPR_HOST_CALLBACK": (
        CAT_HOST_SYNC, "warn",
        "the traced stage contains a host callback primitive: every "
        "dispatch blocks on a device->host transition"),
    "UNBUCKETED_CAPACITY": (
        CAT_RECOMPILE, "warn",
        "a static capacity baked into the stage-cache key is not "
        "bucket-aligned (columnar.bucket_capacity): the key varies with "
        "exact input sizes and recompiles per size instead of per "
        "bucket"),
    "MESH_FULL_REPLICATION": (
        CAT_MESH, "warn",
        "a broadcast exchange under shard_map all-gathers a full "
        "relation onto every shard (n_shards x its bytes of ICI traffic "
        "and HBM)"),
    "MESH_GATHER_RESULT": (
        CAT_MESH, "info",
        "a single-partition exchange under shard_map gathers all rows "
        "onto every shard (expected for global sorts/aggregates; "
        "hazardous when the gathered relation is large)"),
    "JAXPR_ALL_GATHER": (
        CAT_MESH, "warn",
        "the traced stage lowers to all_gather collectives under "
        "shard_map (full replication confirmed in the jaxpr)"),
    "X64_TRUNCATION": (
        CAT_X64, "error",
        "a 64-bit column (long/double/timestamp/decimal) is used while "
        "JAX x64 is disabled: device arrays silently truncate to 32 "
        "bits"),
    "JOIN_HASH_TABLE_PRESSURE": (
        CAT_KERNEL, "warn",
        "a join the conf would run on the hash kernel degrades: the "
        "hashMaxTableSlots-clamped table either forces the sort "
        "fallback (load factor > 0.7) or its slot bytes exceed the "
        "device HBM budget — the kernel choice silently falls back or "
        "pressures the lease"),
    "JAXPR_I32_ACCUMULATOR": (
        CAT_X64, "warn",
        "the traced stage reduces into an int32 accumulator with JAX "
        "x64 disabled: sums wrap at 2^31"),
    "PLAN_INTEGRITY": (
        CAT_PLAN, "error",
        "an optimizer rule application broke a plan invariant "
        "(unresolvable/ambiguous column reference, undeclared output-"
        "schema change, duplicate output names, incoherent aggregate, "
        "incompatible join-key dtypes, or a nondeterministic batch "
        "rewrite) — the rewritten plan can return wrong results; "
        "produced by analysis/plan_integrity.py under "
        "spark_tpu.sql.planChangeValidation=lite (full raises "
        "PlanIntegrityError instead)"),
}


@dataclass
class Finding:
    """One typed analyzer finding, event-log serializable."""

    code: str
    message: str
    op: str = ""  # op_tag / node identity the finding anchors to
    detail: Dict = field(default_factory=dict)

    def __post_init__(self):
        if self.code not in FINDING_CODES:
            raise ValueError(
                f"unknown finding code {self.code!r}; register it in "
                f"analysis.findings.FINDING_CODES")

    @property
    def category(self) -> str:
        return FINDING_CODES[self.code][0]

    @property
    def severity(self) -> str:
        return FINDING_CODES[self.code][1]

    def to_dict(self) -> Dict:
        d = {"code": self.code, "category": self.category,
             "severity": self.severity, "message": self.message}
        if self.op:
            d["op"] = self.op
        if self.detail:
            d["detail"] = self.detail
        return d

    def render(self) -> str:
        loc = f" at {self.op}" if self.op else ""
        return f"[{self.severity}] {self.code} ({self.category}){loc}: " \
               f"{self.message}"


class AnalysisFindingError(RuntimeError):
    """Raised under `spark_tpu.sql.analysis.strict`, before any ingest or
    launch, when the analyzer produced error-severity findings. Carries
    the full list so callers (and tests) can inspect codes structurally.
    The message is the JAX package's word for word."""

    def __init__(self, findings: List[Finding]):
        self.findings = list(findings)
        errors = [f for f in self.findings if f.severity == "error"]
        lines = "\n".join("  " + f.render() for f in errors)
        super().__init__(
            f"static analysis failed (analysis.strict=true): "
            f"{len(errors)} error finding(s) before compile:\n{lines}")


def errors_of(findings: List[Finding]) -> List[Finding]:
    return [f for f in findings if f.severity == "error"]
