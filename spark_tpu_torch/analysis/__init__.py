"""Static analysis: the physical-plan analyzer, plan-integrity
validation, the source lints and the concurrency checks (the port of
`spark_tpu/analysis/`).

- **Plan analyzer** (`plan_analyzer`): after planning and before any
  ingest or launch, walk the physical plan on the host and emit typed
  `Finding`s -- dtype-overflow hazards, host-sync loops, unbucketed
  capacities, hash-table pressure, mesh replication. Findings flow
  through the listener bus (`on_analysis`) into the event log, render in
  `explain(analysis=True)`, and are governed by
  `spark_tpu.sql.analysis.{enabled,strict}`; strict mode raises
  `AnalysisFindingError` before any device work on error-severity
  findings. `predictions` writes down the plan's size predictions for
  `history.prediction_report` to grade.
- **Plan integrity** (`plan_integrity`): the optimizer's validator and
  tracer (`spark_tpu.sql.planChangeValidation`, `planChangeLog`).
- **Source lints** (`lints/`, `concurrency/`): a registry of AST passes
  over `spark_tpu_torch/`; `python -m spark_tpu_torch.analysis.lints
  --all` runs them.

The JAX package's `jaxpr_analyzer` (`analyze_jaxpr`, `trace_stage`) has
no counterpart: the port runs eagerly and builds no stage program to
walk before dispatch. The hazards that walk confirms are found on the
plan (`MESH_GATHER_RESULT`/`MESH_FULL_REPLICATION`,
`UDF_HOST_ROUNDTRIP`), and the port sums integers into int64
accumulators, so `JAXPR_I32_ACCUMULATOR` cannot arise.
`spark_tpu.sql.analysis.jaxpr` stays unported (`config.UNPORTED_KEYS`).
"""

from .findings import (AnalysisFindingError, CATEGORIES, FINDING_CODES,
                       Finding, errors_of)
from .plan_analyzer import analyze_plan
from .plan_integrity import (PlanChangeTracer, PlanIntegrityError,
                             PlanIntegrityValidator)

__all__ = [
    "AnalysisFindingError", "CATEGORIES", "FINDING_CODES", "Finding",
    "PlanChangeTracer", "PlanIntegrityError", "PlanIntegrityValidator",
    "analyze_plan", "errors_of",
]
