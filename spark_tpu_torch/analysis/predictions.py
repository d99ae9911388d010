"""Plan-time size predictions, graded against observed metrics (the
port of `spark_tpu/analysis/predictions.py`, record for record).

The planner and analyzer predict sizes everywhere -- exchange routed
bytes from row estimates, join output capacities, aggregate group
counts -- and this module writes those predictions down so they can be
checked against what the metrics channel measured: a systematically
wrong estimator (the thing that mis-seeds adaptive capacities and
mis-sizes runtime filters) shows up instead of staying invisible.

`predict_plan` walks the planned physical tree (host work only,
microseconds) and emits one record per predictable site:

    {"kind": "exch_rows"|"exch_bytes"|"join_rows"|"agg_groups",
     "tag": <node tag>, "predicted": <int>, "basis": <how derived>}

The executor keeps the list as `QueryExecution.plan_predictions` and
puts it in the event-log record (`predictions`);
`history.grade_predictions` joins each record against the observed
metric of the same tag (`exch_bytes_<tag>`, `join_rows_<tag>`,
`agg_groups_<tag>`) and grades it hit / over / under, and
`history.prediction_report` runs that over a replayed event log.
"""

from __future__ import annotations

from typing import List, Optional

from ..plan import physical as P


def _estimate_rows(node: P.PhysicalPlan) -> Optional[int]:
    from ..plan.runtime_filter import estimate_rows_physical
    try:
        return estimate_rows_physical(node)
    except Exception:  # noqa: BLE001 — estimates are best-effort
        return None


def _row_width(node: P.PhysicalPlan) -> int:
    try:
        return 8 * max(1, len(node.schema().fields))
    except Exception:  # noqa: BLE001
        return 8


def predict_plan(root: P.PhysicalPlan, conf, mesh_n: int = 1
                 ) -> List[dict]:
    """One prediction record per exchange / join / aggregate in the
    planned tree. Pure host-side walk; never raises past a node."""
    out: List[dict] = []
    seen = set()  # runtime-filter creation chains DAG-share nodes

    def walk(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for c in node.children:
            walk(c)
        try:
            _predict_node(node, out, mesh_n)
        except Exception:  # noqa: BLE001 — advisory only
            pass

    walk(root)
    try:
        _predict_udf(root, conf, out)
    except Exception:  # noqa: BLE001 — advisory only
        pass
    return out


def _predict_udf(root: P.PhysicalPlan, conf, out: List[dict]) -> None:
    """Predicted Arrow batch/row traffic through the UDF worker lane,
    graded against the observed `udf_batches`/`udf_rows` counters.
    Worker mode only: the in-process lane evaluates whole batches and
    never slices, so the batch count is not a prediction there."""
    if str(conf.get("spark_tpu.sql.udf.mode") or "inprocess") != "worker":
        return
    from ..execution.python_eval import node_udfs
    max_rec = int(conf.get(
        "spark_tpu.sql.udf.arrow.maxRecordsPerBatch"))
    rows_total = 0
    seen = set()

    def walk(node):
        nonlocal rows_total
        if id(node) in seen:
            return
        seen.add(id(node))
        for c in node.children:
            walk(c)
        if not node_udfs(node):
            return
        rows = _estimate_rows(node.children[0] if node.children
                              else node)
        if rows is not None and rows > 0:
            rows_total += rows

    walk(root)
    if rows_total <= 0:
        return
    out.append({"kind": "udf_rows", "tag": "udf",
                "predicted": int(rows_total), "basis": "scan-estimate"})
    out.append({"kind": "udf_batches", "tag": "udf",
                "predicted": int(-(-rows_total // max_rec)),
                "basis": f"rows/{max_rec}"})


def _predict_node(node, out: List[dict], mesh_n: int) -> None:
    if isinstance(node, P.ExchangeExec):
        if mesh_n <= 1:
            return  # identity on a single chip: nothing observable
        rows = _estimate_rows(node.children[0])
        if rows is None or rows <= 0:
            return
        width = _row_width(node.children[0])
        out.append({"kind": "exch_rows", "tag": node.tag,
                    "predicted": int(rows), "basis": "scan-estimate"})
        out.append({"kind": "exch_bytes", "tag": node.tag,
                    "predicted": int(rows) * width,
                    "basis": f"rows*{width}B"})
    elif isinstance(node, P.JoinExec):
        if node.out_cap is not None:
            # a seeded/learned capacity is itself a prediction of the
            # true output-row total — grade how tight the AQE seat is
            out.append({"kind": "join_rows", "tag": node.tag,
                        "predicted": int(node.out_cap),
                        "basis": "out_cap"})
        elif getattr(node, "cbo_est_rows", None) is not None:
            # the reorder cost model's own output estimate — grading it
            # against join_rows_<tag> closes the loop on the order
            # decisions (a systematically-wrong model shows up in
            # history.prediction_report as basis cbo-reorder misses)
            out.append({"kind": "join_rows", "tag": node.tag,
                        "predicted": int(node.cbo_est_rows),
                        "basis": "cbo-reorder"})
        else:
            rows = _estimate_rows(node.children[0])
            if rows is not None and rows > 0:
                out.append({"kind": "join_rows", "tag": node.tag,
                            "predicted": int(rows),
                            "basis": "probe-estimate"})
    elif isinstance(node, P.HashAggregateExec):
        if node.est_groups:
            out.append({"kind": "agg_groups", "tag": node.tag,
                        "predicted": int(node.est_groups),
                        "basis": "est_groups"})
