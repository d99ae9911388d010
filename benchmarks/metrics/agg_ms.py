"""Operators, aggregate: HashAggregateExec ms a query, from the
synchronised operator pass over each query of the mix after the window,
mean over the mix's queries."""

OPERATOR = "HashAggregateExec"


def read(ctx):
    ops = ctx.get("operators") or {}
    if not any(OPERATOR in t for t in ops.values()):
        return None
    return sum(t.get(OPERATOR, 0.0) for t in ops.values()) / len(ops) * 1e3
