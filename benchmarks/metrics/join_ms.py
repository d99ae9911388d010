"""Operators, joins: JoinExec and RuntimeFilterExec ms a query, from the
synchronised operator pass over each query of the mix after the window,
mean over the mix's queries."""

OPERATORS = ("JoinExec", "RuntimeFilterExec")


def read(ctx):
    ops = ctx.get("operators") or {}
    if not any(o in t for t in ops.values() for o in OPERATORS):
        return None
    return sum(t.get(o, 0.0) for t in ops.values() for o in OPERATORS) \
        / len(ops) * 1e3
